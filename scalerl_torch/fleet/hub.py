"""Connection hub and job executor: the learner host's message plumbing.

Port of ``scalerl_tpu/fleet/hub.py`` (jax-free there too), over the port's
``fleet/transport.py``:

- :class:`QueueHub` pumps a dynamic set of connections through bounded
  in/out queues with one receive and one send thread.  A dead connection is
  dropped, not fatal.  With ``max_pending`` the inbound queue sheds its
  stalest message instead of blocking the pump.  With
  ``heartbeat_interval`` it pings every connection on that cadence, drops a
  peer silent past the timeout (``on_dead``), answers pings in the pump and
  feeds each pong to the tracer's clock-skew estimator
  (``runtime/tracing.py::observe_pong``), so no consumer ever sees a
  heartbeat.  The serving plane's server and router run on it.
- :class:`JobExecutor` deals jobs from a generator to idle pipe workers and
  funnels their (post-processed) results into a bounded queue; a job sent
  to a dead worker is requeued.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional, Set, Tuple

from scalerl_torch.fleet.framing import ProtocolError
from scalerl_torch.fleet.transport import (
    Connection,
    open_worker_pipes,
    wait_readable,
)
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.supervisor import (
    LivenessTracker,
    is_heartbeat,
    make_ping,
    make_pong,
)
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)


class QueueHub:
    """Pumps a dynamic set of connections through in/out queues.

    ``heartbeat_interval`` > 0 arms the liveness plane: ping every
    connection each interval; a connection with no inbound traffic (results,
    RPCs, or pongs all count) for ``heartbeat_timeout`` seconds (default
    2 x interval — the detection bound) is disconnected and reported via
    ``on_dead(conn, reason)``.  A connection that has never spoken gets
    ``first_contact_grace`` instead — spawned gather processes pay seconds
    of interpreter+import boot before their pump starts answering.
    """

    def __init__(
        self,
        maxsize: int = 256,
        heartbeat_interval: float = 0.0,
        heartbeat_timeout: float = 0.0,
        first_contact_grace: float = 120.0,
        on_dead: Optional[Callable[[Connection, str], None]] = None,
        on_telemetry: Optional[Callable[[Connection, Any], None]] = None,
        max_pending: int = 0,
        on_disconnect: Optional[Callable[[Connection], None]] = None,
    ) -> None:
        # max_pending > 0 arms BOUNDED ADMISSION on the inbound queue: when
        # the consumer lags that far behind, the stalest queued message is
        # shed (counted in shed_total) instead of the recv pump blocking on
        # a full queue — a blocked pump stops answering pings and the whole
        # liveness plane rots behind one slow consumer.  0 keeps the old
        # block-on-full behavior (maxsize still bounds memory).
        self.input_queue: "queue.Queue[Tuple[Connection, Any]]" = queue.Queue(maxsize)
        self.output_queue: "queue.Queue[Tuple[Connection, Any]]" = queue.Queue(maxsize)
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout or 2.0 * heartbeat_interval
        self.first_contact_grace = max(first_contact_grace, self.heartbeat_timeout)
        self.max_pending = max_pending
        self.shed_total = 0
        self.on_dead = on_dead
        # piggybacked telemetry: any inbound dict carrying a "telem" key —
        # heartbeat pongs and result-upload frames — has the payload handed
        # to this callback in the recv pump (one merge point, no new
        # message kinds or round-trips)
        self.on_telemetry = on_telemetry
        # membership: fired for EVERY removal of a registered connection
        # (EOF, protocol error, liveness verdict) — unlike on_dead, which
        # only covers heartbeat verdicts.  The elastic fleet uses this to
        # requeue a dead gather's outstanding tasks and clean its roster
        # entry; close() does not fire it (teardown is not churn).
        self.on_disconnect = on_disconnect
        self.protocol_errors = 0  # corrupt frames rejected by the recv pump
        self.peers_dropped = 0  # liveness verdicts (silent peers dropped)
        telemetry.get_registry().bind(
            "hub",
            lambda: {
                "protocol_errors": self.protocol_errors,
                "peers_dropped": self.peers_dropped,
                "shed_total": self.shed_total,
                "connections": self.connection_count(),
                "input_depth": self.input_queue.qsize(),
                "output_depth": self.output_queue.qsize(),
            },
        )
        self._liveness = LivenessTracker()
        self._greeted: Set[Connection] = set()
        self._conns: Set[Connection] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._recv_loop, daemon=True),
            threading.Thread(target=self._send_loop, daemon=True),
        ]
        if heartbeat_interval > 0:
            self._threads.append(
                threading.Thread(target=self._heartbeat_loop, daemon=True)
            )
        for t in self._threads:
            t.start()

    def connection_count(self) -> int:
        with self._lock:
            return len(self._conns)

    def add_connection(self, conn: Connection) -> None:
        with self._lock:
            self._conns.add(conn)
        self._liveness.beat(conn)

    def disconnect(self, conn: Connection) -> None:
        with self._lock:
            present = conn in self._conns
            self._conns.discard(conn)
            self._greeted.discard(conn)
        self._liveness.forget(conn)
        try:
            conn.close()
        except Exception:
            pass
        if present and self.on_disconnect is not None:
            try:
                self.on_disconnect(conn)
            except Exception:  # noqa: BLE001 — membership hooks must not kill the pump
                logger.exception("hub: on_disconnect callback failed")

    def recv(self, timeout: Optional[float] = None) -> Tuple[Connection, Any]:
        """Next (connection, message); raises queue.Empty on timeout."""
        return self.input_queue.get(timeout=timeout)

    def send(self, conn: Connection, msg: Any, compress: bool = False) -> None:
        self.output_queue.put((conn, (msg, compress)))

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                conns = list(self._conns)
            if not conns:
                self._stop.wait(0.05)
                continue
            ready, dead = wait_readable(conns, timeout=0.05)
            for conn in dead:
                self.disconnect(conn)
            for conn in ready:
                try:
                    msg = conn.recv()
                except ProtocolError as e:
                    # corrupt-frame reject: the stream is desynchronized, so
                    # drop the link — a socket gather reconnects through the
                    # accept loop (its backoff path) and resends
                    self.protocol_errors += 1
                    telemetry.get_registry().counter("hub.protocol_errors").inc()
                    telemetry.record_event("protocol_error", error=str(e))
                    logger.warning("hub: corrupt frame rejected (%s)", e)
                    self.disconnect(conn)
                    continue
                except (EOFError, OSError, ConnectionError, ValueError):
                    self.disconnect(conn)
                    continue
                self._liveness.beat(conn)
                with self._lock:
                    self._greeted.add(conn)
                if (
                    self.on_telemetry is not None
                    and isinstance(msg, dict)
                    and "telem" in msg
                ):
                    # piggybacked fleet telemetry (pong or result upload)
                    try:
                        self.on_telemetry(conn, msg.get("telem"))
                    except Exception:  # noqa: BLE001 — telemetry must not kill the pump
                        logger.exception("hub: on_telemetry callback failed")
                if is_heartbeat(msg):
                    # swallowed here: pings answered in-pump, pongs are pure
                    # liveness — consumers never see a heartbeat kind
                    if msg.get("kind") == "ping":
                        self.send(conn, make_pong(msg))
                    elif "rt" in msg:
                        # the pong echoes our ping's wall t and adds the
                        # responder's rt/host: one free clock-skew sample
                        # per heartbeat, feeding the tracer's per-link
                        # offset table (tools/trace_report.py alignment)
                        tracing.observe_pong(msg)
                    continue
                if self.max_pending > 0:
                    # bounded admission: shed the STALEST queued message so
                    # the freshest data survives and the pump never blocks
                    # (a blocked pump stops answering pings); the loop also
                    # covers max_pending >= queue maxsize, where put_nowait
                    # is the binding constraint
                    while True:
                        if self.input_queue.qsize() >= self.max_pending:
                            self._shed_one()
                        try:
                            self.input_queue.put_nowait((conn, msg))
                            break
                        except queue.Full:
                            self._shed_one()
                else:
                    self.input_queue.put((conn, msg))

    def _shed_one(self) -> None:
        try:
            self.input_queue.get_nowait()
        except queue.Empty:
            return
        self.shed_total += 1
        telemetry.get_registry().counter("hub.shed_total").inc()

    def _send_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, (msg, compress) = self.output_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                conn.send(msg, compress=compress)
            except (BrokenPipeError, OSError, ConnectionError):
                self.disconnect(conn)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            with self._lock:
                conns = list(self._conns)
                greeted = set(self._greeted)
            now_stale = set(self._liveness.stale(self.heartbeat_timeout))
            grace_stale = set(self._liveness.stale(self.first_contact_grace))
            for conn in conns:
                # detection bound: a peer that answers no ping for
                # heartbeat_timeout (= 2 intervals by default) is dead even
                # though its socket never closed
                stale = now_stale if conn in greeted else grace_stale
                if conn in stale:
                    reason = (
                        "heartbeat timeout: no traffic for "
                        f"{self.heartbeat_timeout:.1f}s"
                        if conn in greeted
                        else "heartbeat timeout: peer never spoke within "
                        f"{self.first_contact_grace:.1f}s of connecting"
                    )
                    logger.warning("hub: dropping silent connection (%s)", reason)
                    self.peers_dropped += 1
                    telemetry.record_event("peer_dead", reason=reason)
                    self.disconnect(conn)
                    if self.on_dead is not None:
                        try:
                            self.on_dead(conn, reason)
                        except Exception:  # noqa: BLE001 — reporter must not kill the pump
                            logger.exception("hub: on_dead callback failed")
                else:
                    self.send(conn, make_ping())


class JobExecutor:
    """Feed jobs from a generator to N pipe workers; collect results.

    The worker ``target(conn, *args)`` loop should ``conn.recv()`` a job,
    process it, and ``conn.send(result)``; ``None`` job means shutdown.
    """

    def __init__(
        self,
        target: Callable[..., None],
        job_source: Iterator[Any],
        num_workers: int,
        postprocess: Optional[Callable[[Any], Any]] = None,
        out_maxsize: int = 8,
    ) -> None:
        self._job_source = job_source
        self._postprocess = postprocess
        self.results: "queue.Queue[Any]" = queue.Queue(out_maxsize)
        self._stop = threading.Event()
        self._retry: "queue.Queue[Any]" = queue.Queue()
        self._idle: "queue.Queue[Connection]" = queue.Queue()
        self._conns, self._procs = open_worker_pipes(
            num_workers, target, lambda i: (i,)
        )
        for c in self._conns:
            self._idle.put(c)
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True),
            threading.Thread(target=self._collect_loop, daemon=True),
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._idle.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                job = self._retry.get_nowait()
            except queue.Empty:
                try:
                    job = next(self._job_source)
                except StopIteration:
                    self._idle.put(conn)
                    return
            try:
                conn.send(job)
            except (BrokenPipeError, OSError):
                # worker died: the generator cannot replay, so requeue the
                # job for the next idle worker instead of dropping it
                self._retry.put(job)
                continue

    def _collect_loop(self) -> None:
        while not self._stop.is_set():
            if not self._conns:
                self._stop.wait(0.05)
                continue
            ready, dead = wait_readable(list(self._conns), timeout=0.02)
            for conn in dead:
                self._conns.remove(conn)
            for conn in ready:
                try:
                    result = conn.recv()
                except (EOFError, OSError, ConnectionError):
                    if conn in self._conns:
                        self._conns.remove(conn)
                    continue
                if self._postprocess is not None:
                    result = self._postprocess(result)
                self.results.put(result)
                self._idle.put(conn)

    def shutdown(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=timeout)
            if proc.is_alive():
                proc.terminate()
        for conn in self._conns:
            conn.close()
