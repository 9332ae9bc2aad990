"""Actor-fleet protocol: workers, gathers, server, local and remote clusters.

Port of ``scalerl_tpu/fleet/cluster.py`` (jax-free there too), over the
port's framing, transport, hub, chaos, tracing, supervisor and telemetry.
Parity target: ``scalerl/hpc/worker.py`` (27-352), the HandyRL-style fleet:
a server hands out rollout and eval tasks, per-host *gathers* fan workers
into one uplink with task prefetch, weight caching and batched result
upload, and remote hosts join through an entry handshake.

This is the control plane for **host CPU actors** feeding a central learner
on the card (the SEED RL topology).  Weights are versioned numpy snapshots
from ``runtime.param_server.ParameterServer``; every payload rides the flat
frame codec, with zlib on the rollout uplink.  Gathers and workers never
touch the card: a gather starts by spawn from a learner that holds CUDA
(``utils/platform.py::safe_mp_context``) and runs one torch thread.

Wire protocol (dicts over ``fleet.transport.Connection``):

    worker->gather  {"kind": "task"}                      request next task
                    {"kind": "params", "have": v}         fetch weights if stale
                    {"kind": "result", "v": {...}}        one episode result
    gather->server  {"kind": "task_batch", "n": k}        prefetch k tasks
                    {"kind": "params", "have": v}
                    {"kind": "result_batch", "v": [...], "seq": s}
                                                          batched upload, kept
                                                          by the gather until acked
    server->gather  {"kind": "task_batch", "v": [t...]}   t=None means stop
                    {"kind": "params", "version": v, "weights": tree}
                    {"kind": "result_ack", "seq": s}      upload s fully received

    Every result carries an at-least-once dedup key (worker_id,
    upload_epoch, episode_seq): unacked uploads are resent after a
    reconnect, so a cut link or a checksum-rejected frame costs a
    retransmit, never a lost or double-counted episode.
    entry handshake {"kind": "entry", "num_workers": n, "host": h}
                    -> {"kind": "entry_ack", "base_worker_id": b, "config": {...}}

Elasticity (the scale events ``runtime/autoscaler.py`` drives):

    gather->server  {"kind": "gather_hello", "base_worker_id": b,
                     "num_workers": n, "gather_epoch": e}
                                          membership, sent on connect and
                                          after every reconnect
                    {"kind": "task_return", "v": [t...]}
                                          unstarted prefetched tasks handed
                                          back on drain, for reissue
                    {"kind": "drain_done", "base_worker_id": b}
                                          drain complete: results flushed,
                                          every retained upload acked
    server->gather  {"kind": "drain"}     stop starting episodes, return
                                          unstarted tasks, flush, await
                                          acks, close cleanly

    Tasks the server hands out are stamped with a monotonic ``_task_id``
    and tracked per gather link: a link that dies (EOF, protocol error,
    liveness verdict, a killed process) has its outstanding tasks requeued
    for the next gather, and results are deduplicated at task level too (a
    task that raced its requeue and completed twice counts once):
    at-least-once execution, exactly-once episode accounting.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from scalerl_torch.fleet.framing import ProtocolError
from scalerl_torch.fleet.hub import QueueHub
from scalerl_torch.fleet.transport import (
    Connection,
    PipeConnection,
    accept_connection,
    connect_socket,
    listen_socket,
    open_worker_pipes,
    send_recv,
    wait_readable,
)
from scalerl_torch.runtime import chaos, telemetry, tracing
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.supervisor import (
    DRAIN,
    DRAIN_DONE,
    is_heartbeat,
    make_drain,
    make_pong,
)
from scalerl_torch.runtime.telemetry import TelemetryAggregator
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENTRY_PORT = 9999
WORKER_PORT = 9998

# EpisodeRunner: (task dict, weights pytree, worker_id) -> result dict
EpisodeRunner = Callable[[Dict[str, Any], Any, int], Dict[str, Any]]


def _host_child_threads() -> None:
    """A gather or worker runs one intra-op torch thread: children x threads
    stay within the host's cores, and none of them touches the card."""
    import torch

    from scalerl_torch.utils.platform import ACTOR_TORCH_THREADS

    torch.set_num_threads(ACTOR_TORCH_THREADS)


@dataclass
class FleetConfig:
    num_workers: int = 4
    workers_per_gather: int = 16
    task_prefetch: int = 0          # 0 → 1 + workers/4, like the reference
    upload_batch: int = 4           # results batched per uplink message
    compress_uplink: bool = True
    entry_port: int = ENTRY_PORT
    worker_port: int = WORKER_PORT
    server_host: str = "127.0.0.1"
    # Liveness plane (runtime/supervisor.py): the server pings every gather
    # link on this cadence and declares a SILENT (not closed) peer dead
    # after heartbeat_timeout_s (0 → 2 x interval, the detection bound);
    # gathers treat a server link with no traffic for the same window as
    # dead and reconnect.  0 disables heartbeats entirely (pre-supervision
    # behavior: only closed connections are detected).
    heartbeat_interval_s: float = 5.0
    heartbeat_timeout_s: float = 0.0
    # Socket-gather reconnect: capped exponential backoff
    # (supervisor.exp_backoff) after a lost server link, up to max_reconnects
    # attempts across the gather's lifetime before it gives up and exits.
    reconnect_backoff_s: float = 0.5
    reconnect_backoff_cap_s: float = 10.0
    max_reconnects: int = 5
    # Bounded admission (the fleet-wide max_pending/shed_total vocabulary,
    # shared with RolloutQueue and the inference batcher): when > 0, the
    # server hub sheds the stalest queued inbound message once this many
    # are pending instead of blocking its recv pump on a slow consumer —
    # unbounded queue growth silently becomes latency and policy lag.
    # 0 (default) keeps the pre-serving block-on-full behavior.
    max_pending: int = 0
    # Telemetry plane (runtime/telemetry.py): gathers piggyback compact
    # registry snapshots (their own counters + per-worker payloads relayed
    # from worker results) on heartbeat pongs and result-upload frames; the
    # server merges them into per-worker and aggregate series.  No new
    # message kinds or round-trips — just extra dict keys on existing v2
    # codec frames.  False strips the piggyback (pre-telemetry wire shape).
    telemetry_piggyback: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_gathers(self) -> int:
        return 1 + max(0, self.num_workers - 1) // self.workers_per_gather

    def prefetch(self, workers: int) -> int:
        return self.task_prefetch or 1 + workers // 4

    @property
    def heartbeat_timeout(self) -> float:
        return self.heartbeat_timeout_s or 2.0 * self.heartbeat_interval_s


# ---------------------------------------------------------------------------
# worker


def worker_loop(
    conn: Connection,
    worker_id: int,
    runner: EpisodeRunner,
    epoch_salt: int = 0,
) -> None:
    """Task loop: parity with ``Worker.run`` (``hpc/worker.py:96-120``).

    Runner exceptions are *reported upstream* before the worker exits (the
    reference's fleet forgot dead workers, SURVEY.md §5); the server
    surfaces them.

    Every result carries an at-least-once dedup key: ``(worker_id,
    upload_epoch, episode_seq)``.  A gather that loses its server link
    resends the in-flight upload on the fresh connection (the gather's
    reconnect path), so the server may see a result twice;
    the per-worker monotonic ``episode_seq`` lets it drop the duplicate
    instead of double-counting the episode into replay.  ``upload_epoch``
    is a random per-worker-process nonce so an elastically *respawned*
    worker (same id, fresh seq counter) is not mistaken for a replay —
    and ``epoch_salt`` (the owning gather's ``gather_epoch`` nonce) rides
    its high bits, so every worker of a respawned gather is provably in a
    fresh epoch even against a per-worker randomness collision: a slow
    duplicate from the corpse gather can never collide with the
    replacement's live sequence.
    """
    import os as _os
    import traceback

    _host_child_threads()
    weights: Any = None
    version = -1
    upload_epoch = (int(epoch_salt) << 32) | int.from_bytes(_os.urandom(4), "big")
    episode_seq = 0
    reg = telemetry.get_registry()
    ep_meter = reg.meter("worker.episodes_per_s")
    try:
        while True:
            task = send_recv(conn, {"kind": "task"})
            if task is None:
                break
            t_task = time.monotonic()
            task_ctx = tracing.extract(task)
            want = int(task.get("param_version", -1))
            if want >= 0 and want != version:
                reply = send_recv(
                    conn, {"kind": "params", "have": version, "want": want}
                )
                if reply is not None:
                    version = int(reply["version"])
                    weights = reply["weights"]
                    reg.counter("worker.param_fetches").inc()
            try:
                # activate the task's trace for the episode: any flight
                # event recorded inside (env error, chaos injection in this
                # process) carries the trace id — forensics link both ways
                with tracing.get_tracer().activate(task_ctx):
                    result = runner(task, weights, worker_id)
                if task_ctx is not None:
                    tracing.record_span(
                        "task.episode", parent=task_ctx, t_start=t_task,
                        t_end=time.monotonic(), kind="fleet",
                        worker=worker_id,
                    )
            except Exception as exc:  # noqa: BLE001 - funneled upstream
                reg.counter("worker.errors").inc()
                conn.send(
                    {
                        "kind": "worker_error",
                        "v": {
                            "worker_id": worker_id,
                            "task": task,
                            "error": repr(exc),
                            "traceback": traceback.format_exc(),
                        },
                    }
                )
                break
            result["worker_id"] = worker_id
            result["param_version"] = version
            result["upload_epoch"] = upload_epoch
            result["episode_seq"] = episode_seq
            episode_seq += 1
            # echo the server's task id so it can close the outstanding-task
            # entry (and requeue-survivors dedup at task level)
            tid = task.get("_task_id") if isinstance(task, dict) else None
            if tid is not None:
                result["_task_id"] = tid
            reg.counter("worker.episodes").inc()
            ep_meter.mark()
            # compact telemetry piggyback: rides the existing result frame
            # up through the gather to the server's aggregator — no extra
            # messages (the gather strips it before the dedup-keyed upload)
            result["_telem"] = reg.compact()
            conn.send({"kind": "result", "v": result})
    except (EOFError, OSError, ConnectionError, KeyboardInterrupt):
        pass
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# gather


class Gather:
    """Per-host fan-in proxy: parity with ``Gather.run`` (``hpc/worker.py:153-232``).

    Liveness (runtime/supervisor.py): the gather answers server pings in its
    select loop, treats a server link silent past ``config.heartbeat_timeout``
    as dead, and — given a ``reconnect`` factory (socket gathers) — replaces
    the link with capped exponential backoff instead of dying, resending the
    in-flight upload/RPC on the fresh link (at-least-once delivery: the
    server may see a duplicate result batch after a mid-upload cut, which is
    harmless for rollout streams).  Pipe gathers (``LocalCluster``) keep the
    old die-on-error behavior: a dead pipe means a dead parent.
    """

    def __init__(
        self,
        server_conn: Connection,
        config: FleetConfig,
        runner: EpisodeRunner,
        base_worker_id: int,
        num_workers: int,
        reconnect: Optional[Callable[[], Connection]] = None,
    ) -> None:
        import os as _os

        self.server = server_conn
        self.config = config
        self.reconnect = reconnect
        self.reconnects_used = 0
        self._server_seen = time.monotonic()
        self.tasks: "queue.Queue[Any]" = queue.Queue()
        self.results: List[Dict[str, Any]] = []
        self.num_workers = num_workers
        # gather-level incarnation nonce: salts every child worker's
        # upload_epoch (high bits), so a respawned gather's whole worker
        # range is provably a fresh epoch — a slow duplicate from the dead
        # predecessor can never collide with this incarnation's sequences
        self.gather_epoch = int.from_bytes(_os.urandom(4), "big")
        # drain protocol (scale-down / spot SIGTERM): a server "drain" frame
        # stops new episodes, returns unstarted tasks, flushes + awaits acks,
        # then exits cleanly with a "drain_done"
        self.draining = False
        self._drain_requested = False
        # at-least-once uploads, completed: every result batch is RETAINED
        # under a gather-local upload seq until the server acks it
        # ("result_ack").  A batch the server never processed — the link
        # was cut mid-frame, or the frame arrived corrupt and was rejected
        # (ProtocolError -> disconnect) — is resent after the reconnect;
        # the server's (worker_id, episode_seq) dedup makes the redelivery
        # exactly-once from replay's point of view.
        self._upload_seq = 0
        self._unacked: Dict[int, List[Dict[str, Any]]] = {}
        self._params_version = -1
        self._params_msg: Any = None
        # telemetry plane: this gather's own counters plus the newest
        # compact snapshot relayed from each worker's result stream; both
        # ride the uplink on pongs and result-batch frames
        self.base_worker_id = base_worker_id
        self._worker_telem: Dict[int, Dict[str, float]] = {}
        self._reg = telemetry.get_registry()
        self._reg.bind(
            "gather",
            lambda: {
                "unacked_uploads": len(self._unacked),
                "live_workers": len(self.worker_conns),
                "reconnects": self.reconnects_used,
                "params_version": self._params_version,
            },
        )
        self.worker_conns, self.worker_procs = open_worker_pipes(
            num_workers,
            worker_loop,
            lambda i: (base_worker_id + i, runner, self.gather_epoch),
        )
        # task source exhausted: serve None to further requests, but keep
        # running until every worker has drained its final result and closed
        self._exhausted = False
        # membership announce: the server's roster (scale decisions, targeted
        # drains) learns about this gather before any task traffic flows
        self._send_hello()

    def _send_hello(self) -> None:
        self.server.send(
            {
                "kind": "gather_hello",
                "base_worker_id": self.base_worker_id,
                "num_workers": self.num_workers,
                "gather_epoch": self.gather_epoch,
            }
        )

    # -- server link ---------------------------------------------------
    def _replace_server_conn(self, why: Exception) -> None:
        """Reconnect with capped exponential backoff, or re-raise ``why``."""
        if self.reconnect is None:
            raise why if isinstance(why, Exception) else ConnectionError(str(why))
        from scalerl_torch.runtime.supervisor import exp_backoff

        try:
            self.server.close()
        except Exception:  # noqa: BLE001 — link already broken
            pass
        while self.reconnects_used < self.config.max_reconnects:
            delay = exp_backoff(
                self.reconnects_used,
                self.config.reconnect_backoff_s,
                self.config.reconnect_backoff_cap_s,
            )
            self.reconnects_used += 1
            self._reg.counter("gather.reconnect_attempts").inc()
            telemetry.record_event(
                "reconnect", attempt=self.reconnects_used, why=repr(why)
            )
            logger.warning(
                "gather: server link lost (%r); reconnecting in %.2fs "
                "(attempt %d/%d)",
                why, delay, self.reconnects_used, self.config.max_reconnects,
            )
            time.sleep(delay)
            try:
                self.server = self.reconnect()
                self._server_seen = time.monotonic()
                # re-announce membership FIRST: the server requeued this
                # gather's outstanding tasks when the old link dropped, and
                # the fresh roster entry is what targeted drains address
                self._send_hello()
                # the cut may have eaten in-flight uploads (or the server
                # rejected a corrupt frame and dropped the link): resend
                # everything unacked on the fresh link; a failure here is
                # just another failed reconnect attempt
                self._resend_unacked()
                return
            except (ConnectionError, OSError) as e:
                why = e
        raise ConnectionError(
            f"gather: server unreachable after {self.reconnects_used} "
            "reconnect attempts"
        ) from why

    def _recv_from_server(self) -> Any:
        """One server frame, heartbeats filtered (pings answered inline).

        On a reconnectable (socket) link with heartbeats enabled the wait is
        bounded by the liveness timeout — a silently-dead server surfaces as
        ``TimeoutError`` for the reconnect path instead of a forever-block.
        Pipe links keep unbounded waits: a pipe cannot die silently (peer
        death closes the fd), and a timeout would only convert a slow server
        on a loaded host into a dead gather.
        """
        timeout = (
            self.config.heartbeat_timeout
            if self.config.heartbeat_interval_s > 0 and self.reconnect is not None
            else None
        )
        while True:
            msg = self.server.recv(timeout=timeout)
            self._server_seen = time.monotonic()
            if is_heartbeat(msg):
                if msg.get("kind") == "ping":
                    self.server.send(self._make_pong(msg))
                continue
            if isinstance(msg, dict) and msg.get("kind") == "result_ack":
                # upload acks arrive unsolicited, possibly ahead of an RPC
                # reply — filter them like heartbeats
                self._unacked.pop(int(msg.get("seq", -1)), None)
                continue
            if isinstance(msg, dict) and msg.get("kind") == DRAIN:
                # drain is unsolicited too; flag it and let the main loop
                # run the protocol outside any in-flight RPC (sending the
                # task_return from here would re-enter the reconnect path)
                self._drain_requested = True
                continue
            return msg

    def _server_rpc(self, msg: Dict[str, Any], compress: bool = False) -> Any:
        """send+recv with heartbeat filtering and reconnect-with-retry."""
        while True:
            try:
                self.server.send(msg, compress=compress)
                return self._recv_from_server()
            except (ConnectionError, EOFError, OSError, TimeoutError) as e:
                self._replace_server_conn(e)

    def _server_send(self, msg: Dict[str, Any], compress: bool = False) -> None:
        while True:
            try:
                self.server.send(msg, compress=compress)
                return
            except (ConnectionError, BrokenPipeError, OSError) as e:
                self._replace_server_conn(e)

    def _pump_server(self) -> None:
        """Drain unsolicited server frames (pings) outside any RPC."""
        try:
            while self.server.poll(0):
                msg = self.server.recv()
                self._server_seen = time.monotonic()
                if is_heartbeat(msg):
                    if msg.get("kind") == "ping":
                        self.server.send(self._make_pong(msg))
                elif isinstance(msg, dict) and msg.get("kind") == "result_ack":
                    self._unacked.pop(int(msg.get("seq", -1)), None)
                elif isinstance(msg, dict) and msg.get("kind") == DRAIN:
                    self._drain_requested = True
                else:
                    logger.warning(
                        "gather: unsolicited server message %r",
                        msg.get("kind") if isinstance(msg, dict) else type(msg),
                    )
        except (ConnectionError, EOFError, OSError) as e:
            self._replace_server_conn(e)

    # -- telemetry piggyback -------------------------------------------
    def _telemetry_payload(self) -> Dict[str, Any]:
        """Compact snapshot for the uplink: this gather's registry plus the
        newest per-worker snapshots relayed off the result stream."""
        return {
            "src": f"gather:{self.base_worker_id}",
            "v": self._reg.compact(),
            "workers": {str(w): s for w, s in self._worker_telem.items()},
        }

    def _make_pong(self, ping_msg: Dict[str, Any]) -> Dict[str, Any]:
        pong = make_pong(ping_msg)
        if self.config.telemetry_piggyback:
            # heartbeat pongs carry the compact snapshot: a silent-but-idle
            # gather still reports series every heartbeat interval
            pong["telem"] = self._telemetry_payload()
        return pong

    def _check_server_liveness(self) -> None:
        # silent-death is a TCP pathology: pipe links (reconnect=None) skip
        # the staleness verdict — their failure mode is EOF, caught above
        if self.config.heartbeat_interval_s <= 0 or self.reconnect is None:
            return
        if time.monotonic() - self._server_seen > self.config.heartbeat_timeout:
            self._replace_server_conn(
                TimeoutError(
                    "no server traffic for "
                    f"{self.config.heartbeat_timeout:.1f}s"
                )
            )

    # -- drain protocol -------------------------------------------------
    def _begin_drain(self) -> None:
        """Stop starting episodes: serve None to further task requests and
        hand every unstarted prefetched task back to the server for
        reissue.  Workers finish the episode they hold (its result flushes
        normally), then exit on the None task; the run loop completes the
        protocol once the last worker is gone."""
        if self.draining:
            return
        self.draining = True
        self._exhausted = True
        self._reg.counter("gather.drains").inc()
        telemetry.record_event("drain_begin", base=self.base_worker_id)
        returned: List[Any] = []
        while True:
            try:
                t = self.tasks.get_nowait()
            except queue.Empty:
                break
            if t is not None:
                returned.append(t)
        if returned:
            self._server_send({"kind": "task_return", "v": returned})
        logger.info(
            "gather %d: draining (%d unstarted tasks returned, %d workers "
            "finishing)",
            self.base_worker_id, len(returned), len(self.worker_conns),
        )

    def _await_acks(self, timeout: float = 30.0) -> bool:
        """Pump the server link until every retained upload is acked (or the
        deadline passes) — the zero-lost-uploads half of a clean close."""
        deadline = time.monotonic() + timeout
        while self._unacked and time.monotonic() < deadline:
            try:
                if self.server.poll(0.1):
                    self._pump_server()
                self._check_server_liveness()
            except (ConnectionError, EOFError, OSError, TimeoutError) as e:
                try:
                    self._replace_server_conn(e)
                except (ConnectionError, EOFError, OSError):
                    return False  # reconnect budget spent: uploads stay retained
        return not self._unacked

    # -- main loop -----------------------------------------------------
    def run(self) -> None:
        try:
            while self.worker_conns:
                # snapshot the server link: a reconnect mid-sweep (triggered
                # by any conn in this iteration) replaces self.server, and
                # the STALE object may still sit in ready/dead — it must
                # never be mistaken for a dead worker pipe
                server_conn = self.server
                ready, dead = wait_readable(
                    self.worker_conns + [server_conn], timeout=0.02
                )
                for conn in dead:
                    if conn is server_conn:
                        if conn is self.server:  # not already replaced
                            self._replace_server_conn(
                                ConnectionError("server connection invalid")
                            )
                    elif conn in self.worker_conns:
                        self.worker_conns.remove(conn)
                for conn in ready:
                    if conn is server_conn:
                        if conn is self.server:
                            self._pump_server()
                        continue
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError, ConnectionError):
                        if conn in self.worker_conns:
                            self.worker_conns.remove(conn)
                        continue
                    self._handle(conn, msg)
                self._check_server_liveness()
                if self._drain_requested and not self.draining:
                    self._begin_drain()
            # every worker exited cleanly: final flush, then hold for the
            # server's acks so a drain/scale-down loses zero retained
            # uploads (the at-least-once retention is pointless if the
            # process exits before redelivery could happen)
            self._flush_results()
            acked = self._await_acks()
            if self.draining:
                telemetry.record_event(
                    "drain_done", base=self.base_worker_id, acked=acked
                )
                self._server_send(
                    {"kind": DRAIN_DONE, "base_worker_id": self.base_worker_id}
                )
        finally:
            self._flush_results()
            for c in self.worker_conns:
                c.close()

    def _handle(self, conn: Connection, msg: Dict[str, Any]) -> None:
        kind = msg["kind"]
        if kind == "task":
            if self.tasks.empty() and not self._exhausted:
                n = self.config.prefetch(len(self.worker_conns))
                batch = self._server_rpc({"kind": "task_batch", "n": n})
                for t in batch["v"]:
                    self.tasks.put(t)
            task = None if self._exhausted else self.tasks.get()
            if task is None:
                self._exhausted = True
            else:
                self._reg.counter("gather.tasks_served").inc()
            conn.send(task)
        elif kind == "params":
            have = int(msg["have"])
            want = int(msg.get("want", -1))
            if (
                self._params_version < 0          # cache miss
                or have == self._params_version   # worker already at cache
                or want > self._params_version    # task needs newer weights
            ):
                reply = self._server_rpc(
                    {"kind": "params", "have": self._params_version}
                )
                if reply is not None:
                    self._params_version = int(reply["version"])
                    self._params_msg = reply
            if self._params_msg is not None and have != self._params_version:
                conn.send(self._params_msg)
            else:
                conn.send(None)
        elif kind == "result":
            result = msg["v"]
            # relay point for worker telemetry: keep the newest compact
            # snapshot per worker, strip it from the dedup-keyed upload
            telem = result.pop("_telem", None) if isinstance(result, dict) else None
            if telem is not None:
                self._worker_telem[result.get("worker_id", -1)] = telem
            self._reg.counter("gather.results").inc()
            self.results.append(result)
            if len(self.results) >= self.config.upload_batch:
                self._flush_results()
        elif kind == "worker_error":
            # forward immediately (ahead of batched results) so the server
            # learns about the dead worker without waiting for a batch
            self._server_send({"kind": "worker_error", "v": msg["v"]})
        else:
            logger.warning("gather: unknown message kind %r", kind)

    def _flush_results(self) -> None:
        if self.results:
            batch, self.results = self.results, []
            self._upload_seq += 1
            self._unacked[self._upload_seq] = batch
            self._reg.counter("gather.uploads").inc()
            msg = {"kind": "result_batch", "v": batch, "seq": self._upload_seq}
            if self.config.telemetry_piggyback:
                # the upload frame is the other piggyback carrier: a busy
                # gather reports fresher than the heartbeat cadence for free
                msg["telem"] = self._telemetry_payload()
            self._server_send(msg, compress=self.config.compress_uplink)

    def _resend_unacked(self) -> None:
        """Replay every retained (un-acked) upload on the current link —
        plain sends: the caller owns reconnect-on-failure."""
        for seq in sorted(self._unacked):
            self.server.send(
                {"kind": "result_batch", "v": self._unacked[seq], "seq": seq},
                compress=self.config.compress_uplink,
            )


def gather_main(
    server_conn: Connection,
    config: FleetConfig,
    runner: EpisodeRunner,
    base_worker_id: int,
    num_workers: int,
    reconnect: Optional[Callable[[], Connection]] = None,
) -> None:
    _host_child_threads()
    try:
        Gather(
            server_conn, config, runner, base_worker_id, num_workers,
            reconnect=reconnect,
        ).run()
    except (KeyboardInterrupt, ConnectionError, EOFError, OSError):
        pass


# ---------------------------------------------------------------------------
# server


class WorkerServer:
    """Learner-side fleet endpoint.

    Parity with ``WorkerServer`` + ``ParameterServer`` capability
    (``hpc/worker.py:269-297``, ``hpc/parameter_server.py``): an entry
    listener hands out worker-id ranges to remote hosts; a worker listener
    feeds gather connections into a ``QueueHub``; the trainer publishes
    weights and drains episode results.
    """

    def __init__(
        self,
        config: FleetConfig,
        task_source: Callable[[], Optional[Dict[str, Any]]],
        result_maxsize: int = 4096,
        worker_error_maxsize: int = 256,
    ) -> None:
        self.config = config
        self.task_source = task_source
        self.params = ParameterServer()
        # heartbeat plane: the hub pings every gather link and reports a
        # silently-dead one (socket open, peer gone) here within
        # ~2 heartbeat intervals — closed sockets were already detected,
        # silent ones previously hung the fleet forever
        # fleet telemetry merge point: gathers piggyback compact snapshots
        # on pongs and uploads; the hub's recv pump hands every "telem"
        # payload here, and the aggregator's tree rides the process-wide
        # registry snapshot under fleet.*.  BOUNDED: elastic churn mints a
        # fresh source id per respawn, so dead sources must age out instead
        # of accumulating in the learner's view forever
        self.telemetry = TelemetryAggregator(max_sources=1024)
        self.hub = QueueHub(
            heartbeat_interval=config.heartbeat_interval_s,
            heartbeat_timeout=config.heartbeat_timeout
            if config.heartbeat_interval_s > 0
            else 0.0,
            on_dead=self._on_dead_connection,
            on_telemetry=lambda _conn, payload: self.telemetry.absorb_payload(payload),
            max_pending=config.max_pending,
            on_disconnect=self._on_disconnect,
        )
        self.results: "queue.Queue[Dict[str, Any]]" = queue.Queue(result_maxsize)
        # bounded error funnel: nobody is REQUIRED to poll this on a long
        # elastic run (gathers churn constantly on preemptible capacity), so
        # it must never grow without bound — the stalest entry is evicted on
        # overflow while the full history survives as the
        # server.worker_errors_total counter + per-error FlightRecorder
        # events (report_worker_error)
        self.worker_errors: "queue.Queue[Dict[str, Any]]" = queue.Queue(
            worker_error_maxsize
        )
        self.worker_errors_total = 0
        self.worker_errors_dropped = 0
        self.total_results = 0
        self.dropped_results = 0
        # elastic membership roster: conn -> {base_worker_id, num_workers,
        # gather_epoch, draining, joined_t}, fed by gather_hello frames and
        # pruned on disconnect/drain_done — what scale decisions and
        # targeted drains address
        self.gather_links: Dict[Connection, Dict[str, Any]] = {}
        self._roster_lock = threading.Lock()
        self.gathers_joined = 0
        self.gathers_drained = 0
        # exactly-once task accounting across elastic churn: every task
        # handed out carries a monotonic _task_id tracked per link; a dead
        # link's outstanding tasks requeue, and completions dedup at task
        # level so a requeue that raced its original execution counts once
        self._task_lock = threading.Lock()
        self._next_task_id = 0
        self._outstanding: Dict[int, Tuple[Connection, Any]] = {}
        self._conn_tasks: Dict[Connection, Set[int]] = {}
        self._completed_tasks: "OrderedDict[int, None]" = OrderedDict()
        self._completed_cap = 65536
        # open per-task root spans (head-sampled at dispatch; closed by the
        # dedup verdict) — bounded like the completed-task table
        self._task_traces: "OrderedDict[int, Any]" = OrderedDict()
        self._returned_tasks: Deque[Any] = deque()
        self.requeued_tasks = 0
        self.duplicate_tasks = 0
        reg = telemetry.get_registry()
        reg.bind("fleet", self.telemetry.tree)
        reg.bind(
            "server",
            lambda: {
                "total_results": self.total_results,
                "duplicate_results": self.duplicate_results,
                "dropped_results": self.dropped_results,
                "results_queued": self.results.qsize(),
                "worker_errors": self.worker_errors.qsize(),
                "worker_errors_total": self.worker_errors_total,
                "worker_errors_dropped": self.worker_errors_dropped,
                "param_version": self.params.version,
                "live_gathers": self.live_gather_count(),
                "live_workers": self.live_worker_count(),
                "gathers_joined": self.gathers_joined,
                "gathers_drained": self.gathers_drained,
                "outstanding_tasks": len(self._outstanding),
                "requeued_tasks": self.requeued_tasks,
                "duplicate_tasks": self.duplicate_tasks,
            },
        )
        # at-least-once dedup: per worker, per upload_epoch, the newest
        # episode_seq accepted (a bounded few epochs retained per worker) —
        # a reconnect-resent duplicate has the same epoch and a seq we
        # already consumed, and a SLOW duplicate from a dead gather's old
        # epoch stays recognizable even after its respawn registered a
        # fresh epoch (the single-(epoch, seq) table this replaces would
        # have been reset by the late frame and double-counted it)
        self._dedup_seen: Dict[int, "OrderedDict[int, int]"] = {}
        self._dedup_epochs_per_worker = 4
        self.duplicate_results = 0
        self._next_worker_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._server_socks: List[Any] = []

    def report_worker_error(self, err: Dict[str, Any]) -> None:
        """One funnel for every fleet failure report: bounded queue for
        pollers, monotonic counter + FlightRecorder event for everyone else
        (the queue may overflow on a long elastic run; the telemetry plane
        never loses the count)."""
        self.worker_errors_total += 1
        telemetry.get_registry().counter("server.worker_errors_total").inc()
        telemetry.record_event(
            "worker_error",
            worker_id=err.get("worker_id"),
            error=str(err.get("error"))[:200],
        )
        while True:
            try:
                self.worker_errors.put_nowait(err)
                return
            except queue.Full:
                try:
                    self.worker_errors.get_nowait()
                    self.worker_errors_dropped += 1
                except queue.Empty:
                    pass

    def _on_dead_connection(self, conn: Connection, reason: str) -> None:
        """Hub liveness verdict: mark the gather's workers dead so the
        trainer sees it (``worker_errors``) instead of silently losing
        throughput.  A socket gather that survived (e.g. network partition
        healed) reconnects on its own and re-registers via the accept
        loop."""
        logger.error("fleet: gather connection declared dead (%s)", reason)
        self.report_worker_error(
            {"worker_id": None, "task": None, "error": f"gather link dead: {reason}"}
        )

    def _on_disconnect(self, conn: Connection) -> None:
        """ANY removal of a gather link (EOF, corrupt frame, liveness
        verdict, preempted node): drop its roster entry and requeue its
        outstanding tasks so the remaining/backfilled fleet picks them up.
        A reconnecting gather still runs those tasks — the task-level
        completion dedup makes the double execution count once."""
        with self._roster_lock:
            self.gather_links.pop(conn, None)
        requeued = []
        with self._task_lock:
            for tid in self._conn_tasks.pop(conn, set()):
                entry = self._outstanding.pop(tid, None)
                if entry is not None and tid not in self._completed_tasks:
                    requeued.append(entry[1])
            self._returned_tasks.extend(requeued)
            self.requeued_tasks += len(requeued)
        if requeued:
            telemetry.get_registry().counter("server.requeued_tasks").inc(
                len(requeued)
            )
            telemetry.record_event(
                "tasks_requeued", count=len(requeued), why="disconnect"
            )
            logger.warning(
                "fleet: requeued %d outstanding tasks from a dropped gather "
                "link", len(requeued),
            )

    def _is_duplicate(self, result: Dict[str, Any]) -> bool:
        """At-least-once dedup on the (worker_id, upload_epoch, episode_seq)
        key stamped by ``worker_loop``.  Per-worker results flow through one
        gather in order (reconnect resends preserve order), so "seq <= newest
        accepted within the same epoch" identifies a resend exactly.  A
        bounded history of recent epochs is kept PER WORKER so a slow
        duplicate from a dead gather (old epoch) arriving after its
        respawn's fresh epoch is still recognized instead of resetting the
        table.  Results without the key (foreign runners) are always
        accepted."""
        wid = result.get("worker_id")
        seq = result.get("episode_seq")
        if wid is None or seq is None:
            return False
        epoch = int(result.get("upload_epoch", 0))
        seq = int(seq)
        epochs = self._dedup_seen.setdefault(wid, OrderedDict())
        last = epochs.get(epoch)
        if last is not None and seq <= last:
            return True
        epochs[epoch] = seq if last is None else max(last, seq)
        epochs.move_to_end(epoch)
        while len(epochs) > self._dedup_epochs_per_worker:
            epochs.popitem(last=False)
        return False

    # -- trainer API ---------------------------------------------------
    def publish(self, weights: Any) -> int:
        return self.params.push(weights)

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """ONE merged tree: this process's registry (server/hub/codec/ring/
        queue/supervisor instruments) plus the fleet aggregator's per-worker
        and aggregate series under ``fleet.*``."""
        return telemetry.snapshot()

    def get_result(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        try:
            return self.results.get(timeout=timeout)
        except queue.Empty:
            return None

    def assign_worker_ids(self, n: int) -> int:
        with self._id_lock:
            base = self._next_worker_id
            self._next_worker_id += n
            return base

    # -- elastic membership --------------------------------------------
    def live_gather_count(self) -> int:
        with self._roster_lock:
            return len(self.gather_links)

    def live_worker_count(self) -> int:
        """Workers behind currently-registered, non-draining gather links —
        the roster view of fleet capacity (spawned-but-booting gathers are
        invisible here until their hello lands; executors that spawn
        processes should count those themselves)."""
        with self._roster_lock:
            return sum(
                info["num_workers"]
                for info in self.gather_links.values()
                if not info.get("draining")
            )

    def drain_workers(self, n_workers: int) -> int:
        """Scale-down: ask the newest-joined gathers covering ``n_workers``
        to drain — stop starting episodes, return unstarted tasks, flush and
        await acks, then exit cleanly (``drain_done``).  Returns the worker
        count actually asked to drain.  Zero episodes are lost: in-flight
        episodes complete and upload, unstarted tasks reissue elsewhere."""
        with self._roster_lock:
            candidates = sorted(
                (
                    (conn, info)
                    for conn, info in self.gather_links.items()
                    if not info.get("draining")
                ),
                key=lambda item: item[1].get("joined_t", 0.0),
                reverse=True,  # LIFO: drain the newest capacity first
            )
            picked = []
            covered = 0
            for conn, info in candidates:
                if covered >= n_workers:
                    break
                info["draining"] = True
                picked.append((conn, info))
                covered += info["num_workers"]
        for conn, info in picked:
            telemetry.record_event(
                "drain_request",
                base=info["base_worker_id"],
                workers=info["num_workers"],
            )
            telemetry.get_registry().counter("server.drain_requests").inc()
            self.hub.send(conn, make_drain())
        return covered

    # -- bring-up ------------------------------------------------------
    def start(self, listen: bool = False) -> None:
        self._threads.append(
            threading.Thread(target=self._serve_loop, daemon=True)
        )
        if listen:
            entry = listen_socket(self.config.entry_port)
            workers = listen_socket(self.config.worker_port)
            self._server_socks = [entry, workers]
            self._threads.append(
                threading.Thread(target=self._entry_loop, args=(entry,), daemon=True)
            )
            self._threads.append(
                threading.Thread(target=self._accept_loop, args=(workers,), daemon=True)
            )
        for t in self._threads:
            t.start()

    def add_gather_connection(self, conn: Connection) -> None:
        self.hub.add_connection(conn)

    def _entry_loop(self, sock) -> None:
        while not self._stop.is_set():
            try:
                conn = accept_connection(sock, timeout=0.5)
            except (TimeoutError, OSError):
                continue
            try:
                msg = conn.recv(timeout=10.0)
                if not isinstance(msg, dict) or msg.get("kind") != "entry":
                    raise ProtocolError(
                        f"entry port expects an 'entry' frame, got "
                        f"{msg.get('kind') if isinstance(msg, dict) else type(msg).__name__!r}"
                    )
                n = int(msg["num_workers"])
                base = self.assign_worker_ids(n)
                conn.send(
                    {
                        "kind": "entry_ack",
                        "base_worker_id": base,
                        "config": {
                            "workers_per_gather": self.config.workers_per_gather,
                            "upload_batch": self.config.upload_batch,
                            "worker_port": self.config.worker_port,
                            # liveness policy is the learner's call: remote
                            # hosts adopt its heartbeat cadence so detection
                            # bounds match on both ends of every link
                            "heartbeat_interval_s": self.config.heartbeat_interval_s,
                            "heartbeat_timeout_s": self.config.heartbeat_timeout_s,
                            # like the heartbeat policy, the telemetry
                            # piggyback is the learner's call
                            "telemetry_piggyback": self.config.telemetry_piggyback,
                            "extra": self.config.extra,
                        },
                    }
                )
            except Exception:
                logger.exception("entry handshake failed")
            finally:
                conn.close()

    def _accept_loop(self, sock) -> None:
        while not self._stop.is_set():
            try:
                conn = accept_connection(sock, timeout=0.5)
            except (TimeoutError, OSError):
                continue
            self.hub.add_connection(conn)

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, msg = self.hub.recv(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._handle(conn, msg)
            except Exception:
                logger.exception("server: failed handling %r", msg.get("kind"))

    def _next_task(self) -> Optional[Any]:
        """Requeued tasks (returned on drain, or orphaned by a dead gather)
        take priority over the source — they were already accounted as
        handed out, and reissue is how a scale event loses zero episodes."""
        with self._task_lock:
            if self._returned_tasks:
                return self._returned_tasks.popleft()
        return None if self._stop.is_set() else self.task_source()

    def _record_outstanding(self, conn: Connection, task: Any) -> Any:
        """Stamp (once) and track the task under the issuing link."""
        if not isinstance(task, dict):
            return task
        task = dict(task)
        with self._task_lock:
            if "_task_id" not in task:
                task["_task_id"] = self._next_task_id
                self._next_task_id += 1
                # head-sampled task trace: the root rides the task frame
                # (dispatch -> worker episode -> upload -> dedup verdict);
                # a requeued task keeps its original context
                root = tracing.start_span(
                    "task", kind="fleet", task=task["_task_id"]
                )
                if root.sampled:
                    self._task_traces[task["_task_id"]] = root
                    while len(self._task_traces) > self._completed_cap:
                        _tid, stale = self._task_traces.popitem(last=False)
                        stale.end(verdict="abandoned")
                    tracing.inject(task, root)
            tid = task["_task_id"]
            self._outstanding[tid] = (conn, task)
            self._conn_tasks.setdefault(conn, set()).add(tid)
        return task

    def _handle(self, conn: Connection, msg: Dict[str, Any]) -> None:
        kind = msg["kind"]
        if kind == "task_batch":
            n = int(msg["n"])
            tasks = []
            for _ in range(n):
                t = self._next_task()
                if t is not None:
                    t = self._record_outstanding(conn, t)
                tasks.append(t)
                if t is None:
                    break
            self.hub.send(conn, {"kind": "task_batch", "v": tasks})
        elif kind == "params":
            weights, version = self.params.pull(int(msg["have"]))
            if weights is None:
                self.hub.send(conn, None)
            else:
                self.hub.send(
                    conn, {"kind": "params", "version": version, "weights": weights}
                )
        elif kind == "result_batch":
            if "seq" in msg:
                # ack FIRST: at-least-once means the gather retains the
                # batch until this lands; dedup below absorbs redelivery
                self.hub.send(conn, {"kind": "result_ack", "seq": msg["seq"]})
            reg = telemetry.get_registry()
            for r in msg["v"]:
                if self._is_duplicate(r):
                    self.duplicate_results += 1
                    reg.counter("server.duplicate_results").inc()
                    continue
                # task-level exactly-once: a task orphaned by a dead/drained
                # gather was requeued and may complete TWICE (the corpse's
                # workers finished it, and so did the reissue) — the second
                # completion is dropped here, keeping the episode count
                # exact across preemption waves
                tid = r.pop("_task_id", None) if isinstance(r, dict) else None
                if tid is not None:
                    with self._task_lock:
                        if tid in self._completed_tasks:
                            self.duplicate_tasks += 1
                            dup_task = True
                        else:
                            self._completed_tasks[tid] = None
                            while len(self._completed_tasks) > self._completed_cap:
                                self._completed_tasks.popitem(last=False)
                            entry = self._outstanding.pop(tid, None)
                            if entry is not None:
                                self._conn_tasks.get(entry[0], set()).discard(tid)
                            dup_task = False
                        root = self._task_traces.pop(tid, None)
                    if root is not None:
                        # the dedup verdict closes the task trace either way
                        root.end(
                            verdict="duplicate" if dup_task else "accepted"
                        )
                    if dup_task:
                        reg.counter("server.duplicate_tasks").inc()
                        continue
                self.total_results += 1
                reg.meter("server.results_per_s").mark()
                try:
                    self.results.put_nowait(r)
                except queue.Full:
                    # backpressure: evict the stalest queued result so the
                    # freshest episodes survive (off-policy freshness)
                    try:
                        self.results.get_nowait()
                        self.dropped_results += 1
                    except queue.Empty:
                        pass
                    try:
                        self.results.put_nowait(r)
                    except queue.Full:
                        self.dropped_results += 1
        elif kind == "gather_hello":
            # dynamic admission: a gather (initial, respawned, late-joining,
            # or reconnecting) announces its worker range — the roster entry
            # is what scale decisions count and targeted drains address
            with self._roster_lock:
                self.gather_links[conn] = {
                    "base_worker_id": int(msg.get("base_worker_id", -1)),
                    "num_workers": int(msg.get("num_workers", 0)),
                    "gather_epoch": int(msg.get("gather_epoch", 0)),
                    "draining": False,
                    "joined_t": time.monotonic(),
                }
                self.gathers_joined += 1
            telemetry.get_registry().counter("server.gathers_joined").inc()
            telemetry.record_event(
                "gather_join",
                base=msg.get("base_worker_id"),
                workers=msg.get("num_workers"),
            )
        elif kind == "task_return":
            # drain protocol: unstarted prefetched tasks come home for
            # reissue — accounting-wise they were never started
            requeued = 0
            with self._task_lock:
                for t in msg["v"]:
                    tid = t.get("_task_id") if isinstance(t, dict) else None
                    if tid is not None:
                        entry = self._outstanding.pop(tid, None)
                        if entry is not None:
                            self._conn_tasks.get(entry[0], set()).discard(tid)
                        if tid in self._completed_tasks:
                            continue  # raced a completion: nothing to redo
                    self._returned_tasks.append(t)
                    requeued += 1
                self.requeued_tasks += requeued
            if requeued:
                telemetry.get_registry().counter("server.requeued_tasks").inc(
                    requeued
                )
                telemetry.record_event(
                    "tasks_requeued", count=requeued, why="drain"
                )
        elif kind == DRAIN_DONE:
            with self._roster_lock:
                info = self.gather_links.pop(conn, None)
                self.gathers_drained += 1
            telemetry.get_registry().counter("server.gathers_drained").inc()
            telemetry.record_event(
                "gather_drained",
                base=msg.get("base_worker_id"),
                workers=(info or {}).get("num_workers"),
            )
            logger.info(
                "fleet: gather %s drained cleanly", msg.get("base_worker_id")
            )
        elif kind == "worker_error":
            err = msg["v"]
            logger.error(
                "fleet worker %s failed on task %r:\n%s",
                err.get("worker_id"),
                err.get("task"),
                err.get("traceback", err.get("error")),
            )
            self.report_worker_error(err)
        else:
            logger.warning("server: unknown message kind %r", kind)

    def stop(self) -> None:
        self._stop.set()
        self.hub.close()
        for s in self._server_socks:
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# clusters


class LocalCluster:
    """Gathers as local processes over pipes (parity: ``WorkerCluster``,
    ``hpc/worker.py:241-258``) — doubles as the multi-node simulator.

    ``max_restarts``: elastic recovery, beyond the reference (whose fleet
    simply forgot dead workers — SURVEY.md §5).  When > 0, a supervisor
    thread respawns a gather that dies unexpectedly — same worker-id range,
    fresh pipe registered with the server, and a fresh ``gather_epoch``
    nonce salting its workers' upload epochs so a slow duplicate from the
    corpse can never collide with the replacement's sequences — up to
    ``max_restarts`` times across the cluster.  The ``QueueHub`` already
    drops the dead pipe; the learner sees at most a brief throughput dip.
    0 (default) keeps the fail-fast behavior (errors surface via
    ``server.worker_errors``).

    Deliberate elasticity rides next to the crash path: ``scale_up`` admits
    fresh gathers mid-run (new worker-id ranges), the server's
    ``drain_workers`` closes gathers with zero episode loss, and
    ``ClusterExecutor`` packages both for ``runtime/autoscaler.py``.
    """

    def __init__(
        self,
        server: WorkerServer,
        config: FleetConfig,
        runner: EpisodeRunner,
        mp_context: Optional[str] = None,
        max_restarts: int = 0,
    ) -> None:
        self.server = server
        self.config = config
        self.runner = runner
        # a forked child must not inherit a CUDA context: when the parent
        # has initialized CUDA and no context was requested, start()
        # selects spawn (runners must then be picklable, e.g.
        # GenerationRunner over module-level functions)
        self.mp_context = mp_context
        self.max_restarts = max_restarts
        self.restarts = 0
        self.procs: List[mp.Process] = []
        self._spans: List[Tuple[int, int]] = []  # (base_worker_id, n) per gather
        self._ctx = None
        self._scale_lock = threading.Lock()
        self._stopping = threading.Event()
        self._supervisor: Optional[threading.Thread] = None

    def spawned_worker_count(self) -> int:
        """Workers behind live gather processes — the executor-side capacity
        truth (includes gathers still booting, which the server roster
        cannot see yet; excludes the dead and the cleanly exited)."""
        with self._scale_lock:
            return sum(
                n for (base, n), p in zip(self._spans, self.procs) if p.is_alive()
            )

    def scale_up(self, num_workers: int) -> int:
        """Dynamic admission: add ``num_workers`` of capacity mid-run as
        fresh gather processes with FRESH worker-id ranges (never a reuse
        of a dead range — the dedup epochs make reuse safe, fresh ranges
        make it legible).  Returns the worker count actually added."""
        if self._ctx is None:
            raise RuntimeError("scale_up before start(): no mp context yet")
        per = self.config.workers_per_gather
        remaining = int(num_workers)
        added = 0
        while remaining > 0:
            n = min(per, remaining)
            remaining -= n
            base = self.server.assign_worker_ids(n)
            with self._scale_lock:
                self._spawn(len(self.procs), base, n)
            added += n
        return added

    def _spawn(self, slot: int, base: int, n: int) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        # gathers spawn worker children, so they cannot be daemonic;
        # join() terminates stragglers and their daemonic workers
        proc = self._ctx.Process(
            target=gather_main,
            args=(PipeConnection(child), self.config, self.runner, base, n),
        )
        proc.start()
        child.close()
        self.server.add_gather_connection(PipeConnection(parent))
        if slot < len(self.procs):
            self.procs[slot] = proc
        else:
            self.procs.append(proc)
            self._spans.append((base, n))

    def start(self) -> None:
        from scalerl_torch.utils.platform import safe_mp_context

        per = self.config.workers_per_gather
        remaining = self.config.num_workers
        self._ctx = mp.get_context(safe_mp_context(self.mp_context))
        for g in range(self.config.num_gathers):
            n = min(per, remaining)
            remaining -= n
            base = self.server.assign_worker_ids(n)
            self._spawn(g, base, n)
        inj = chaos.active()
        mass_kill_armed = inj is not None and inj.plan.rates.get("mass_kill", 0.0) > 0
        if self.max_restarts > 0 or mass_kill_armed:
            # the supervisor doubles as the chaos preemption-wave driver:
            # with mass_kill configured it runs even at max_restarts=0 so
            # the AUTOSCALER (not the respawn budget) does the backfilling
            self._supervisor = threading.Thread(
                target=self._supervise, name="fleet-supervisor", daemon=True
            )
            self._supervisor.start()

    def chaos_poll(self) -> List[int]:
        """One seeded preemption-wave draw against the live gather procs
        (``mass_kill`` chaos kind); returns the killed slot indices."""
        return apply_mass_kill(self.procs, site="fleet")

    def _supervise(self) -> None:
        given_up: set = set()
        while not self._stopping.wait(0.5):
            self.chaos_poll()
            for slot, proc in enumerate(self.procs):
                if (
                    proc.is_alive()
                    or slot in given_up
                    or self._stopping.is_set()
                ):
                    continue
                if proc.exitcode == 0:
                    # clean exit (task source drained): not a failure —
                    # respawning would just burn budget on process churn
                    given_up.add(slot)
                    continue
                if self.restarts >= self.max_restarts:
                    # budget exhausted: surface it the fail-fast way (the
                    # learner polls worker_errors) and keep watching the
                    # OTHER slots rather than abandoning supervision
                    logger.error(
                        "fleet gather %d died (exit %s); restart budget "
                        "exhausted (%d used)",
                        slot, proc.exitcode, self.restarts,
                    )
                    self.server.report_worker_error(
                        {
                            "worker_id": None,
                            "task": None,
                            "error": (
                                f"gather {slot} died (exit {proc.exitcode}); "
                                f"restart budget exhausted "
                                f"({self.restarts}/{self.max_restarts})"
                            ),
                        }
                    )
                    given_up.add(slot)
                    continue
                self.restarts += 1
                base, n = self._spans[slot]
                logger.warning(
                    "fleet gather %d died (exit %s); respawning workers "
                    "%d..%d (restart %d/%d)",
                    slot, proc.exitcode, base, base + n - 1,
                    self.restarts, self.max_restarts,
                )
                self._spawn(slot, base, n)

    def join(self, timeout: float = 10.0) -> None:
        self._stopping.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()


class RemoteCluster:
    """Remote-host side: entry handshake then socket gathers (parity:
    ``RemoteWorkerCluster.run`` + ``entry``, ``hpc/worker.py:300-341``)."""

    def __init__(
        self,
        config: FleetConfig,
        runner: EpisodeRunner,
        num_workers: Optional[int] = None,
        mp_context: Optional[str] = None,
    ) -> None:
        self.config = config
        self.runner = runner
        self.num_workers = num_workers or config.num_workers
        self.mp_context = mp_context  # see LocalCluster: spawn once CUDA is live
        self.procs: List[mp.Process] = []
        self._spans: List[Tuple[int, int]] = []  # (base_worker_id, n) per proc
        self._adopted: Optional[FleetConfig] = None
        self._scale_lock = threading.Lock()

    def entry(self) -> Tuple[int, Dict[str, Any]]:
        conn = connect_socket(self.config.server_host, self.config.entry_port)
        try:
            ack = send_recv(
                conn, {"kind": "entry", "num_workers": self.num_workers, "host": ""}
            )
            if not isinstance(ack, dict) or ack.get("kind") != "entry_ack":
                raise ProtocolError(
                    f"entry handshake expects an 'entry_ack' reply, got "
                    f"{ack.get('kind') if isinstance(ack, dict) else type(ack).__name__!r}"
                )
            return int(ack["base_worker_id"]), ack["config"]
        finally:
            conn.close()

    def _adopt(self, remote_cfg: Dict[str, Any]) -> FleetConfig:
        import dataclasses

        # adopt the learner side's fleet policy from the handshake
        return dataclasses.replace(
            self.config,
            workers_per_gather=int(
                remote_cfg.get("workers_per_gather", self.config.workers_per_gather)
            ),
            worker_port=int(
                remote_cfg.get("worker_port", self.config.worker_port)
            ),
            upload_batch=int(
                remote_cfg.get("upload_batch", self.config.upload_batch)
            ),
            heartbeat_interval_s=float(
                remote_cfg.get(
                    "heartbeat_interval_s", self.config.heartbeat_interval_s
                )
            ),
            heartbeat_timeout_s=float(
                remote_cfg.get(
                    "heartbeat_timeout_s", self.config.heartbeat_timeout_s
                )
            ),
            telemetry_piggyback=bool(
                remote_cfg.get(
                    "telemetry_piggyback", self.config.telemetry_piggyback
                )
            ),
            extra={**self.config.extra, **remote_cfg.get("extra", {})},
        )

    def _launch(self, config: FleetConfig, base: int, num_workers: int) -> None:
        from scalerl_torch.utils.platform import safe_mp_context

        per = config.workers_per_gather
        remaining = num_workers
        offset = 0
        ctx = mp.get_context(safe_mp_context(self.mp_context))
        while remaining > 0:
            n = min(per, remaining)
            proc = ctx.Process(
                target=_remote_gather_main,
                args=(
                    self.config.server_host,
                    config.worker_port,
                    config,
                    self.runner,
                    base + offset,
                    n,
                ),
            )
            proc.start()
            with self._scale_lock:
                self.procs.append(proc)
                self._spans.append((base + offset, n))
            remaining -= n
            offset += n

    def start(self) -> None:
        base, remote_cfg = self.entry()
        self._adopted = self._adopt(remote_cfg)
        self._launch(self._adopted, base, self.num_workers)

    def scale_up(self, num_workers: int) -> int:
        """Dynamic admission from the remote-host side: a FRESH entry
        handshake mid-run assigns a new worker-id range and new socket
        gathers join the live fleet — the late-join path a spot replacement
        node takes.  Returns the worker count added."""
        base, remote_cfg = self.entry()
        config = self._adopted if self._adopted is not None else self._adopt(remote_cfg)
        self._launch(config, base, int(num_workers))
        return int(num_workers)

    def spawned_worker_count(self) -> int:
        """Executor-side capacity truth (see LocalCluster)."""
        with self._scale_lock:
            return sum(
                n for (base, n), p in zip(self._spans, self.procs) if p.is_alive()
            )

    def chaos_poll(self) -> List[int]:
        """One seeded preemption-wave draw against the gather procs."""
        return apply_mass_kill(self.procs, site="fleet")

    def join(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()


def _remote_gather_main(host, port, config, runner, base, n) -> None:
    conn = connect_socket(host, port)
    # one attempt per call: Gather._replace_server_conn owns the capped
    # exponential backoff schedule and the max_reconnects budget
    reconnect = lambda: connect_socket(host, port, retries=1)  # noqa: E731
    gather_main(conn, config, runner, base, n, reconnect=reconnect)


# ---------------------------------------------------------------------------
# elasticity: preemption waves + the autoscaler's reference executor


def apply_mass_kill(procs: List[mp.Process], site: str = "fleet") -> List[int]:
    """One ``mass_kill`` chaos draw against ``procs``: when the active
    injector's seeded wave fires, SIGTERM the chosen live peers (a spot
    preemption wave in miniature) and return their indices.  No injector or
    no fire → empty list, zero cost."""
    inj = chaos.active()
    if inj is None:
        return []
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    victims = inj.mass_kill_victims(len(alive), site=site)
    if not victims:
        return []
    killed = [alive[v] for v in victims]
    for i in killed:
        procs[i].terminate()
    telemetry.record_event("mass_kill", site=site, victims=killed)
    logger.warning(
        "chaos: mass_kill wave terminated %d/%d gathers (slots %s)",
        len(killed), len(alive), killed,
    )
    return killed


def apply_preempt(
    procs: List[mp.Process], site: str = "fleet"
) -> Optional[int]:
    """One ``preempt`` chaos draw against ``procs``: when the active
    injector fires, SIGTERM exactly ONE chosen live peer (a single spot
    reclaim, the unit the preemption-resume machinery must absorb) and
    return its index.  No injector or no fire → ``None``, zero cost."""
    inj = chaos.active()
    if inj is None:
        return None
    alive = [i for i, p in enumerate(procs) if p.is_alive()]
    victim = inj.preempt_victim(len(alive), site=site)
    if victim is None:
        return None
    i = alive[victim]
    procs[i].terminate()
    telemetry.record_event("preempt", site=site, victim=i)
    logger.warning(
        "chaos: preempt SIGTERMed peer slot %d (1/%d alive)", i, len(alive)
    )
    return i


class ClusterExecutor:
    """The autoscaler's reference ``ScaleExecutor`` over a ``WorkerServer``
    plus a Local/RemoteCluster.

    - ``worker_count``: the CLUSTER's spawned-process view (booting gathers
      count; dead ones don't) — using the server roster here would re-fire
      the floor rule every poll while a replacement boots.
    - ``scale_up``: spawn fresh gathers with fresh worker-id ranges
      (``cluster.scale_up``).
    - ``scale_down``: the server's drain protocol (``drain_workers``) — a
      deliberate zero-loss close, never a kill.
    """

    def __init__(self, server: WorkerServer, cluster: Any) -> None:
        self.server = server
        self.cluster = cluster

    def worker_count(self) -> int:
        return self.cluster.spawned_worker_count()

    def scale_up(self, n: int) -> int:
        return self.cluster.scale_up(n)

    def scale_down(self, n: int) -> int:
        return self.server.drain_workers(n)
