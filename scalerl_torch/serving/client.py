"""RemotePolicyClient: an env shell's view of the inference plane.

Port of ``scalerl_tpu/serving/client.py``.  It offers the acting facade the
actor planes already call (``act(obs, last_action, reward, done,
core_state)`` and ``initial_state``), but every policy forward runs on the
central :class:`~scalerl_torch.serving.server.InferenceServer`: the actor
keeps only envs and numpy buffers.  Replies are numpy; a core that arrives
as device tensors (from the local fallback) is read back before it goes on
the wire.

- **pipelined requests over ONE connection**: requests carry ids and a
  reader thread demuxes the replies, so several threads share one link and
  a request can be in flight while the caller prepares the next
  (:meth:`RemotePolicyClient.act_async`, :class:`PendingReply`);
- **reconnect with capped exponential backoff** on a lost or corrupt link
  (``supervisor.exp_backoff``): the client redials and resends the request
  in flight (at-least-once acting, harmless: inference has no side
  effects);
- **the shed-retry policy**: a shed reply is retried after a short pause;
  with a fallback, the third shed of one request goes to the fallback;
- **local fallback**: when the reconnect budget is spent (an in-process
  pipe cannot be redialed at all) the client turns to ``fallback``, an
  object with the same facade (the trainer passes the learner's agent, on
  the card), and counts ``serving_client.fallbacks``.  Without a fallback
  it raises :class:`ServingUnavailable`.  The serving trainer keeps the
  fallback for parity with the JAX package; a run that must prove it was
  served checks that counter;
- **re-probing out of degraded mode**: a fallen-back client redials once a
  window on a capped schedule, so a recovered server gets its clients back.

Every reply carries the parameter generation that served it; the client
keeps the newest (``.generation``) for the staleness gauge.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from scalerl_torch.fleet.transport import Connection
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.supervisor import exp_backoff, is_heartbeat, make_pong
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ServingUnavailable(ConnectionError):
    """The server is unreachable and no local fallback was configured."""


class PendingReply:
    """A demuxed in-flight request: ``result()`` blocks for the reply."""

    __slots__ = ("req_id", "_event", "_reply", "link_epoch")

    def __init__(self, req_id: int, link_epoch: int) -> None:
        self.req_id = req_id
        self.link_epoch = link_epoch
        self._event = threading.Event()
        self._reply: Optional[Dict[str, Any]] = None

    def deliver(self, reply: Optional[Dict[str, Any]]) -> None:
        self._reply = reply
        self._event.set()

    def done(self) -> bool:
        """Non-blocking: has a reply (or a link-loss verdict) landed?
        Poll-harvest callers (the traffic replay) sweep thousands of these
        without parking a thread per request."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"no reply for request {self.req_id}")
        if self._reply is None:
            raise ConnectionError("serving link lost while request in flight")
        return self._reply


def _as_core(core) -> Tuple:
    """Normalize a codec-decoded core payload to a tuple of (c, h) pairs."""
    if not core:
        return ()
    return tuple((np.asarray(pair[0]), np.asarray(pair[1])) for pair in core)


def _host(x) -> np.ndarray:
    """A numpy view of ``x``; a tensor (a core the local fallback left on
    the device) is read back first."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RemotePolicyClient:
    """Acting facade over a serving connection, with reconnect + fallback.

    ``conn``: an established :class:`Connection` (in-process pipe pair or a
    pre-dialed socket).  ``connect``: zero-arg factory producing a fresh
    connection — the reconnect path; without it a lost link goes straight
    to the fallback (in-process pipes cannot be redialed).  ``fallback``:
    an object with the same ``act``/``initial_state`` facade (typically the
    local agent) used when the server is unreachable or sheds.
    """

    def __init__(
        self,
        conn: Optional[Connection] = None,
        connect: Optional[Callable[[], Connection]] = None,
        fallback: Any = None,
        request_timeout_s: float = 30.0,
        max_reconnects: int = 5,
        reconnect_backoff_s: float = 0.2,
        reconnect_backoff_cap_s: float = 2.0,
        max_attempts: int = 8,
        reprobe_backoff_s: float = 0.5,
        reprobe_backoff_cap_s: float = 30.0,
        reprobe_jitter: bool = False,
        reprobe_rng: Any = None,
    ) -> None:
        """``reprobe_backoff_s``/``reprobe_backoff_cap_s``: the capped
        schedule on which a fallen-back client redials the server
        (``reprobe_backoff_s <= 0`` disables re-probing — the pre-fix
        latch).  ``reprobe_jitter`` opts the schedule into decorrelated
        jitter (``exp_backoff``) so a whole fleet of degraded clients does
        not redial a recovering server in one synchronized storm; default
        off for determinism-pinned tests, ``reprobe_rng`` pins the draw."""
        if conn is None and connect is None:
            raise ValueError("need a connection or a connect factory")
        self._connect = connect
        self._fallback = fallback
        self.request_timeout_s = request_timeout_s
        self.max_reconnects = max_reconnects
        self.reconnect_backoff_s = reconnect_backoff_s
        self.reconnect_backoff_cap_s = reconnect_backoff_cap_s
        self.max_attempts = max_attempts
        self.reprobe_backoff_s = reprobe_backoff_s
        self.reprobe_backoff_cap_s = reprobe_backoff_cap_s
        self.reprobe_jitter = reprobe_jitter
        self._reprobe_rng = reprobe_rng
        self.reprobes_used = 0
        self._next_probe_t = 0.0
        self.reconnects_used = 0
        self.fallen_back = False
        self.generation = 0  # newest param generation seen in a reply
        self._ids = itertools.count(1)
        self._send_lock = threading.Lock()
        self._link_lock = threading.Lock()
        self._link_epoch = 0
        self._waiters: Dict[int, PendingReply] = {}
        self._waiters_lock = threading.Lock()
        self._closed = threading.Event()
        self._reg = telemetry.get_registry()
        self._conn = conn if conn is not None else connect()
        self._reader = self._start_reader()

    # -- link plumbing --------------------------------------------------
    def _start_reader(self) -> threading.Thread:
        t = threading.Thread(
            target=self._read_loop,
            args=(self._conn, self._link_epoch),
            name="serve-client-reader",
            daemon=True,
        )
        t.start()
        return t

    def _read_loop(self, conn: Connection, epoch: int) -> None:
        while not self._closed.is_set():
            try:
                msg = conn.recv(timeout=0.2)
            except TimeoutError:
                continue
            except (ConnectionError, EOFError, OSError, ValueError):
                # includes ProtocolError (a chaos bit-flip on the downlink):
                # the stream is desynchronized, fail every in-flight waiter
                # so their attempt loops redial and resend
                self._fail_waiters(epoch)
                return
            if is_heartbeat(msg):
                if isinstance(msg, dict) and msg.get("kind") == "ping":
                    try:
                        with self._send_lock:
                            conn.send(make_pong(msg))
                    except (ConnectionError, OSError):
                        self._fail_waiters(epoch)
                        return
                continue
            if not isinstance(msg, dict):
                continue
            waiter = None
            with self._waiters_lock:
                waiter = self._waiters.pop(msg.get("req"), None)
            if waiter is not None:
                waiter.deliver(msg)
            # replies for abandoned requests (a retried act whose original
            # answer arrived late) are dropped here — harmless duplicates

    def _fail_waiters(self, epoch: int) -> None:
        with self._waiters_lock:
            waiters, self._waiters = dict(self._waiters), {}
        for w in waiters.values():
            if w.link_epoch <= epoch:
                w.deliver(None)

    def _revive_link(self, seen_epoch: int, why: BaseException) -> None:
        """Replace a dead link (one winner; racers adopt the result).

        Exhausted budget or no factory -> flip to the local fallback when
        one exists, else raise :class:`ServingUnavailable`.
        """
        with self._link_lock:
            if self._closed.is_set():
                # shutdown, not failure: callers route to the fallback
                # without flipping the degraded-mode flag or redialing
                raise ServingUnavailable("client closed")
            if self.fallen_back:
                return
            if self._link_epoch != seen_epoch:
                return  # another thread already revived the link
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — link already broken
                pass
            last: BaseException = why
            while (
                self._connect is not None
                and self.reconnects_used < self.max_reconnects
            ):
                delay = exp_backoff(
                    self.reconnects_used,
                    self.reconnect_backoff_s,
                    self.reconnect_backoff_cap_s,
                )
                self.reconnects_used += 1
                self._reg.counter("serving_client.reconnects").inc()
                telemetry.record_event(
                    "serving_reconnect",
                    attempt=self.reconnects_used,
                    why=repr(why),
                )
                logger.warning(
                    "serving client: link lost (%r); redialing in %.2fs "
                    "(attempt %d/%d)",
                    why, delay, self.reconnects_used, self.max_reconnects,
                )
                time.sleep(delay)
                try:
                    self._conn = self._connect()
                    self._link_epoch += 1
                    self._reader = self._start_reader()
                    return
                except (ConnectionError, OSError) as e:
                    last = e
            if self._fallback is not None:
                self.fallen_back = True
                self._schedule_reprobe()
                self._reg.counter("serving_client.fallbacks").inc()
                telemetry.record_event("serving_fallback", why=repr(last))
                logger.error(
                    "serving client: server unreachable (%r); falling back "
                    "to LOCAL inference", last,
                )
                return
            raise ServingUnavailable(
                f"inference server unreachable after "
                f"{self.reconnects_used} reconnect attempts"
            ) from last

    def _schedule_reprobe(self) -> None:
        """Arm the next degraded-mode redial on the capped schedule."""
        if self.reprobe_backoff_s <= 0 or self._connect is None:
            self._next_probe_t = float("inf")
            return
        self._next_probe_t = time.monotonic() + exp_backoff(
            self.reprobes_used,
            self.reprobe_backoff_s,
            self.reprobe_backoff_cap_s,
            jitter=self.reprobe_jitter,
            rng=self._reprobe_rng,
        )

    def _maybe_reprobe(self) -> bool:
        """Fallen back + the probe window passed: ONE redial attempt (a
        cheap connect, never a blocking retry loop — the env loop stays on
        the local fallback until a probe lands).  Success re-arms the
        remote path with a fresh reconnect budget; failure re-schedules on
        the capped backoff.  Returns True when remote service resumed."""
        if not self.fallen_back or self._connect is None:
            return False
        if self.reprobe_backoff_s <= 0:
            return False
        if time.monotonic() < self._next_probe_t:
            return False
        with self._link_lock:
            if not self.fallen_back or self._closed.is_set():
                return False
            if time.monotonic() < self._next_probe_t:
                return False  # another thread probed while we waited
            self.reprobes_used += 1
            self._reg.counter("serving_client.reprobes").inc()
            try:
                conn = self._connect()
            except (ConnectionError, OSError) as e:
                self._schedule_reprobe()
                telemetry.record_event(
                    "serving_reprobe", ok=False,
                    attempt=self.reprobes_used, why=repr(e),
                )
                return False
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — old link already dead
                pass
            self._conn = conn
            self._link_epoch += 1
            self._reader = self._start_reader()
            self.fallen_back = False
            self.reconnects_used = 0  # recovered link earns a fresh budget
            self._next_probe_t = 0.0
        telemetry.record_event(
            "serving_reprobe", ok=True, attempt=self.reprobes_used
        )
        logger.info(
            "serving client: re-probe succeeded after %d attempt(s); "
            "resuming REMOTE inference", self.reprobes_used,
        )
        return True

    # -- request plumbing ----------------------------------------------
    def _submit(self, msg: Dict[str, Any]) -> PendingReply:
        req_id = next(self._ids)
        msg["req"] = req_id
        with self._link_lock:
            epoch = self._link_epoch
            conn = self._conn
        waiter = PendingReply(req_id, epoch)
        with self._waiters_lock:
            self._waiters[req_id] = waiter
        try:
            with self._send_lock:
                conn.send(msg)
        except (ConnectionError, OSError) as e:
            with self._waiters_lock:
                self._waiters.pop(req_id, None)
            self._revive_link(epoch, e)
            raise ConnectionError("send failed; link revived or fallen back") from e
        return waiter

    def _rpc(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Send + wait with redial-and-resend; honors shed replies."""
        shed_seen = 0
        for attempt in range(self.max_attempts):
            if self.fallen_back:
                raise ServingUnavailable("client has fallen back to local")
            if self._closed.is_set():
                raise ServingUnavailable("client closed")
            with self._link_lock:
                epoch = self._link_epoch
            waiter = None
            try:
                waiter = self._submit(dict(msg))
                reply = waiter.result(timeout=self.request_timeout_s)
            except (ConnectionError, TimeoutError, OSError) as e:
                if waiter is not None:  # abandoned: drop the demux slot
                    with self._waiters_lock:
                        self._waiters.pop(waiter.req_id, None)
                self._reg.counter("serving_client.retries").inc()
                self._revive_link(epoch, e)
                continue
            if reply.get("shed"):
                # explicit load shed: bounded admission pushed back — yield
                # briefly so the batcher drains, then retry (the fallback
                # covers sustained overload via shed_to_fallback_after)
                shed_seen += 1
                self._reg.counter("serving_client.sheds").inc()
                if self._fallback is not None and shed_seen >= 3:
                    return {"use_fallback": True}
                time.sleep(0.002 * shed_seen)
                continue
            if "error" in reply:
                self._reg.counter("serving_client.errors").inc()
                raise RuntimeError(f"serving error: {reply['error']}")
            # the req-id demux matched, but verify the frame kind too: a
            # stale or mis-routed reply must not be parsed as a result.
            # "act" requests come back as "act_result"; every other RPC
            # echoes its request kind on the reply
            got = reply.get("kind")
            if got is not None and got not in ("act_result", msg.get("kind")):
                self._reg.counter("serving_client.kind_mismatch").inc()
                continue
            return reply
        if self._fallback is not None:
            return {"use_fallback": True}
        raise ServingUnavailable(
            f"no reply after {self.max_attempts} attempts"
        )

    # -- the acting facade ---------------------------------------------
    def initial_state(self, batch_size: int):
        if self.fallen_back:
            self._maybe_reprobe()
        if self.fallen_back and self._fallback is not None:
            return self._fallback.initial_state(batch_size)
        try:
            reply = self._rpc({"kind": "core_init", "batch": int(batch_size)})
        except ServingUnavailable:
            if self._fallback is None:
                raise
            return self._fallback.initial_state(batch_size)
        if reply.get("use_fallback"):
            return self._fallback.initial_state(batch_size)
        return _as_core(reply.get("core"))

    def act_async(self, obs, last_action, reward, done, core_state) -> PendingReply:
        """Fire one act request without waiting (pipelined callers)."""
        return self._submit(self._act_msg(obs, last_action, reward, done,
                                          core_state))

    def _act_msg(self, obs, last_action, reward, done, core_state) -> Dict:
        return {
            "kind": "act",
            "obs": np.asarray(obs),
            "last_action": np.asarray(last_action, np.int32),
            "reward": np.asarray(reward, np.float32),
            "done": np.asarray(done, bool),
            "core": tuple((_host(c), _host(h)) for c, h in core_state),
        }

    def act(self, obs, last_action, reward, done, core_state):
        """Central batched inference with the local facade's signature:
        returns ``(action, logits, new_core)`` as host numpy."""
        if self.fallen_back:
            # degraded mode is not a one-way door: past the probe window,
            # one cheap redial per act decides whether remote resumes
            self._maybe_reprobe()
        if not self.fallen_back:
            self._reg.counter("serving_client.requests").inc()
            # head-sampled request trace: the context rides the act frame
            # (the ``trace`` wire key) so the server's queue-wait/flush
            # spans land in the same trace as this end-to-end span
            span = tracing.start_span("serve.request", kind="serving")
            msg = self._act_msg(obs, last_action, reward, done, core_state)
            tracing.inject(msg, span)
            try:
                reply = self._rpc(msg)
            except ServingUnavailable:
                span.end(outcome="unavailable")
                if self._fallback is None:
                    raise
                reply = {"use_fallback": True}
            if not reply.get("use_fallback"):
                # max-fold: mid-rollout a multi-replica front door serves
                # mixed generations; the client-observed one stays monotonic
                self.generation = max(
                    self.generation, int(reply.get("gen", self.generation))
                )
                span.end(gen=self.generation)
                return (
                    np.asarray(reply["action"]),
                    np.asarray(reply["logits"]),
                    _as_core(reply.get("core")),
                )
            span.end(outcome="fallback")
        # degraded mode: local inference on the fallback policy keeps the
        # env loop alive (the pre-serving topology)
        return self._fallback.act(obs, last_action, reward, done, core_state)

    def close(self) -> None:
        self._closed.set()
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001 — teardown
            pass
        # wake every blocked waiter NOW: the reader may exit via its stop
        # check without ever seeing the closed fd
        self._fail_waiters(self._link_epoch)
