"""Batched inference server: one policy on the card answering thin env shells.

Port of ``scalerl_tpu/serving/server.py``, the SEED-RL inversion of the
actor plane: instead of every actor holding a policy copy, one policy lives
on the learner's device and actors stream observations to it over the
fleet's codec (``fleet/transport.py``).  The server owns:

- a **dynamic batcher** (``batcher.py``): a flush fires at ``max_batch``
  lanes or when the oldest request has waited ``max_wait_s``, padded up a
  bucket ladder so the model sees a few static batch shapes;
- **one copy each way a flush**: the stacked request batch goes to the
  device through ONE :func:`_device_put` (the arrays' bytes packed into one
  pinned buffer, copied without blocking the host) and the outputs come
  back through ONE :func:`_device_get` (actions, logits and the new core
  packed into one float32 tensor).  ``device_puts`` and ``device_gets``
  count them.  The serve step is the model's logits, then a categorical
  draw by the Gumbel-max trick from the server's own ``torch.Generator``
  on its device, seeded from ``ServingConfig.seed``;
- **the sync guard, only where the server runs alone**:
  ``torch.cuda.set_sync_debug_mode`` is process-wide, unlike the JAX
  transfer guard, which is per thread.  Beside a learner and actor threads
  an armed guard would make their sanctioned reads raise, and a read that
  relaxes it would disarm the server mid-flush.  So the guard is off by
  default (the serving trainer) and the copies are counted instead;
  ``guard_warm_flushes=True`` arms it around every flush at a bucket that
  has flushed before, for a server with the card to itself;
- **generation-tagged parameters**: :meth:`push_params` publishes a
  device-side snapshot copy with a monotonic generation
  (``runtime/param_server.py::ParamSnapshotPlane``), and every reply
  carries the generation that served it;
- **bounded admission**: at ``max_pending`` queued requests a new one is
  shed with an immediate reply (``serving.shed_total``).  Every act request
  admitted ends in exactly one reply, counted: answered, shed or an error
  (:meth:`accounting`); :meth:`stop` answers what the batcher still holds
  before it returns (the JAX copy leaves it unanswered);
- **SLO telemetry**: ``serving.latency_s`` (a digest histogram),
  ``serving.batch_occupancy``, ``serving.requests_per_s``, flush and
  request counters, the staleness gauge (:meth:`observe_staleness`), and
  the ``health`` reply the router polls.

Wire protocol (dicts over a ``Connection``):

    client->server  {"kind": "act", "req": r, "obs": [B,...],
                     "last_action": [B], "reward": [B], "done": [B],
                     "core": ((c, h), ...)}
                    {"kind": "core_init", "req": r, "batch": B}
                    {"kind": "health", "req": r}
                    {"kind": "router_hello", "req": r}
    server->client  {"kind": "act_result", "req": r, "action": [B],
                     "logits": [B, A], "core": ((c, h), ...), "gen": g}
                    {"kind": "act_result", "req": r, "shed": True}
                    {"kind": "core_init", "req": r, "core": ...}
"""

from __future__ import annotations

import copy
import queue as queue_mod
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from scalerl_torch.fleet.hub import QueueHub
from scalerl_torch.fleet.transport import (
    Connection,
    SocketConnection,
    accept_connection,
    listen_socket,
)
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.dispatch import _sync_debug_mode, steady_state_guard
from scalerl_torch.runtime.param_server import ParamSnapshotPlane
from scalerl_torch.serving.batcher import (
    DynamicBatcher,
    ServingConfig,
    ServingRequest,
    bucket_for,
)
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# chaos site of accepted socket links: a plan scopes faults to the
# inference plane with SCALERL_CHAOS "sites=serve"
SERVE_CHAOS_SITE = "serve_sock"


def _device_put(arrays: Sequence[np.ndarray], device: torch.device) -> Tuple[torch.Tensor, ...]:
    """ONE host->device copy of a flush's host arrays: their bytes, each
    padded to 4, in one buffer, pinned on a card and copied without blocking
    the host, then cut into typed views on the device.  A module seam:
    tests count the calls here."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += a.nbytes + (-a.nbytes) % 4
    buf = np.empty(total, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    host = torch.from_numpy(buf)
    dev = host.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else host
    return tuple(
        dev[o:o + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
        for a, o in zip(arrays, offsets))


def _device_get(packed: torch.Tensor, relax: bool = False) -> np.ndarray:
    """ONE device->host read of a flush's packed outputs.  ``relax`` lifts
    the server's own armed sync guard for this copy; an unarmed server
    never touches the process-wide mode.  A module seam: tests count the
    calls here."""
    if packed.device.type != "cuda":
        return packed.numpy()
    if not relax:
        return packed.cpu().numpy()
    with _sync_debug_mode("default"):
        return packed.cpu().numpy()


def _pad_lanes(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad a [B, ...] host array up to [bucket, ...]."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    pad = [(0, bucket - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


class InferenceServer(ParamSnapshotPlane):
    """Holds one policy on the agent's device; serves batched act requests.

    ``agent``: a policy-value agent exposing ``.model`` (the uniform
    recurrent signature), ``.device`` and ``.get_weights()`` (the initial
    snapshot).  The server runs its own copy of the model, so its flush
    thread never shares a module with the agent's threads.
    ``guard_warm_flushes``: arm
    ``steady_state_guard()`` around warm flushes (see the module
    docstring: only for a server with the card to itself).
    """

    def __init__(
        self,
        agent,
        config: Optional[ServingConfig] = None,
        hub_maxsize: int = 1024,
        guard_warm_flushes: bool = False,
    ) -> None:
        self.config = config or ServingConfig()
        self.device = torch.device(agent.device)
        self._model = copy.deepcopy(agent.model)
        self.guard_warm_flushes = guard_warm_flushes
        # a recurrent core's per-lane shapes, read once (no device copy): the
        # cold core_init reply is host zeros of these
        self._core_shapes = [tuple(c.shape[1:]) for c, _ in self._model.initial_state(1)]
        self._init_param_plane(agent.get_weights(), self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.batcher = DynamicBatcher(self.config)
        self.hub = QueueHub(
            maxsize=hub_maxsize,
            heartbeat_interval=self.config.heartbeat_interval_s,
            max_pending=self.config.max_pending,
        )
        # a bucket's first flush may synchronise (first allocations, cuDNN's
        # algorithm search); later flushes at that bucket are "warm"
        self._warm_buckets: set = set()
        reg = telemetry.get_registry()
        # digest backend: the SLO quantiles stay honest at any request count
        self._lat_hist = reg.histogram("serving.latency_s", backend="digest")
        self._occ_hist = reg.histogram("serving.batch_occupancy")
        self._req_meter = reg.meter("serving.requests_per_s")
        self._req_counter = reg.counter("serving.requests")
        self._flush_counter = reg.counter("serving.flushes")
        self._stale_gauge = reg.gauge("serving.staleness")
        reg.bind(
            "serving.server",
            lambda: {
                "generation": self.generation,
                "connections": self.hub.connection_count(),
                "warm_buckets": len(self._warm_buckets),
            },
        )
        self.flushes = 0
        self.device_puts = 0
        self.device_gets = 0
        # the act-request ledger: admitted == answered + shed + errors once
        # stopped (each counter is written by one thread only)
        self.admitted = 0
        self.answered = 0
        self.shed = 0
        self.errors = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listen_sock = None

    def observe_staleness(self, served_generation: int) -> float:
        """Learner steps between the newest pushed params and the generation
        that served a transition; sets ``serving.staleness`` and the unified
        ``staleness`` gauge.  The learner calls this as it consumes batches,
        so generation tags on the acting side become a lag on the learning
        side (what V-trace's clipped importance weights absorb)."""
        lag = self.staleness_steps(served_generation)
        self._stale_gauge.set(lag)
        telemetry.observe_staleness(lag, plane="serving")
        return lag

    def slo(self) -> Dict[str, float]:
        """Latency quantiles in milliseconds and the mean batch occupancy."""
        h = self._lat_hist
        occ = self._occ_hist.read()
        return {
            "p50_ms": h.quantile(0.50) * 1e3,
            "p95_ms": h.quantile(0.95) * 1e3,
            "p99_ms": h.quantile(0.99) * 1e3,
            "requests": self._req_counter.value,
            "batch_occupancy_mean": occ["mean"],
        }

    def accounting(self) -> Dict[str, Any]:
        """The act-request ledger and whether it balances (exact once the
        server has stopped; while it runs, requests in the batcher are the
        difference)."""
        out = {"admitted": self.admitted, "answered": self.answered, "shed": self.shed,
               "errors": self.errors, "pending": self.batcher.stats()["pending_requests"]}
        out["balanced"] = out["admitted"] == out["answered"] + out["shed"] + out["errors"]
        return out

    # -- bring-up -------------------------------------------------------
    def start(self, listen_port: Optional[int] = None) -> None:
        self._threads = [
            threading.Thread(target=self._admit_loop, name="serve-admit", daemon=True),
            threading.Thread(target=self._flush_loop, name="serve-flush", daemon=True),
        ]
        if listen_port is not None:
            self._listen_sock = listen_socket(listen_port)
            self._threads.append(threading.Thread(
                target=self._accept_loop, args=(self._listen_sock,),
                name="serve-accept", daemon=True))
        for t in self._threads:
            t.start()

    def add_connection(self, conn: Connection) -> None:
        """Register an in-process or pre-accepted client link."""
        self.hub.add_connection(conn)

    def stop(self) -> None:
        """Stop admitting, answer what the batcher holds, close every link
        and join the threads (each within 3 s); a second call is a
        no-op."""
        self._stop.set()
        self.batcher.close()
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
        self.hub.close()
        for t in self._threads:
            t.join(timeout=3.0)

    def _accept_loop(self, sock) -> None:
        while not self._stop.is_set():
            try:
                conn = accept_connection(sock, timeout=0.5)
            except (TimeoutError, OSError):
                continue
            if isinstance(conn, SocketConnection):
                conn.chaos_site = SERVE_CHAOS_SITE
            self.hub.add_connection(conn)

    # -- admission ------------------------------------------------------
    def _admit_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, msg = self.hub.recv(timeout=0.2)
            except queue_mod.Empty:
                continue
            try:
                self._admit(conn, msg)
            except Exception:  # noqa: BLE001 — a bad request must not kill admission
                logger.exception("serving: failed handling %r",
                                 msg.get("kind") if isinstance(msg, dict) else msg)

    def _admit(self, conn: Connection, msg: Dict[str, Any]) -> None:
        kind = msg.get("kind")
        if kind == "act":
            obs = np.asarray(msg["obs"])
            req = ServingRequest(
                conn=conn,
                req_id=msg.get("req"),
                lanes=int(obs.shape[0]),
                trace=tracing.extract(msg),
                payload={
                    "obs": obs,
                    "last_action": np.asarray(msg["last_action"], np.int32),
                    "reward": np.asarray(msg["reward"], np.float32),
                    "done": np.asarray(msg["done"], bool),
                    "core": msg.get("core") or (),
                },
            )
            self.admitted += 1
            if not self.batcher.submit(req):
                # an explicit shed, answered now, so the client retries or
                # falls back instead of timing out on silence
                self.shed += 1
                self.hub.send(conn, {"kind": "act_result", "req": req.req_id, "shed": True})
        elif kind == "core_init":
            B = int(msg["batch"])
            core = tuple((np.zeros((B,) + s, np.float32), np.zeros((B,) + s, np.float32))
                         for s in self._core_shapes)
            self.hub.send(conn, {"kind": "core_init", "req": msg.get("req"), "core": core})
        elif kind == "health":
            # the router's poll: instruments that already exist, no device
            # traffic, safe at any load
            self.hub.send(conn, self._health_reply(msg))
        elif kind == "router_hello":
            logger.info("serving: router membership announce (%r)", msg.get("req"))
            self.hub.send(conn, {"kind": "router_hello", "req": msg.get("req"),
                                 "gen": self.generation, "host": telemetry.host_id()})
        else:
            logger.warning("serving: unknown message kind %r", kind)

    def _health_reply(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        s = self.slo()
        q = self.batcher.stats()
        return {
            "kind": "health_result",
            "req": msg.get("req"),
            "gen": self.generation,
            "host": telemetry.host_id(),
            "p50_ms": s["p50_ms"],
            "p95_ms": s["p95_ms"],
            "requests": s["requests"],
            "pending": q["pending_requests"],
            "shed_total": q["shed_total"] + self.hub.shed_total,
        }

    # -- the flush loop -------------------------------------------------
    def _flush_loop(self) -> None:
        while True:
            batch = self.batcher.next_batch(poll_s=0.05)
            if batch is None:
                return  # the batcher is closed and drained
            try:
                self._flush(batch)
            except Exception as e:  # noqa: BLE001 — answer, then keep serving
                logger.exception("serving: flush failed")
                for req in batch:
                    self.errors += 1
                    self.hub.send(req.conn, {"kind": "act_result", "req": req.req_id,
                                             "error": repr(e)})

    def _assemble(self, batch: List[ServingRequest], bucket: int) -> Dict[str, Any]:
        """Stack requests into ONE set of [bucket, ...] host arrays (numpy
        only; the single upload happens in :meth:`_flush`)."""
        cat = {k: np.concatenate([r.payload[k] for r in batch], axis=0)
               for k in ("obs", "last_action", "reward", "done")}
        host = {k: _pad_lanes(v, bucket) for k, v in cat.items()}
        cores = [r.payload["core"] for r in batch]
        if cores and len(cores[0]):
            host["core"] = tuple(
                tuple(
                    _pad_lanes(np.concatenate([np.asarray(c[i][j], np.float32) for c in cores],
                                              axis=0), bucket)
                    for j in range(2)
                )
                for i in range(len(cores[0]))
            )
        else:
            host["core"] = ()
        return host

    def _gumbel(self, logits: torch.Tensor) -> torch.Tensor:
        """Gumbel noise for the categorical draw, from the server's
        generator (tests inject the JAX server's draws here)."""
        u = torch.rand(logits.shape, generator=self._generator, device=logits.device,
                       dtype=logits.dtype)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))

    def _serve(self, params, obs, last_action, reward, done, core):
        """The batched acting step: the model's logits over one time step,
        then a categorical draw (``argmax(logits + gumbel)``, as
        ``jax.random.categorical`` draws)."""
        out, new_core = functional_call(
            self._model, params, (obs[None], last_action[None], reward[None], done[None], core))
        logits = out.policy_logits[0]
        action = torch.argmax(logits + self._gumbel(logits), dim=-1)
        return action, logits, new_core

    def _flush(self, batch: List[ServingRequest]) -> None:
        lanes = sum(r.lanes for r in batch)
        bucket = bucket_for(lanes, self.batcher.buckets)
        t_flush0 = time.monotonic()
        host = self._assemble(batch, bucket)
        params, gen = self._snapshot_params()
        armed = self.guard_warm_flushes and bucket in self._warm_buckets
        guard = steady_state_guard() if armed else nullcontext()
        with guard, torch.no_grad():
            flat_core = [a for pair in host["core"] for a in pair]
            dev = _device_put([host["obs"], host["last_action"], host["reward"],
                               host["done"], *flat_core], self.device)
            self.device_puts += 1
            core = tuple((dev[4 + 2 * i], dev[5 + 2 * i]) for i in range(len(host["core"])))
            action, logits, new_core = self._serve(params, *dev[:4], core)
            packed = torch.cat([action[:, None].float(), logits.float(),
                                *(t.float() for pair in new_core for t in pair)], dim=1)
            out = _device_get(packed, relax=armed)
            self.device_gets += 1
        self._warm_buckets.add(bucket)
        self.flushes += 1
        self._flush_counter.inc()
        self._occ_hist.observe(lanes / max(bucket, 1))
        A = logits.shape[-1]
        widths = [t.shape[-1] for pair in new_core for t in pair]
        host_core, offset = [], 1 + A
        for w_c, w_h in zip(widths[0::2], widths[1::2]):
            host_core.append((out[:, offset:offset + w_c], out[:, offset + w_c:offset + w_c + w_h]))
            offset += w_c + w_h
        self._reply(batch, (out[:, 0].astype(np.int32), out[:, 1:1 + A], host_core), gen,
                    t_flush0, bucket)

    def _reply(self, batch: List[ServingRequest], out, gen: int, t_flush0: float = 0.0,
               bucket: int = 0) -> None:
        """Demux the flushed [bucket, ...] outputs back to per-request
        slices, each tagged with the generation that served it (a push
        during the flush bumps ``self.generation``, never this tag)."""
        host_action, host_logits, host_core = out
        offset = 0
        now = time.monotonic()
        for req in batch:
            sl = slice(offset, offset + req.lanes)
            offset += req.lanes
            self._lat_hist.observe(max(now - req.t_enqueue, 0.0))
            self.answered += 1
            self._req_counter.inc()
            self._req_meter.mark()
            if req.trace is not None:
                # lifecycle edges off stamps the flush already took: the
                # batcher dwell, then the assemble + device round trip
                tracing.record_span("serve.queue_wait", parent=req.trace,
                                    t_start=req.t_enqueue, t_end=t_flush0, kind="serving")
                tracing.record_span("serve.flush", parent=req.trace, t_start=t_flush0,
                                    t_end=now, kind="serving", lanes=req.lanes,
                                    bucket=bucket, gen=gen)
            self.hub.send(req.conn, {
                "kind": "act_result",
                "req": req.req_id,
                "action": host_action[sl].copy(),
                "logits": host_logits[sl].copy(),
                "core": tuple((c[sl].copy(), h[sl].copy()) for c, h in host_core),
                "gen": gen,
            })
