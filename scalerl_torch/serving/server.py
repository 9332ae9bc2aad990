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
  the ``health`` reply the router polls;
- **the learner's mp layout**: beside a learner whose mesh has ``mp > 1``
  the server takes the learner's per-leaf specs (the params of
  ``ParallelLearnFn.state_sharding``, the twin of the JAX
  ``_live_param_shardings``) and holds only the rank's shards of the
  served params, on every push: the live state's local shards, or a rank's
  cut of whole host weights, with no collective.  The ranks of one mp
  group then flush in lockstep on shards.  At each tick every rank offers
  what its own batcher would admit now (:meth:`DynamicBatcher.ready`, by
  its own deadline), packed into rows on the host first, with its
  snapshot's generation, the observations' spec, a stop flag and whether
  its batch failed to pack; the group all-gathers the offers, and every
  rank reads the same verdict from them.  Nothing offered, or generations
  apart (a push between two ranks' reads): each waits a poll and offers
  again.  Specs apart: every rank answers its batch with an error.  Else
  each rank takes its own offer (``take``; a rank whose batch failed to
  pack answers it with the error and pools none), the group pools its rows
  in rank order, pads them to the bucket of the pooled lanes and runs the
  policy on its shards (``parallel/train_step.py::make_pooled_act_fn``);
  every rank draws the Gumbel noise over the whole pooled bucket from its
  ``config.seed`` generator, so the ranks' actions agree, and replies to
  its own requests only.  A request that no offer could carry (an
  observation dtype outside ``_OBS_DTYPES``, more than ``_OBS_DIMS`` dims a
  lane) is refused at admission, before any collective.  A stop on any
  rank ends the group's loop on the same tick, after one last flush of
  what every rank holds.  A failure inside the pooled flush's collectives
  or the policy on shards leaves the group out of step: that rank answers
  its batch with the error and leaves the loop, and a peer left in a
  collective fails after ``_GROUP_TIMEOUT_S`` and leaves too.  These
  collectives run on process groups of the server's own
  (``parallel/mesh.py::with_own_groups``), built at construction on every
  rank in the same order, so the flush thread never shares a group with
  the learner thread, and no twin of the JAX ``dispatch_guard`` serialises
  the two.  That holds with gloo, where it was run (two ranks on one
  card); with nccl, two threads on each rank launching on two
  communicators in an order that differs between ranks might deadlock on
  the device, and that is unverified until two cards run it.

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


# what the ranks of a lockstep flush offer each other a tick: requests,
# lanes, a stop flag, the snapshot's generation, whether the rank's batch
# failed to pack, and the observations' dtype (an index into _OBS_DTYPES, -1
# with no lanes), number of dims a lane and per-lane shape (up to _OBS_DIMS
# dims, -1 past its end), which a rank with no request of its own pools
# zeros of
_OBS_DTYPES = (np.float32, np.uint8, np.float64, np.float16, np.int32, np.int64, np.bool_)
_OBS_DIMS = 4
_NO_SPEC = (-1, 0) + (-1,) * _OBS_DIMS
# the wait between two ticks at which nothing was offered
_GROUP_POLL_S = 0.002
# how long a rank waits in a collective of the server's groups for its
# peers (a peer whose flush failed inside the pooled section never comes)
_GROUP_TIMEOUT_S = 300.0


def _obs_spec(dtype, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The offer's encoding of observations of ``dtype`` and per-lane
    ``shape``; ValueError where a lockstep flush cannot carry them."""
    codes = [np.dtype(d) for d in _OBS_DTYPES]
    if np.dtype(dtype) not in codes:
        raise ValueError(f"a lockstep flush pools observations of dtypes "
                         f"{[c.name for c in codes]}, not {np.dtype(dtype).name}")
    if len(shape) > _OBS_DIMS:
        raise ValueError(f"a lockstep flush pools observations of at most {_OBS_DIMS} "
                         f"dims a lane, got {tuple(shape)}")
    return (codes.index(np.dtype(dtype)), len(shape)) + tuple(shape) + (-1,) * (
        _OBS_DIMS - len(shape))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _pack_rows(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """``[n, ...]`` host arrays -> one ``[n, S]`` uint8 array, lane-major:
    each lane's bytes of every array, each padded to 4 (so lanes can be
    pooled and picked out as rows)."""
    n = arrays[0].shape[0]
    widths = [a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64)) for a in arrays]
    buf = np.zeros((n, sum(w + (-w) % 4 for w in widths)), np.uint8)
    offset = 0
    for a, w in zip(arrays, widths):
        buf[:, offset:offset + w] = np.ascontiguousarray(a).reshape(n, -1).view(np.uint8)
        offset += w + (-w) % 4
    return buf


def _unpack_rows(rows: torch.Tensor, layout) -> List[torch.Tensor]:
    """The typed ``[N, ...]`` tensors of :func:`_pack_rows`'s ``[N, S]``
    rows, ``layout`` the arrays' ``(dtype, per-lane shape)``."""
    out, offset = [], 0
    for dtype, shape in layout:
        w = np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64))
        out.append(rows[:, offset:offset + w].contiguous().view(_torch_dtype(dtype))
                   .reshape((rows.shape[0],) + tuple(shape)))
        offset += w + (-w) % 4
    return out


def _row_width(layout) -> int:
    """The bytes of one :func:`_pack_rows` row of arrays of ``layout``."""
    widths = [np.dtype(d).itemsize * int(np.prod(s, dtype=np.int64)) for d, s in layout]
    return sum(w + (-w) % 4 for w in widths)


def _live_param_specs(agent) -> Optional[Dict[str, Any]]:
    """The learner's per-leaf param specs (by param name) when the agent
    trains on a mesh of several ranks with ``mp > 1``: the params of its
    ``ParallelLearnFn.state_sharding``.  None otherwise, so a server beside
    an unmeshed or pure-dp learner holds the whole policy as before."""
    mesh = getattr(agent, "mesh", None)
    if mesh is None or mesh.device_mesh is None or mesh.shape.get("mp", 1) <= 1:
        return None
    return getattr(getattr(getattr(agent, "_learn", None), "state_sharding", None), "params", None)


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
    Beside a learner whose mesh has ``mp > 1`` the server holds the rank's
    shards in the learner's layout and flushes in lockstep with the other
    ranks of its mp group; it is then built at the same point on every rank
    (it makes process groups), and pushes go to every rank of the group in
    the same order.
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
        self._param_specs = _live_param_specs(agent)
        self.mesh = None
        self._act = None
        params = agent.get_weights()
        if self._param_specs is not None:
            import datetime

            from scalerl_torch.parallel.mesh import with_own_groups
            from scalerl_torch.parallel.train_step import make_pooled_act_fn

            specs = self._param_specs
            self.mesh = with_own_groups(agent.mesh,
                                        timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))
            self._full_shapes = {k: tuple(v.shape) for k, v in params.items()}
            self._act = make_pooled_act_fn(self._serve_rows, self.mesh, params,
                                           param_specs=lambda path, x: specs.get(path[-1], ()),
                                           modules=(self._model,))
            (axis,) = self._act.axes
            self._pool_group = self.mesh.group(axis)
            self._pool_size = self.mesh.shape[axis]
            # a quantized push scales a sharded leaf by the whole leaf's max:
            # one all-reduce on the LEARNER's groups, from the pushing thread
            self._shard_ctx = getattr(agent._learn, "shard_ctx", None)
            # the live state's shards: no gather
            params = agent.state.params
        self._init_param_plane(self._local_params(params), self.device)
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
        # act requests refused at admission, answered with an error and
        # never admitted (observations a lockstep flush cannot carry)
        self.refused = 0
        # the failure that put a lockstep group out of step, if any
        self.group_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listen_sock = None

    def _local_params(self, params):
        """The rank's shards of pushed params under the learner's mp layout:
        a DTensor leaf (the live state) gives its local shard, a whole
        tensor or numpy leaf (host weights, a restored checkpoint) its cut;
        neither issues a collective.  Unmeshed, the params as they are."""
        if self._act is None:
            return params
        from torch.distributed.tensor import DTensor

        full = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if not isinstance(v, DTensor) and tuple(v.shape) != self._full_shapes[k]:
                raise ValueError(f"push {k!r} whole ({self._full_shapes[k]}) or as the learner's "
                                 f"sharded state, not of shape {tuple(v.shape)}")
            full[k] = v
        return self._act.local_params(full)

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
            if self._act is not None:
                try:
                    _obs_spec(obs.dtype, tuple(obs.shape[1:]))
                except ValueError as e:
                    self.refused += 1
                    self.hub.send(conn, {"kind": "act_result", "req": msg.get("req"),
                                         "error": repr(e)})
                    return
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
        if self._act is not None:
            self._group_flush_loop()
            return
        while True:
            batch = self.batcher.next_batch(poll_s=0.05)
            if batch is None:
                return  # the batcher is closed and drained
            try:
                self._flush(batch)
            except Exception as e:  # noqa: BLE001 — answer, then keep serving
                logger.exception("serving: flush failed")
                self._answer_errors(batch, e)

    def _answer_errors(self, batch: List[ServingRequest], e: BaseException) -> None:
        for req in batch:
            self.errors += 1
            self.hub.send(req.conn, {"kind": "act_result", "req": req.req_id, "error": repr(e)})

    def _prepare(self, batch: List[ServingRequest]):
        """This rank's offered lanes packed into ``[lanes, S]`` host rows
        (:func:`_pack_rows`) and their observation spec, or the error that
        kept them from packing: all of it before any collective, so a bad
        batch on one rank cannot leave its peers waiting."""
        if not batch:
            return None, _NO_SPEC, None
        try:
            host = self._assemble(batch, sum(r.lanes for r in batch))
            arrays = [host["obs"], host["last_action"], host["reward"], host["done"],
                      *(a for pair in host["core"] for a in pair)]
            spec = _obs_spec(arrays[0].dtype, arrays[0].shape[1:])
            if [(a.dtype, a.shape[1:]) for a in arrays] != self._lane_layout(spec):
                raise ValueError("the lanes' arrays do not match the policy's: "
                                 f"{[(a.dtype.name, a.shape) for a in arrays]}")
            return _pack_rows(arrays), spec, None
        except Exception as e:  # noqa: BLE001 — answered after the offer
            return None, _NO_SPEC, e

    def _lane_layout(self, spec: Tuple[int, ...]) -> List[Tuple[np.dtype, Tuple[int, ...]]]:
        """The ``(dtype, per-lane shape)`` of each packed array: the
        observations of ``spec``, last actions, rewards, done flags, then
        the core's (c, h) pairs."""
        code, ndim = spec[:2]
        obs = (np.dtype(_OBS_DTYPES[code]), tuple(spec[2:2 + ndim]))
        core = [(np.dtype(np.float32), s) for s in self._core_shapes for _ in range(2)]
        return [obs, (np.dtype(np.int32), ()), (np.dtype(np.float32), ()),
                (np.dtype(np.bool_), ()), *core]

    def _offer(self, n: int, lanes: int, stop: bool, gen: int, spec: Tuple[int, ...],
               fault: bool) -> List[List[int]]:
        """This rank's offer, all-gathered over its mp group (one int64
        all-gather on the server's own group): a row a rank, in group
        order, ``[requests, lanes, stop, generation, fault, *spec]``."""
        import torch.distributed as dist

        mine = torch.tensor([n, lanes, int(stop), gen, int(fault), *spec], dtype=torch.int64,
                            device=self.mesh.device_type)
        parts = [torch.empty_like(mine) for _ in range(self._pool_size)]
        dist.all_gather(parts, mine, group=self._pool_group)
        return torch.stack(parts).tolist()

    def _group_flush_loop(self) -> None:
        """The lockstep flush of an mp group (module docstring): a tick at a
        time until a stop, a failed pooled flush, or the stop's last tick."""
        last = False
        while True:
            verdict = self._tick(self.batcher.ready(), last)
            if verdict == "stop":
                # a stop on any rank: admit nothing more here, flush what
                # every rank holds on one last tick, and leave together
                self.batcher.close()
                last = True
            elif verdict == "failed" or last:
                break
            elif verdict == "idle":
                self._stop.wait(_GROUP_POLL_S)
        # what the group leaves behind: a stop's last tick with generations
        # apart, or a failed pooled flush
        self.batcher.close()
        self._answer_errors(self.batcher.take(len(self.batcher.ready())),
                            RuntimeError("serving group stopped"))

    def _tick(self, offered: List[ServingRequest], last: bool = False) -> str:
        """One offer of ``offered`` (the oldest pending requests), then the
        verdict every rank reads from the offers alike: ``"stop"`` (a rank
        stops; nothing taken), ``"idle"`` (nothing offered, or generations
        apart), ``"failed"`` (the pooled section failed here), else
        ``"flushed"``: each rank took its offer and answered it, by a pooled
        flush or with an error."""
        params, gen = self._snapshot_params()
        packed, spec, fault = self._prepare(offered)
        offers = self._offer(len(offered), sum(r.lanes for r in offered),
                             last or self._stop.is_set(), gen, spec, fault is not None)
        if not last and any(o[2] for o in offers):
            return "stop"
        if not any(o[1] for o in offers) or len({o[3] for o in offers}) > 1:
            return "idle"
        batch = self.batcher.take(len(offered))
        if fault is not None:
            self._answer_errors(batch, fault)
            batch, packed = [], None
        counts = [0 if o[4] else o[1] for o in offers]
        specs = sorted({tuple(o[5:]) for o in offers if o[1] and not o[4]})
        if len(specs) > 1:
            self._answer_errors(batch, ValueError(
                "the ranks of a lockstep flush hold observations of different specs "
                f"(dtype code, dims, shape): {specs}"))
        elif specs and not self._flush_pooled(batch, packed, counts, specs[0], params, gen):
            return "failed"
        return "flushed"

    def _serve_rows(self, params, rows: torch.Tensor, layout):
        """:meth:`_serve` on a pooled ``[bucket, S]`` batch of packed lanes."""
        obs, last_action, reward, done, *flat_core = _unpack_rows(rows, layout)
        core = tuple(zip(flat_core[0::2], flat_core[1::2]))
        return self._serve(params, obs, last_action, reward, done, core)

    def _flush_pooled(self, batch: List[ServingRequest], packed: Optional[np.ndarray],
                      counts: List[int], spec: Tuple[int, ...], params, gen: int) -> bool:
        """One lockstep flush: the group's lanes pooled in rank order and
        padded to the bucket of the pooled lanes, the policy on the rank's
        shards, replies to this rank's own requests.  False when the pooled
        section (its collectives and the policy on shards) failed here: the
        group is out of step, and the loop ends."""
        lanes = sum(counts)
        bucket = bucket_for(lanes, self.batcher.buckets)
        t_flush0 = time.monotonic()
        layout = self._lane_layout(spec)
        if packed is None:  # no lanes of this rank's own
            packed = np.zeros((0, _row_width(layout)), np.uint8)
        try:
            with torch.no_grad():
                (rows,) = _device_put([_pad_lanes(packed, max(counts))], self.device)
                self.device_puts += 1
                action, logits, new_core = self._act(params, rows, counts, bucket, layout)
        except Exception as e:  # noqa: BLE001 — answered; the peers time out
            logger.exception("serving: pooled flush failed; the lockstep group stops")
            self.group_error = e
            self._answer_errors(batch, e)
            return False
        try:
            out = self._fetch(action, logits, new_core, False)
            self._finish(batch, out, gen, t_flush0, bucket, lanes)
        except Exception as e:  # noqa: BLE001 — answer, then keep serving
            logger.exception("serving: pooled flush failed")
            self._answer_errors(batch, e)
        return True

    def _fetch(self, action, logits, new_core, relax: bool):
        """ONE device->host read of a flush's outputs: ``(actions, logits,
        [(c, h), ...])`` as host arrays."""
        packed = torch.cat([action[:, None].float(), logits.float(),
                            *(t.float() for pair in new_core for t in pair)], dim=1)
        out = _device_get(packed, relax=relax)
        self.device_gets += 1
        A = logits.shape[-1]
        widths = [t.shape[-1] for pair in new_core for t in pair]
        host_core, offset = [], 1 + A
        for w_c, w_h in zip(widths[0::2], widths[1::2]):
            host_core.append((out[:, offset:offset + w_c], out[:, offset + w_c:offset + w_c + w_h]))
            offset += w_c + w_h
        return out[:, 0].astype(np.int32), out[:, 1:1 + A], host_core

    def _finish(self, batch, out, gen: int, t_flush0: float, bucket: int, lanes: int) -> None:
        self._warm_buckets.add(bucket)
        self.flushes += 1
        self._flush_counter.inc()
        self._occ_hist.observe(lanes / max(bucket, 1))
        self._reply(batch, out, gen, t_flush0, bucket)

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
            out = self._fetch(action, logits, new_core, armed)
        self._finish(batch, out, gen, t_flush0, bucket, lanes)

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
