"""Disaggregated sequence-RL dataflow: generation fleet -> learner.

Port of ``scalerl_tpu/genrl/disagg.py``.  Generation and training want
different hardware shapes and scale as separate tiers (MindSpeed RL,
PAPERS.md): N generation hosts each run an engine behind a
:class:`GenerationHost` shell and stream completed, generation-tagged
sequences over the codec-v2 fleet wire into the learner's sequence replay,
while param snapshots flow back as quantized generation-tagged pushes.

Wire protocol (dicts over ``fleet.transport.Connection``, codec v2 — the
CRC / ``ProtocolError``-drops-the-link semantics of the data plane apply
as-is):

    host→learner    {"kind": "gen_hello", "host_id": h, "host_epoch": e,
                     "lanes": n}           membership announce (on connect
                                           AND after every reconnect)
                    {"kind": "lease", "n": k, "have_gen": g}
                                           request k prompt leases; the
                                           reply piggybacks the newest
                                           snapshot generation
                    {"kind": "params", "have": g}
                                           fetch the quantized snapshot if
                                           stale
                    {"kind": "seq_batch", "v": [seq...], "seq": s}
                                           completed sequence chunks,
                                           RETAINED by the host until acked
                    {"kind": "lease_return", "v": [lease...]}
                                           unstarted/abandoned leases handed
                                           back (drain, or give-up) for
                                           reissue — no prompt is lost
                    {"kind": "drain_done", "host_id": h}
    learner→host    {"kind": "gen_welcome", "epoch": e, "gen": g}
                                           hello reply: the LEARNER epoch
                                           (bumped on every ledger resume)
                                           and the current snapshot
                                           generation a (re)joining host
                                           must adopt before admitting work
                    {"kind": "lease", "v": [lease...], "gen": g, "epoch": e}
                                           lease None = prompt source done
                    {"kind": "params", "generation": g, "weights": tree,
                     "epoch": e}
                                           int8-quantized wire snapshot
                                           (``quantize_wire_tree``)
                    {"kind": "seq_ack", "seq": s}
                    {"kind": "drain"}      stop admitting prompts, finish
                                           (or return) live lanes, flush +
                                           await acks, exit 0

Robustness is the fleet's machinery (``fleet/cluster.py``) applied at
sequence granularity:

- every completed sequence carries the at-least-once dedup key
  ``(host_id, host_epoch, seq_id)`` — un-acked uploads are resent after a
  reconnect and absorbed by the learner's bounded per-host epoch table;
- every prompt lease is stamped with a monotonic ``_task_id`` tracked per
  link: a host killed mid-decode has its in-flight leases requeued for the
  surviving/backfilled fleet, and a racing duplicate completion (the corpse
  finished it too) counts exactly once (``disagg.duplicate_leases``);
- the drain protocol extends the fleet's: a draining generation host stops
  admitting prompts, finishes (or returns) its live lanes, flushes and
  awaits acks, then exits 0 — zero sequences lost to a deliberate
  scale-down;
- ``mass_kill`` chaos waves ride :func:`fleet.cluster.apply_mass_kill`
  under the ``disagg`` site, and the autoscaler's floor rule backfills
  through :class:`GenerationTierExecutor`;
- the learner itself is preemptible: a SIGTERM'd learner saves its whole
  accounting plane (lease table, dedup keys, accepted-but-unconsumed
  sequences, snapshot generation) into a durable ledger
  (``genrl/ledger.py``) and a restart resumes it under a bumped **learner
  epoch** — hosts park in-flight work, redial with capped backoff, and the
  ``gen_welcome`` handshake re-synchronizes epoch + snapshot generation so
  pre-restart uploads dedup exactly.

The shells, the learner endpoint and the scripted engine are host-side
numpy; real engines arrive through a picklable ``engine_factory``, and only
that callable touches the card.  A real engine's shell turns each wire
snapshot into tensors on the engine's device in ONE batched upload
(:func:`upload_wire_params`), or raises; only scripted shells take numpy.
Spawned hosts run scripted engines and never initialise CUDA.

What differs from the JAX module: a thread host whose link drops while its
fleet is closing gives up at once (the fleet's reconnect seam raises
:class:`FleetClosed`) instead of spending its whole backoff budget, so
:meth:`LocalGenerationFleet.join` ends thread hosts within its deadline.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from scalerl_torch.fleet.hub import QueueHub
from scalerl_torch.fleet.transport import Connection, PipeConnection
from scalerl_torch.genrl import ledger as ledger_store
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.autoscaler import FleetSignals
from scalerl_torch.runtime.param_server import ParamSnapshotPlane
from scalerl_torch.runtime.supervisor import (
    DRAIN,
    DRAIN_DONE,
    exp_backoff,
    is_heartbeat,
    make_drain,
    make_pong,
)
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

class FleetClosed(ConnectionError):
    """Raised by a fleet's reconnect seam once the fleet is shutting down:
    the host stops redialing and exits."""


# EngineFactory: (host params (dequantized wire tree), wire generation) ->
# an engine shell (see ScriptedSequenceEngine for the duck-typed surface).
# Must be picklable (module-level class/function) for spawn-mode fleets.
EngineFactory = Callable[[Any, int], Any]


# ---------------------------------------------------------------------------
# wire snapshot format: host-side quantization (the numpy twin of
# runtime/quantize.py, so shells decode it without touching the card)

WIRE_QUANT_MODES = ("int8", "none")
_QKEY = "__q__"


def _native_float(arr: np.ndarray) -> np.ndarray:
    """Non-native float dtypes widen to float32 for the wire: the codec
    only frames native numpy dtypes."""
    if arr.dtype.kind not in "fiub?":
        return arr.astype(np.float32)
    return arr


def quantize_wire_tree(tree: Any, mode: str) -> Any:
    """Compress a HOST weight pytree for the snapshot wire.

    ``"int8"`` mirrors ``runtime/quantize.py``'s semantics in numpy: per
    leaf symmetric quantization (one f32 scale = max|x| / 127) for float
    leaves with ``ndim >= 2``; 1-D f32-sensitive leaves (biases, norms)
    pass through untouched.  ``"none"`` passes every leaf through (still
    normalizing non-native float dtypes).  The output is a plain
    dict/list/tuple/ndarray pytree the codec frames as-is.
    """
    if mode not in WIRE_QUANT_MODES:
        raise ValueError(
            f"wire quantize mode must be one of {WIRE_QUANT_MODES}, got "
            f"{mode!r}"
        )

    def enc(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: enc(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(enc(v) for v in node)
        if isinstance(node, np.ndarray) or np.isscalar(node) or hasattr(
            node, "dtype"
        ):
            arr = _native_float(np.asarray(node))
            if (
                mode == "int8"
                and arr.ndim >= 2
                and np.issubdtype(arr.dtype, np.floating)
            ):
                amax = float(np.max(np.abs(arr.astype(np.float32))))
                scale = max(amax / 127.0, 1e-12)
                q = np.clip(
                    np.round(arr.astype(np.float32) / scale), -127, 127
                ).astype(np.int8)
                return {
                    _QKEY: 1,
                    "q": q,
                    "scale": float(scale),
                    "dtype": arr.dtype.name,
                }
            return arr
        return node

    return enc(tree)


def dequantize_wire_tree(tree: Any) -> Any:
    """Reconstruct a :func:`quantize_wire_tree` snapshot (original numpy
    dtypes; lossless for passthrough leaves)."""

    def dec(node: Any) -> Any:
        if isinstance(node, dict):
            if node.get(_QKEY) == 1:
                return (
                    node["q"].astype(np.float32) * np.float32(node["scale"])
                ).astype(np.dtype(node["dtype"]))
            return {k: dec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(dec(v) for v in node)
        return node

    return dec(tree)


def wire_tree_bytes(tree: Any) -> int:
    """Snapshot payload size in bytes — the broadcast-bandwidth number the
    int8 wire format exists to shrink."""
    total = 0

    def walk(node: Any) -> None:
        nonlocal total
        if isinstance(node, dict):
            if node.get(_QKEY) == 1:
                total += node["q"].nbytes + 4
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, np.ndarray):
            total += node.nbytes

    walk(tree)
    return total


# ---------------------------------------------------------------------------
# config


@dataclass
class DisaggConfig:
    """Knobs for the disaggregated dataflow (both tiers adopt the
    learner's copy — the generation-host processes receive it at spawn)."""

    num_hosts: int = 2
    lanes_per_host: int = 4          # engine shell admission capacity
    lease_prefetch: int = 0          # leases fetched per RPC; 0 -> lanes + 1
    upload_batch: int = 4            # completed sequences per uplink frame
    compress_uplink: bool = True
    heartbeat_interval_s: float = 5.0
    heartbeat_timeout_s: float = 0.0
    max_pending: int = 0             # learner hub bounded admission
    seq_maxsize: int = 4096          # learner-side accepted-sequence queue
    snapshot_quantize: str = "int8"  # int8 | none (wire snapshot format)
    # a draining host may spend this many engine steps finishing live
    # lanes before abandoning the rest back to the learner for reissue
    drain_step_budget: int = 2000
    ack_timeout_s: float = 30.0      # drain/exit wait for retained uploads
    # learner-loss recovery: a host that loses its uplink parks in-flight
    # work and redials with capped exponential backoff before giving up
    reconnect_backoff_s: float = 0.05
    reconnect_backoff_cap_s: float = 2.0
    reconnect_max_tries: int = 40

    @property
    def heartbeat_timeout(self) -> float:
        return self.heartbeat_timeout_s or 2.0 * self.heartbeat_interval_s

    @property
    def prefetch(self) -> int:
        return self.lease_prefetch or self.lanes_per_host + 1

    def validate(self) -> None:
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if self.lanes_per_host < 1:
            raise ValueError(
                f"lanes_per_host must be >= 1, got {self.lanes_per_host}"
            )
        if self.snapshot_quantize not in WIRE_QUANT_MODES:
            raise ValueError(
                f"snapshot_quantize must be one of {WIRE_QUANT_MODES}, got "
                f"{self.snapshot_quantize!r}"
            )
        if self.upload_batch < 1:
            raise ValueError(
                f"upload_batch must be >= 1, got {self.upload_batch}"
            )
        if self.reconnect_max_tries < 1:
            raise ValueError(
                "reconnect_max_tries must be >= 1, got "
                f"{self.reconnect_max_tries}"
            )


def upload_wire_params(params: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A dequantized wire snapshot (``{name: float32 ndarray}``) as tensors
    on ``device``, in ONE batched host->device copy: the leaves are packed
    into one pinned buffer on a card, copied without blocking the host,
    and split into views.  Raises on anything but a flat dict of float32
    arrays, so a real engine never receives numpy params."""
    if not isinstance(params, Mapping):
        raise TypeError(f"wire snapshot must be a {{name: array}} dict, got {type(params).__name__}")
    names = list(params)
    arrays = []
    for k in names:
        v = params[k]
        if not isinstance(v, np.ndarray) or v.dtype != np.float32:
            raise TypeError(f"wire leaf {k!r} must be a float32 ndarray, got "
                            f"{getattr(v, 'dtype', type(v).__name__)}")
        arrays.append(np.ascontiguousarray(v).reshape(-1))
    flat = torch.from_numpy(np.concatenate(arrays) if arrays else np.zeros(0, np.float32))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    out, offset = {}, 0
    for k in names:
        n = params[k].size
        out[k] = flat[offset:offset + n].view(params[k].shape)
        offset += n
    return out


# ---------------------------------------------------------------------------
# tracing helpers: the sequence lifecycle is ONE trace — root opened by the
# learner at lease issue, every edge a retroactive span off host monotonic
# stamps

# private host-side stamps riding the lease through the engine shells;
# stripped before a payload goes on the wire
_T_SUBMIT = "_t_submit"
_T_RECV = "_t_recv"
# speculative-decode timer mark at submit (cumulative engine draft/verify
# seconds): lets the harvest edge apportion draft vs verify time into
# child spans under seq.decode
_T_SPEC = "_t_spec"


def _inherit_trace(payload: Dict[str, Any], lease: Mapping[str, Any]) -> None:
    """Copy the lease's propagated context (and the submit stamp) onto its
    completion payload, so the host shell can emit the decode edge and the
    learner/trainer can keep extending the same trace."""
    ctx = lease.get(tracing.TRACE_KEY)
    if ctx is not None:
        payload[tracing.TRACE_KEY] = ctx
        t_sub = lease.get(_T_SUBMIT)
        if t_sub is not None:
            payload[_T_SUBMIT] = t_sub
        spec = lease.get(_T_SPEC)
        if spec is not None:
            payload[_T_SPEC] = spec


def record_consumption_trace(
    payloads: List[Dict[str, Any]],
    t_drain: float,
    t_add0: float,
    t_add1: float,
    t_learn0: float,
    t_learn1: float,
    learn_step: int,
) -> int:
    """Extend every traced wire payload with the learner-side edges —
    ``seq.replay_wait`` (accepted-queue dwell), ``seq.seq_add`` (replay
    insert) and ``seq.learn_step`` (the learn step that consumed it).  All
    arguments are ``time.monotonic()`` stamps the caller already took
    around work it already does; returns the number of traces extended.
    Shared by :class:`~scalerl_torch.trainer.sequence_rl.
    DisaggSequenceRLTrainer` and any consumer loop over the learner."""
    n = 0
    for p in payloads:
        ctx = tracing.extract(p)
        if ctx is None:
            continue
        n += 1
        t_q = p.get("_t_q")
        if isinstance(t_q, (int, float)):
            tracing.record_span(
                "seq.replay_wait", parent=ctx, t_start=float(t_q),
                t_end=t_drain, kind="disagg",
            )
        tracing.record_span(
            "seq.seq_add", parent=ctx, t_start=t_add0, t_end=t_add1,
            kind="disagg", step=learn_step,
        )
        tracing.record_span(
            "seq.learn_step", parent=ctx, t_start=t_learn0, t_end=t_learn1,
            kind="disagg", step=learn_step,
        )
    return n


# ---------------------------------------------------------------------------
# engine shells: the duck-typed surface GenerationHost drives
#
#   generation: int                      wire generation currently loaded
#   push_params(params, generation)      adopt a dequantized wire snapshot
#   capacity() -> int                    leases admissible right now
#   submit(lease: dict) -> None          admit one lease
#   step() -> List[dict]                 advance; completed payloads
#   live() -> int                        leases in flight
#   abandon() -> List[dict]              give up in-flight leases (drain)


def scripted_sequence_payload(
    seed: int, response_len: int, vocab: int, generation: int,
    sample: int = 0,
) -> Dict[str, Any]:
    """The deterministic completion a :class:`ScriptedSequenceEngine`
    produces for lease ``seed`` — a pure function of the lease (and the
    ``sample`` index within a fanned-out group), NEVER of the host that
    ran it, so chaos tests can assert bit-exact payloads across kills,
    requeues, and racing duplicate executions."""
    rng = (
        np.random.default_rng(int(seed))
        if sample == 0
        else np.random.default_rng((int(seed), int(sample)))
    )
    n = int(rng.integers(1, 5))
    r = int(rng.integers(1, response_len + 1))
    return {
        "seed": int(seed),
        "prompt": rng.integers(2, vocab, size=n).astype(np.int32),
        "prompt_len": n,
        "response_tokens": rng.integers(2, vocab, size=r).astype(np.int32),
        "behavior_logp": -rng.random(r).astype(np.float32),
        "values": rng.standard_normal(r).astype(np.float32),
        "generation": int(generation),
    }


class ScriptedSequenceEngine:
    """Host-only deterministic engine shell for soaks and chaos tests.

    "Decodes" ``tokens_per_step`` tokens per :meth:`step` per live lease
    (so a preemption wave genuinely lands MID-DECODE), then emits the
    scripted payload — a pure function of the lease seed, host-independent,
    so exact-unique accounting can also verify every byte.
    """

    def __init__(
        self,
        lanes: int = 4,
        response_len: int = 8,
        tokens_per_step: int = 2,
        step_sleep_s: float = 0.0,
        vocab: int = 32,
    ) -> None:
        self.lanes = lanes
        self.response_len = response_len
        self.tokens_per_step = max(int(tokens_per_step), 1)
        self.step_sleep_s = step_sleep_s
        self.vocab = vocab
        self.generation = 0
        self._live: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()

    def push_params(self, params: Any, generation: int) -> None:
        self.generation = int(generation)

    def capacity(self) -> int:
        return self.lanes - len(self._live)

    def live(self) -> int:
        return len(self._live)

    def submit(self, lease: Dict[str, Any]) -> None:
        seed = int(lease.get("seed", 0))
        samples = int(lease.get("samples", 1))
        # a fanned-out lease occupies one scripted lane per sample —
        # every sample is its own deterministic payload, so kills landing
        # between sibling completions still account exactly
        for k in range(samples):
            payload = scripted_sequence_payload(
                seed, self.response_len, self.vocab, self.generation,
                sample=k,
            )
            self._live[(id(lease), k)] = {
                "lease": lease,
                "sample": k,
                "samples": samples,
                "payload": payload,
                "remaining": len(payload["response_tokens"]),
            }

    def step(self) -> List[Dict[str, Any]]:
        if self.step_sleep_s:
            time.sleep(self.step_sleep_s)
        done: List[Dict[str, Any]] = []
        for key in list(self._live):
            entry = self._live[key]
            entry["remaining"] -= self.tokens_per_step
            if entry["remaining"] <= 0:
                payload = dict(entry["payload"])
                tid = entry["lease"].get("_task_id")
                if tid is not None:
                    payload["_task_id"] = tid
                if entry["samples"] > 1:
                    payload["_sample_idx"] = entry["sample"]
                    payload["_samples_total"] = entry["samples"]
                _inherit_trace(payload, entry["lease"])
                done.append(payload)
                del self._live[key]
        return done

    def abandon(self) -> List[Dict[str, Any]]:
        leases: List[Dict[str, Any]] = []
        seen: Set[int] = set()
        for e in self._live.values():
            if id(e["lease"]) not in seen:
                seen.add(id(e["lease"]))
                leases.append(e["lease"])
        self._live.clear()
        return leases


class ScriptedEngineFactory:
    """Picklable factory for spawn-mode fleets (the soak's engine)."""

    def __init__(
        self,
        lanes: int = 4,
        response_len: int = 8,
        tokens_per_step: int = 2,
        step_sleep_s: float = 0.0,
        vocab: int = 32,
    ) -> None:
        self.lanes = lanes
        self.response_len = response_len
        self.tokens_per_step = tokens_per_step
        self.step_sleep_s = step_sleep_s
        self.vocab = vocab

    def __call__(self, params: Any, generation: int) -> ScriptedSequenceEngine:
        eng = ScriptedSequenceEngine(
            lanes=self.lanes,
            response_len=self.response_len,
            tokens_per_step=self.tokens_per_step,
            step_sleep_s=self.step_sleep_s,
            vocab=self.vocab,
        )
        eng.push_params(params, generation)
        return eng


class CohortEngineShell:
    """Drive a fixed-cohort :class:`~scalerl_torch.genrl.engine.
    GenerationEngine` as a disagg shell: buffered leases flush as one
    bucket-pair round per :meth:`step` (the engine's whole-round program),
    and each lease's true-length slice becomes its wire payload.

    The engine's internal generation counter is mapped to the WIRE
    generation the learner published (``push_params`` records the pair),
    so payload tags speak the learner's id space.
    """

    def __init__(
        self, engine: Any, round_batch: int, initial_generation: int = 0
    ) -> None:
        self.engine = engine
        self.round_batch = max(int(round_batch), 1)
        self.generation = int(initial_generation)
        self._pending: List[Dict[str, Any]] = []
        # the engine's internal counter at construction maps to the WIRE
        # generation its construction params carried
        self._gen_map: Dict[int, int] = {
            int(engine.generation): int(initial_generation)
        }

    def push_params(self, params: Any, generation: int) -> None:
        self._gen_map[
            self.engine.push_params(upload_wire_params(params, self.engine.device))
        ] = int(generation)
        while len(self._gen_map) > 64:
            self._gen_map.pop(min(self._gen_map))
        self.generation = int(generation)

    def capacity(self) -> int:
        return self.round_batch - len(self._pending)

    def live(self) -> int:
        return len(self._pending)

    def submit(self, lease: Dict[str, Any]) -> None:
        # a fanned-out lease occupies one cohort lane per sample (the
        # GRPO tiled layout; the prefix-CoW savings live on the
        # continuous engine — here fan-out is a data-layout feature)
        samples = int(lease.get("samples", 1)) if isinstance(
            lease, dict
        ) else 1
        for k in range(samples):
            self._pending.append((lease, k, samples))

    def abandon(self) -> List[Dict[str, Any]]:
        leases: List[Dict[str, Any]] = []
        seen = set()
        for lease, _k, _n in self._pending:
            if id(lease) not in seen:
                seen.add(id(lease))
                leases.append(lease)
        self._pending = []
        return leases

    def step(self) -> List[Dict[str, Any]]:
        if not self._pending:
            return []
        # flush at most one fixed round's worth of lanes; a group whose
        # tail overflows the round rides the next one
        batch = self._pending[: self.round_batch]
        self._pending = self._pending[self.round_batch :]
        lengths = np.ones((self.round_batch,), np.int32)
        for i, (t, _k, _n) in enumerate(batch):
            lengths[i] = int(t["length"])
        L = int(lengths.max())
        # partial rounds pad with inert lanes up to the FIXED round batch
        # (one shape for every round), and the pad lanes' outputs are
        # simply dropped below
        prompts = np.full((self.round_batch, L), 2, np.int32)
        for i, (t, _k, _n) in enumerate(batch):
            prompts[i, : lengths[i]] = np.asarray(
                t["prompt"], np.int32
            )[: lengths[i]]
        result = self.engine.generate(prompts, lengths)
        wire_gen = self._gen_map.get(result.generation, result.generation)
        out = []
        for i, (t, k, n) in enumerate(batch):
            r = max(int(result.response_len[i]), 1)
            payload = {
                "prompt": prompts[i, : lengths[i]].copy(),
                "prompt_len": int(lengths[i]),
                "response_tokens": result.response_tokens[i, :r].copy(),
                "behavior_logp": result.behavior_logp[i, :r].copy(),
                "values": result.values[i, :r].copy(),
                "generation": int(wire_gen),
            }
            tid = t.get("_task_id")
            if tid is not None:
                payload["_task_id"] = tid
            if n > 1:
                payload["_sample_idx"] = k
                payload["_samples_total"] = n
            _inherit_trace(payload, t)
            out.append(payload)
        return out


class ContinuousEngineShell:
    """Drive a :class:`~scalerl_torch.genrl.continuous.ContinuousEngine` as
    a disagg shell: leases ride the engine's admission queue with their
    lease id as the lane ``tag``, so out-of-order completions still close
    the lease that admitted them."""

    def __init__(self, engine: Any, initial_generation: int = 0) -> None:
        self.engine = engine
        self.generation = int(initial_generation)
        self._live: Dict[int, Dict[str, Any]] = {}
        self._next = 0
        self._gen_map: Dict[int, int] = {
            int(engine.generation): int(initial_generation)
        }

    def push_params(self, params: Any, generation: int) -> None:
        self._gen_map[
            self.engine.push_params(upload_wire_params(params, self.engine.device))
        ] = int(generation)
        while len(self._gen_map) > 64:
            self._gen_map.pop(min(self._gen_map))
        self.generation = int(generation)

    def capacity(self) -> int:
        return (
            self.engine.config.lanes
            - self.engine.live_lanes
            - self.engine.pending
        )

    def live(self) -> int:
        return len(self._live)

    def spec_timers(self) -> Optional[Tuple[float, float]]:
        """Cumulative (draft_s, verify_s) when the wrapped engine decodes
        speculatively, else None — the host's trace edges use deltas of
        this to attribute draft vs verify time under seq.decode."""
        timers = getattr(self.engine, "spec_timers", None)
        return timers() if timers is not None else None

    def submit(self, lease: Dict[str, Any]) -> None:
        key = self._next
        self._next += 1
        samples = int(lease.get("samples", 1)) if isinstance(
            lease, dict
        ) else 1
        self._live[key] = {"lease": lease, "n": samples, "arrived": 0}
        # a fanned-out lease rides submit_group: the engine admits all
        # n lanes over ONE shared prompt prefix (CoW fork) — the perf
        # half of the GRPO group shape
        self.engine.submit_group(
            np.asarray(lease["prompt"], np.int32),
            samples,
            int(lease["length"]),
            tag=key,
        )

    def abandon(self) -> List[Dict[str, Any]]:
        """Give up leases still in flight (their lanes cannot be evicted
        mid-decode); the learner reissues them, and the eventual straggler
        completion is absorbed by lease-level dedup."""
        leases = [e["lease"] for e in self._live.values()]
        self._live.clear()
        return leases

    def step(self) -> List[Dict[str, Any]]:
        out = []
        for c in self.engine.step():
            entry = self._live.get(c.tag)
            if entry is None:
                continue  # abandoned during a drain: the reissue owns it
            lease = entry["lease"]
            sample_idx = entry["arrived"]
            entry["arrived"] += 1
            if entry["arrived"] >= entry["n"]:
                self._live.pop(c.tag, None)
            payload = {
                "prompt": np.asarray(c.prompt, np.int32),
                "prompt_len": int(c.prompt_len),
                "response_tokens": np.asarray(c.response_tokens, np.int32),
                "behavior_logp": np.asarray(c.behavior_logp, np.float32),
                "values": np.asarray(c.values, np.float32),
                "generation": int(
                    self._gen_map.get(c.generation, c.generation)
                ),
            }
            tid = lease.get("_task_id")
            if tid is not None:
                payload["_task_id"] = tid
            if entry["n"] > 1:
                payload["_sample_idx"] = sample_idx
                payload["_samples_total"] = entry["n"]
            _inherit_trace(payload, lease)
            out.append(payload)
        return out


# ---------------------------------------------------------------------------
# the generation-host shell


class GenerationHost:
    """One generation host's protocol shell.

    Owns the learner link and the robustness machinery — lease prefetch,
    retained-until-acked uploads with resend-after-reconnect, heartbeat
    answering, and the drain protocol — while the actual token generation
    lives behind the duck-typed engine shell built by ``engine_factory``
    from the first fetched param snapshot.  Everything here is host numpy;
    the factory is the only seam that may touch the card.
    """

    def __init__(
        self,
        conn: Connection,
        config: DisaggConfig,
        engine_factory: EngineFactory,
        host_id: int,
        reconnect: Optional[Callable[[], Connection]] = None,
    ) -> None:
        self.conn = conn
        self.config = config
        self.engine_factory = engine_factory
        self.host_id = int(host_id)
        self.reconnect = reconnect
        self.host_epoch = int.from_bytes(os.urandom(4), "big")
        # the learner's incarnation, adopted from gen_welcome (and every
        # lease/params reply): uploads are stamped with it so a restarted
        # learner can attribute redeliveries to its predecessor exactly
        self.learner_epoch = 0
        self.engine: Any = None
        self._have_gen = -1
        self._latest_gen = 0
        self._queued: Deque[Dict[str, Any]] = deque()
        self._completed: List[Dict[str, Any]] = []
        self._seq_id = 0
        self._upload_seq = 0
        self._unacked: Dict[int, List[Dict[str, Any]]] = {}
        # per-upload trace metadata: [(ctx, t_flush), ...] so the ack can
        # close each sequence's seq.upload edge (flush -> ack, wire + wait)
        self._unacked_trace: Dict[int, List[Tuple[Any, float]]] = {}
        self._exhausted = False
        self._draining = False
        reg = telemetry.get_registry()
        self._seq_counter = reg.counter("disagg_host.sequences")
        self._upload_counter = reg.counter("disagg_host.uploads")
        self._fetch_counter = reg.counter("disagg_host.param_fetches")
        self._reconnect_counter = reg.counter("disagg_host.reconnects")
        self._send_hello()

    # -- link -----------------------------------------------------------
    def _send_hello(self) -> None:
        self.conn.send(
            {
                "kind": "gen_hello",
                "host_id": self.host_id,
                "host_epoch": self.host_epoch,
                "lanes": self.config.lanes_per_host,
            }
        )

    def _replace_conn(self, why: Exception) -> None:
        if self.reconnect is None:
            raise why
        try:
            self.conn.close()
        except Exception:  # noqa: BLE001 — link already broken
            pass
        # learner loss: everything in flight stays PARKED by construction
        # (queued leases, live lanes, retained un-acked uploads) while we
        # redial with capped exponential backoff — a restarting learner
        # takes a while to come back, and a dead one ends the host only
        # after the full budget
        for attempt in range(self.config.reconnect_max_tries):
            try:
                self.conn = self.reconnect()
                break
            except FleetClosed:
                raise why
            except (ConnectionError, EOFError, OSError):
                if attempt + 1 >= self.config.reconnect_max_tries:
                    raise why
                time.sleep(
                    exp_backoff(
                        attempt,
                        base=self.config.reconnect_backoff_s,
                        cap=self.config.reconnect_backoff_cap_s,
                    )
                )
        self._reconnect_counter.inc()
        telemetry.record_event(
            "gen_host_reconnect", host=self.host_id,
            retained_uploads=len(self._unacked),
        )
        # membership first (the learner requeued our leases when the old
        # link dropped), then every retained upload on the fresh link
        self._send_hello()
        for seq in sorted(self._unacked):
            self.conn.send(
                {"kind": "seq_batch", "v": self._unacked[seq], "seq": seq},
                compress=self.config.compress_uplink,
            )

    def _send(self, msg: Dict[str, Any], compress: bool = False) -> None:
        while True:
            try:
                self.conn.send(msg, compress=compress)
                return
            except (ConnectionError, BrokenPipeError, OSError) as e:
                self._replace_conn(e)

    def _absorb(self, msg: Any) -> bool:
        """Handle an unsolicited frame; True when it was consumed."""
        if is_heartbeat(msg):
            if msg.get("kind") == "ping":
                self.conn.send(make_pong(msg))
            return True
        if isinstance(msg, dict) and msg.get("kind") == "seq_ack":
            seq = int(msg.get("seq", -1))
            self._unacked.pop(seq, None)
            now = time.monotonic()
            for ctx, t_flush in self._unacked_trace.pop(seq, ()):
                # the upload edge closes at the ACK, so a reconnect
                # retransmit shows up as a long seq.upload span — exactly
                # the causality the critical-path report exists to surface
                tracing.record_span(
                    "seq.upload", parent=ctx, t_start=t_flush, t_end=now,
                    kind="disagg", host=self.host_id,
                )
            return True
        if isinstance(msg, dict) and msg.get("kind") == "gen_welcome":
            self._adopt_epoch(msg)
            # a (re)joining host adopts the learner's CURRENT snapshot
            # generation before admitting work: lifting _latest_gen makes
            # the run loop refetch params ahead of the next lease
            self._latest_gen = max(self._latest_gen, int(msg.get("gen", 0)))
            return True
        if isinstance(msg, dict) and msg.get("kind") == DRAIN:
            self._draining = True
            return True
        return False

    def _adopt_epoch(self, msg: Mapping[str, Any]) -> None:
        epoch = int(msg.get("epoch", self.learner_epoch))
        if epoch != self.learner_epoch:
            telemetry.record_event(
                "learner_epoch_adopted", host=self.host_id,
                epoch=epoch, prev=self.learner_epoch,
            )
            self.learner_epoch = epoch

    def _rpc(self, msg: Dict[str, Any]) -> Any:
        """send + recv with unsolicited-frame filtering and reconnect."""
        while True:
            try:
                self.conn.send(msg)
                while True:
                    reply = self.conn.recv()
                    if not self._absorb(reply):
                        return reply
            except (ConnectionError, EOFError, OSError, TimeoutError) as e:
                self._replace_conn(e)

    def _pump(self) -> None:
        try:
            while self.conn.poll(0):
                self._absorb(self.conn.recv())
        except (ConnectionError, EOFError, OSError) as e:
            self._replace_conn(e)

    # -- dataflow --------------------------------------------------------
    def _fetch_params(self) -> None:
        t0 = time.monotonic()
        reply = self._rpc({"kind": "params", "have": self._have_gen})
        if not isinstance(reply, dict):
            return
        self._adopt_epoch(reply)
        if "weights" not in reply:
            return
        gen = int(reply["generation"])
        params = dequantize_wire_tree(reply["weights"])
        self._fetch_counter.inc()
        if self.engine is None:
            self.engine = self.engine_factory(params, gen)
        else:
            self.engine.push_params(params, gen)
        self._have_gen = gen
        self._latest_gen = max(self._latest_gen, gen)
        ctx = tracing.extract(reply)
        if ctx is not None:
            # child of the learner's snapshot_publish span: fetch + decode
            # + engine adoption, one edge per host per generation
            tracing.record_span(
                "snapshot.fetch", parent=ctx, t_start=t0,
                t_end=time.monotonic(), kind="disagg",
                generation=gen, host=self.host_id,
            )

    def _request_leases(self) -> None:
        want = min(
            self.config.prefetch,
            max(self.engine.capacity() - len(self._queued), 0)
            if self.engine is not None
            else self.config.prefetch,
        )
        if want <= 0:
            return
        reply = self._rpc(
            {"kind": "lease", "n": want, "have_gen": self._have_gen}
        )
        self._adopt_epoch(reply)
        self._latest_gen = max(self._latest_gen, int(reply.get("gen", 0)))
        now = time.monotonic()
        for lease in reply.get("v", []):
            if lease is None:
                self._exhausted = True
            else:
                if isinstance(lease, dict) and tracing.TRACE_KEY in lease:
                    # the queue-wait edge opens here: lease in hand, not
                    # yet admitted to a lane
                    lease[_T_RECV] = now
                self._queued.append(lease)

    def _trace_submit(self, lease: Any) -> Any:
        """Close the queue-wait edge and stamp the submit time the decode
        edge starts from (host monotonic stamps only)."""
        if isinstance(lease, dict):
            ctx = tracing.extract(lease)
            if ctx is not None:
                now = time.monotonic()
                tracing.record_span(
                    "seq.queue_wait", parent=ctx,
                    t_start=float(lease.pop(_T_RECV, now)), t_end=now,
                    kind="disagg", host=self.host_id,
                )
                lease[_T_SUBMIT] = now
                spec = getattr(self.engine, "spec_timers", None)
                if spec is not None:
                    mark = spec()
                    if mark is not None:
                        lease[_T_SPEC] = mark
        return lease

    def _trace_harvest(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Close the decode edge (engine submit -> harvested completion;
        one span per harvested sequence, never per token).  When the
        engine decodes speculatively, two child spans under seq.decode
        apportion the engine's draft vs verify seconds that elapsed over
        this sequence's decode window (engine-wide aggregates — the
        per-pass truth lives in the engine's own genrl.macro_step spans;
        this gives the critical-path analyzer named draft/verify edges on
        the SEQUENCE trace without any per-token work)."""
        ctx = tracing.extract(payload)
        if ctx is not None:
            t_sub = payload.pop(_T_SUBMIT, None)
            mark = payload.pop(_T_SPEC, None)
            if t_sub is not None:
                t_sub = float(t_sub)
                span = tracing.record_span(
                    "seq.decode", parent=ctx, t_start=t_sub,
                    t_end=time.monotonic(), kind="disagg",
                    host=self.host_id,
                    tokens=int(np.size(payload.get("response_tokens", ()))),
                )
                spec = getattr(self.engine, "spec_timers", None)
                if mark is not None and spec is not None:
                    now_mark = spec()
                    if now_mark is not None:
                        dd = max(now_mark[0] - float(mark[0]), 0.0)
                        dv = max(now_mark[1] - float(mark[1]), 0.0)
                        if dd > 0.0:
                            tracing.record_span(
                                "seq.draft", parent=span, t_start=t_sub,
                                t_end=t_sub + dd, kind="disagg",
                                host=self.host_id,
                            )
                        if dv > 0.0:
                            tracing.record_span(
                                "seq.verify", parent=span,
                                t_start=t_sub + dd, t_end=t_sub + dd + dv,
                                kind="disagg", host=self.host_id,
                            )
        return payload

    def _flush(self, force: bool = False) -> None:
        if not self._completed:
            return
        if not force and len(self._completed) < self.config.upload_batch:
            return
        batch, self._completed = self._completed, []
        self._upload_seq += 1
        self._unacked[self._upload_seq] = batch
        now = time.monotonic()
        traced = [
            (tracing.extract(p), now) for p in batch
            if tracing.extract(p) is not None
        ]
        if traced:
            self._unacked_trace[self._upload_seq] = traced
        self._upload_counter.inc()
        self._send(
            {"kind": "seq_batch", "v": batch, "seq": self._upload_seq},
            compress=self.config.compress_uplink,
        )

    def _stamp(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        payload["host_id"] = self.host_id
        payload["host_epoch"] = self.host_epoch
        payload["seq_id"] = self._seq_id
        # the epoch dimension of the at-least-once key: a redelivery that
        # was generated under a previous learner incarnation is attributed
        # to the resume, not to ordinary wire duplication
        payload["learner_epoch"] = self.learner_epoch
        self._seq_id += 1
        return payload

    def _await_acks(self) -> bool:
        deadline = time.monotonic() + self.config.ack_timeout_s
        while self._unacked and time.monotonic() < deadline:
            try:
                if self.conn.poll(0.1):
                    self._absorb(self.conn.recv())
            except (ConnectionError, EOFError, OSError) as e:
                try:
                    self._replace_conn(e)
                except (ConnectionError, EOFError, OSError):
                    return False
        return not self._unacked

    # -- the host loop ---------------------------------------------------
    def run(self) -> None:
        """The host lifecycle: lease -> generate -> upload until drained
        (clean exit 0), the prompt source runs dry, or the link dies
        past the reconnect budget."""
        try:
            while True:
                self._pump()
                if self._draining:
                    self._run_drain()
                    return
                # params before leases: the first lease must decode on a
                # real snapshot (the factory needs one to build the engine)
                if self.engine is None or self._latest_gen > self._have_gen:
                    self._fetch_params()
                    if self.engine is None:
                        time.sleep(0.05)
                        continue
                if not self._exhausted and self.engine.capacity() > 0 and (
                    len(self._queued) < self.config.prefetch
                ):
                    self._request_leases()
                while self._queued and self.engine.capacity() > 0:
                    self.engine.submit(
                        self._trace_submit(self._queued.popleft())
                    )
                if self.engine.live() > 0:
                    for payload in self.engine.step():
                        self._seq_counter.inc()
                        self._completed.append(
                            self._stamp(self._trace_harvest(payload))
                        )
                    self._flush()
                elif self._exhausted and not self._queued:
                    # source dry, everything decoded: final flush + acks,
                    # then a clean exit (the Gather end-of-source shape)
                    self._flush(force=True)
                    self._await_acks()
                    return
                else:
                    time.sleep(0.005)
        except (KeyboardInterrupt, ConnectionError, EOFError, OSError):
            pass
        finally:
            try:
                self.conn.close()
            except Exception:  # noqa: BLE001 — already gone
                pass

    def _run_drain(self) -> None:
        """The drain protocol at sequence granularity: stop admitting,
        return unstarted leases, finish live lanes within the step budget
        (abandoning the remainder for reissue), flush + await acks, then
        announce ``drain_done`` and exit 0."""
        telemetry.record_event("drain_begin", host=self.host_id)
        returned = list(self._queued)
        self._queued.clear()
        if self.engine is not None:
            for _ in range(self.config.drain_step_budget):
                if self.engine.live() == 0:
                    break
                for payload in self.engine.step():
                    self._completed.append(
                        self._stamp(self._trace_harvest(payload))
                    )
            returned.extend(self.engine.abandon())
        for lease in returned:
            if isinstance(lease, dict):
                # host-local monotonic stamps are meaningless on the host
                # that gets the reissue — it re-stamps its own edges
                lease.pop(_T_RECV, None)
                lease.pop(_T_SUBMIT, None)
        if returned:
            self._send({"kind": "lease_return", "v": returned})
        self._flush(force=True)
        acked = self._await_acks()
        telemetry.record_event(
            "drain_done", host=self.host_id, acked=acked
        )
        self._send({"kind": DRAIN_DONE, "host_id": self.host_id})


def generation_host_main(
    conn: Connection,
    config: DisaggConfig,
    engine_factory: EngineFactory,
    host_id: int,
    reconnect: Optional[Callable[[], Connection]] = None,
) -> None:
    """Process/thread entry point (``open_worker_pipes``-compatible)."""
    try:
        GenerationHost(
            conn, config, engine_factory, host_id, reconnect=reconnect
        ).run()
    except (KeyboardInterrupt, ConnectionError, EOFError, OSError):
        pass


# ---------------------------------------------------------------------------
# the learner-side endpoint


class SequenceLearner(ParamSnapshotPlane):
    """Learner-side endpoint of the disaggregated dataflow.

    Owns the hub the generation hosts connect to, the prompt-lease
    accounting (monotonic ``_task_id`` per lease, tracked per link,
    requeued on ANY link removal, completions deduped at lease level), the
    per-(host, epoch, seq) at-least-once dedup for the retained-upload
    protocol, the accepted-sequence queue the trainer drains, and the
    quantized snapshot plane the hosts pull from — the
    :class:`ParamSnapshotPlane` idiom with the WIRE tree as the stored
    snapshot (generation ids and the gen -> learner-step map back the
    unified staleness gauge).
    """

    def __init__(
        self,
        config: DisaggConfig,
        prompt_source: Callable[[], Optional[Dict[str, Any]]],
        ledger_path: Optional[str] = None,
    ) -> None:
        config.validate()
        self.config = config
        self.prompt_source = prompt_source
        self.ledger_path = ledger_path
        self._init_param_plane(None, torch.device("cpu"))
        self.hub = QueueHub(
            heartbeat_interval=config.heartbeat_interval_s,
            heartbeat_timeout=config.heartbeat_timeout
            if config.heartbeat_interval_s > 0
            else 0.0,
            max_pending=config.max_pending,
            on_disconnect=self._on_disconnect,
        )
        self.sequences: "queue.Queue[Dict[str, Any]]" = queue.Queue(
            config.seq_maxsize
        )
        # elastic membership roster (scale decisions, targeted drains)
        self.host_links: Dict[Connection, Dict[str, Any]] = {}
        self._roster_lock = threading.Lock()
        self.hosts_joined = 0
        self.hosts_drained = 0
        # exactly-once lease accounting across churn
        self._lease_lock = threading.Lock()
        self._next_task_id = 0
        self._outstanding: Dict[int, Tuple[Connection, Any]] = {}
        self._conn_leases: Dict[Connection, Set[int]] = {}
        self._completed_leases: "OrderedDict[int, None]" = OrderedDict()
        self._completed_cap = 65536
        # group fan-out: a lease issued with samples=n closes
        # only when n distinct sample indices arrived; per-(lease, sample)
        # dedup keeps a reissue racing its original at exactly n samples
        self._completed_samples: "OrderedDict[Tuple[int, int], None]" = (
            OrderedDict()
        )
        self._sample_counts: Dict[int, int] = {}
        # open root spans per lease (head-sampled at issue time; closed at
        # ingest); bounded like the completed-lease table so a lease the
        # fleet never completes cannot leak a span forever
        self._trace_roots: "OrderedDict[int, Any]" = OrderedDict()
        self._snapshot_trace: Optional[Any] = None
        self._returned: Deque[Any] = deque()
        self.requeued_leases = 0
        self.duplicate_leases = 0
        # at-least-once upload dedup: per host, per epoch, newest seq_id
        self._dedup_seen: Dict[int, "OrderedDict[int, int]"] = {}
        self._dedup_epochs_per_host = 4
        self.duplicate_sequences = 0
        self.total_sequences = 0
        self.dropped_sequences = 0
        self.snapshot_wire_bytes = 0
        # preemption/resume plane: the learner's incarnation counter (1 on
        # a fresh start, predecessor+1 after a ledger restore) plus the
        # markers that let the resumed epoch attribute drops to the resume
        self.learner_epoch = 1
        self.restored_extra: Optional[Dict[str, Any]] = None
        self._restored_completed: Set[int] = set()
        self._restored_dedup: Dict[int, Dict[int, int]] = {}
        self.resumed_sequences_reissued = 0
        self.resumed_duplicates_dropped = 0
        reg = telemetry.get_registry()
        self._epoch_gauge = reg.gauge("learner.epoch")
        self._reissued_counter = reg.counter("resume.sequences_reissued")
        self._resume_dup_counter = reg.counter("resume.duplicates_dropped")
        self._seq_meter = reg.meter("disagg.sequences_per_s")
        self._stale_gauge = reg.gauge("disagg.staleness")
        reg.bind(
            "disagg.learner",
            lambda: {
                "generation": self.generation,
                "total_sequences": self.total_sequences,
                "duplicate_sequences": self.duplicate_sequences,
                "duplicate_leases": self.duplicate_leases,
                "requeued_leases": self.requeued_leases,
                "dropped_sequences": self.dropped_sequences,
                "sequences_queued": self.sequences.qsize(),
                "outstanding_leases": len(self._outstanding),
                "live_hosts": self.live_host_count(),
                "live_lanes": self.live_lane_count(),
                "hosts_joined": self.hosts_joined,
                "hosts_drained": self.hosts_drained,
                "snapshot_wire_bytes": self.snapshot_wire_bytes,
                "learner_epoch": self.learner_epoch,
                "resumed_sequences_reissued": self.resumed_sequences_reissued,
                "resumed_duplicates_dropped": (
                    self.resumed_duplicates_dropped
                ),
            },
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if ledger_path is not None and ledger_store.ledger_exists(
            ledger_path
        ):
            self._restore_ledger(ledger_path)
        self._epoch_gauge.set(self.learner_epoch)

    # -- param plane -----------------------------------------------------
    def publish(
        self, host_weights: Any, learner_step: Optional[int] = None
    ) -> int:
        """Publish a fresh snapshot to the generation tier: one host-side
        quantization per publish (``snapshot_quantize`` wire format), a
        monotonic generation bump, and the gen -> learner-step record the
        unified staleness definition reads.  Hosts pull lazily (the lease
        reply advertises the newest generation), so N hosts cost one
        quantization, not N."""
        span = tracing.start_span("snapshot_publish", kind="disagg")
        wire = quantize_wire_tree(host_weights, self.config.snapshot_quantize)
        self.snapshot_wire_bytes = wire_tree_bytes(wire)
        with self._param_lock:
            self.generation += 1
            gen = self.generation
            self._params = wire
            self._quantized = None
            self._record_step(gen, learner_step)
            # the generation's trace rides every params reply, so each
            # host's snapshot.fetch span parents back to this publish
            self._snapshot_trace = span.context if span.sampled else None
        span.end(generation=gen, wire_bytes=self.snapshot_wire_bytes)
        return gen

    def observe_consumed(self, served_generation: int) -> float:
        """The trainer consumed sequences tagged ``served_generation``:
        report the unified staleness (learner steps behind the newest
        generation) on both the plane-local and the unified gauge."""
        lag = self.staleness_steps(served_generation)
        self._stale_gauge.set(lag)
        telemetry.observe_staleness(lag, plane="disagg")
        return lag

    # -- membership ------------------------------------------------------
    def live_host_count(self) -> int:
        with self._roster_lock:
            return sum(
                1
                for info in self.host_links.values()
                if not info.get("draining")
            )

    def live_lane_count(self) -> int:
        with self._roster_lock:
            return sum(
                info["lanes"]
                for info in self.host_links.values()
                if not info.get("draining")
            )

    def drain_hosts(self, n_hosts: int) -> int:
        """Scale-down: ask the newest-joined ``n_hosts`` generation hosts
        to drain (stop admitting, finish/return live lanes, flush + await
        acks, exit 0).  Returns the host count actually asked."""
        with self._roster_lock:
            candidates = sorted(
                (
                    (conn, info)
                    for conn, info in self.host_links.items()
                    if not info.get("draining")
                ),
                key=lambda item: item[1].get("joined_t", 0.0),
                reverse=True,
            )
            picked = []
            for conn, info in candidates[: max(int(n_hosts), 0)]:
                info["draining"] = True
                picked.append((conn, info))
        for conn, info in picked:
            telemetry.record_event(
                "drain_request", host=info["host_id"], tier="generation"
            )
            telemetry.get_registry().counter("disagg.drain_requests").inc()
            self.hub.send(conn, make_drain())
        return len(picked)

    # -- trainer API -----------------------------------------------------
    def get_sequence(
        self, timeout: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        try:
            return self.sequences.get(timeout=timeout)
        except queue.Empty:
            return None

    def queue_occupancy(self) -> float:
        return self.sequences.qsize() / (self.sequences.maxsize or 1)

    # -- bring-up --------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve_loop, name="disagg-learner", daemon=True
            )
            self._thread.start()

    def add_host_connection(self, conn: Connection) -> None:
        self.hub.add_connection(conn)

    def stop(self) -> None:
        self._stop.set()
        self.hub.close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    # -- durable ledger (preemption tolerance) ---------------------------
    def ledger_state(
        self, extra: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """Snapshot the learner's whole accounting plane as one codec-v2
        encodable tree: open + returned leases (reissued verbatim on
        restart), the completed-lease / completed-sample / dedup tables
        (so pre-restart redeliveries drop exactly), the accepted-but-
        unconsumed sequence queue (drained here — losing it would lose
        those sequences forever, their leases already closed), the param
        plane (wire snapshot, generation, gen -> learner-step map), and
        the churn counters.  ``extra`` carries trainer-owned state (replay
        contents, learn step, lease RNG) through the same frame.

        Call with the serve loop stopped (:meth:`stop`): the snapshot
        CONSUMES the accepted queue, so it is a save-and-exit primitive,
        not a live backup.
        """
        queued: List[Dict[str, Any]] = []
        while True:
            try:
                queued.append(self.sequences.get_nowait())
            except queue.Empty:
                break
        with self._lease_lock:
            open_leases = [
                lease
                for _tid, (_conn, lease) in sorted(self._outstanding.items())
                if isinstance(lease, dict)
            ]
            returned = list(self._returned)
            state: Dict[str, Any] = {
                "format": 1,
                "learner_epoch": self.learner_epoch,
                "next_task_id": self._next_task_id,
                "open_leases": open_leases,
                "returned_leases": returned,
                "completed_leases": list(self._completed_leases.keys()),
                "completed_samples": list(self._completed_samples.keys()),
                "sample_counts": dict(self._sample_counts),
                "dedup_seen": {
                    hid: dict(epochs)
                    for hid, epochs in self._dedup_seen.items()
                },
            }
        with self._param_lock:
            state.update(
                generation=self.generation,
                gen_steps=dict(self._gen_steps),
                latest_learner_step=self._latest_learner_step,
                params=self._params,
            )
        state["queued_sequences"] = queued
        state["counters"] = {
            "total_sequences": self.total_sequences,
            "duplicate_sequences": self.duplicate_sequences,
            "duplicate_leases": self.duplicate_leases,
            "requeued_leases": self.requeued_leases,
            "dropped_sequences": self.dropped_sequences,
            "hosts_joined": self.hosts_joined,
            "hosts_drained": self.hosts_drained,
        }
        state["extra"] = extra if extra is not None else {}
        return state

    def save_ledger(
        self,
        path: Optional[str] = None,
        extra: Optional[Dict[str, Any]] = None,
        keep_last: int = 2,
    ) -> str:
        """Persist :meth:`ledger_state` durably (write-new-then-rotate +
        sha256 manifest + ``.prev`` fallback — ``genrl/ledger.py``).  The
        PreemptionGuard safe-point calls this between rounds, so the saved
        frame is always a consistent inter-step cut."""
        p = path if path is not None else self.ledger_path
        if p is None:
            raise ValueError(
                "SequenceLearner has no ledger path (pass one here or at "
                "construction)"
            )
        state = self.ledger_state(extra=extra)
        out = ledger_store.save_ledger(p, state, keep_last=keep_last)
        logger.info(
            "disagg ledger saved: epoch=%d open_leases=%d queued=%d gen=%d",
            self.learner_epoch, len(state["open_leases"]),
            len(state["queued_sequences"]), state["generation"],
        )
        return out

    def _restore_ledger(self, path: str) -> None:
        state = ledger_store.load_ledger(path)
        self.learner_epoch = int(state.get("learner_epoch", 0)) + 1
        with self._lease_lock:
            self._next_task_id = int(state.get("next_task_id", 0))
            for tid in state.get("completed_leases", []):
                self._completed_leases[int(tid)] = None
                self._restored_completed.add(int(tid))
            for tid, k in state.get("completed_samples", []):
                self._completed_samples[(int(tid), int(k))] = None
            for tid, got in state.get("sample_counts", {}).items():
                self._sample_counts[int(tid)] = int(got)
            for hid, epochs in state.get("dedup_seen", {}).items():
                self._dedup_seen[int(hid)] = OrderedDict(
                    (int(e), int(s)) for e, s in epochs.items()
                )
                self._restored_dedup[int(hid)] = {
                    int(e): int(s) for e, s in epochs.items()
                }
            # re-issue every lease that was open (on a host's lanes) or
            # parked for reissue at save time — they keep their _task_id,
            # so a pre-restart completion racing the reissue still counts
            # exactly once through the restored completed-lease table
            reissue = [
                lease
                for lease in (
                    list(state.get("open_leases", []))
                    + list(state.get("returned_leases", []))
                )
                if lease is not None
            ]
            self._returned.extend(reissue)
            self.resumed_sequences_reissued = len(reissue)
        with self._param_lock:
            self.generation = int(state.get("generation", 0))
            self._params = state.get("params")
            self._quantized = None
            gen_steps = {
                int(g): int(s)
                for g, s in state.get("gen_steps", {}).items()
            }
            self._gen_steps = gen_steps if gen_steps else {0: 0}
            self._latest_learner_step = int(
                state.get("latest_learner_step", 0)
            )
        requeued_seqs = 0
        for seq in state.get("queued_sequences", []):
            if isinstance(seq, dict) and "_t_q" in seq:
                # the replay-wait stamp is a pre-restart monotonic reading;
                # restart the dwell clock at restore
                seq["_t_q"] = time.monotonic()
            try:
                self.sequences.put_nowait(seq)
                requeued_seqs += 1
            except queue.Full:
                self.dropped_sequences += 1
        counters = state.get("counters", {})
        self.total_sequences = int(counters.get("total_sequences", 0))
        self.duplicate_sequences = int(
            counters.get("duplicate_sequences", 0)
        )
        self.duplicate_leases = int(counters.get("duplicate_leases", 0))
        self.requeued_leases = int(counters.get("requeued_leases", 0))
        self.dropped_sequences += int(counters.get("dropped_sequences", 0))
        self.hosts_joined = int(counters.get("hosts_joined", 0))
        self.hosts_drained = int(counters.get("hosts_drained", 0))
        self.restored_extra = dict(state.get("extra", {}))
        self._reissued_counter.inc(self.resumed_sequences_reissued)
        telemetry.record_event(
            "preemption_resume",
            epoch=self.learner_epoch,
            reissued=self.resumed_sequences_reissued,
            queued=requeued_seqs,
            generation=self.generation,
            learner_step=self._latest_learner_step,
        )
        logger.info(
            "disagg ledger restored: epoch=%d reissued=%d queued=%d gen=%d "
            "step=%d",
            self.learner_epoch, self.resumed_sequences_reissued,
            requeued_seqs, self.generation, self._latest_learner_step,
        )

    # -- lease accounting ------------------------------------------------
    def _next_lease(self) -> Optional[Any]:
        with self._lease_lock:
            while self._returned:
                lease = self._returned.popleft()
                tid = (
                    lease.get("_task_id") if isinstance(lease, dict) else None
                )
                if tid is not None and tid in self._completed_leases:
                    # the original (or a retained-upload resend) closed
                    # this lease while the reissue waited — handing it out
                    # again would only decode a guaranteed duplicate
                    continue
                return lease
        return None if self._stop.is_set() else self.prompt_source()

    def _record_outstanding(self, conn: Connection, lease: Any) -> Any:
        if not isinstance(lease, dict):
            return lease
        lease = dict(lease)
        with self._lease_lock:
            if "_task_id" not in lease:
                lease["_task_id"] = self._next_task_id
                self._next_task_id += 1
                # head sampling happens HERE, once per sequence lifecycle:
                # the root span rides the lease (and every requeue of it)
                # as the "trace" wire key; rate 0 keeps this a no-op
                root = tracing.start_span(
                    "sequence", kind="disagg", lease=lease["_task_id"]
                )
                if root.sampled:
                    self._trace_roots[lease["_task_id"]] = root
                    while len(self._trace_roots) > self._completed_cap:
                        _tid, stale = self._trace_roots.popitem(last=False)
                        stale.end(outcome="abandoned")
                    tracing.inject(lease, root)
            tid = lease["_task_id"]
            self._outstanding[tid] = (conn, lease)
            self._conn_leases.setdefault(conn, set()).add(tid)
        return lease

    def _on_disconnect(self, conn: Connection) -> None:
        """ANY removal of a host link (EOF, corrupt frame, liveness
        verdict, preempted node): drop the roster entry and requeue its
        outstanding leases — an in-flight generation on a killed host is
        reissued, and the racing duplicate completion counts once."""
        with self._roster_lock:
            self.host_links.pop(conn, None)
        requeued = []
        with self._lease_lock:
            for tid in self._conn_leases.pop(conn, set()):
                entry = self._outstanding.pop(tid, None)
                if entry is not None and tid not in self._completed_leases:
                    requeued.append(entry[1])
            self._returned.extend(requeued)
            self.requeued_leases += len(requeued)
        if requeued:
            telemetry.get_registry().counter("disagg.requeued_leases").inc(
                len(requeued)
            )
            telemetry.record_event(
                "leases_requeued", count=len(requeued), why="disconnect"
            )
            logger.warning(
                "disagg: requeued %d in-flight leases from a dropped "
                "generation host", len(requeued),
            )

    def _is_duplicate(self, seq: Dict[str, Any]) -> bool:
        """Per-(host_id, host_epoch, seq_id) at-least-once dedup — the
        WorkerServer episode rule at sequence granularity, with the same
        bounded per-host epoch history so a slow duplicate from a corpse
        host stays recognizable after its replacement registered."""
        hid = seq.get("host_id")
        sid = seq.get("seq_id")
        if hid is None or sid is None:
            return False
        epoch = int(seq.get("host_epoch", 0))
        sid = int(sid)
        epochs = self._dedup_seen.setdefault(int(hid), OrderedDict())
        last = epochs.get(epoch)
        if last is not None and sid <= last:
            restored = self._restored_dedup.get(int(hid), {}).get(epoch)
            if restored is not None and sid <= restored:
                # dropped by a RESTORED key — a pre-restart upload
                # redelivered to the resumed incarnation (the epoch
                # dimension of the at-least-once key doing its job)
                self.resumed_duplicates_dropped += 1
                self._resume_dup_counter.inc()
            return True
        epochs[epoch] = sid if last is None else max(last, sid)
        epochs.move_to_end(epoch)
        while len(epochs) > self._dedup_epochs_per_host:
            epochs.popitem(last=False)
        return False

    # -- serve loop ------------------------------------------------------
    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, msg = self.hub.recv(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._handle(conn, msg)
            except Exception:  # noqa: BLE001 — one bad frame must not kill the loop
                logger.exception(
                    "disagg learner: failed handling %r",
                    msg.get("kind") if isinstance(msg, dict) else msg,
                )

    def _handle(self, conn: Connection, msg: Dict[str, Any]) -> None:
        kind = msg.get("kind")
        if kind == "lease":
            n = int(msg.get("n", 1))
            leases: List[Any] = []
            for _ in range(n):
                lease = self._next_lease()
                if lease is not None:
                    lease = self._record_outstanding(conn, lease)
                leases.append(lease)
                if lease is None:
                    break
            with self._param_lock:
                gen = self.generation
            self.hub.send(
                conn,
                {
                    "kind": "lease",
                    "v": leases,
                    "gen": gen,
                    "epoch": self.learner_epoch,
                },
            )
        elif kind == "params":
            with self._param_lock:
                wire, gen = self._params, self.generation
                snap_trace = self._snapshot_trace
            if wire is None or int(msg.get("have", -1)) == gen:
                self.hub.send(
                    conn,
                    {
                        "kind": "params",
                        "generation": gen,
                        "epoch": self.learner_epoch,
                    },
                )
            else:
                reply = {
                    "kind": "params",
                    "generation": gen,
                    "weights": wire,
                    "epoch": self.learner_epoch,
                }
                tracing.inject(reply, snap_trace)
                self.hub.send(conn, reply, compress=True)
        elif kind == "seq_batch":
            # ack FIRST: the host retains the batch until this lands;
            # dedup below absorbs any redelivery
            if "seq" in msg:
                self.hub.send(conn, {"kind": "seq_ack", "seq": msg["seq"]})
            self._ingest(msg.get("v", []))
        elif kind == "gen_hello":
            with self._roster_lock:
                self.host_links[conn] = {
                    "host_id": int(msg.get("host_id", -1)),
                    "host_epoch": int(msg.get("host_epoch", 0)),
                    "lanes": int(msg.get("lanes", 0)),
                    "draining": False,
                    "joined_t": time.monotonic(),
                }
                self.hosts_joined += 1
            telemetry.get_registry().counter("disagg.hosts_joined").inc()
            telemetry.record_event(
                "gen_host_join",
                host=msg.get("host_id"),
                lanes=msg.get("lanes"),
            )
            # the epoch handshake: a (re)joining host learns the learner's
            # incarnation AND the current snapshot generation it must adopt
            # before admitting work (a host that outlived a learner restart
            # re-hellos here and re-synchronizes both)
            with self._param_lock:
                gen = self.generation
            self.hub.send(
                conn,
                {
                    "kind": "gen_welcome",
                    "epoch": self.learner_epoch,
                    "gen": gen,
                },
            )
        elif kind == "lease_return":
            requeued = 0
            with self._lease_lock:
                for lease in msg.get("v", []):
                    tid = (
                        lease.get("_task_id")
                        if isinstance(lease, dict)
                        else None
                    )
                    if tid is not None:
                        entry = self._outstanding.pop(tid, None)
                        if entry is not None:
                            self._conn_leases.get(entry[0], set()).discard(
                                tid
                            )
                        if tid in self._completed_leases:
                            continue  # raced its completion: done already
                    self._returned.append(lease)
                    requeued += 1
                self.requeued_leases += requeued
            if requeued:
                telemetry.get_registry().counter(
                    "disagg.requeued_leases"
                ).inc(requeued)
                telemetry.record_event(
                    "leases_requeued", count=requeued, why="drain"
                )
        elif kind == DRAIN_DONE:
            with self._roster_lock:
                self.host_links.pop(conn, None)
                self.hosts_drained += 1
            telemetry.get_registry().counter("disagg.hosts_drained").inc()
            telemetry.record_event(
                "gen_host_drained", host=msg.get("host_id")
            )
            logger.info(
                "disagg: generation host %s drained cleanly",
                msg.get("host_id"),
            )
        else:
            logger.warning("disagg learner: unknown message kind %r", kind)

    def _ingest(self, batch: List[Dict[str, Any]]) -> None:
        reg = telemetry.get_registry()
        for seq in batch:
            if self._is_duplicate(seq):
                self.duplicate_sequences += 1
                reg.counter("disagg.duplicate_sequences").inc()
                continue
            # lease-level exactly-once: a lease orphaned by a killed host
            # was reissued and may complete TWICE — the second completion
            # is dropped here, keeping the sequence count exact.  A
            # fanned-out lease (samples=n) dedups per (lease, sample) and
            # closes only once all n samples landed.
            tid = seq.pop("_task_id", None) if isinstance(seq, dict) else None
            if tid is not None:
                k = int(seq.pop("_sample_idx", 0))
                total = int(seq.pop("_samples_total", 1))
                closed = False
                with self._lease_lock:
                    if tid in self._completed_leases or (
                        (tid, k) in self._completed_samples
                    ):
                        self.duplicate_leases += 1
                        dup = True
                        # a reissue that raced past the close re-recorded
                        # itself as outstanding — drop that zombie entry
                        # so the lease table closes exactly (orphans == 0)
                        entry = self._outstanding.pop(tid, None)
                        if entry is not None:
                            self._conn_leases.get(entry[0], set()).discard(
                                tid
                            )
                    else:
                        dup = False
                        self._completed_samples[(tid, k)] = None
                        while (
                            len(self._completed_samples) > self._completed_cap
                        ):
                            self._completed_samples.popitem(last=False)
                        got = self._sample_counts.get(tid, 0) + 1
                        if got >= total:
                            closed = True
                            self._sample_counts.pop(tid, None)
                            self._completed_leases[tid] = None
                            while (
                                len(self._completed_leases)
                                > self._completed_cap
                            ):
                                self._completed_leases.popitem(last=False)
                            entry = self._outstanding.pop(tid, None)
                            if entry is not None:
                                self._conn_leases.get(
                                    entry[0], set()
                                ).discard(tid)
                        else:
                            self._sample_counts[tid] = got
                if dup:
                    reg.counter("disagg.duplicate_leases").inc()
                    if tid in self._restored_completed:
                        # a lease closed before the restart completing
                        # again after it (straggler host, reissue race)
                        self.resumed_duplicates_dropped += 1
                        self._resume_dup_counter.inc()
                    continue
                seq["lease_id"] = tid
                if total > 1:
                    seq["sample_idx"] = k
                if closed:
                    root = self._trace_roots.pop(tid, None)
                    if root is not None:
                        # the root span covers lease issue -> accepted
                        # ingest (of the LAST group sample); the trainer's
                        # seq_add/learn_step edges extend the trace
                        # afterwards (record_consumption_trace)
                        root.end(host=seq.get("host_id"))
            if tracing.TRACE_KEY in seq:
                seq["_t_q"] = time.monotonic()  # replay-wait edge opens
            self.total_sequences += 1
            self._seq_meter.mark()
            try:
                self.sequences.put_nowait(seq)
            except queue.Full:
                # backpressure: evict the stalest queued sequence so the
                # freshest generations survive (off-policy freshness)
                try:
                    self.sequences.get_nowait()
                    self.dropped_sequences += 1
                except queue.Empty:
                    pass
                try:
                    self.sequences.put_nowait(seq)
                except queue.Full:
                    self.dropped_sequences += 1


# ---------------------------------------------------------------------------
# the generation-host fleet (pipe processes or in-process threads)


class LocalGenerationFleet:
    """Generation hosts as local children over pipes — the process shape
    the soak/chaos tests kill, or (``use_threads=True``) in-process threads
    for single-process integration runs where the wire still flows
    but nothing needs SIGTERMing.

    Mirrors ``LocalCluster``: ``scale_up`` admits fresh hosts mid-run with
    FRESH host ids, ``chaos_poll`` applies one seeded ``mass_kill`` draw
    (site ``"disagg"``), and a supervisor thread drives the waves
    automatically when the active chaos plan arms them — backfilling is the
    AUTOSCALER's job (floor rule), never a respawn budget here.
    """

    def __init__(
        self,
        learner: SequenceLearner,
        config: DisaggConfig,
        engine_factory: EngineFactory,
        mp_context: Optional[str] = None,
        use_threads: bool = False,
        chaos_poll_interval_s: float = 0.5,
        auto_chaos: bool = True,
    ) -> None:
        self.learner = learner
        self.config = config
        self.engine_factory = engine_factory
        self.mp_context = mp_context
        self.use_threads = use_threads
        self.chaos_poll_interval_s = chaos_poll_interval_s
        # auto_chaos=False leaves the seeded wave to an explicit
        # chaos_poll() call — tests that must land the wave MID-DECODE
        # (after warmup) own the timing themselves
        self.auto_chaos = auto_chaos
        self.procs: List[Any] = []
        self._next_host_id = 0
        self._ctx: Any = None
        self._scale_lock = threading.Lock()
        self._stopping = threading.Event()
        self._supervisor: Optional[threading.Thread] = None

    def _assign_host_id(self) -> int:
        with self._scale_lock:
            hid = self._next_host_id
            self._next_host_id += 1
            return hid

    def spawned_host_count(self) -> int:
        with self._scale_lock:
            return sum(1 for p in self.procs if p.is_alive())

    def _spawn(self, host_id: int) -> None:
        import multiprocessing as mp

        if self.use_threads:
            parent, child = mp.Pipe(duplex=True)
            proc = threading.Thread(
                target=generation_host_main,
                args=(
                    PipeConnection(child),
                    self.config,
                    self.engine_factory,
                    host_id,
                ),
                kwargs={"reconnect": self._dial},
                name=f"gen-host-{host_id}",
                daemon=True,
            )
            proc.start()
        else:
            parent, child = self._ctx.Pipe(duplex=True)
            proc = self._ctx.Process(
                target=_host_proc_main,
                args=(child, self.config, self.engine_factory, host_id),
                daemon=True,
            )
            proc.start()
            child.close()
        self.learner.add_host_connection(PipeConnection(parent))
        with self._scale_lock:
            self.procs.append(proc)

    def start(self) -> None:
        if not self.use_threads:
            import multiprocessing as mp

            from scalerl_torch.utils.platform import safe_mp_context

            self._ctx = mp.get_context(safe_mp_context(self.mp_context))
        for _ in range(self.config.num_hosts):
            self._spawn(self._assign_host_id())
        from scalerl_torch.runtime import chaos

        inj = chaos.active()
        armed = inj is not None and (
            inj.plan.rates.get("mass_kill", 0.0) > 0
            or inj.plan.rates.get("preempt", 0.0) > 0
        )
        if armed and self.auto_chaos and not self.use_threads:
            self._supervisor = threading.Thread(
                target=self._supervise, name="disagg-supervisor", daemon=True
            )
            self._supervisor.start()

    def scale_up(self, n_hosts: int) -> int:
        """Dynamic admission: backfill with FRESH host ids (never a reuse
        of a dead id — fresh ids keep the dedup tables legible)."""
        added = 0
        for _ in range(max(int(n_hosts), 0)):
            self._spawn(self._assign_host_id())
            added += 1
        return added

    def _dial(self) -> Connection:
        """Thread-mode reconnect seam: a host that lost its uplink redials
        the CURRENT learner — which a preemption harness may have swapped
        for a restarted one via :meth:`adopt_learner`.  Raises
        ``ConnectionError`` while no learner is accepting; the host's
        capped backoff owns the retry cadence."""
        import multiprocessing as mp

        if self._stopping.is_set():
            raise FleetClosed("generation fleet is closing")
        with self._scale_lock:
            learner = self.learner
        if learner is None or learner.stopped:
            raise ConnectionError("no live learner to dial")
        parent, child = mp.Pipe(duplex=True)
        learner.add_host_connection(PipeConnection(parent))
        return PipeConnection(child)

    def adopt_learner(self, learner: SequenceLearner) -> None:
        """Point the reconnect seam at a restarted learner: surviving
        hosts redial into it, the ``gen_welcome`` handshake hands them the
        new epoch + snapshot generation, and their retained uploads resend
        into the restored dedup tables."""
        with self._scale_lock:
            self.learner = learner

    def chaos_poll(self) -> List[int]:
        """One seeded preemption-wave draw against the live host procs:
        a ``mass_kill`` wave plus (independently seeded) one ``preempt``
        single-victim SIGTERM."""
        if self.use_threads:
            return []
        from scalerl_torch.fleet.cluster import apply_mass_kill, apply_preempt

        killed = apply_mass_kill(self.procs, site="disagg")
        victim = apply_preempt(self.procs, site="disagg")
        if victim is not None and victim not in killed:
            killed.append(victim)
        return killed

    def _supervise(self) -> None:
        while not self._stopping.wait(self.chaos_poll_interval_s):
            self.chaos_poll()

    def join(self, timeout: float = 10.0) -> None:
        self._stopping.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if not self.use_threads and p.is_alive():
                p.terminate()


def _host_proc_main(child_conn, config, engine_factory, host_id) -> None:
    generation_host_main(
        PipeConnection(child_conn), config, engine_factory, host_id
    )


# ---------------------------------------------------------------------------
# autoscaler wiring: the generation tier as a scalable role


class GenerationTierExecutor:
    """The autoscaler's ``ScaleExecutor`` over the generation tier:
    ``scale_up`` spawns fresh hosts, ``scale_down`` runs the drain
    protocol (a deliberate zero-loss close, never a kill)."""

    def __init__(
        self, learner: SequenceLearner, fleet: LocalGenerationFleet
    ) -> None:
        self.learner = learner
        self.fleet = fleet

    def worker_count(self) -> int:
        return self.fleet.spawned_host_count()

    def scale_up(self, n: int) -> int:
        return self.fleet.scale_up(n)

    def scale_down(self, n: int) -> int:
        return self.learner.drain_hosts(n)


def disagg_signal_source(
    learner: SequenceLearner, registry: Optional[Any] = None
) -> Callable[[], FleetSignals]:
    """Generation-tier signal reader: the IMPALA/Podracer triad applied to
    sequence RL — decode production (``disagg.sequences_per_s``) vs learn
    consumption (``genrl.learn_steps_per_s``) vs replay-feed occupancy —
    plus the unified snapshot-staleness gauge, so the autoscaler can
    rebalance host counts per role off staleness pressure as well as
    queue pressure (``AutoscalerConfig.max_staleness``)."""
    last = {"shed": 0.0}

    def read() -> FleetSignals:
        reg = registry if registry is not None else telemetry.get_registry()
        shed = float(learner.hub.shed_total + learner.dropped_sequences)
        delta, last["shed"] = shed - last["shed"], shed
        return FleetSignals(
            fps=reg.meter("disagg.sequences_per_s").rate(),
            learn_steps_per_s=reg.meter("genrl.learn_steps_per_s").rate(),
            queue_occupancy=learner.queue_occupancy(),
            shed_delta=delta,
            snapshot_staleness=reg.gauge("staleness").value,
            live_workers=learner.live_host_count(),
        )

    return read
