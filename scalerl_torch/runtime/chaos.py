"""Seeded, deterministic fault injection for the data plane.

Podracer-style TPU deployments (arxiv 2104.06272) treat corruption and
preemption as routine events to be *absorbed*; IMPALA (arxiv 1802.01561)
requires the learner to tolerate stale/duplicated actor data by
construction.  This module makes those properties testable: a
:class:`FaultInjector` wraps the fleet transport, the shm rollout ring, and
checkpoint I/O and injects the faults the integrity layer must catch —
dropped/duplicated/bit-flipped/truncated frames, a peer killed mid-frame,
torn shm slot writes, partial checkpoint directories, and NaN/Inf poisoned
training batches.

Everything is driven by a :class:`ChaosPlan` (seed + per-fault rates).
Determinism contract: every fault *kind* at every *site* draws from its own
``numpy`` PCG64 stream seeded by ``(plan.seed, kind, site)``, so the same
seed reproduces the same fault schedule at a site regardless of how other
sites interleave (connection pumps run in threads; a single shared stream
would make schedules scheduling-dependent).

Activation paths:

- tests: ``chaos.install(FaultInjector(ChaosPlan(...)))`` / ``chaos.clear()``;
- soak runs: ``SCALERL_CHAOS=<seed>:<spec>`` — read lazily on first
  :func:`active` call in ANY process (spawned fleet children inherit the
  env var, so the whole tree runs under the same plan).

Spec syntax (see docs/DISTRIBUTED.md "Data integrity & chaos testing"):
comma-separated ``kind=rate`` or ``kind=rate@max_count`` entries plus
options ``minframe=<bytes>`` (frame faults only hit frames at least this
large — scopes chaos to the rollout uplink, not the entry handshake),
``sites=<prefix>[|<prefix>...]`` (frame faults only at matching transport
sites, e.g. ``sites=sock``), ``delay=<seconds>`` (the ``frame_delay``
duration), and ``kills=<n>`` (victims per ``mass_kill`` wave; default half
the live peers).  Example::

    SCALERL_CHAOS="42:frame_bitflip=0.05@3,grad_nan=0.2@10,minframe=1024"

Port of ``scalerl_tpu/runtime/chaos.py``: the same plan and seed give the
same fault schedule, draw for draw.  Plain numpy: fleet workers and spawned
children import it for pennies; the NaN *guard* (the thing chaos throws
grad faults at) lives in ``parallel/train_step.py``.  ``poison_batch``
plants its NaN/Inf in numpy arrays in place and in torch tensors by a
device-side write into a copy, with no host read.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_VAR = "SCALERL_CHAOS"

# fault vocabulary: transport frames, shm slots, checkpoints, gradients
FRAME_KINDS = (
    "frame_drop",      # frame silently discarded (lost uplink datagram)
    "frame_dup",       # frame delivered twice (at-least-once resend)
    "frame_bitflip",   # one random bit flipped anywhere in the frame
    "frame_truncate",  # frame cut at a random byte boundary
    "frame_delay",     # frame delayed by plan.delay_s
    "peer_kill",       # half the frame sent, then the connection dies
)
KINDS = FRAME_KINDS + (
    "slot_tear",       # committed shm slot payload bytes scrambled
    "ckpt_partial",    # freshly-written checkpoint left truncated
    "grad_nan",        # NaN planted in the training batch
    "grad_inf",        # Inf planted in the training batch
    "mass_kill",       # K fleet peers SIGTERMed in one window (spot wave)
    "preempt",         # ONE peer SIGTERMed at a site (single spot reclaim)
)

_UNLIMITED = 1 << 62


@dataclass(frozen=True)
class ChaosPlan:
    """Seed + per-fault-kind rates/limits driving a :class:`FaultInjector`."""

    seed: int
    rates: Mapping[str, float] = field(default_factory=dict)
    limits: Mapping[str, int] = field(default_factory=dict)
    min_frame_bytes: int = 0
    site_prefixes: Tuple[str, ...] = ()  # empty = every site
    delay_s: float = 0.05
    # mass_kill victim count per wave (spec option ``kills=<n>``); 0 means
    # "half the live peers, rounded up" — the spot-preemption-wave default
    kill_count: int = 0

    def __post_init__(self) -> None:
        for kind in self.rates:
            if kind not in KINDS:
                raise ValueError(
                    f"unknown chaos fault kind {kind!r}; known: {sorted(KINDS)}"
                )

    @classmethod
    def parse(cls, text: str) -> "ChaosPlan":
        """Parse the ``<seed>:<spec>`` string (the SCALERL_CHAOS format)."""
        head, sep, spec = text.partition(":")
        if not sep:
            raise ValueError(
                f"chaos plan {text!r} must look like '<seed>:<kind>=<rate>,...'"
            )
        try:
            seed = int(head)
        except ValueError as e:
            raise ValueError(f"chaos plan seed {head!r} is not an integer") from e
        rates: Dict[str, float] = {}
        limits: Dict[str, int] = {}
        minframe = 0
        sites: Tuple[str, ...] = ()
        delay_s = 0.05
        kill_count = 0
        for token in filter(None, (t.strip() for t in spec.split(","))):
            key, eq, value = token.partition("=")
            if not eq:
                raise ValueError(f"chaos spec token {token!r} is not key=value")
            if key in KINDS:
                rate_s, at, max_s = value.partition("@")
                rates[key] = float(rate_s)
                if at:
                    limits[key] = int(max_s)
            elif key == "minframe":
                minframe = int(value)
            elif key == "sites":
                sites = tuple(filter(None, value.split("|")))
            elif key == "delay":
                delay_s = float(value)
            elif key == "kills":
                kill_count = int(value)
            else:
                raise ValueError(
                    f"unknown chaos spec key {key!r} (fault kinds: "
                    f"{sorted(KINDS)}; options: minframe, sites, delay, kills)"
                )
        return cls(
            seed=seed,
            rates=rates,
            limits=limits,
            min_frame_bytes=minframe,
            site_prefixes=sites,
            delay_s=delay_s,
            kill_count=kill_count,
        )

    def spec(self) -> str:
        """Round-trip back to the env-var string (for spawning soak children)."""
        parts = []
        for kind, rate in self.rates.items():
            lim = self.limits.get(kind)
            parts.append(f"{kind}={rate}" + (f"@{lim}" if lim is not None else ""))
        if self.min_frame_bytes:
            parts.append(f"minframe={self.min_frame_bytes}")
        if self.site_prefixes:
            parts.append("sites=" + "|".join(self.site_prefixes))
        if self.delay_s != 0.05:
            parts.append(f"delay={self.delay_s}")
        if self.kill_count:
            parts.append(f"kills={self.kill_count}")
        return f"{self.seed}:" + ",".join(parts)


class FaultInjector:
    """Deterministic fault scheduler over independent per-(kind, site) streams.

    Thread-safe: transport pumps, actor threads, and the learner can all
    consult the injector concurrently; each (kind, site) stream is advanced
    under the lock, so per-site schedules stay reproducible.
    """

    def __init__(self, plan: ChaosPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._gens: Dict[Tuple[str, str], np.random.Generator] = {}
        self.fired: Dict[str, int] = {k: 0 for k in KINDS}
        self.opportunities: Dict[str, int] = {k: 0 for k in KINDS}

    # -- decision streams ----------------------------------------------
    def _gen(self, kind: str, site: str) -> np.random.Generator:
        key = (kind, site)
        g = self._gens.get(key)
        if g is None:
            # crc32 of the label folds (kind, site) into the seed material
            # deterministically across processes and python hash seeds
            ss = np.random.SeedSequence(
                [self.plan.seed, zlib.crc32(f"{kind}|{site}".encode())]
            )
            g = np.random.Generator(np.random.PCG64(ss))
            self._gens[key] = g
        return g

    def decide(self, kind: str, site: str = "") -> bool:
        """One fault-or-not draw from the (kind, site) stream."""
        rate = self.plan.rates.get(kind, 0.0)
        if rate <= 0.0:
            return False
        with self._lock:
            g = self._gen(kind, site)
            self.opportunities[kind] += 1
            hit = bool(g.random() < rate)  # drawn BEFORE the limit check so
            # the stream position (and thus later decisions) is independent
            # of how many faults already landed
            if hit and self.fired[kind] >= self.plan.limits.get(kind, _UNLIMITED):
                return False
            if hit:
                self.fired[kind] += 1
        if hit:
            # telemetry outside the injector lock: counter + flight event so
            # a post-mortem can line injected faults up against detections
            from scalerl_torch.runtime import telemetry

            telemetry.get_registry().counter(f"chaos.{kind}").inc()
            telemetry.record_event("chaos_injection", fault=kind, site=site)
        return hit

    def _draw_int(self, kind: str, site: str, n: int) -> int:
        with self._lock:
            return int(self._gen(kind, site).integers(0, n))

    # -- transport frames ----------------------------------------------
    def frame_faults(
        self, data: bytes, site: str
    ) -> Tuple[List[bytes], Optional[bytes]]:
        """Mangle one outgoing frame.

        Returns ``(frames, kill)``: the frames to actually transmit (empty =
        drop, two = duplicate, one mutated = bit-flip/truncate) and, when
        ``kill`` is not None, a *partial* frame body to transmit before the
        sender tears the connection down mid-frame (the peer-kill fault).
        At most one fault per frame, in fixed precedence order.
        """
        if self.plan.site_prefixes and not any(
            site.startswith(p) for p in self.plan.site_prefixes
        ):
            return [data], None
        if len(data) < self.plan.min_frame_bytes:
            return [data], None
        if self.decide("peer_kill", site):
            return [], data[: max(1, len(data) // 2)]
        if self.decide("frame_drop", site):
            return [], None
        if self.decide("frame_dup", site):
            return [data, data], None
        if self.decide("frame_truncate", site):
            return [data[: self._draw_int("frame_truncate", site, len(data))]], None
        if self.decide("frame_bitflip", site):
            pos = self._draw_int("frame_bitflip", site, len(data) * 8)
            mut = bytearray(data)
            mut[pos // 8] ^= 1 << (pos % 8)
            return [bytes(mut)], None
        if self.decide("frame_delay", site):
            time.sleep(self.plan.delay_s)
        return [data], None

    # -- preemption waves ------------------------------------------------
    def mass_kill_victims(self, n_peers: int, site: str = "fleet") -> List[int]:
        """One preemption-wave draw: when the ``mass_kill`` stream fires,
        return the indices (into the caller's list of ``n_peers`` live
        peers) to kill inside this window — ``plan.kill_count`` of them, or
        half the fleet rounded up when unset.  Empty list = no wave.

        The victim choice draws from the same per-(kind, site) stream as
        the fire decision, so the same seed preempts the same peers — the
        autoscaler-backfill chaos tests replay identical waves.
        """
        if n_peers <= 0 or not self.decide("mass_kill", site):
            return []
        k = self.plan.kill_count or max(1, (n_peers + 1) // 2)
        k = min(k, n_peers)
        with self._lock:
            g = self._gen("mass_kill", site)
            victims = sorted(int(i) for i in g.choice(n_peers, size=k, replace=False))
        return victims

    def preempt_victim(self, n_peers: int, site: str = "fleet") -> Optional[int]:
        """One seeded single-preemption draw: when the ``preempt`` stream
        fires, return the index (into the caller's list of ``n_peers`` live
        peers) of the ONE peer to SIGTERM; None = no preemption.

        ``mass_kill`` models a spot *wave*; ``preempt`` models the scheduler
        reclaiming a single worker — the learner, one generation host, or a
        serving replica — mid-run.  Sites distinguish the tier
        (``"learner"``, ``"disagg"``, ``"router"``), and the victim choice
        draws from the same per-(kind, site) stream as the fire decision so
        the same seed preempts the same peer.
        """
        if n_peers <= 0 or not self.decide("preempt", site):
            return None
        with self._lock:
            return int(self._gen("preempt", site).integers(0, n_peers))

    # -- shm ring slots ------------------------------------------------
    def tear_slot(self, payload, site: str = "shm_ring") -> bool:
        """Scramble bytes of a committed slot payload (a torn write).

        ``payload``: a writable buffer (the slot's shared-memory bytes,
        *after* the integrity checksum was written — so the reader's verify
        must fail).  Returns True when the tear happened.
        """
        if not self.decide("slot_tear", site):
            return False
        arr = np.frombuffer(payload, dtype=np.uint8)
        if arr.size:
            with self._lock:
                g = self._gen("slot_tear", site)
                pos = g.integers(0, arr.size, size=max(1, arr.size // 64))
            arr[pos] ^= 0xFF
        return True

    # -- checkpoints ----------------------------------------------------
    def corrupt_checkpoint(self, path: str, site: str = "ckpt") -> bool:
        """Leave the freshly-written checkpoint at ``path`` partial, the way
        a preemption landing mid-flush does: the largest data file is
        truncated to half and the top-level metadata files (the LAST thing
        a checkpointer finalizes) are removed.  Returns True when the
        corruption happened."""
        if not self.decide("ckpt_partial", site):
            return False
        candidates: List[Tuple[int, str]] = []
        for root, _dirs, files in os.walk(path):
            for name in files:
                p = os.path.join(root, name)
                try:
                    candidates.append((os.path.getsize(p), p))
                except OSError:
                    continue
        if not candidates:
            return False
        size, victim = max(candidates)
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
        removed = []
        for name in ("_METADATA", "_CHECKPOINT_METADATA"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                os.remove(p)
                removed.append(name)
        logger.warning(
            "chaos: left checkpoint %s partial (truncated %s %d -> %d "
            "bytes; removed %s)",
            path, victim, size, size // 2, removed or "nothing",
        )
        return True

    # -- gradients -------------------------------------------------------
    def poison_batch(self, batch, site: str = "batch") -> bool:
        """Plant a NaN/Inf in the first float leaf (by sorted key) of a
        training batch.

        Host numpy arrays are written in place; a torch tensor is replaced
        in ``batch`` by a copy with the value written on its own device (a
        CUDA batch is never read to the host, and the replay a sampled
        tensor may alias is not touched).  Poisoning the batch corrupts the
        loss and gradients downstream, which is exactly what the learn
        step's non-finite guard must absorb.
        """
        if self.decide("grad_nan", site):
            value = float("nan")
        elif self.decide("grad_inf", site):
            value = float("inf")
        else:
            return False
        import torch

        for key in sorted(batch):
            arr = batch[key]
            if isinstance(arr, torch.Tensor):
                if not arr.is_floating_point() or arr.numel() == 0:
                    continue
                poisoned = arr.clone()
                poisoned.view(-1)[0] = value
                batch[key] = poisoned
                return True
            if (not isinstance(arr, np.ndarray) or not np.issubdtype(arr.dtype, np.floating)
                    or arr.size == 0):
                continue
            arr.reshape(-1)[0] = value
            return True
        return False


# ---------------------------------------------------------------------------
# process-wide activation

_ACTIVE: Optional[FaultInjector] = None
_ENV_CHECKED = False
_INSTALL_LOCK = threading.Lock()


def install(injector: Optional[FaultInjector]) -> None:
    """Install (or, with None, remove) the process-wide injector."""
    global _ACTIVE, _ENV_CHECKED
    with _INSTALL_LOCK:
        _ACTIVE = injector
        _ENV_CHECKED = True  # explicit install wins over the env var


def clear() -> None:
    """Remove any injector AND forget the env-var verdict, so the next
    :func:`active` call re-reads ``SCALERL_CHAOS`` (tests toggle the var)."""
    global _ACTIVE, _ENV_CHECKED
    with _INSTALL_LOCK:
        _ACTIVE = None
        _ENV_CHECKED = False


def from_env() -> Optional[FaultInjector]:
    text = os.environ.get(ENV_VAR, "")
    if not text:
        return None
    return FaultInjector(ChaosPlan.parse(text))


def active() -> Optional[FaultInjector]:
    """The process-wide injector, or None.

    Lazily initialized from ``SCALERL_CHAOS`` exactly once per process —
    spawned fleet children inherit the env var, so a soak plan covers the
    whole process tree.  The fast path is one global read: with no chaos
    configured the data plane pays nothing.
    """
    global _ACTIVE, _ENV_CHECKED
    if _ENV_CHECKED:
        return _ACTIVE
    with _INSTALL_LOCK:
        if not _ENV_CHECKED:
            try:
                _ACTIVE = from_env()
            except ValueError:
                logger.exception("chaos: invalid %s value ignored", ENV_VAR)
                _ACTIVE = None
            _ENV_CHECKED = True
            if _ACTIVE is not None:
                logger.warning(
                    "chaos: fault injection ACTIVE (%s=%s)",
                    ENV_VAR, os.environ.get(ENV_VAR),
                )
    return _ACTIVE
