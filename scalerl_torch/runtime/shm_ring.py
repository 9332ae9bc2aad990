"""Cross-process rollout slot ring over shared memory.

Port of ``scalerl_tpu/runtime/shm_ring.py``.  The process-grade big brother
of :class:`~scalerl_torch.runtime.rollout_queue.RolloutQueue` (which is
thread-scoped): actor *processes* acquire fixed-size trajectory slots, fill
them through zero-copy numpy views, and commit; the learner drains committed
slots and recycles them.  Index handoff goes through the lock-free C++ ring
(``scalerl_torch/csrc/shm_ring.cpp``, built by ``native/build.py``), or,
only when the caller passes ``use_native=False``, through
``multiprocessing`` queues; the payload path (shared-memory numpy slots) is
identical either way.  Unlike the JAX ring, ``use_native=None`` never falls
back quietly: a ring library that cannot be built raises.  The slot layout,
its integrity words and their CRC are the JAX ring's, byte for byte.

Parity target: the reference's shared-tensor pool + SimpleQueue index cycle
(``scalerl/impala/impala_atari.py:122-151,416-437``), minus the per-handoff
pickle and with multi-producer/multi-consumer safety.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import struct
import time
import zlib
from multiprocessing import shared_memory
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from scalerl_torch.native import load_ring_lib
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.chaos import active as chaos_active
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ALIGN = 64
# per-slot integrity words (trailing, inside the slot stride): CRC32 of the
# payload bytes + a monotonic per-slot commit sequence number
_INTG = struct.Struct("<II")


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SlotSpec:
    """Field layout of one trajectory slot: name -> (shape, dtype)."""

    def __init__(self, fields: Mapping[str, Tuple[Tuple[int, ...], np.dtype]]):
        self.fields: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            k: (tuple(s), np.dtype(d)) for k, (s, d) in fields.items()
        }
        self.offsets: Dict[str, int] = {}
        off = 0
        for name, (shape, dtype) in self.fields.items():
            self.offsets[name] = off
            off += _aligned(int(np.prod(shape)) * dtype.itemsize)
        self.slot_bytes = _aligned(off)

    def views(self, buf: memoryview) -> Dict[str, np.ndarray]:
        out = {}
        for name, (shape, dtype) in self.fields.items():
            start = self.offsets[name]
            n = int(np.prod(shape)) * dtype.itemsize
            out[name] = np.frombuffer(
                buf[start:start + n], dtype=dtype
            ).reshape(shape)
        return out


class ShmRolloutRing:
    """MPMC slot ring shared by actor processes and the learner."""

    def __init__(
        self,
        spec: SlotSpec,
        num_slots: int,
        use_native: Optional[bool] = None,
        integrity: bool = True,
    ) -> None:
        """``integrity``: reserve per-slot sequence+checksum words.  The
        writer stamps a CRC32 of the payload at ``commit``; readers verify
        (``verify_slot`` / ``pop_full_verified``) so a torn write — a
        producer SIGKILLed mid-``memcpy``, a scribbler process — is
        *detected* instead of silently training on garbage.

        ``use_native``: ``None`` or ``True`` loads the native ring and
        raises if it cannot be built; ``False`` takes the Python queues."""
        if num_slots < 2:
            raise ValueError(f"num_slots must be >= 2, got {num_slots}")
        self.spec = spec
        self.num_slots = num_slots
        self.integrity = bool(integrity)
        self._slot_stride = spec.slot_bytes + (_ALIGN if self.integrity else 0)
        self.torn_reads = 0  # per-process detection counter (learner-side)
        lib = load_ring_lib() if use_native is not False else None
        self.native = lib is not None
        ctrl_bytes = (
            int(lib.srl_ring_bytes(num_slots)) if self.native else 0
        )
        self._ctrl_bytes = _aligned(ctrl_bytes)
        total = self._ctrl_bytes + num_slots * self._slot_stride
        self.shm = shared_memory.SharedMemory(create=True, size=total)
        self._owner = True
        # telemetry plane: occupancy + torn_reads ride the merged snapshot
        # (snapshot-time binding — zero hot-path cost; a later ring simply
        # shadows an earlier one in the same process; weakref so the
        # registry never pins a torn-down ring's shm mapping alive)
        import weakref

        ring_ref = weakref.ref(self)

        def _ring_stats() -> Dict[str, int]:
            ring = ring_ref()
            return ring.stats() if ring is not None else {"gone": 1}

        telemetry.get_registry().bind("ring", _ring_stats)
        self._base_obj = None  # cached ctypes buffer export (see _base_ptr)
        self._base_addr: Optional[int] = None
        if self.native:
            self.shm.buf[:self._ctrl_bytes] = b"\x00" * self._ctrl_bytes
            rc = lib.srl_ring_init(self._base_ptr(), num_slots)
            if rc != 0:
                self.unlink()
                raise RuntimeError(f"ring init failed rc={rc}")
            self._free = self._full = None
        else:
            # spawn context: its SemLocks may be shared with BOTH spawn
            # children (pickled) and fork children (inherited), whereas
            # fork-context SemLocks raise when pickled into a spawn child —
            # and the consumers (trainer/parallel_dqn.py) spawn
            ctx = mp.get_context("spawn")
            self._free = ctx.Queue()
            self._full = ctx.Queue()
            for i in range(num_slots):
                self._free.put(i)
            self._closed = ctx.Event()

    # -- pickling: children re-attach by shm name ----------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["shm"] = None
        state["_shm_name"] = self.shm.name
        state["_owner"] = False
        state["_base_obj"] = None
        state["_base_addr"] = None
        return state

    def __setstate__(self, state):
        name = state.pop("_shm_name")
        self.__dict__.update(state)
        self.shm = shared_memory.SharedMemory(name=name)

    def _base_ptr(self) -> int:
        # One cached buffer export per process: creating a fresh
        # ``from_buffer`` view on every call leaks exports that keep the
        # mapping pinned ("cannot close exported pointers exist" during
        # unlink).  detach() drops the cached object before shm.close().
        if self._base_addr is None:
            self._base_obj = ctypes.c_char.from_buffer(self.shm.buf)
            self._base_addr = ctypes.addressof(self._base_obj)
        return self._base_addr

    def _lib(self):
        return load_ring_lib()

    def _fallback_get(self, q, timeout: Optional[float]) -> Optional[int]:
        """Queue get that also wakes on close() (mirrors native rc=-2)."""
        import queue as _q
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while not self._closed.is_set():
            step = 0.1
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return None
                step = min(step, remaining)
            try:
                return q.get(timeout=step)
            except _q.Empty:
                continue
        return None

    # -- actor side ----------------------------------------------------
    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Free slot index, or None on timeout/closed."""
        if self.native:
            us = -1 if timeout is None else int(timeout * 1e6)
            idx = int(self._lib().srl_ring_acquire(self._base_ptr(), us))
            return idx if idx >= 0 else None
        return self._fallback_get(self._free, timeout)

    def commit(self, idx: int) -> None:
        if self.integrity:
            self._stamp_slot(idx)
        if self.native:
            rc = self._lib().srl_ring_commit(self._base_ptr(), idx)
            if rc != 0:
                raise RuntimeError(f"ring commit failed rc={rc}")
        else:
            self._full.put(idx)

    # -- learner side --------------------------------------------------
    def pop_full(self, timeout: Optional[float] = None) -> Optional[int]:
        if self.native:
            us = -1 if timeout is None else int(timeout * 1e6)
            idx = int(self._lib().srl_ring_pop_full(self._base_ptr(), us))
            return idx if idx >= 0 else None
        return self._fallback_get(self._full, timeout)

    def release(self, idx: int) -> None:
        if self.native:
            rc = self._lib().srl_ring_release(self._base_ptr(), idx)
            if rc != 0:
                raise RuntimeError(f"ring release failed rc={rc}")
        else:
            self._free.put(idx)

    # -- payload -------------------------------------------------------
    def _slot_start(self, idx: int) -> int:
        if not 0 <= idx < self.num_slots:
            raise IndexError(idx)
        return self._ctrl_bytes + idx * self._slot_stride

    def slot(self, idx: int) -> Dict[str, np.ndarray]:
        """Zero-copy field views of slot ``idx`` in shared memory."""
        start = self._slot_start(idx)
        return self.spec.views(self.shm.buf[start:start + self.spec.slot_bytes])

    # -- integrity (torn-write detection) ------------------------------
    def _payload_crc(self, idx: int) -> int:
        start = self._slot_start(idx)
        mv = self.shm.buf[start:start + self.spec.slot_bytes]
        try:
            return zlib.crc32(mv)
        finally:
            mv.release()  # never leave a lingering buffer export (detach)

    def _stamp_slot(self, idx: int) -> None:
        """Write the integrity words for a filled slot (commit side)."""
        off = self._slot_start(idx) + self.spec.slot_bytes
        _crc_old, seq = _INTG.unpack_from(self.shm.buf, off)
        crc = self._payload_crc(idx)
        _INTG.pack_into(self.shm.buf, off, crc, (seq + 1) & 0xFFFFFFFF)
        inj = chaos_active()
        if inj is not None:
            # tear AFTER the stamp so the reader's verify must catch it
            start = self._slot_start(idx)
            mv = self.shm.buf[start:start + self.spec.slot_bytes]
            try:
                inj.tear_slot(mv, site="shm_ring")
            finally:
                mv.release()

    def verify_slot(self, idx: int) -> bool:
        """Recompute the payload CRC and compare against the commit stamp."""
        if not self.integrity:
            return True
        off = self._slot_start(idx) + self.spec.slot_bytes
        crc, _seq = _INTG.unpack_from(self.shm.buf, off)
        return crc == self._payload_crc(idx)

    def slot_seq(self, idx: int) -> int:
        """Commit sequence number of slot ``idx`` (0 = never committed)."""
        if not self.integrity:
            return 0
        off = self._slot_start(idx) + self.spec.slot_bytes
        return _INTG.unpack_from(self.shm.buf, off)[1]

    def pop_full_verified(
        self,
        timeout: Optional[float] = None,
        repolls: int = 3,
        repoll_delay_s: float = 0.002,
    ) -> Optional[int]:
        """``pop_full`` + checksum verification.

        A mismatching slot is re-polled ``repolls`` times (a commit-ordering
        race resolves in microseconds; a true torn write never does), then
        counted in ``torn_reads``, released back to the free pool, and the
        next full slot is tried — the learner skips the corrupt payload
        instead of training on it.  Returns None on timeout/close, exactly
        like ``pop_full``.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            t = (
                None
                if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            idx = self.pop_full(timeout=t)
            if idx is None:
                return None
            ok = self.verify_slot(idx)
            for _ in range(repolls):
                if ok:
                    break
                time.sleep(repoll_delay_s)
                ok = self.verify_slot(idx)
            if ok:
                return idx
            self.torn_reads += 1
            telemetry.get_registry().counter("ring.torn_reads").inc()
            telemetry.record_event(
                "torn_read", slot=idx, seq=self.slot_seq(idx),
                total=self.torn_reads,
            )
            logger.warning(
                "shm ring: torn/corrupt slot %d detected (seq %d); "
                "released without consuming (%d total)",
                idx, self.slot_seq(idx), self.torn_reads,
            )
            self.release(idx)
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def gather_batch(
        self, idxs: List[int], out: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        """Stack slots into ``[len(idxs), ...]`` per-field batches (native
        memcpy when the C++ lib is loaded, Python copy loop otherwise)."""
        if out is None:
            out = {
                name: np.empty((len(idxs),) + shape, dtype)
                for name, (shape, dtype) in self.spec.fields.items()
            }
        if self.native and idxs:
            lib = self._lib()
            base = self._base_ptr() + self._ctrl_bytes
            n = len(idxs)
            for name, (shape, dtype) in self.spec.fields.items():
                nbytes = int(np.prod(shape)) * dtype.itemsize
                srcs = (ctypes.c_char_p * n)(
                    *(
                        base + idx * self._slot_stride + self.spec.offsets[name]
                        for idx in idxs
                    )
                )
                dst = out[name]
                if not dst.flags["C_CONTIGUOUS"] or dst.shape != (n,) + shape:
                    raise ValueError(f"gather_batch: out[{name!r}] must be a C-contiguous "
                                     f"{(n,) + shape} array")
                lib.srl_gather_batch(
                    dst.ctypes.data_as(ctypes.c_char_p), srcs, n, nbytes
                )
            return out
        for b, idx in enumerate(idxs):
            for name, view in self.slot(idx).items():
                out[name][b] = view
        return out

    def stats(self) -> Dict[str, int]:
        """Occupancy snapshot for watchdog stall reports.

        Fallback mode reports approximate free/full depths (qsize is
        advisory); the native ring exposes no depth API, so only slot count
        and the closed flag are reported there — still enough to tell "ring
        closed under us" from "producers wedged".
        """
        out = {
            "slots": self.num_slots,
            "closed": int(self.closed),
            "integrity": int(self.integrity),
            "torn_reads": self.torn_reads,
        }
        if not self.native:
            out["free"] = self._free.qsize()
            out["full"] = self._full.qsize()
        return out

    # -- lifecycle -----------------------------------------------------
    @property
    def closed(self) -> bool:
        """True once any holder called close() — lets pollers distinguish
        shutdown from a timeout (both return None from acquire/pop_full):
        ``while not ring.closed: idx = ring.pop_full(timeout=1.0) ...``"""
        if self.native:
            return bool(self._lib().srl_ring_closed(self._base_ptr()))
        return self._closed.is_set()

    def close(self) -> None:
        if self.native:
            self._lib().srl_ring_close(self._base_ptr())
        else:
            self._closed.set()

    def __del__(self):
        # drop the cached buffer export before SharedMemory.__del__ runs —
        # GC dict-clear order is unspecified, and if the mmap closes second
        # it raises "cannot close exported pointers exist"
        self._base_obj = None

    def detach(self) -> None:
        """Drop this process's mapping.  Callers must release every
        ``slot()`` view first — live views keep the buffer exported and the
        mapping cannot close (warned, not silently leaked)."""
        import gc

        self._base_obj = None  # release the cached ctypes buffer export
        self._base_addr = None
        try:
            self.shm.close()
        except BufferError:
            gc.collect()  # drop unreferenced slot views, then retry once
            try:
                self.shm.close()
            except BufferError:
                logger.warning(
                    "shm ring %s not closed: slot views still alive "
                    "(release them before detach/unlink)",
                    self.shm.name,
                )
        except OSError:
            pass

    def unlink(self) -> None:
        """Owner-side final cleanup of the shared segment."""
        self.detach()
        if self._owner:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass
