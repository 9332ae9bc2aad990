"""Free/full rollout-slot queue: the host side of the learner's infeed.

The port's own copy of ``scalerl_tpu/runtime/rollout_queue.py`` (jax-free
there too): a fixed pool of numpy trajectory slots; actors take a free
index (:meth:`RolloutQueue.acquire`), fill the slot and :meth:`commit` it;
the learner drains ``n`` full slots into one time-major batch
(:meth:`get_batch`) and :meth:`recycle` s them.  ``max_pending`` > 0 bounds
the full queue by shedding its stalest slot.  An actor's exception goes in
through :meth:`report_error` and re-raises in the learner's next
``get_batch``; :meth:`stats` reports occupancy (the watchdog's probe and
the registry's ``queue`` binding).
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from scalerl_torch.data.trajectory import TrajectorySpec
from scalerl_torch.runtime import telemetry


class RolloutQueue:
    def __init__(
        self, spec: TrajectorySpec, num_slots: int, max_pending: int = 0
    ) -> None:
        """``max_pending`` > 0 arms bounded admission on the full queue:
        a ``commit`` that would leave more than ``max_pending`` consumable
        slots sheds the STALEST one back to the free pool instead
        (``shed_total``).  Queue depth is worst-case policy lag, so a slow learner
        now costs dropped-oldest rollouts — bounded staleness — rather
        than unbounded lag.  0 keeps the old behavior (depth bounded only
        by ``num_slots``)."""
        if num_slots < 2:
            raise ValueError(f"num_slots must be >= 2, got {num_slots}")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.spec = spec
        self.num_slots = num_slots
        self.max_pending = max_pending
        self.shed_total = 0
        self.slots: List[Dict[str, np.ndarray]] = [
            spec.host_zeros() for _ in range(num_slots)
        ]
        self.free: "queue.Queue[int]" = queue.Queue()
        self.full: "queue.Queue[int]" = queue.Queue()
        for i in range(num_slots):
            self.free.put(i)
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._closed = threading.Event()
        # telemetry plane: queue occupancy in the merged snapshot (weakref
        # snapshot-time binding — nothing on the acquire/commit hot path)
        q_ref = weakref.ref(self)
        telemetry.get_registry().bind(
            "queue", lambda: (lambda q: q.stats() if q is not None else {"gone": 1})(q_ref())
        )

    # -- actor side ----------------------------------------------------
    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Take a free slot index (None on shutdown)."""
        while not self._closed.is_set():
            try:
                return self.free.get(timeout=0.1 if timeout is None else timeout)
            except queue.Empty:
                if timeout is not None:
                    return None
        return None

    def commit(self, idx: int) -> None:
        if self.max_pending > 0 and self.full.qsize() >= self.max_pending:
            # bounded admission: recycle the stalest full slot so the
            # freshest rollout is what the learner trains on next
            try:
                stale = self.full.get_nowait()
            except queue.Empty:
                stale = None
            if stale is not None:
                self.free.put(stale)
                self.shed_total += 1
                telemetry.get_registry().counter("queue.shed_total").inc()
        self.full.put(idx)

    def report_error(self, exc: BaseException) -> None:
        telemetry.get_registry().counter("queue.actor_errors").inc()
        with self._error_lock:
            if self._error is None:
                self._error = exc
        self._closed.set()

    # -- learner side --------------------------------------------------
    def _check_error(self) -> None:
        with self._error_lock:
            if self._error is not None:
                raise RuntimeError("actor worker died") from self._error

    def get_batch(
        self, batch_size: int, timeout: Optional[float] = None
    ) -> Tuple[Dict[str, np.ndarray], List[int]]:
        """Drain ``batch_size`` full slots into one [T+1, batch, ...] batch.

        Slots are recycled by the caller via ``recycle`` *after* the batch
        has been shipped to device (the stack below copies, so recycling
        immediately after this returns is also safe).
        """
        idxs: List[int] = []
        try:
            while len(idxs) < batch_size:
                self._check_error()
                try:
                    idxs.append(
                        self.full.get(timeout=0.5 if timeout is None else timeout)
                    )
                except queue.Empty:
                    if self._closed.is_set():
                        self._check_error()
                        raise RuntimeError("rollout queue closed")
                    if timeout is not None:
                        raise TimeoutError(
                            f"get_batch: only {len(idxs)}/{batch_size} slots ready"
                        )
            batch = {
                # core-state keys describe row 0 only: batch axis is 0; the
                # time-major fields batch on axis 1
                k: np.concatenate(
                    [self.slots[i][k] for i in idxs],
                    axis=0 if k.startswith("core_") else 1,
                )
                for k in self.slots[idxs[0]].keys()
            }
        except BaseException:
            # any exit (error funnel, timeout, close, KeyboardInterrupt,
            # a bad slot in the batch build): the drained slots are still
            # full and unconsumed — hand them back, or the pool leaks one
            # slot per exit until acquire() deadlocks.  Re-enqueueing at
            # the tail perturbs FIFO order: rollouts drained here age to
            # the back of the queue and pick up extra policy lag before
            # they are finally consumed.  Acceptable — V-trace corrects
            # bounded lag, and this path only runs on timeouts/teardown —
            # but callers that need strict lag bounds should drain and
            # drop instead of retrying.
            for i in idxs:
                self.full.put(i)
            raise
        return batch, idxs

    def recycle(self, idxs: List[int]) -> None:
        for i in idxs:
            self.free.put(i)

    def stats(self) -> Dict[str, int]:
        """Occupancy snapshot for watchdog stall reports: free/full queue
        depths (approximate under concurrency — qsize is advisory), total
        slots, and how many are in flight (acquired or being consumed)."""
        free, full = self.free.qsize(), self.full.qsize()
        return {
            "slots": self.num_slots,
            "free": free,
            "full": full,
            "in_flight": max(self.num_slots - free - full, 0),
            "shed_total": self.shed_total,
            "closed": int(self._closed.is_set()),
        }

    def close(self) -> None:
        self._closed.set()
