"""Dynamic batcher for the centralized inference plane.

A copy of ``scalerl_tpu/serving/batcher.py`` (``ServingConfig``,
``ServingRequest``, ``DynamicBatcher``) over the port's telemetry; the
continuous engine uses it as its admission queue.

- **flush on size OR deadline** — a flush fires the moment ``max_batch``
  lanes are pending, or when the *oldest* pending request has waited
  ``max_wait_s`` (the latency/occupancy trade every serving system tunes);
- **bucketed static shapes** — flushed batches are padded up to a fixed
  bucket ladder, so the consumer sees a few static batch shapes;
- **bounded admission with explicit load-shedding** — at ``max_pending``
  queued requests new arrivals are *shed* (counted, reported to the caller)
  instead of growing an unbounded queue whose depth silently becomes
  latency and policy lag.

Requests are host numpy; the consumer owns the device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from collections import deque

from scalerl_torch.runtime import telemetry

# the pow2 ladder lives in utils/buckets.py; re-exported under the serving
# plane's public names
from scalerl_torch.utils.buckets import bucket_for, default_buckets  # noqa: F401


@dataclass
class ServingConfig:
    """Knobs for the inference server + dynamic batcher.

    ``max_pending`` follows the fleet-wide bounded-admission vocabulary
    (``FleetConfig.max_pending``): 0 disables shedding (unbounded queue,
    the pre-serving behavior of every other queue in the codebase).
    """

    max_batch: int = 64          # flush the moment this many lanes pend
    max_wait_s: float = 0.005    # ... or when the oldest request waited this
    max_pending: int = 256       # bounded admission: requests, not lanes
    buckets: Tuple[int, ...] = ()  # () -> power-of-two ladder to max_batch
    seed: int = 0                # serve-fn sampling key seed
    # liveness plane for socket clients (0 = off; serving links are
    # short-RPC, the client's request timeout is the primary detector)
    heartbeat_interval_s: float = 0.0

    def resolved_buckets(self) -> Tuple[int, ...]:
        return tuple(self.buckets) or default_buckets(self.max_batch)

    @classmethod
    def from_args(cls, args: Any) -> "ServingConfig":
        """Build from an ``RLArguments``-style object (serve_* fields)."""
        return cls(
            max_batch=int(getattr(args, "serve_max_batch", 64)),
            max_wait_s=float(getattr(args, "serve_max_wait_ms", 5.0)) / 1e3,
            max_pending=int(getattr(args, "serve_max_pending", 256)),
            seed=int(getattr(args, "seed", 0)),
        )


@dataclass
class ServingRequest:
    """One pending act request: a [B, ...] slab of env lanes plus the reply
    route (opaque to the batcher — the server demuxes)."""

    conn: Any
    req_id: Any
    lanes: int
    payload: Dict[str, Any]
    t_enqueue: float = field(default_factory=time.monotonic)
    # propagated trace context (runtime/tracing.py) when the client's act
    # request carried one — the server emits queue-wait/flush spans off it
    trace: Any = None


class DynamicBatcher:
    """Thread-safe pending-request queue with flush-on-size-or-deadline.

    Producers call :meth:`submit` (the server's admission pump); ONE
    consumer thread calls :meth:`next_batch` (the flush loop).  Shedding
    happens at submit time so a rejected request is answered immediately —
    the client retries or falls back locally instead of waiting on a queue
    that can only grow.
    """

    def __init__(self, config: ServingConfig) -> None:
        self.config = config
        self.buckets = config.resolved_buckets()
        self._cond = threading.Condition()
        self._pending: Deque[ServingRequest] = deque()
        self._pending_lanes = 0
        self._closed = False
        self.shed_total = 0
        self.submitted_total = 0
        telemetry.get_registry().bind("serving.batcher", self.stats)

    def submit(self, req: ServingRequest) -> bool:
        """Admit one request; False = shed (queue at ``max_pending``)."""
        with self._cond:
            if self._closed:
                return False
            if (
                self.config.max_pending > 0
                and len(self._pending) >= self.config.max_pending
            ):
                self.shed_total += 1
                telemetry.get_registry().counter("serving.shed_total").inc()
                return False
            self.submitted_total += 1
            self._pending.append(req)
            self._pending_lanes += req.lanes
            self._cond.notify()
            return True

    def next_batch(self, poll_s: float = 0.05) -> Optional[List[ServingRequest]]:
        """Block until a flush is due; returns the FIFO request batch
        (None once closed and drained).  A flush takes whole requests up to
        ``max_batch`` lanes — a request is never split across flushes.  A
        closed batcher hands over what it still holds at once (the JAX copy
        waits out each deadline), so a stopping server answers it."""
        with self._cond:
            while True:
                if self._pending:
                    if self._pending_lanes >= self.config.max_batch or self._closed:
                        return self._take_locked()
                    deadline = self._pending[0].t_enqueue + self.config.max_wait_s
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return self._take_locked()
                    self._cond.wait(timeout=min(remaining, poll_s))
                elif self._closed:
                    return None
                else:
                    self._cond.wait(timeout=poll_s)

    def poll_batch(
        self, max_lanes: Optional[int] = None
    ) -> Optional[List[ServingRequest]]:
        """Non-blocking flush: the continuous-batching admission pump.

        Returns a FIFO request batch the moment a flush is *due* — pending
        lanes can fill ``max_lanes`` (capacity-triggered, the size half of
        the flush predicate) or the oldest pending request has waited
        ``max_wait_s`` (the deadline half) — else ``None`` immediately.
        ``max_lanes`` caps the batch (defaults to ``max_batch``); the
        caller passes its free-lane count so admission never over-commits.
        Same whole-request / never-split contract as :meth:`next_batch`.
        """
        with self._cond:
            if not self._pending:
                return None
            limit = self.config.max_batch if max_lanes is None else max_lanes
            if limit <= 0:
                return None
            due = self._pending_lanes >= limit or (
                time.monotonic()
                >= self._pending[0].t_enqueue + self.config.max_wait_s
            )
            if not due:
                return None
            if self._pending[0].lanes > limit:
                # the head request alone overflows the caller's free lanes:
                # not admissible yet (unlike the serving flush, admission
                # has a hard lane budget — no oversize bucket to grow into)
                return None
            return self._take_locked(limit)

    def ready(self) -> List[ServingRequest]:
        """The requests that :meth:`next_batch` would hand over now, by this
        batcher's own size and deadline, without taking them: what a rank
        of a lockstep flush offers its group before each rank takes its own
        (:meth:`take`).  Empty while no flush is due; a closed batcher
        offers everything it holds."""
        with self._cond:
            if not self._pending:
                return []
            if self._closed:
                return list(self._pending)
            due = self._pending_lanes >= self.config.max_batch or (
                time.monotonic() >= self._pending[0].t_enqueue + self.config.max_wait_s)
            if not due:
                return []
            out: List[ServingRequest] = []
            lanes = 0
            for req in self._pending:
                if out and lanes + req.lanes > self.config.max_batch:
                    break
                out.append(req)
                lanes += req.lanes
            return out

    def take(self, n_requests: int) -> List[ServingRequest]:
        """The ``n_requests`` oldest pending requests, whatever the flush
        predicate says: a rank that admits what another rank's
        :meth:`poll_batch` flushed from an identical queue, or what its own
        :meth:`ready` offered."""
        with self._cond:
            if n_requests > len(self._pending):
                raise RuntimeError(f"take({n_requests}) from a queue of {len(self._pending)}: "
                                   "the queues of ranks in lockstep drifted apart")
            batch = [self._pending.popleft() for _ in range(n_requests)]
            self._pending_lanes -= sum(r.lanes for r in batch)
            return batch

    def _take_locked(
        self, max_lanes: Optional[int] = None
    ) -> List[ServingRequest]:
        limit = self.config.max_batch if max_lanes is None else max_lanes
        batch: List[ServingRequest] = []
        lanes = 0
        while self._pending:
            nxt = self._pending[0]
            if batch and lanes + nxt.lanes > limit:
                break
            batch.append(self._pending.popleft())
            lanes += nxt.lanes
        self._pending_lanes -= lanes
        return batch

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "pending_requests": len(self._pending),
                "pending_lanes": self._pending_lanes,
                "shed_total": self.shed_total,
                "submitted_total": self.submitted_total,
            }
