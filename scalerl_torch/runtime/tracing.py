"""Head-sampled host spans: the part of ``scalerl_tpu/runtime/tracing.py``
that the generation engines call.

:func:`sampling_enabled` is the cheap hot-loop predicate and
:func:`record_span` records one retroactive span from two
``time.monotonic()`` stamps the call site already took, so tracing never
adds a device read to a loop.  The sample rate comes from
``SCALERL_TRACE_SAMPLE`` (default 0: off, the loops pay one float compare).
Finished spans land in a bounded ring of ``RING_SPANS`` read by
:meth:`Tracer.finished`.  Context propagation over the wire,
the JSONL sink and the clock-skew estimator are not ported yet.
"""

from __future__ import annotations

import os
import random
import threading
import uuid
from collections import deque
from typing import Any, Deque, Dict, List, Optional

ENV_SAMPLE = "SCALERL_TRACE_SAMPLE"
RING_SPANS = 4096


class Tracer:
    """Root spans are kept with probability ``sample_rate``; a span with a
    parent follows its parent's decision (it exists only if the parent was
    kept)."""

    def __init__(self, sample_rate: Optional[float] = None) -> None:
        if sample_rate is None:
            sample_rate = float(os.environ.get(ENV_SAMPLE, "0") or 0.0)
        self.sample_rate = max(0.0, min(float(sample_rate), 1.0))
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=RING_SPANS)

    def _sample_root(self) -> bool:
        if self.sample_rate <= 0.0:
            return False
        return self.sample_rate >= 1.0 or self._rng.random() < self.sample_rate

    def record(self, name: str, parent: Optional[Dict[str, Any]], t_start: float,
               t_end: float, kind: str = "", **attrs: Any) -> Optional[Dict[str, Any]]:
        if parent is None and not self._sample_root():
            return None
        span = {
            "name": name,
            "kind": kind,
            "trace_id": parent["trace_id"] if parent else uuid.uuid4().hex,
            "span_id": uuid.uuid4().hex[:16],
            "parent_id": parent["span_id"] if parent else None,
            "t_start": t_start,
            "t_end": t_end,
            "attrs": attrs,
        }
        with self._lock:
            self._ring.append(span)
        return span

    def finished(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)


_LOCK = threading.Lock()
_TRACER: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        with _LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def reset(sample_rate: Optional[float] = None) -> None:
    """A fresh default tracer, re-reading the environment unless
    ``sample_rate`` is given (tests)."""
    global _TRACER
    with _LOCK:
        _TRACER = Tracer(sample_rate)


def record_span(name: str, parent: Any, t_start: float, t_end: float,
                kind: str = "", **attrs: Any) -> Optional[Dict[str, Any]]:
    """One retroactive span from two host monotonic stamps; returns the
    span (a parent for child spans) or None when the root was not
    sampled."""
    return get_tracer().record(name, parent, t_start, t_end, kind=kind, **attrs)


def sampling_enabled() -> bool:
    """Cheap hot-loop predicate: is there any chance a root samples?"""
    return get_tracer().sample_rate > 0.0
