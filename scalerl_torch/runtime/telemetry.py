"""Process-local metrics: counters, gauges, histograms and rate meters.

The part of ``scalerl_tpu/runtime/telemetry.py`` that the generation plane
calls: the four instruments, :class:`MetricsRegistry` (named instruments
plus snapshot-time bindings, nested into one tree by :meth:`snapshot`) and
the process-wide default registry.  The exporters, the aggregator, the
flight recorder and the digest-backed histogram are not ported yet.
Plain Python; instruments are bumped once per macro step or admission,
never per token.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


class Counter:
    """Monotonic event counter."""

    kind = "counter"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def read(self) -> float:
        return self._value


class Gauge:
    """Last-written value."""

    kind = "gauge"
    __slots__ = ("name", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def read(self) -> float:
        return self._value


class Histogram:
    """Count/sum/min/max plus a bounded reservoir for quantiles:
    deterministic systematic sampling (every k-th observation once full),
    so snapshots are reproducible."""

    kind = "histogram"
    __slots__ = ("name", "_lock", "count", "sum", "min", "max", "_reservoir",
                 "_cap", "_stride")

    def __init__(self, name: str, reservoir_size: int = 256) -> None:
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        self._cap = int(reservoir_size)
        self._stride = 1

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                self._stride += 1
                if self.count % self._stride == 0:
                    self._reservoir[self.count % self._cap] = v

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._reservoir:
                return 0.0
            data = sorted(self._reservoir)
        idx = min(len(data) - 1, max(0, int(q * (len(data) - 1))))
        return data[idx]

    def read(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0.0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                        "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            out = {
                "count": float(self.count),
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
            }
        out["p50"] = self.quantile(0.50)
        out["p95"] = self.quantile(0.95)
        out["p99"] = self.quantile(0.99)
        return out


class RateMeter:
    """Sliding-window event rate: ``rate()`` is events/second over the
    trailing ``window_s``; ``total`` is the lifetime event count."""

    kind = "meter"
    __slots__ = ("name", "window_s", "_lock", "_events", "total")

    def __init__(self, name: str, window_s: float = 30.0) -> None:
        self.name = name
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events: Deque[Tuple[float, float]] = deque()
        self.total = 0.0

    def mark(self, n: float = 1.0) -> None:
        t = time.monotonic()
        with self._lock:
            self.total += n
            self._events.append((t, float(n)))
            self._trim(t)

    def _trim(self, t: float) -> None:
        horizon = t - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        t = time.monotonic()
        with self._lock:
            self._trim(t)
            if not self._events:
                return 0.0
            n = sum(c for _, c in self._events)
            # observed span, floored at 1 s so a fresh burst reports a
            # per-second rate instead of an absurd instantaneous one
            span = max(t - max(self._events[0][0], t - self.window_s), 1.0)
        return n / span

    def read(self) -> Dict[str, float]:
        return {"rate": self.rate(), "total": self.total}


Instrument = Any  # Counter | Gauge | Histogram | RateMeter


class MetricsRegistry:
    """Thread-safe instrument registry with a nested snapshot tree.

    ``counter``/``gauge``/``histogram``/``meter`` return (creating once) the
    named instrument; ``bind(name, fn)`` registers a snapshot-time callable
    (scalar or dict subtree); a raising binding snapshots as an error
    string.  Dotted names nest in :meth:`snapshot`.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}
        self._bindings: Dict[str, Callable[[], Any]] = {}

    def _get(self, name: str, cls: type, factory: Callable[[str], Instrument]):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory(name)
                self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(f"instrument {name!r} is a {inst.kind}, not a {cls.kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram, Histogram)

    def meter(self, name: str) -> RateMeter:
        return self._get(name, RateMeter, RateMeter)

    def bind(self, name: str, fn: Callable[[], Any]) -> None:
        """Bind a snapshot-time callable at ``name``; rebinding replaces."""
        with self._lock:
            self._bindings[name] = fn

    def unbind(self, name: str) -> None:
        with self._lock:
            self._bindings.pop(name, None)

    def _values(self) -> Dict[str, Any]:
        with self._lock:
            instruments = dict(self._instruments)
            bindings = dict(self._bindings)
        flat: Dict[str, Any] = {name: inst.read() for name, inst in instruments.items()}
        for name, fn in bindings.items():
            try:
                flat[name] = fn()
            except Exception as e:  # noqa: BLE001 — a dead binding must not kill a snapshot
                flat[name] = f"<error: {e!r}>"
        return flat

    def snapshot(self) -> Dict[str, Any]:
        """One merged nested tree of every instrument and binding."""
        tree: Dict[str, Any] = {}
        for name, value in self._values().items():
            parts = name.split(".")
            node = tree
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    nxt = {} if nxt is None else {"_value": nxt}
                    node[p] = nxt
                node = nxt
            leaf = parts[-1]
            if isinstance(node.get(leaf), dict) and isinstance(value, dict):
                node[leaf].update(value)
            else:
                node[leaf] = value
        return tree


_LOCK = threading.Lock()
_REGISTRY: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def reset() -> None:
    """A fresh default registry (tests)."""
    global _REGISTRY
    with _LOCK:
        _REGISTRY = MetricsRegistry()
