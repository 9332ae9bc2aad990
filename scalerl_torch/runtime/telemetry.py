"""Process-local metrics: counters, gauges, histograms and rate meters,
their export, and the flight recorder.

Port of the parts of ``scalerl_tpu/runtime/telemetry.py`` that the
generation plane, the trainers and the process plane call: the four
instruments, :class:`MetricsRegistry` (named instruments plus snapshot-time
bindings, nested into one tree by :meth:`snapshot`, flattened by
:meth:`scalars`), the process-wide default registry, the export half the
trainers start by default: :class:`JsonlExporter` (one snapshot a line),
:class:`PrometheusExporter` (a text exposition file), the
:class:`TelemetryExportLoop` thread that drives both,
:func:`write_final_snapshot` and :func:`observe_train_metrics`; and the
:class:`FlightRecorder` (a bounded tail of structured events that the ring,
the transport, chaos and checkpoints write to, with :func:`record_event`,
:func:`get_recorder` and :func:`flight_dump_path`; an event recorded while
a span is active carries its trace id, through
:func:`set_trace_id_provider`).  A histogram keeps its quantiles in a
256-sample reservoir, or with ``backend="digest"`` in
``runtime/attribution.py``'s mergeable ``LatencyDigest``, which holds its
relative error at any count (the serving plane's latency SLOs).
:func:`observe_staleness` sets the one ``staleness`` gauge every
distribution path reports.  :meth:`MetricsRegistry.compact` is the fleet's
piggyback snapshot, and :class:`TelemetryAggregator` merges those snapshots
on the learner (``fleet/cluster.py`` binds its tree under ``fleet.*``).  Plain Python; instruments are bumped once per chunk, learn step,
flush or admission, never per token, and no device value enters one.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_DIR = "SCALERL_TELEMETRY_DIR"
ENV_HOST_ID = "SCALERL_HOST_ID"

_HOST_ID: Optional[str] = None


def host_id() -> str:
    """A stable identity of this process for merged artifacts (flight
    events order on ``(host_id, seq)``): ``SCALERL_HOST_ID`` when set, else
    ``<hostname>-<pid>``."""
    global _HOST_ID
    if _HOST_ID is None:
        env = os.environ.get(ENV_HOST_ID, "")
        if env:
            _HOST_ID = env
        else:
            import socket

            _HOST_ID = f"{socket.gethostname()}-{os.getpid()}"
    return _HOST_ID


# runtime/tracing.py registers its current-trace lookup here, so a flight
# event recorded while a span is active carries the trace id, without this
# module importing the tracer
_TRACE_ID_PROVIDER: Optional[Callable[[], Optional[str]]] = None


def set_trace_id_provider(fn: Optional[Callable[[], Optional[str]]]) -> None:
    global _TRACE_ID_PROVIDER
    _TRACE_ID_PROVIDER = fn


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
    """Count/sum/min/max plus a bounded quantile estimator, one of two
    backends:

    - ``"reservoir"`` (default): deterministic systematic sampling (every
      k-th observation once full), so snapshots are reproducible; fine for
      small counts, biased at the tail once the count dwarfs 256;
    - ``"digest"``: ``runtime/attribution.LatencyDigest``, whose quantiles
      stay within ``relative_error`` of the truth at any count and whose
      merge is exact; :meth:`read` adds a ``p999``.
    """

    kind = "histogram"
    __slots__ = ("name", "_lock", "count", "sum", "min", "max", "_reservoir",
                 "_cap", "_stride", "backend", "_digest")

    def __init__(self, name: str, reservoir_size: int = 256,
                 backend: str = "reservoir", relative_error: float = 0.01) -> None:
        if backend not in ("reservoir", "digest"):
            raise ValueError(f"unknown histogram backend {backend!r}")
        self.name = name
        self.backend = backend
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        self._cap = int(reservoir_size)
        self._stride = 1
        self._digest = None
        if backend == "digest":
            # deferred: attribution's module is not needed by reservoir users
            from scalerl_torch.runtime.attribution import LatencyDigest

            self._digest = LatencyDigest(relative_error=relative_error)

    def observe(self, v: float) -> None:
        v = float(v)
        if self._digest is not None:
            with self._lock:
                self.count += 1
                self.sum += v
                self.min = min(self.min, v)
                self.max = max(self.max, v)
            self._digest.observe(v)
            return
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
        if self._digest is not None:
            return self._digest.quantile(q)
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
        if self._digest is not None:
            out["p999"] = self.quantile(0.999)
        return out

    def digest_wire(self) -> Optional[Dict[str, Any]]:
        """The mergeable digest as a JSON-safe dict, or None on the
        reservoir backend."""
        return self._digest.to_wire() if self._digest is not None else None


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

    def histogram(self, name: str, reservoir_size: int = 256,
                  backend: str = "reservoir", relative_error: float = 0.01) -> Histogram:
        return self._get(name, Histogram, lambda n: Histogram(
            n, reservoir_size, backend=backend, relative_error=relative_error))

    def meter(self, name: str) -> RateMeter:
        return self._get(name, RateMeter, RateMeter)

    def bind(self, name: str, fn: Callable[[], Any]) -> None:
        """Bind a snapshot-time callable at ``name``; rebinding replaces."""
        with self._lock:
            self._bindings[name] = fn

    def unbind(self, name: str) -> None:
        with self._lock:
            self._bindings.pop(name, None)

    def set_gauges(self, values: Mapping[str, float], prefix: str = "") -> None:
        """Bulk gauge write of a host metric dict: every finite number lands
        as ``<prefix><key>``; a name already held by another instrument
        kind keeps that instrument."""
        for k, v in values.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if isinstance(v, float) and not math.isfinite(v):
                continue
            try:
                self.gauge(prefix + k).set(float(v))
            except TypeError:
                continue

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


    def scalars(self, prefix: str = "") -> Dict[str, float]:
        """Flat ``{dotted.name: float}`` view; histograms and meters expand
        to their summary fields (the loggers' and the exposition's input)."""
        out: Dict[str, float] = {}

        def emit(name: str, value: Any) -> None:
            if isinstance(value, dict):
                for k, v in value.items():
                    emit(f"{name}.{k}", v)
            elif isinstance(value, (bool, int, float)):
                out[name] = float(value)

        for name, value in self._values().items():
            emit(prefix + name, value)
        return out

    def compact(self, prefix: str = "") -> Dict[str, float]:
        """The fleet's piggyback view: :meth:`scalars` less the histograms'
        quantile, min, max and sum fields (counters, gauges, meter totals
        and rates, histogram count and mean), small enough to ride every
        heartbeat pong."""
        return {name: value for name, value in self.scalars(prefix).items()
                if not name.endswith((".p50", ".p95", ".p99", ".p999", ".min",
                                      ".max", ".sum"))}


# ---------------------------------------------------------------------------
# fleet aggregation (learner side)


class TelemetryAggregator:
    """Merge compact per-source snapshots into per-source and aggregate
    series (``scalerl_tpu/runtime/telemetry.py::TelemetryAggregator``).

    Sources are fleet peers: ``gather:<base_worker_id>`` uplinks and the
    ``worker:<id>`` payloads they relay.  :meth:`absorb` keeps the newest
    snapshot of a source (cumulative counters, so the newest is the series
    value) and its last-seen stamp; :meth:`aggregate` sums each key over the
    sources; :meth:`tree` is what the fleet binds under ``fleet.*``.  With
    ``max_sources > 0`` the stalest source is evicted when a new one would
    pass the cap (elastic churn mints a fresh source a respawn), and
    :meth:`evict_stale` drops every source silent past ``max_age_s``.
    """

    def __init__(self, max_sources: int = 0) -> None:
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict[str, float]] = {}
        self._seen: Dict[str, float] = {}
        self.frames_absorbed = 0
        self.max_sources = int(max_sources)
        self.evicted = 0

    def absorb(self, source: str, compact: Mapping[str, Any]) -> None:
        if not isinstance(compact, Mapping):
            return
        clean = {k: float(v) for k, v in compact.items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)}
        with self._lock:
            self._latest[str(source)] = clean
            self._seen[str(source)] = time.monotonic()
            self.frames_absorbed += 1
            while self.max_sources > 0 and len(self._latest) > self.max_sources:
                stalest = min(self._seen, key=self._seen.get)
                self._latest.pop(stalest, None)
                self._seen.pop(stalest, None)
                self.evicted += 1

    def evict_stale(self, max_age_s: float) -> int:
        """Drop every source silent for longer than ``max_age_s``; returns
        how many went."""
        horizon = time.monotonic() - max_age_s
        with self._lock:
            stale = [s for s, t in self._seen.items() if t < horizon]
            for src in stale:
                self._latest.pop(src, None)
                self._seen.pop(src, None)
            self.evicted += len(stale)
        return len(stale)

    def absorb_payload(self, payload: Any) -> None:
        """Absorb one piggybacked ``{"src": ..., "v": {...}, "workers": {id:
        {...}}}`` payload (the fleet's wire shape)."""
        if not isinstance(payload, Mapping):
            return
        src = payload.get("src")
        if src is not None:
            self.absorb(str(src), payload.get("v") or {})
        for wid, wsnap in (payload.get("workers") or {}).items():
            self.absorb(f"worker:{wid}", wsnap)

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._latest)

    def aggregate(self) -> Dict[str, float]:
        with self._lock:
            snaps = list(self._latest.values())
        agg: Dict[str, float] = {}
        for snap in snaps:
            for k, v in snap.items():
                agg[k] = agg.get(k, 0.0) + v
        return agg

    def tree(self) -> Dict[str, Any]:
        with self._lock:
            per_source = {src: dict(snap) for src, snap in self._latest.items()}
            seen = dict(self._seen)
        now = time.monotonic()
        return {
            "sources": len(per_source),
            "frames_absorbed": self.frames_absorbed,
            "evicted": self.evicted,
            "aggregate": self.aggregate(),
            "per_worker": {src: {**snap, "age_s": round(now - seen.get(src, now), 3)}
                           for src, snap in per_source.items()},
        }


# ---------------------------------------------------------------------------
# exporters


class JsonlExporter:
    """Append one ``{"t": ..., "snapshot": {...}}`` line per write."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, snapshot: Mapping[str, Any]) -> None:
        line = json.dumps({"t": time.time(), "snapshot": snapshot}, default=str)
        with open(self.path, "a") as f:
            f.write(line + "\n")


class PrometheusExporter:
    """A Prometheus text-exposition file, replaced atomically (tmp +
    rename); names sanitized to ``[a-zA-Z_][a-zA-Z0-9_]*`` under the
    ``scalerl_`` prefix, as the JAX package writes them."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @staticmethod
    def _sanitize(name: str) -> str:
        s = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
        if not s or not (s[0].isalpha() or s[0] == "_"):
            s = "_" + s
        return "scalerl_" + s

    def write(self, scalars: Mapping[str, float]) -> None:
        lines = []
        for name in sorted(scalars):
            v = scalars[name]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if isinstance(v, float) and not math.isfinite(v):
                v = 0.0
            lines.append(f"{self._sanitize(name)} {v}")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, self.path)


class TelemetryExportLoop:
    """A thread writing ``telemetry.jsonl`` and ``metrics.prom`` into
    ``out_dir`` every ``interval_s`` seconds from one registry;
    :meth:`flush` writes at once, :meth:`stop` flushes a last time so the
    files hold the final state."""

    def __init__(
        self,
        out_dir: str,
        interval_s: float = 30.0,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.out_dir = out_dir
        self.interval_s = float(interval_s)
        self.registry = registry
        self.jsonl = JsonlExporter(os.path.join(out_dir, "telemetry.jsonl"))
        self.prom = PrometheusExporter(os.path.join(out_dir, "metrics.prom"))
        self.writes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _registry(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def flush(self) -> None:
        reg = self._registry()
        try:
            self.jsonl.write(reg.snapshot())
            self.prom.write(reg.scalars())
            self.writes += 1
        except Exception:  # noqa: BLE001 — an exporter must never kill the run
            logger.exception("telemetry export failed")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def start(self) -> "TelemetryExportLoop":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="telemetry-export",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.flush()

    def __enter__(self) -> "TelemetryExportLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# flight recorder


class FlightRecorder:
    """Bounded ring buffer of recent structured events.

    ``record(kind, **fields)`` is a deque append under a lock, safe from
    any thread; only the newest ``capacity`` events are kept, so a long run
    still dumps a readable tail on failure."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self.total_recorded = 0

    def record(self, kind: str, **fields: Any) -> None:
        evt = {"t_wall": time.time(), "t_mono": time.monotonic(), "kind": kind,
               "host_id": host_id()}
        if _TRACE_ID_PROVIDER is not None:
            try:
                tid = _TRACE_ID_PROVIDER()
            except Exception:  # noqa: BLE001 — stamping must never fail a record
                tid = None
            if tid:
                evt["trace"] = tid
        if fields:
            evt.update(fields)
        with self._lock:
            evt["seq"] = self.total_recorded  # monotonic per process
            self._events.append(evt)
            self.total_recorded += 1

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The retained tail, oldest first; ``kind`` filters to one kind."""
        with self._lock:
            evts = list(self._events)
        if kind is None:
            return evts
        return [e for e in evts if e.get("kind") == kind]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump_text(self) -> str:
        evts = self.events()
        if not evts:
            return "<flight recorder empty>"
        lines = [f"flight recorder: last {len(evts)} events "
                 f"({self.total_recorded} total recorded, capacity {self.capacity})"]
        for e in evts:
            extra = {k: v for k, v in e.items()
                     if k not in ("t_wall", "t_mono", "kind", "host_id", "seq")}
            stamp = time.strftime("%H:%M:%S", time.localtime(e["t_wall"]))
            lines.append(f"  [{stamp}] {e['kind']} {extra}" if extra
                         else f"  [{stamp}] {e['kind']}")
        return "\n".join(lines)

    def dump_json(self, path: str) -> str:
        """Write the tail as ``{"events": [...]}``; returns the path.  A
        failure is logged, never raised: dumps run on failure paths."""
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump({"total_recorded": self.total_recorded, "capacity": self.capacity,
                           "events": self.events()}, f, default=str)
        except Exception as e:  # noqa: BLE001 — a dump failure must not mask the crash
            logger.warning("flight recorder dump to %s failed: %r", path, e)
        return path


_LOCK = threading.Lock()
_REGISTRY: Optional[MetricsRegistry] = None
_RECORDER: Optional[FlightRecorder] = None


def get_registry() -> MetricsRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def get_recorder() -> FlightRecorder:
    """The process-wide flight recorder (``SCALERL_FLIGHT_EVENTS`` events,
    256 by default)."""
    global _RECORDER
    if _RECORDER is None:
        with _LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder(
                    int(os.environ.get("SCALERL_FLIGHT_EVENTS", "256") or 256))
    return _RECORDER


def reset() -> None:
    """A fresh default registry and flight recorder (tests)."""
    global _REGISTRY, _RECORDER
    with _LOCK:
        _REGISTRY = MetricsRegistry()
        _RECORDER = FlightRecorder()


def record_event(kind: str, **fields: Any) -> None:
    """Record one structured event on the default flight recorder."""
    get_recorder().record(kind, **fields)


def snapshot() -> Dict[str, Any]:
    """The merged tree of the default registry."""
    return get_registry().snapshot()


def flight_dump_path(tag: str) -> str:
    """Where failure-path flight dumps land: ``SCALERL_TELEMETRY_DIR`` when
    set, else the system tempdir."""
    import tempfile

    out_dir = os.environ.get(ENV_DIR, "") or tempfile.gettempdir()
    return os.path.join(out_dir, f"scalerl_flight_{tag}_{os.getpid()}.json")


def write_final_snapshot(out_dir: str) -> str:
    """Write ``final_snapshot.json`` (the merged tree and the flight
    recorder's tail) into ``out_dir``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "final_snapshot.json")
    payload = {"t": time.time(), "pid": os.getpid(), "snapshot": get_registry().snapshot(),
               "flight_recorder": get_recorder().events()}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, default=str)
    os.replace(tmp, path)
    return path


def observe_train_metrics(host_metrics: Optional[Mapping[str, Any]]) -> None:
    """Fold one chunk's or learn step's host metric dict into the registry:
    the all-finite guard's ``skipped_steps`` and ``nonfinite_grads`` add
    to the ``train.`` counters.  Host floats only (the output of
    ``runtime.dispatch.get_metrics``), so it never adds a device copy."""
    if not host_metrics:
        return
    reg = get_registry()

    def _num(key: str) -> float:
        try:
            f = float(host_metrics.get(key, 0.0))
        except (TypeError, ValueError):
            return 0.0
        return f if math.isfinite(f) else 0.0

    skipped = _num("skipped_steps")
    nonfinite = _num("nonfinite_grads")
    if skipped > 0.0:
        reg.counter("train.skipped_steps").inc(skipped)
    if nonfinite > 0.0:
        reg.counter("train.nonfinite_grads").inc(nonfinite)


def observe_staleness(lag_steps: float, plane: str = "") -> float:
    """Set the unified ``staleness`` gauge: learner steps behind the newest
    generation, the one staleness definition every distribution path
    reports (computed by ``ParamSnapshotPlane.staleness_steps``).  ``plane``
    also stamps ``staleness_plane.<plane>``, so a process with several
    planes can tell the reporters apart."""
    lag = float(max(lag_steps, 0.0))
    reg = get_registry()
    reg.gauge("staleness").set(lag)
    if plane:
        reg.gauge(f"staleness_plane.{plane}").set(lag)
    return lag
