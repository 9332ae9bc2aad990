"""Streaming tier-latency attribution: mergeable digests and the online
edge walk.

Port of ``scalerl_tpu/runtime/attribution.py`` (jax-free there too):

- :class:`LatencyDigest`: a DDSketch-style log-bucket sketch.  Fixed
  γ-spaced buckets (γ = (1+α)/(1−α) for a relative error α) hold integer
  counts, so every quantile is within α of the truth at any count, and a
  merge is exact bucket-wise addition (associative and commutative).  The
  telemetry histogram's ``backend="digest"`` is one of these.
- :func:`build_traces`, :func:`attribute_edges` (a cursor walk over
  sibling spans) and :func:`attribute_tiers` (an innermost-wins sweep over
  nested spans): each charges every interval of [trace start, trace end]
  to exactly one named edge or tier, so the parts sum to the end-to-end
  latency exactly.
- :class:`TierLedger`: subscribed to the tracer's finished-span feed
  (``runtime/tracing.py``), it buffers each sampled trace's spans,
  decomposes the trace when its root ends and feeds one digest a tier;
  :meth:`TierLedger.bottleneck` names the tier with the largest p95.

Every stamp is a host ``time.monotonic()`` the span sites already took.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# the mergeable log-bucket digest

# values at or below this are "zero" latencies (clock granularity noise);
# they get their own exact bucket instead of a -inf bucket index
MIN_TRACKABLE = 1e-9


class LatencyDigest:
    """Fixed-γ log-bucket quantile sketch with exact merge.

    Bucket ``i`` covers ``(γ^(i-1), γ^i]``; a value reports back as the
    bucket midpoint-in-log-space ``2·γ^i/(γ+1)``, which is within the
    configured ``relative_error`` of the true value — for EVERY quantile,
    at ANY count.  ``merge`` is bucket-wise integer addition (associative,
    commutative, exact), so digests built on different hosts/threads
    compose without bias, unlike reservoir union.

    Bounded: when the bucket map would exceed ``max_buckets``, the LOWEST
    buckets collapse into one (DDSketch's collapsing strategy) — the upper
    tail, which is what an SLO gate reads, keeps full resolution.
    Thread-safe; ``observe`` is a dict increment under a lock.
    """

    __slots__ = ("relative_error", "gamma", "_log_gamma", "_lock", "count",
                 "sum", "min", "max", "zero_count", "_buckets",
                 "max_buckets", "_collapsed_at")

    def __init__(self, relative_error: float = 0.01,
                 max_buckets: int = 1024) -> None:
        if not 0.0 < relative_error < 1.0:
            raise ValueError(f"relative_error must be in (0, 1): {relative_error}")
        self.relative_error = float(relative_error)
        self.gamma = (1.0 + self.relative_error) / (1.0 - self.relative_error)
        self._log_gamma = math.log(self.gamma)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zero_count = 0
        self._buckets: Dict[int, int] = {}
        self.max_buckets = max(int(max_buckets), 8)
        self._collapsed_at: Optional[int] = None  # lowest live index after a collapse

    # -- ingest ----------------------------------------------------------
    def _index(self, v: float) -> int:
        return int(math.ceil(math.log(v) / self._log_gamma - 1e-12))

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if v <= MIN_TRACKABLE:
                self.zero_count += 1
                return
            i = self._index(v)
            if self._collapsed_at is not None and i < self._collapsed_at:
                i = self._collapsed_at
            self._buckets[i] = self._buckets.get(i, 0) + 1
            if len(self._buckets) > self.max_buckets:
                self._collapse()

    def observe_array(self, values: Any) -> None:
        """Bulk ingest via one vectorized bucketing pass — the replay
        harness and tests feed millions of samples without a Python loop
        per value."""
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        pos = arr[arr > MIN_TRACKABLE]
        with self._lock:
            self.count += int(arr.size)
            self.sum += float(arr.sum())
            self.min = min(self.min, float(arr.min()))
            self.max = max(self.max, float(arr.max()))
            self.zero_count += int(arr.size - pos.size)
            if pos.size:
                idx = np.ceil(np.log(pos) / self._log_gamma - 1e-12).astype(np.int64)
                if self._collapsed_at is not None:
                    idx = np.maximum(idx, self._collapsed_at)
                uniq, counts = np.unique(idx, return_counts=True)
                for i, c in zip(uniq.tolist(), counts.tolist()):
                    self._buckets[i] = self._buckets.get(i, 0) + c
                if len(self._buckets) > self.max_buckets:
                    self._collapse()

    def _collapse(self) -> None:
        # called under the lock: fold the lowest buckets together until the
        # map fits — tail resolution is untouched
        while len(self._buckets) > self.max_buckets:
            lows = sorted(self._buckets)[:2]
            lo, nxt = lows[0], lows[1]
            self._buckets[nxt] += self._buckets.pop(lo)
            self._collapsed_at = nxt

    # -- read ------------------------------------------------------------
    def _value_of(self, i: int) -> float:
        return 2.0 * math.pow(self.gamma, i) / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        q = min(max(float(q), 0.0), 1.0)
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * (self.count - 1)
            seen = self.zero_count
            if rank < seen:
                return 0.0
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                if rank < seen:
                    # clamp into the observed range: the bucket midpoint of
                    # the extreme buckets may overshoot min/max slightly
                    return min(max(self._value_of(i), self.min), self.max)
            return self.max

    def read(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0.0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                        "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                        "p999": 0.0}
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
        out["p999"] = self.quantile(0.999)
        return out

    # -- compose ---------------------------------------------------------
    def merge(self, other: "LatencyDigest") -> "LatencyDigest":
        """Fold ``other`` into self (exact integer addition per bucket).
        Both digests must share γ — merging different error bounds would
        silently degrade the tighter one."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"digest gamma mismatch: {self.gamma} vs {other.gamma}"
            )
        with other._lock:
            o_count, o_sum = other.count, other.sum
            o_min, o_max = other.min, other.max
            o_zero = other.zero_count
            o_buckets = dict(other._buckets)
        with self._lock:
            self.count += o_count
            self.sum += o_sum
            self.min = min(self.min, o_min)
            self.max = max(self.max, o_max)
            self.zero_count += o_zero
            for i, c in o_buckets.items():
                if self._collapsed_at is not None and i < self._collapsed_at:
                    i = self._collapsed_at
                self._buckets[i] = self._buckets.get(i, 0) + c
            if len(self._buckets) > self.max_buckets:
                self._collapse()
        return self

    def to_wire(self) -> Dict[str, Any]:
        """JSON-safe snapshot (string bucket keys) for the ``_telem``
        piggyback / artifact files; :meth:`from_wire` round-trips it."""
        with self._lock:
            return {
                "relerr": self.relative_error,
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "zero": self.zero_count,
                "buckets": {str(i): c for i, c in self._buckets.items()},
            }

    @classmethod
    def from_wire(cls, node: Mapping[str, Any],
                  max_buckets: int = 1024) -> "LatencyDigest":
        d = cls(relative_error=float(node.get("relerr", 0.01)),
                max_buckets=max_buckets)
        d.count = int(node.get("count", 0))
        d.sum = float(node.get("sum", 0.0))
        if d.count:
            d.min = float(node.get("min", math.inf))
            d.max = float(node.get("max", -math.inf))
        d.zero_count = int(node.get("zero", 0))
        d._buckets = {
            int(i): int(c) for i, c in (node.get("buckets") or {}).items()
        }
        return d


# ---------------------------------------------------------------------------
# the exact-sum edge walk


def build_traces(spans: List[Dict]) -> Dict[str, Dict[str, Any]]:
    """Group span records by trace id; identify each trace's root and
    orphans; stamp the [t0, t1] envelope and ``e2e``."""
    traces: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        traces.setdefault(s["trace"], {"spans": []})["spans"].append(s)
    for t in traces.values():
        ids = {s["span"] for s in t["spans"]}
        t["root"] = next(
            (s for s in t["spans"] if not s.get("parent")), None
        )
        t["orphans"] = [
            s for s in t["spans"]
            if s.get("parent") and s["parent"] not in ids
        ]
        t0 = min(float(s["t0"]) for s in t["spans"])
        t1 = max(float(s["t0"]) + float(s["dur"]) for s in t["spans"])
        if t["root"] is not None:
            t0 = min(t0, float(t["root"]["t0"]))
        t["t0"], t["t1"] = t0, t1
        t["e2e"] = max(t1 - t0, 0.0)
    return traces


def _walk(
    trace: Mapping[str, Any],
    name_of: Callable[[Dict[str, Any]], str],
    gap_of: Callable[[bool, bool], str],
) -> Dict[str, float]:
    """The clip-overlap/fill-gap cursor walk behind
    :func:`attribute_edges`: charge every interval of [start, end] to
    exactly one label; the values sum to ``e2e`` by construction.
    ``gap_of(is_head, is_tail)`` names un-spanned intervals.  Sequential
    (sibling) spans decompose exactly; NESTED spans resolve to the
    earlier-starting (enclosing) one — the traffic plane's nested shape
    uses :func:`attribute_tiers`'s innermost-wins sweep instead."""
    edges: Dict[str, float] = {}
    start, end = trace["t0"], trace["t1"]
    root = trace["root"]
    children = sorted(
        (
            s for s in trace["spans"]
            if root is None or s["span"] != root["span"]
        ),
        key=lambda s: float(s["t0"]),
    )
    cursor = start
    seen_child = False
    for s in children:
        s0 = max(float(s["t0"]), cursor)
        s1 = min(float(s["t0"]) + float(s["dur"]), end)
        if s0 > cursor:
            gap = gap_of(not seen_child, False)
            edges[gap] = edges.get(gap, 0.0) + (s0 - cursor)
            cursor = s0
        if s1 > cursor:
            name = name_of(s)
            edges[name] = edges.get(name, 0.0) + (s1 - cursor)
            cursor = s1
            seen_child = True
    if end > cursor:
        gap = gap_of(not seen_child, True)
        edges[gap] = edges.get(gap, 0.0) + (end - cursor)
    return edges


def attribute_edges(trace: Mapping[str, Any]) -> Dict[str, float]:
    """Charge every interval of [trace start, trace end] to exactly one
    edge (or ``untracked``): walk the child spans in start order, clip to
    the un-attributed suffix, fill holes with ``untracked``.  The values
    sum to ``e2e`` by construction."""
    return _walk(trace, lambda s: s["name"], lambda head, tail: "untracked")


# span-name -> tier name for the traffic plane.  Traffic spans NEST —
# ``router.route`` (admit -> client-bound reply) encloses the replica's
# ``serve.*`` spans — so the tier walk is an INNERMOST-WINS sweep: at
# every instant the latest-starting covering span is the most specific
# stage the request is in.  ``router.dispatch`` therefore collects
# exactly the intervals spent inside the router but NOT inside a replica
# span: admit + routing decision + replica-link send on the way out, and
# the reply hop back through the router on the way in.
TRAFFIC_TIERS = {
    "router.route": "router.dispatch",
    "serve.queue_wait": "replica.queue",
    "serve.flush": "replica.flush",
}
TIER_HEAD_GAP = "client.dispatch"   # trace start -> first tracked edge
TIER_INTERIOR_GAP = "wire.gap"      # holes between tracked edges
TIER_TAIL_GAP = "reply.wire"        # last tracked edge -> trace end

# roots the traffic plane decomposes (bench/replay fire traffic.request;
# a plain RemotePolicyClient.act fires serve.request)
TRAFFIC_ROOTS = ("traffic.request", "serve.request")


def attribute_tiers(
    trace: Mapping[str, Any],
    tiers: Optional[Mapping[str, str]] = None,
) -> Dict[str, float]:
    """Exact-sum tier decomposition for NESTED traffic spans.

    A boundary sweep over the child spans' elementary intervals: each
    interval of [trace start, trace end] is charged to the covering span
    with the LATEST start (innermost wins — the most specific stage;
    :func:`attribute_edges`'s cursor walk would let the enclosing
    ``router.route`` swallow the replica's nested spans).  Edge names map
    through ``tiers``; uncovered intervals are named by POSITION — the
    head gap is the client's dispatch leg (fire -> router admit: client
    queueing + the request wire), interior gaps are untracked
    wire/handoff time, and the tail gap is the reply leg (last tracked
    stamp -> client wakeup).  Values sum to ``e2e`` by construction (the
    elementary intervals partition [start, end])."""
    mapping = TRAFFIC_TIERS if tiers is None else tiers
    start, end = float(trace["t0"]), float(trace["t1"])
    root = trace["root"]
    ivals: List[Tuple[float, float, Dict[str, Any]]] = []
    for s in trace["spans"]:
        if root is not None and s["span"] == root["span"]:
            continue
        s0 = max(float(s["t0"]), start)
        s1 = min(float(s["t0"]) + float(s["dur"]), end)
        if s1 > s0:
            ivals.append((s0, s1, s))
    cuts = sorted({start, end,
                   *(p for s0, s1, _ in ivals for p in (s0, s1))})
    segs: List[Tuple[float, float, Optional[str]]] = []
    for a, b in zip(cuts, cuts[1:]):
        cover = [
            (s0, s1, s) for s0, s1, s in ivals if s0 <= a and s1 >= b
        ]
        if cover:
            # innermost wins: latest start; ties break to the shorter
            # (more deeply nested) span
            _, _, s = max(cover, key=lambda c: (c[0], -(c[1] - c[0])))
            segs.append((a, b, mapping.get(s["name"], s["name"])))
        else:
            segs.append((a, b, None))
    covered = [i for i, (_, _, n) in enumerate(segs) if n is not None]
    first_cov = covered[0] if covered else None
    last_cov = covered[-1] if covered else None
    edges: Dict[str, float] = {}
    for i, (a, b, name) in enumerate(segs):
        if name is None:
            if first_cov is None or i < first_cov:
                name = TIER_HEAD_GAP
            elif i > last_cov:
                name = TIER_TAIL_GAP
            else:
                name = TIER_INTERIOR_GAP
        edges[name] = edges.get(name, 0.0) + (b - a)
    return edges


# ---------------------------------------------------------------------------
# the online ledger


class TierLedger:
    """Online per-trace tier decomposition feeding per-tier digests.

    Subscribe with :meth:`attach` (``tracing.get_tracer().add_listener``):
    every finished-span record is buffered by trace id; the moment a
    trace's ROOT ends (roots end last — the client stamps e2e), the
    buffered spans decompose via :func:`attribute_tiers` and each tier's
    duration lands in its :class:`LatencyDigest`.  Counters:

    - ``decomposed`` — roots fully attributed (the completeness numerator);
    - ``late_spans`` — spans arriving for an already-decomposed trace
      (duplicate replies after first-reply-wins dedup; never re-opened,
      never double-charged);
    - ``orphans`` — buffered traces that never saw a root (evicted at the
      ``max_pending`` cap or counted at :meth:`drain`);
    - ``max_sum_err`` — the largest |Σedges − e2e| ever observed (exactness
      is by construction; this is the float-noise witness).

    ``registry`` binding: ``reg.bind("attr", ledger.tree)`` exposes the
    per-tier quantiles + shares in every telemetry snapshot with zero
    hot-path cost.  Single-process scope: the ledger sees the spans its
    process records (an in-process router and replicas record every tier);
    across hosts the per-host span files are merged offline instead.
    """

    def __init__(
        self,
        roots: Tuple[str, ...] = TRAFFIC_ROOTS,
        relative_error: float = 0.01,
        max_pending: int = 8192,
        tiers: Optional[Mapping[str, str]] = None,
        registry: Any = None,
        bind_as: str = "attr",
    ) -> None:
        self.roots = tuple(roots)
        self.relative_error = float(relative_error)
        self.tiers = dict(TRAFFIC_TIERS if tiers is None else tiers)
        self.max_pending = max(int(max_pending), 1)
        self._lock = threading.Lock()
        # trace id -> buffered span records (insertion-ordered for the
        # bounded evict: the stalest trace goes first)
        self._pending: "OrderedDict[str, List[Dict[str, Any]]]" = OrderedDict()
        # recently decomposed trace ids: late spans (duplicate replies) are
        # counted, never mistaken for orphans or re-decomposed
        self._done: Deque[str] = deque(maxlen=4096)
        self._done_set: set = set()
        self.digests: Dict[str, LatencyDigest] = {}
        self.totals: Dict[str, float] = {}  # exact per-tier attributed seconds
        self.decomposed = 0
        self.orphans = 0
        self.late_spans = 0
        self.max_sum_err = 0.0
        self._e2e = LatencyDigest(relative_error=self.relative_error)
        if registry is not None:
            registry.bind(bind_as, self.tree)

    # -- feed ------------------------------------------------------------
    def attach(self, tracer: Any) -> "TierLedger":
        tracer.add_listener(self.ingest)
        return self

    def detach(self, tracer: Any) -> None:
        tracer.remove_listener(self.ingest)

    def ingest(self, rec: Mapping[str, Any]) -> None:
        """One finished-span record (the tracer-listener entry point).
        Host-side dict work only — never called with device values."""
        tid = rec.get("trace")
        if not tid:
            return
        is_root = not rec.get("parent") and rec.get("name") in self.roots
        with self._lock:
            if tid in self._done_set:
                self.late_spans += 1
                return
            buf = self._pending.get(tid)
            if buf is None:
                if not is_root and rec.get("name") not in self.tiers:
                    # a span family this ledger does not track (seq.*,
                    # snapshot.*): never buffered, never an orphan
                    return
                buf = self._pending[tid] = []
                while len(self._pending) > self.max_pending:
                    # bounded: evict the stalest rootless trace as orphaned
                    self._pending.popitem(last=False)
                    self.orphans += 1
            buf.append(dict(rec))
            if not is_root:
                return
            spans = self._pending.pop(tid)
            self._done.append(tid)
            self._done_set.add(tid)
            while len(self._done_set) > self._done.maxlen:
                # deque evicted its oldest on append; mirror into the set
                self._done_set = set(self._done)
        self._decompose(tid, spans)

    def _decompose(self, tid: str, spans: List[Dict[str, Any]]) -> None:
        trace = build_traces(spans)[tid]
        edges = attribute_tiers(trace, self.tiers)
        e2e = trace["e2e"]
        err = abs(sum(edges.values()) - e2e)
        with self._lock:
            self.decomposed += 1
            self.max_sum_err = max(self.max_sum_err, err)
            for tier, dur in edges.items():
                self.totals[tier] = self.totals.get(tier, 0.0) + dur
                d = self.digests.get(tier)
                if d is None:
                    d = self.digests[tier] = LatencyDigest(
                        relative_error=self.relative_error
                    )
            # digest observes outside self._lock would race tier creation;
            # LatencyDigest has its own lock, and observe below is cheap
        for tier, dur in edges.items():
            self.digests[tier].observe(dur)
        self._e2e.observe(e2e)

    def drain(self) -> int:
        """End of run: count every still-buffered (rootless) trace as
        orphaned and clear.  Returns the number drained."""
        with self._lock:
            n = len(self._pending)
            self.orphans += n
            self._pending.clear()
        return n

    # -- read ------------------------------------------------------------
    def e2e_digest(self) -> LatencyDigest:
        return self._e2e

    def tree(self) -> Dict[str, Any]:
        """The registry binding: per-tier digest summary + exact share,
        plus the ledger counters — evaluated only at snapshot time."""
        with self._lock:
            totals = dict(self.totals)
            tiers = list(self.digests)
            pending = len(self._pending)
        grand = sum(totals.values()) or 1.0
        out: Dict[str, Any] = {
            "decomposed": self.decomposed,
            "orphans": self.orphans,
            "late_spans": self.late_spans,
            "pending": pending,
            "max_sum_err_s": self.max_sum_err,
            "e2e": self._e2e.read(),
        }
        for tier in tiers:
            row = self.digests[tier].read()
            row["share"] = totals.get(tier, 0.0) / grand
            row["total_s"] = totals.get(tier, 0.0)
            out[tier.replace(".", "_")] = row
        return out

    def bottleneck(self) -> Dict[str, Any]:
        """The verdict: the tier with the largest p95 share of the critical
        path, its digest quantiles, and the exact-sum attribution table
        (shares sum to 1 over the decomposed traces)."""
        with self._lock:
            totals = dict(self.totals)
            tiers = list(self.digests)
        grand = sum(totals.values()) or 1.0
        table: Dict[str, Dict[str, float]] = {}
        for tier in tiers:
            d = self.digests[tier]
            table[tier] = {
                "share": round(totals.get(tier, 0.0) / grand, 4),
                "total_s": round(totals.get(tier, 0.0), 6),
                "p50_ms": round(d.quantile(0.50) * 1e3, 3),
                "p95_ms": round(d.quantile(0.95) * 1e3, 3),
                "p99_ms": round(d.quantile(0.99) * 1e3, 3),
                "count": d.count,
            }
        p95_total = sum(row["p95_ms"] for row in table.values()) or 1.0
        for row in table.values():
            row["p95_share"] = round(row["p95_ms"] / p95_total, 4)
        bottleneck = max(
            table, key=lambda t: table[t]["p95_ms"], default=""
        ) if table else ""
        return {
            "bottleneck_tier": bottleneck,
            "tiers": table,
            "decomposed": self.decomposed,
            "orphans": self.orphans,
            "late_spans": self.late_spans,
            "max_sum_err_s": self.max_sum_err,
            "e2e_p50_ms": round(self._e2e.quantile(0.50) * 1e3, 3),
            "e2e_p95_ms": round(self._e2e.quantile(0.95) * 1e3, 3),
            "e2e_p99_ms": round(self._e2e.quantile(0.99) * 1e3, 3),
            "relative_error": self.relative_error,
        }
