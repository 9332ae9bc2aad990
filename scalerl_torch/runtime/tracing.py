"""Cross-tier tracing: head-sampled spans, their context over the wire,
the per-host JSONL sink and the clock-skew estimator.

Port of ``scalerl_tpu/runtime/tracing.py`` (jax-free there too):

- :class:`Span` / :class:`SpanContext`: trace, span and parent ids, the
  host id, and host ``time.monotonic()`` stamps only, so a span never reads
  the device to stamp a time.  Wall time comes from one (wall, monotonic)
  anchor a process (:func:`wall_of`); aligning hosts is one offset a host,
  which :class:`ClockSkewEstimator` measures off the heartbeat ping/pong
  round trips (:func:`observe_pong`, fed by ``fleet/hub.py``).
- Head sampling: a root is kept with probability ``SCALERL_TRACE_SAMPLE``
  (default 0: the loops pay one float compare, :func:`sampling_enabled`);
  a span with a parent always records, so descendants follow their root's
  decision across processes.  Finished spans land in a bounded ring
  (``SCALERL_TRACE_SPANS``) and go to every listener
  (:meth:`Tracer.add_listener`; ``runtime/attribution.py::TierLedger``
  subscribes there).
- Propagation rides frames that already flow: any protocol dict may carry
  a ``{"tid", "sid"}`` context under the ``trace`` key (:func:`inject`,
  :func:`extract`): the serving ``act`` requests, the router's forwards.
- :func:`record_span` records a span after the fact from two stamps the
  call site already took (the generation engines and the serving plane use
  it), so tracing adds no blocking call to a loop.
- With ``SCALERL_TRACE_DIR`` set every finished span is appended, a line at
  a time, to ``spans_<host>_<pid>.jsonl`` beside a meta line and the skew
  offsets (:func:`export_skew`).

Flight events recorded while a span is active on a thread carry its trace
id (``telemetry.set_trace_id_provider``).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional

from scalerl_torch.runtime import telemetry
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_SAMPLE = "SCALERL_TRACE_SAMPLE"
ENV_DIR = "SCALERL_TRACE_DIR"
ENV_SPANS = "SCALERL_TRACE_SPANS"

# the wire piggyback key: any protocol dict may carry one
# {"tid": ..., "sid": ...} context under this key
TRACE_KEY = "trace"

# one (wall, monotonic) anchor per process: every span's wall time is
# anchor_wall + (t_mono - anchor_mono), so a wall-clock step mid-run moves
# NOTHING (the timers.py lesson) and cross-host alignment reduces to one
# per-host offset
_ANCHOR_WALL = time.time()
_ANCHOR_MONO = time.monotonic()


def wall_of(t_mono: float) -> float:
    """Map a ``time.monotonic()`` stamp onto this process's wall anchor."""
    return _ANCHOR_WALL + (t_mono - _ANCHOR_MONO)


def new_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """The propagated identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> Dict[str, str]:
        return {"tid": self.trace_id, "sid": self.span_id}

    @classmethod
    def from_wire(cls, node: Any) -> Optional["SpanContext"]:
        if not isinstance(node, Mapping):
            return None
        tid, sid = node.get("tid"), node.get("sid")
        if not (isinstance(tid, str) and isinstance(sid, str)):
            return None
        return cls(tid, sid)

    def __repr__(self) -> str:  # debugging aid in stall dumps
        return f"SpanContext({self.trace_id}/{self.span_id})"


class Span:
    """One recorded operation.  Created by :meth:`Tracer.start_span`;
    ``end()`` (idempotent) hands it to the tracer's ring + sink."""

    __slots__ = (
        "name", "kind", "trace_id", "span_id", "parent_id", "host",
        "t_start", "t_end", "attrs", "_tracer", "_ended",
    )
    sampled = True

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        kind: str,
        t_start: float,
        attrs: Dict[str, Any],
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.host = telemetry.host_id()
        self.t_start = t_start  # monotonic
        self.t_end: Optional[float] = None
        self.attrs = attrs
        self._ended = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self, t_end: Optional[float] = None, **attrs: Any) -> None:
        """Finish the span at ``t_end`` (``time.monotonic()``, default now).
        Host-side stamps ONLY — never materialize a device value to end a
        span."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.t_end = t_end if t_end is not None else time.monotonic()
        self._tracer._finish(self)

    def to_record(self) -> Dict[str, Any]:
        t_end = self.t_end if self.t_end is not None else self.t_start
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "host": self.host,
            "t0": wall_of(self.t_start),
            "dur": max(t_end - self.t_start, 0.0),
            "attrs": self.attrs,
        }

    # context-manager protocol: activates the span for FlightRecorder
    # trace stamping, ends it on exit
    def __enter__(self) -> "Span":
        self._tracer._push_active(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        self._tracer._pop_active(self)
        self.end()


class _NoopSpan:
    """The unsampled root: every operation is a no-op, ``context`` is None
    so :func:`inject` stays silent and descendants stay unsampled."""

    __slots__ = ()
    sampled = False
    context = None
    trace_id = None

    def end(self, t_end: Optional[float] = None, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def _context_of(parent: Any) -> Optional[SpanContext]:
    """Normalize a parent argument: Span, SpanContext, wire dict, or None."""
    if parent is None or parent is NOOP_SPAN:
        return None
    if isinstance(parent, SpanContext):
        return parent
    ctx = getattr(parent, "context", None)
    if isinstance(ctx, SpanContext):
        return ctx
    return SpanContext.from_wire(parent)


class Tracer:
    """Head-sampling span factory with a bounded finished-span ring and an
    optional per-host JSONL sink (``SCALERL_TRACE_DIR``)."""

    def __init__(
        self,
        sample_rate: Optional[float] = None,
        capacity: Optional[int] = None,
        out_dir: Optional[str] = None,
    ) -> None:
        if sample_rate is None:
            sample_rate = float(os.environ.get(ENV_SAMPLE, "0") or 0.0)
        if capacity is None:
            capacity = int(os.environ.get(ENV_SPANS, "4096") or 4096)
        self.sample_rate = max(0.0, min(float(sample_rate), 1.0))
        self.capacity = max(int(capacity), 1)
        self.out_dir = out_dir if out_dir is not None else os.environ.get(
            ENV_DIR, ""
        )
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = deque()
        self.dropped = 0
        self._sink = None
        self._sink_path: Optional[str] = None
        self._tls = threading.local()
        self._rng = random.Random(os.urandom(8))
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []

    # -- sampling + span creation ---------------------------------------
    def _sample(self) -> bool:
        if self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        return self._rng.random() < self.sample_rate

    def start_span(
        self,
        name: str,
        parent: Any = None,
        kind: str = "",
        t_start: Optional[float] = None,
        **attrs: Any,
    ):
        """A new span.  ``parent`` is a Span, SpanContext, wire dict, or
        None; with None the HEAD sampling decision is made here (rate 0 =
        free no-op), with a parent the span always records — descendants
        follow their root's decision across process boundaries.
        ``t_start`` is an optional ``time.monotonic()`` stamp for
        retroactive spans."""
        ctx = _context_of(parent)
        if ctx is None:
            if not self._sample():
                return NOOP_SPAN
            trace_id, parent_id = new_id(), None
        else:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        span = Span(
            self,
            name,
            trace_id,
            new_id(),
            parent_id,
            kind,
            t_start if t_start is not None else time.monotonic(),
            dict(attrs),
        )
        telemetry.get_registry().counter("trace.spans_started").inc()
        return span

    # -- finished-span plumbing -----------------------------------------
    def _finish(self, span: Span) -> None:
        rec = span.to_record()
        reg = telemetry.get_registry()
        reg.counter("trace.spans_finished").inc()
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
                reg.counter("trace.spans_dropped").inc()
            self._ring.append(rec)
            self._sink_write(rec)
            listeners = list(self._listeners)
        # outside the ring lock: a listener (the TierLedger's online feed)
        # may take its own locks and must never be able to deadlock a span
        # end against finished()/clear()
        for fn in listeners:
            try:
                fn(rec)
            except Exception as e:  # noqa: BLE001 — a listener must never kill a span site
                logger.warning("trace listener failed: %r", e)

    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Subscribe ``fn`` to every finished-span record (called after the
        ring append, outside the ring lock).  This is how the streaming
        tier attribution (``runtime/attribution.py``) consumes spans ONLINE
        without polling the bounded ring — same records the JSONL sink
        writes, zero extra stamps."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def finished(self) -> List[Dict[str, Any]]:
        """The retained span records, oldest first (bounded ring)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- active-span stack (FlightRecorder linkage) ---------------------
    def _push_active(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop_active(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()

    def current_span(self):
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def activate(self, parent: Any):
        """Context manager: make ``parent`` (Span/SpanContext/wire dict)
        the active trace for this thread WITHOUT creating a new span —
        flight events recorded inside carry its trace id."""
        return _Activation(self, _context_of(parent))

    # -- the per-host JSONL sink ----------------------------------------
    def _ensure_sink(self) -> bool:
        # called under self._lock; opens the per-host file + meta line once
        if self._sink is not None:
            return True
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            host = "".join(
                ch if ch.isalnum() or ch in "-_" else "_"
                for ch in telemetry.host_id()
            )
            self._sink_path = os.path.join(
                self.out_dir, f"spans_{host}_{os.getpid()}.jsonl"
            )
            self._sink = open(self._sink_path, "a", buffering=1)
            self._sink.write(
                json.dumps(
                    {
                        "kind": "meta",
                        "host": telemetry.host_id(),
                        "pid": os.getpid(),
                        "anchor_wall": _ANCHOR_WALL,
                    },
                    default=str,
                )
                + "\n"
            )
            return True
        except Exception as e:  # noqa: BLE001 — the sink must never kill a span site
            logger.warning("trace sink open failed: %r", e)
            self.out_dir = ""
            return False

    # "meta"/"skew" are span-file record kinds read offline, not wire
    # frames: no receive pump ever dispatches on them
    def _sink_write(self, obj: Dict[str, Any]) -> None:
        # called under self._lock.  Line-per-record append on a
        # line-buffered file: a SIGTERM'd host (no atexit) loses at most
        # the line in flight.
        if not self.out_dir or not self._ensure_sink():
            return
        try:
            self._sink.write(json.dumps(obj, default=str) + "\n")
        except Exception as e:  # noqa: BLE001
            logger.warning("trace sink write failed: %r", e)
            self.out_dir = ""  # stop retrying a broken sink

    def export_skew(self, estimator: Optional["ClockSkewEstimator"] = None) -> None:
        """Append this process's per-peer clock-skew offsets to the span
        file (``trace_report`` aligns other hosts' spans with them)."""
        est = estimator if estimator is not None else get_skew()
        with self._lock:
            if not self.out_dir:
                return
            self._sink_write(
                {"kind": "skew", "host": telemetry.host_id(),
                 "offsets": est.offsets()}
            )

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
                self._sink = None


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_span")

    def __init__(self, tracer: Tracer, ctx: Optional[SpanContext]) -> None:
        self._tracer = tracer
        self._ctx = ctx
        self._span = None

    def __enter__(self) -> Optional[SpanContext]:
        if self._ctx is not None:
            # a context-only activation rides the same stack as real spans
            holder = _CtxHolder(self._ctx)
            self._span = holder
            self._tracer._push_active(holder)
        return self._ctx

    def __exit__(self, *exc: Any) -> None:
        if self._span is not None:
            self._tracer._pop_active(self._span)


class _CtxHolder:
    """A stack entry for :meth:`Tracer.activate`: carries a trace id
    without being a recordable span."""

    __slots__ = ("trace_id", "context")
    sampled = True

    def __init__(self, ctx: SpanContext) -> None:
        self.trace_id = ctx.trace_id
        self.context = ctx


# ---------------------------------------------------------------------------
# wire propagation


def inject(msg: Dict[str, Any], parent: Any) -> Dict[str, Any]:
    """Stamp ``msg[TRACE_KEY]`` with the parent's context (no-op for
    unsampled/None parents).  Returns ``msg`` for chaining."""
    ctx = _context_of(parent)
    if ctx is not None and isinstance(msg, dict):
        msg[TRACE_KEY] = ctx.to_wire()
    return msg


def extract(msg: Any) -> Optional[SpanContext]:
    """The propagated context riding ``msg`` (dict with a ``trace`` key),
    or None.  Never mutates the message."""
    if not isinstance(msg, Mapping):
        return None
    return SpanContext.from_wire(msg.get(TRACE_KEY))


# ---------------------------------------------------------------------------
# clock-skew estimation off the existing heartbeat ping/pong RTTs


class ClockSkewEstimator:
    """Per-peer wall-clock offset from (ping t_send, pong rt, recv time).

    The classic NTP bound: ``offset = t_peer - (t_send + rtt / 2)``.  The
    sample taken at the smallest observed RTT is the tightest bound, so
    that one wins (an EWMA would let slow, asymmetric samples smear it).
    Offsets are measured at the OBSERVER — ``trace_report`` subtracts
    ``offset[host]`` from that host's span times to align every file on
    the observer's clock.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # peer -> (best_rtt, offset_at_best_rtt, samples)
        self._peers: Dict[str, List[float]] = {}

    def observe(
        self, peer: str, t_send: float, t_peer: float, t_recv: float
    ) -> None:
        rtt = max(t_recv - t_send, 0.0)
        offset = t_peer - (t_send + rtt / 2.0)
        with self._lock:
            entry = self._peers.get(peer)
            if entry is None:
                self._peers[peer] = [rtt, offset, 1.0]
            else:
                entry[2] += 1.0
                if rtt <= entry[0]:
                    entry[0], entry[1] = rtt, offset

    def offset(self, peer: str) -> float:
        with self._lock:
            entry = self._peers.get(peer)
            return entry[1] if entry is not None else 0.0

    def offsets(self) -> Dict[str, float]:
        with self._lock:
            return {p: e[1] for p, e in self._peers.items()}

    def samples(self, peer: str) -> int:
        with self._lock:
            entry = self._peers.get(peer)
            return int(entry[2]) if entry is not None else 0


def observe_pong(msg: Mapping[str, Any], t_recv: Optional[float] = None) -> None:
    """Feed one heartbeat pong into the default skew estimator.  Pongs
    carry the original ping's wall ``t`` plus the responder's ``rt`` and
    ``host`` (``supervisor.make_pong``); the hub calls this from its recv
    pump, so every heartbeat interval refreshes every link's offset with
    zero extra traffic."""
    if not isinstance(msg, Mapping):
        return
    peer, t_send, t_peer = msg.get("host"), msg.get("t"), msg.get("rt")
    if not peer or not isinstance(t_send, (int, float)) or not isinstance(
        t_peer, (int, float)
    ):
        return
    get_skew().observe(
        str(peer), float(t_send), float(t_peer),
        t_recv if t_recv is not None else time.time(),
    )


# ---------------------------------------------------------------------------
# process-wide defaults

_LOCK = threading.Lock()
_TRACER: Optional[Tracer] = None
_SKEW: Optional[ClockSkewEstimator] = None


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        with _LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def get_skew() -> ClockSkewEstimator:
    global _SKEW
    if _SKEW is None:
        with _LOCK:
            if _SKEW is None:
                _SKEW = ClockSkewEstimator()
    return _SKEW


def reset(sample_rate: Optional[float] = None) -> None:
    """Fresh default tracer + skew estimator, re-reading the env unless
    ``sample_rate`` is given (tests)."""
    global _TRACER, _SKEW
    with _LOCK:
        if _TRACER is not None:
            _TRACER.close()
        _TRACER = Tracer(sample_rate)
        _SKEW = ClockSkewEstimator()


def start_span(name: str, parent: Any = None, kind: str = "", **attrs: Any):
    return get_tracer().start_span(name, parent=parent, kind=kind, **attrs)


def record_span(
    name: str,
    parent: Any,
    t_start: float,
    t_end: float,
    kind: str = "",
    **attrs: Any,
):
    """One-shot retroactive span from two ``time.monotonic()`` stamps the
    call site already took — the sanctioned hot-path idiom: no device
    value, no extra syscalls inside the loop."""
    span = get_tracer().start_span(
        name, parent=parent, kind=kind, t_start=t_start, **attrs
    )
    span.end(t_end=t_end)
    return span


def current_trace_id() -> Optional[str]:
    span = get_tracer().current_span()
    return getattr(span, "trace_id", None) if span is not None else None


def sampling_enabled() -> bool:
    """Cheap hot-loop predicate: is there any chance a root samples?"""
    return get_tracer().sample_rate > 0.0


def export_skew() -> None:
    get_tracer().export_skew()


# FlightRecorder linkage: every flight event recorded while a span (or an
# activate()d context) is live on this thread carries its trace id
telemetry.set_trace_id_provider(current_trace_id)
