"""The generation plane's host-side modules in the PyTorch port against the
JAX package: the same seeded sequence of calls goes to the port's copy and
to the JAX package's module, and every return value, error and statistic
must be equal.  Covers ``PageAllocator``/``rewind_pages``,
``PrefixCache``, ``DynamicBatcher``, the bucket ladder, the telemetry
subset, head-sampled spans and the parameter snapshot plane.
"""

import numpy as np
import pytest
import torch

from scalerl_torch.genrl import paging as tpaging
from scalerl_torch.genrl import prefix_cache as tprefix
from scalerl_torch.runtime import telemetry as ttelemetry
from scalerl_torch.runtime import tracing as ttracing
from scalerl_torch.runtime.param_server import ParamSnapshotPlane
from scalerl_torch.serving import batcher as tbatcher
from scalerl_torch.utils import buckets as tbuckets
from scalerl_tpu.genrl import paging as jpaging
from scalerl_tpu.genrl import prefix_cache as jprefix
from scalerl_tpu.runtime import telemetry as jtelemetry
from scalerl_tpu.serving import batcher as jbatcher
from scalerl_tpu.utils import buckets as jbuckets

torch.set_num_threads(1)


def _call(fn, *args, **kw):
    """(result, error type and message) of one call."""
    try:
        return fn(*args, **kw), None
    except (RuntimeError, ValueError) as e:
        return None, (type(e).__name__, str(e))


@pytest.fixture(scope="module")
def op_script():
    """A seeded script of allocator and cache operations, shared by the
    tests below: (op, args) with lane holders and prompt prefixes drawn
    so that shares, hits, evictions and bad frees all happen.  Both
    packages' default registries start fresh, so the cache's counters do
    not carry what earlier tests in this process counted."""
    ttelemetry.reset()
    jtelemetry.reset()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 6, size=int(rng.integers(1, 14))).astype(np.int32)
               for _ in range(12)]
    ops = []
    for _ in range(400):
        kind = rng.choice(["reserve", "release", "alloc", "share", "free", "rewind",
                           "lookup", "insert", "evict", "flush"],
                          p=[.12, .08, .2, .08, .18, .06, .1, .1, .06, .02])
        ops.append((str(kind), int(rng.integers(0, 1 << 30))))
    return prompts, ops


def _run_script(paging, prefix, prompts, ops):
    """Play ``ops`` against one package's allocator + cache; returns the
    trace of results, errors and stats."""
    a = paging.PageAllocator(24, 4)
    c = prefix.PrefixCache(a, 4)
    a.set_reclaim_hook(c.evict)
    held = {f"lane[{i}]": [] for i in range(4)}
    trace = []
    for kind, seed in ops:
        r = np.random.default_rng(seed)
        lane = f"lane[{int(r.integers(0, 4))}]"
        if kind == "reserve":
            out = _call(a.try_reserve, int(r.integers(1, 6)))
        elif kind == "release":
            out = _call(a.release, int(r.integers(1, 4)))
        elif kind == "alloc":
            out = _call(a.alloc, int(r.integers(1, 4)), holder=lane)
            if out[0]:
                held[lane].extend(out[0])
        elif kind == "share":
            other = held[f"lane[{int(r.integers(0, 4))}]"]
            pages = other[:int(r.integers(1, 3))]
            out = _call(a.share, pages, holder=lane)
            if out[1] is None:
                held[lane].extend(pages)
        elif kind == "free":
            pages = held[lane][:int(r.integers(1, 3))]
            if r.random() < 0.1:
                pages = pages + [int(r.integers(0, 24))]  # maybe a bad free
            out = _call(a.free, pages, holder=lane)
            if out[1] is None:
                del held[lane][:len(pages)]
        elif kind == "rewind":
            out = _call(paging.rewind_pages, a, held[lane], int(r.integers(0, 4)), holder=lane)
        elif kind == "lookup":
            p = prompts[int(r.integers(0, len(prompts)))]
            out = _call(c.lookup, p, int(r.integers(0, len(p) + 1)))
        elif kind == "insert":
            p = prompts[int(r.integers(0, len(prompts)))]
            pages = held[lane]
            out = _call(c.insert, p, len(p), list(pages))
        elif kind == "evict":
            out = _call(c.evict, int(r.integers(1, 4)))
        else:
            out = _call(c.flush)
        trace.append((kind, out, a.stats(), c.stats(), sorted(a._free)))
    return trace


def test_allocator_and_prefix_cache_match_jax(op_script):
    prompts, ops = op_script
    jax_trace = _run_script(jpaging, jprefix, prompts, ops)
    port_trace = _run_script(tpaging, tprefix, prompts, ops)
    assert len(port_trace) == len(jax_trace)
    kinds = {k for k, out, *_ in jax_trace if out[1] is None}
    assert {"alloc", "share", "free", "insert", "lookup", "evict"} <= kinds
    assert any(out[1] is not None for _, out, *_ in jax_trace)  # errors exercised
    for i, (got, want) in enumerate(zip(port_trace, jax_trace)):
        assert got == want, f"op {i}: {got} != {want}"


def test_rewind_pages_matches_jax():
    for paging in (tpaging, jpaging):
        a = paging.PageAllocator(10, 2)
        pages = a.alloc(5, holder="lane[0]")
        a.share(pages[:2], holder="lane[1]")
        assert paging.rewind_pages(a, pages, 3, holder="lane[0]") == 2
        assert len(pages) == 3 and a.stats()["allocated"] == 3
        with pytest.raises(ValueError, match="keep_pages"):
            paging.rewind_pages(a, pages, -1)


@pytest.mark.parametrize("size", [1, 2, 3, 7, 8, 64, 100, 257])
def test_buckets_match_jax(size):
    assert tbuckets.default_buckets(size) == jbuckets.default_buckets(size)
    for ladder in ((), (8,), (1, 4, 16), tbuckets.default_buckets(size)):
        for s in (1, size, 2 * size + 1):
            assert tbuckets.bucket_for(s, ladder) == jbuckets.bucket_for(s, ladder)


def test_batcher_poll_batch_and_sheds_match_jax():
    rng = np.random.default_rng(1)
    script = [(int(rng.integers(1, 5)), int(rng.integers(0, 9)), float(rng.random()))
              for _ in range(120)]
    traces = []
    for mod in (tbatcher, jbatcher):
        b = mod.DynamicBatcher(mod.ServingConfig(max_batch=8, max_wait_s=1e9, max_pending=6))
        trace = []
        for i, (lanes, limit, late) in enumerate(script):
            req = mod.ServingRequest(conn=None, req_id=i, lanes=lanes, payload={"i": i},
                                     t_enqueue=0.0 if late < 0.3 else 1e12)
            trace.append(("submit", b.submit(req)))
            if i % 3 == 0:
                got = b.poll_batch(max_lanes=limit)
                trace.append(("poll", None if got is None else [r.req_id for r in got]))
            trace.append(("stats", b.stats()))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert any(s == ("submit", False) for s in traces[0])  # sheds happened


def test_telemetry_subset_matches_jax():
    treg, jreg = ttelemetry.MetricsRegistry(), jtelemetry.MetricsRegistry()
    rng = np.random.default_rng(2)
    values = rng.exponential(size=700)
    for reg in (treg, jreg):
        reg.counter("genrl.admitted").inc(3)
        reg.gauge("genrl.lane_occupancy").set(0.25)
        for v in values:
            reg.histogram("genrl.admission_latency_s").observe(v)
        reg.bind("genrl.pages", lambda: {"free": 4, "allocated": 2})
        reg.bind("genrl.broken", lambda: 1 / 0)
    t, j = treg.snapshot(), jreg.snapshot()
    assert t["genrl"]["admitted"] == j["genrl"]["admitted"] == 3.0
    assert t["genrl"]["pages"] == j["genrl"]["pages"]
    assert t["genrl"]["admission_latency_s"] == j["genrl"]["admission_latency_s"]
    assert t["genrl"]["broken"].startswith("<error")
    for q in (0.5, 0.95, 0.99):
        assert (treg.histogram("genrl.admission_latency_s").quantile(q)
                == jreg.histogram("genrl.admission_latency_s").quantile(q))
    with pytest.raises(TypeError, match="not a counter"):
        treg.counter("genrl.lane_occupancy")
    m = treg.meter("genrl.decode_tokens_per_s")
    m.mark(100)
    assert m.read()["total"] == 100 and m.rate() > 0
    treg.unbind("genrl.broken")
    assert "broken" not in treg.snapshot()["genrl"]


def test_spans_are_off_by_default_and_sampled_when_on(monkeypatch):
    monkeypatch.delenv(ttracing.ENV_SAMPLE, raising=False)
    ttracing.reset()
    assert not ttracing.sampling_enabled()
    assert ttracing.record_span("genrl.macro_step", None, 1.0, 2.0) is ttracing.NOOP_SPAN
    ttracing.reset(sample_rate=1.0)
    try:
        root = ttracing.record_span("genrl.macro_step", None, 1.0, 2.0, kind="genrl", lanes=4)
        child = ttracing.record_span("seq.verify", root, 1.5, 2.0)
        spans = ttracing.get_tracer().finished()
        assert [s["name"] for s in spans] == ["genrl.macro_step", "seq.verify"]
        assert child.trace_id == root.trace_id and child.parent_id == root.span_id
        assert spans[1]["trace"] == spans[0]["trace"] and spans[1]["parent"] == spans[0]["span"]
        assert root.attrs == {"lanes": 4} and spans[0]["dur"] == 1.0
    finally:
        ttracing.reset(sample_rate=0.0)


class _Plane(ParamSnapshotPlane):
    def __init__(self, params):
        self._init_param_plane(params, torch.device("cpu"))


def test_param_snapshot_plane_copies_and_tags_generations():
    live = {"w": torch.ones(3)}
    plane = _Plane(live)
    snap, gen = plane._snapshot_params()
    assert gen == 0 and snap["w"] is not live["w"]
    live["w"].add_(1.0)  # the learner updates in place: the snapshot holds
    assert torch.equal(plane._snapshot_params()[0]["w"], torch.ones(3))
    assert plane.push_params(live, learner_step=10) == 1
    assert plane.push_params(live, learner_step=15) == 2
    assert torch.equal(plane._snapshot_params()[0]["w"], torch.full((3,), 2.0))
    assert plane.staleness_steps(1) == 5.0 and plane.staleness_steps(2) == 0.0
    # a quantized push stores int8 and dequantizes on read, within half a
    # scale step of the source
    assert plane.push_params({"w": torch.ones(3), "m": torch.eye(3)}, quantize="int8") == 3
    snap = plane._snapshot_params()[0]
    assert torch.equal(snap["w"], torch.ones(3)) and torch.allclose(snap["m"], torch.eye(3))
    assert plane.generation == 3
