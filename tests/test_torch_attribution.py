"""Parity of the port's tier attribution (``scalerl_torch/runtime/attribution.py``)
and the telemetry additions that ride it, with the JAX package's.

- ``LatencyDigest``: the same streams (one at a time and in bulk, with zero
  latencies and a collapse past ``max_buckets``) give equal quantiles,
  reads, merges (either order) and wire dicts; a merge across the packages'
  wire forms round-trips;
- ``build_traces``, ``attribute_edges`` and ``attribute_tiers`` give the
  same per-edge and per-tier sums on the same span lists (nested, requeued,
  gapped and root-only traces, and 200 random ones), each summing to the
  end-to-end latency;
- ``TierLedger`` fed the same finished-span records reaches the same
  verdict, late spans and orphans;
- ``Histogram(backend="digest")`` and ``observe_staleness`` read like the
  JAX registry's.
"""

import numpy as np
import pytest

from scalerl_torch.runtime import attribution as tattr
from scalerl_torch.runtime import telemetry as ttel
from scalerl_tpu.runtime import attribution as jattr
from scalerl_tpu.runtime import telemetry as jtel


def _streams():
    rng = np.random.default_rng(0)
    return {
        "lognormal": rng.lognormal(-4.0, 1.0, 20_000),
        "with_zeros": np.concatenate([np.zeros(50), rng.exponential(0.01, 5_000)]),
        "wide": 10.0 ** rng.uniform(-8, 3, 5_000),
    }


@pytest.mark.parametrize("name", ["lognormal", "with_zeros", "wide"])
@pytest.mark.parametrize("bulk", [False, True])
def test_digest_quantiles_match_jax(name, bulk):
    data = _streams()[name]
    digests = []
    for mod in (jattr, tattr):
        d = mod.LatencyDigest(relative_error=0.01, max_buckets=256)
        if bulk:
            d.observe_array(data)
        else:
            for v in data:
                d.observe(v)
        digests.append(d)
    j, t = digests
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
    assert t.read() == j.read() and t.to_wire() == j.to_wire()
    # the relative-error guarantee, on the port's side
    exact = np.quantile(data, 0.99, method="lower")
    if exact > 1e-6:
        assert abs(t.quantile(0.99) - exact) <= 0.011 * exact + 1e-12


def test_digest_merges_match_jax_in_either_order():
    rng = np.random.default_rng(1)
    parts = [rng.lognormal(-3.0, 1.5, 3_000) for _ in range(3)]

    def merged(mod, order):
        ds = []
        for p in parts:
            d = mod.LatencyDigest(max_buckets=128)
            d.observe_array(p)
            ds.append(d)
        acc = mod.LatencyDigest(max_buckets=128)
        for i in order:
            acc.merge(ds[i])
        return acc.to_wire()

    for order in ((0, 1, 2), (2, 0, 1)):
        assert merged(tattr, order) == merged(jattr, order)
    # the wire form crosses the packages
    j = jattr.LatencyDigest()
    j.observe_array(parts[0])
    t = tattr.LatencyDigest.from_wire(j.to_wire())
    assert t.to_wire() == j.to_wire() and t.quantile(0.95) == j.quantile(0.95)
    with pytest.raises(ValueError, match="gamma"):
        tattr.LatencyDigest(0.01).merge(tattr.LatencyDigest(0.02))


def _span(trace, span, parent, name, t0, dur):
    return {"trace": trace, "span": span, "parent": parent, "name": name, "kind": "serving",
            "host": "h", "t0": t0, "dur": dur, "attrs": {}}


FIXED = {
    "nested": [_span("t", "r", None, "traffic.request", 0.0, 1.0),
               _span("t", "a", "r", "router.route", 0.1, 0.8),
               _span("t", "b", "r", "serve.queue_wait", 0.2, 0.3),
               _span("t", "c", "r", "serve.flush", 0.5, 0.3)],
    "requeued": [_span("t", "r", None, "traffic.request", 0.0, 2.0),
                 _span("t", "a1", "r", "router.route", 0.1, 1.7),
                 _span("t", "q1", "r", "serve.queue_wait", 0.2, 0.2),
                 _span("t", "f1", "r", "serve.flush", 0.4, 0.3),
                 _span("t", "q2", "r", "serve.queue_wait", 0.9, 0.4),
                 _span("t", "f2", "r", "serve.flush", 1.3, 0.4)],
    "gapped": [_span("t", "r", None, "traffic.request", 0.0, 1.0),
               _span("t", "b", "r", "serve.queue_wait", 0.2, 0.2),
               _span("t", "c", "r", "serve.flush", 0.6, 0.2)],
    "root_only": [_span("t", "r", None, "traffic.request", 0.0, 0.5)],
    "orphan": [_span("t", "x", "gone", "serve.flush", 0.1, 0.2),
               _span("t", "y", None, "serve.request", 0.0, 0.4)],
}


def _random_traces(n=200):
    rng = np.random.default_rng(2)
    names = ["router.route", "serve.queue_wait", "serve.flush", "seq.decode", "other"]
    out = []
    for k in range(n):
        e2e = float(rng.uniform(0.01, 2.0))
        spans = [_span(f"t{k}", "r", None, "traffic.request", 0.0, e2e)]
        for i in range(int(rng.integers(0, 7))):
            t0 = float(rng.uniform(-0.1, e2e))
            spans.append(_span(f"t{k}", f"s{i}", "r", names[rng.integers(0, len(names))], t0,
                               float(rng.uniform(0.0, e2e))))
        out.append(spans)
    return out


@pytest.mark.parametrize("walk", ["attribute_edges", "attribute_tiers"])
def test_edge_and_tier_sums_match_jax(walk):
    cases = list(FIXED.values()) + _random_traces()
    for spans in cases:
        jt, tt = jattr.build_traces(spans), tattr.build_traces(spans)
        assert {k: (v["t0"], v["t1"], v["e2e"], len(v["orphans"])) for k, v in tt.items()} == \
            {k: (v["t0"], v["t1"], v["e2e"], len(v["orphans"])) for k, v in jt.items()}
        for tid in tt:
            got = getattr(tattr, walk)(tt[tid])
            assert got == getattr(jattr, walk)(jt[tid])
            assert abs(sum(got.values()) - tt[tid]["e2e"]) < 1e-9
    nested = tattr.attribute_tiers(tattr.build_traces(FIXED["nested"])["t"])
    assert nested["router.dispatch"] == pytest.approx(0.2)
    assert nested[tattr.TIER_HEAD_GAP] == pytest.approx(0.1)


def _records():
    """Finished-span records of 30 traffic traces, a late duplicate, a
    rootless trace and an untracked family, in arrival order (roots last)."""
    recs = []
    rng = np.random.default_rng(3)
    for k in range(30):
        t0 = float(k)
        tid = f"tr{k}"
        q = float(rng.uniform(0.001, 0.004))
        f = float(rng.uniform(0.002, 0.006))
        recs += [_span(tid, "q", "root", "serve.queue_wait", t0 + 0.002, q),
                 _span(tid, "f", "root", "serve.flush", t0 + 0.002 + q, f),
                 _span(tid, "a", "root", "router.route", t0 + 0.001, q + f + 0.002),
                 _span(tid, "root", None, "traffic.request", t0, q + f + 0.005)]
    recs.append(_span("tr3", "late", "root", "serve.flush", 3.5, 0.1))
    recs.append(_span("dangling", "f", "root", "serve.flush", 40.0, 0.1))
    recs.append(_span("seq", "d", "root", "seq.decode", 41.0, 0.1))
    return recs


def test_tier_ledger_verdict_matches_jax():
    out = []
    for mod in (jattr, tattr):
        ledger = mod.TierLedger(max_pending=16)
        for rec in _records():
            ledger.ingest(rec)
        drained = ledger.drain()
        out.append((ledger.bottleneck(), drained, ledger.late_spans, ledger.orphans,
                    {k: v for k, v in ledger.tree().items()}))
    assert out[1] == out[0]
    bn = out[1][0]
    assert bn["decomposed"] == 30 and out[1][1:4] == (1, 1, 1)
    assert sum(r["share"] for r in bn["tiers"].values()) == pytest.approx(1.0, abs=1e-3)


def test_tier_ledger_listens_to_the_port_tracer():
    from scalerl_torch.runtime import tracing

    tracing.reset(sample_rate=1.0)
    try:
        tracer = tracing.get_tracer()
        ledger = tattr.TierLedger(registry=ttel.MetricsRegistry()).attach(tracer)
        root = tracing.start_span("traffic.request", kind="serving")
        t0 = root.t_start
        tracing.record_span("router.route", root, t0 + 0.001, t0 + 0.009, kind="serving")
        tracing.record_span("serve.flush", root, t0 + 0.004, t0 + 0.008, kind="serving")
        root.end(t_end=t0 + 0.010)
        assert ledger.decomposed == 1 and ledger.max_sum_err < 1e-9
        assert set(ledger.digests) == {"client.dispatch", "router.dispatch", "replica.flush",
                                       "reply.wire"}
        ledger.detach(tracer)
    finally:
        tracing.reset(sample_rate=0.0)


def test_digest_histogram_and_staleness_read_like_jax():
    data = _streams()["lognormal"][:3_000]
    reads = []
    for mod in (jtel, ttel):
        reg = mod.MetricsRegistry()
        h = reg.histogram("serving.latency_s", backend="digest")
        for v in data:
            h.observe(v)
        reads.append((h.read(), h.digest_wire(), reg.histogram("plain").digest_wire(),
                      reg.scalars()))
    assert reads[1] == reads[0] and "p999" in reads[1][0]
    with pytest.raises(ValueError, match="backend"):
        ttel.Histogram("x", backend="t-digest")
    lags = []
    for mod in (jtel, ttel):
        mod.reset()
        lags.append((mod.observe_staleness(-3.0), mod.observe_staleness(7.0, plane="serving"),
                     mod.get_registry().gauge("staleness").value,
                     mod.get_registry().gauge("staleness_plane.serving").value))
    assert lags[1] == lags[0] == (0.0, 7.0, 7.0, 7.0)
