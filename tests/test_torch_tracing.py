"""Parity of the port's tracing (``scalerl_torch/runtime/tracing.py``) and
the supervisor's heartbeat vocabulary with the JAX package's.

- Wire context: a frame the JAX package's tracer injects and its codec
  packs extracts in the port to the same trace and span, and the reverse;
  malformed contexts extract to None in both;
- the clock-skew estimator gives equal offsets and sample counts on the
  same pongs, and both packages' pongs carry the same keys;
- head sampling, the bounded ring, retroactive stamps, the listener feed,
  and flight events stamped with the active trace id;
- the per-host JSONL sink writes what the JAX package's
  ``tools/trace_report.py`` reads: the same report from the port's file as
  from the JAX package's for the same spans.
"""

import json
import os
import time

import numpy as np
import pytest

from scalerl_torch.fleet import framing as tframing
from scalerl_torch.runtime import supervisor as tsup
from scalerl_torch.runtime import telemetry as ttel
from scalerl_torch.runtime import tracing as ttr
from scalerl_tpu.fleet import framing as jframing
from scalerl_tpu.runtime import supervisor as jsup
from scalerl_tpu.runtime import tracing as jtr


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(ttr.ENV_DIR, raising=False)
    for mod in (ttr, jtr):
        mod.reset()
    yield
    monkeypatch.delenv(ttr.ENV_SAMPLE, raising=False)
    monkeypatch.delenv(ttr.ENV_DIR, raising=False)
    for mod in (ttr, jtr):
        mod.reset()


def _arm(monkeypatch, tmp_path=None):
    monkeypatch.setenv(ttr.ENV_SAMPLE, "1.0")
    if tmp_path is not None:
        monkeypatch.setenv(ttr.ENV_DIR, str(tmp_path))
    for mod in (ttr, jtr):
        mod.reset()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_context_injected_in_one_package_extracts_in_the_other(monkeypatch, direction):
    _arm(monkeypatch)
    src_tr, src_codec, dst_tr, dst_codec = (
        (jtr, jframing, ttr, tframing) if direction == "jax_to_port"
        else (ttr, tframing, jtr, jframing))
    root = src_tr.start_span("serve.request", kind="serving")
    msg = src_tr.inject({"kind": "act", "req": 3, "obs": np.arange(6, dtype=np.float32)}, root)
    frame = src_codec.pack_message(msg)
    decoded = dst_codec.unpack_message(frame)
    ctx = dst_tr.extract(decoded)
    assert (ctx.trace_id, ctx.span_id) == (root.trace_id, root.span_id)
    assert dst_tr.TRACE_KEY in decoded  # extract never mutates
    # a child recorded on the far side joins the same trace
    child = dst_tr.record_span("serve.flush", ctx, 1.0, 2.0, kind="serving")
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    for bad in ({"kind": "act"}, {"trace": "garbage"}, {"trace": {"tid": 1, "sid": "x"}}, None):
        assert dst_tr.extract(bad) is None and src_tr.extract(bad) is None
    # an unsampled root injects nothing in either package
    assert ttr.inject({}, ttr.NOOP_SPAN) == jtr.inject({}, jtr.NOOP_SPAN) == {}


def test_skew_estimates_match_jax_on_the_same_pongs():
    rng = np.random.default_rng(0)
    samples = []
    for i in range(60):
        peer = f"h{i % 3}"
        t_send = 100.0 + i
        rtt = float(rng.uniform(0.001, 0.2))
        samples.append((peer, t_send, t_send + 2.5 * (i % 3) + rtt * rng.uniform(0.2, 0.8),
                        t_send + rtt))
    ests = [jtr.ClockSkewEstimator(), ttr.ClockSkewEstimator()]
    for est in ests:
        for s in samples:
            est.observe(*s)
    j, t = ests
    assert t.offsets() == j.offsets()
    assert [t.samples(f"h{k}") for k in range(3)] == [j.samples(f"h{k}") for k in range(3)] \
        == [20, 20, 20]
    assert abs(t.offset("h2") - 5.0) < 0.1 and t.offset("unknown") == 0.0
    # pongs through both packages' default estimators
    for peer, t_send, t_peer, t_recv in samples[:9]:
        pong = {"kind": "pong", "t": t_send, "rt": t_peer, "host": peer}
        ttr.observe_pong(pong, t_recv=t_recv)
        jtr.observe_pong(pong, t_recv=t_recv)
    assert ttr.get_skew().offsets() == jtr.get_skew().offsets()
    for junk in ({"kind": "pong"}, None, {"host": "x", "t": "a", "rt": 1.0}):
        ttr.observe_pong(junk)


def test_heartbeat_vocabulary_matches_jax():
    for make in ("make_ping", "make_drain"):
        tmsg, jmsg = getattr(tsup, make)(), getattr(jsup, make)()
        assert set(tmsg) == set(jmsg) and tmsg["kind"] == jmsg["kind"]
    ping = jsup.make_ping()
    tpong, jpong = tsup.make_pong(ping), jsup.make_pong(ping)
    assert set(tpong) == set(jpong) and tpong["t"] == jpong["t"] == ping["t"]
    assert tpong["host"] == ttel.host_id() and isinstance(tpong["rt"], float)
    for msg in (ping, tpong, {"kind": "drain"}, {"kind": "act"}, "ping", None):
        assert tsup.is_heartbeat(msg) == jsup.is_heartbeat(msg)
        assert tsup.is_drain(msg) == jsup.is_drain(msg)
    assert (tsup.PING, tsup.PONG, tsup.DRAIN, tsup.DRAIN_DONE) == \
        (jsup.PING, jsup.PONG, jsup.DRAIN, jsup.DRAIN_DONE)


def test_sampling_ring_stamps_and_listeners(monkeypatch):
    assert not ttr.sampling_enabled()
    assert ttr.start_span("x") is ttr.NOOP_SPAN  # rate 0: a free no-op
    # a child of a remote context records even at rate 0
    child = ttr.start_span("serve.flush", parent={"tid": "a" * 16, "sid": "b" * 16})
    assert child.sampled and child.trace_id == "a" * 16 and child.parent_id == "b" * 16
    child.end()
    _arm(monkeypatch)
    tracer = ttr.Tracer(sample_rate=1.0, capacity=8, out_dir="")
    seen = []
    tracer.add_listener(seen.append)
    for i in range(20):
        tracer.start_span(f"s{i}").end()
    assert len(tracer.finished()) == 8 and tracer.dropped == 12
    assert tracer.finished()[-1]["name"] == "s19" and len(seen) == 20
    tracer.remove_listener(seen.append)
    t0 = time.monotonic() - 1.5
    ttr.record_span("serve.queue_wait", None, t0, t0 + 1.0, kind="serving")
    (rec,) = ttr.get_tracer().finished()
    assert abs(rec["dur"] - 1.0) < 1e-9 and abs(rec["t0"] - ttr.wall_of(t0)) < 1e-9
    assert set(rec) == set(jtr.get_tracer().start_span("y").to_record())


def test_flight_events_carry_the_active_trace_id(monkeypatch):
    _arm(monkeypatch)
    ttel.record_event("before")
    with ttr.start_span("episode") as span:
        ttel.record_event("inside", fault="bitflip")
    with ttr.get_tracer().activate({"tid": "c" * 16, "sid": "d" * 16}):
        ttel.record_event("activated")
    events = {e["kind"]: e for e in ttel.get_recorder().events()}
    assert events["inside"]["trace"] == span.trace_id
    assert "trace" not in events["before"]
    assert events["activated"]["trace"] == "c" * 16


def _write_spans(mod, monkeypatch, path):
    monkeypatch.setenv(ttr.ENV_DIR, str(path))
    mod.reset()
    root = mod.start_span("sequence", kind="disagg")
    mod.record_span("seq.decode", root, root.t_start + 0.1, root.t_start + 0.4, kind="disagg")
    mod.record_span("seq.learn_step", root, root.t_start + 0.5, root.t_start + 0.6,
                    kind="disagg")
    root.end(t_end=root.t_start + 1.0)
    mod.get_skew().observe("other-host", 10.0, 10.5, 10.1)
    mod.export_skew()
    mod.get_tracer().close()
    (name,) = [f for f in os.listdir(path) if f.startswith("spans_")]
    return [json.loads(line) for line in (path / name).read_text().splitlines()]


def test_span_file_reads_in_the_jax_trace_report(monkeypatch, tmp_path):
    from tools.trace_report import build_report

    monkeypatch.setenv(ttr.ENV_SAMPLE, "1.0")
    lines = {}
    for tag, mod in (("port", ttr), ("jax", jtr)):
        (tmp_path / tag).mkdir()
        lines[tag] = _write_spans(mod, monkeypatch, tmp_path / tag)
    assert [sorted(row) for row in lines["port"]] == [sorted(row) for row in lines["jax"]]
    assert lines["port"][0]["kind"] == "meta" and lines["port"][-1]["kind"] == "skew"
    reports = {tag: build_report(str(tmp_path / tag)) for tag in lines}
    for tag, rep in reports.items():
        (trace,) = rep["traces"].values()
        assert sorted(s["name"] for s in trace["spans"]) == \
            ["seq.decode", "seq.learn_step", "sequence"]
    assert reports["port"]["verdict"] == reports["jax"]["verdict"]
    assert reports["port"]["skew_offsets"] == reports["jax"]["skew_offsets"]
