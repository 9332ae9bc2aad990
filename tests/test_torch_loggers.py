"""Parity of the port's loggers, timers, profiling and telemetry export with
the JAX package's.

- the same call sequence makes both ``BaseLogger``s write the same
  ``(step_type, step, data)`` list (interval gating and ``log_registry``);
- TensorBoard event files written by either package restore to the same
  save counters through the other's ``TensorboardLogger.restore_data``;
- ``Timings`` gives the same means and stds on one injected clock;
- the Prometheus exposition and the JSONL snapshot hold the same content as
  the JAX package's for the same instruments (timestamps aside);
- ``maybe_trace`` writes a Chrome trace on the CPU, and the loggers that
  need a missing package raise naming it.
"""

import json
import os
import random
import time

import pytest
import torch

from scalerl_torch.runtime import telemetry as ttel
from scalerl_torch.utils import loggers as tlog
from scalerl_torch.utils import profiling as tprof
from scalerl_torch.utils import timers as ttimers
from scalerl_tpu.runtime import telemetry as jtel
from scalerl_tpu.utils import loggers as jlog
from scalerl_tpu.utils import timers as jtimers

torch.set_num_threads(1)


def _recorder(base):
    class Recorder(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.written = []

        def write(self, step_type, step, data):
            self.written.append((step_type, step, dict(data)))

    return Recorder


@pytest.mark.parametrize("intervals", [dict(), dict(train_interval=7, test_interval=3,
                                                    update_interval=1)])
def test_interval_gating_writes_the_same_sequence(intervals):
    jl, tl = _recorder(jlog.BaseLogger)(**intervals), _recorder(tlog.BaseLogger)(**intervals)
    rng = random.Random(0)
    step = 0
    for _ in range(400):
        step += rng.randint(0, 900)
        kind = rng.choice(["train", "test", "update"])
        data = {"loss": rng.random(), "n": rng.randint(0, 5)}
        for lg in (jl, tl):
            getattr(lg, f"log_{kind}_data")(data, step)
    assert tl.written == jl.written and len(tl.written) > 20


def test_log_registry_writes_the_same_data():
    jreg, treg = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    for reg in (jreg, treg):
        reg.set_gauges({"fps": 10.5, "loss": 0.25, "bad": float("nan")}, prefix="train.")
        reg.counter("train.skipped_steps").inc(2)
        reg.counter("queue.shed_total").inc(1)
        reg.gauge("other.x").set(3.0)
    jl, tl = _recorder(jlog.BaseLogger)(), _recorder(tlog.BaseLogger)()
    for step in (0, 500, 1200, 1300, 2500):
        jl.log_registry(step, registry=jreg, include_prefixes=("train.", "queue."))
        tl.log_registry(step, registry=treg, include_prefixes=("train.", "queue."))
    jl.log_registry(5000, step_type="update", registry=jreg, extra={"e": 1.0})
    tl.log_registry(5000, step_type="update", registry=treg, extra={"e": 1.0})
    assert tl.written == jl.written and len(tl.written) == 3
    with pytest.raises(ValueError, match="step_type"):
        tl.log_registry(0, step_type="eval", registry=treg)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_event_files_restore_across_packages(tmp_path, writer):
    w_mod, r_mod = (tlog, jlog) if writer == "torch" else (jlog, tlog)
    lg = w_mod.TensorboardLogger(str(tmp_path), train_interval=1, update_interval=1)
    lg.log_train_data({"return": 1.0}, 100)
    lg.save_data(3, 4000, 77)
    lg.save_data(5, 8000, 120)
    lg.close()
    back = r_mod.TensorboardLogger(str(tmp_path))
    assert back.restore_data() == (5, 8000, 120)
    assert back.last_log_train_step == 8000 and back.last_log_update_step == 120
    back.close()
    mine = w_mod.TensorboardLogger(str(tmp_path))
    assert mine.restore_data() == (5, 8000, 120)
    mine.close()


def test_timings_match_jax_on_one_clock(monkeypatch):
    t = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: t[0])
    jt, tt = jtimers.Timings(), ttimers.Timings()
    rng = random.Random(1)
    for _ in range(300):
        name = rng.choice(["step", "model", "write"])
        t[0] += rng.uniform(0.0, 0.01)
        jt.time(name)
        tt.time(name)
    assert tt.means() == jt.means()
    assert dict(tt.stds()) == dict(jt.stds())
    assert tt.stds()["never"] == 0.0
    assert tt.summary("x ") == jt.summary("x ")
    timer = ttimers.Timer()
    t[0] += 2.0
    assert abs(timer.since_start() - 2.0) < 1e-9
    assert timer.check_time(1.5) and not timer.check_time(1.5)


def _same_instruments(reg):
    reg.gauge("train.fps").set(123.5)
    reg.gauge("run.seed").set(42.0)
    reg.counter("checkpoint.saves").inc(3)
    reg.counter("queue.shed-total").inc(1)
    h = reg.histogram("learn.step_s")
    for v in (0.1, 0.3, 0.2, 0.5):
        h.observe(v)
    reg.gauge("9lives").set(float("inf"))
    reg.bind("queue", lambda: {"free": 3, "full": 1, "closed": 0})


def test_prometheus_and_jsonl_exports_match_jax(tmp_path):
    jreg, treg = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    _same_instruments(jreg)
    _same_instruments(treg)
    jloop = jtel.TelemetryExportLoop(str(tmp_path / "jax"), interval_s=3600, registry=jreg)
    tloop = ttel.TelemetryExportLoop(str(tmp_path / "torch"), interval_s=3600, registry=treg)
    jloop.flush()
    tloop.flush()
    with open(tmp_path / "jax" / "metrics.prom") as f:
        jprom = f.read()
    with open(tmp_path / "torch" / "metrics.prom") as f:
        tprom = f.read()
    assert tprom == jprom and "scalerl_queue_shed_total 1.0" in tprom
    assert "scalerl__9lives 0.0" in tprom

    def snap(d):
        with open(tmp_path / d / "telemetry.jsonl") as f:
            lines = [json.loads(x) for x in f]
        assert len(lines) == 1 and lines[0]["t"] > 0
        return lines[0]["snapshot"]

    assert snap("torch") == snap("jax")
    tloop.start()
    tloop.stop()  # a last flush
    assert tloop.writes == 2


def test_observe_train_metrics_and_final_snapshot(tmp_path):
    ttel.reset()
    ttel.observe_train_metrics({"skipped_steps": 2.0, "nonfinite_grads": "x", "loss": 1.0})
    ttel.observe_train_metrics(None)
    ttel.observe_train_metrics({"skipped_steps": float("nan"), "nonfinite_grads": 1.0})
    scal = ttel.get_registry().scalars()
    assert scal["train.skipped_steps"] == 2.0 and scal["train.nonfinite_grads"] == 1.0
    path = ttel.write_final_snapshot(str(tmp_path))
    with open(path) as f:
        payload = json.load(f)
    assert payload["snapshot"]["train"]["skipped_steps"] == 2.0
    ttel.reset()


def test_maybe_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.maybe_trace(str(tmp_path)):
        with tprof.annotate("host_region"), tprof.step_marker(3):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"host_region", "train_step#3"} <= names
    with tprof.maybe_trace(""):
        pass
    assert len(os.listdir(tmp_path)) == 1


def test_make_logger_builds_what_it_names(tmp_path, monkeypatch):
    assert isinstance(tlog.make_logger("none", str(tmp_path)), tlog.LazyLogger)
    tb = tlog.make_logger("tensorboard", str(tmp_path), train_interval=5)
    assert isinstance(tb, tlog.TensorboardLogger) and tb.train_interval == 5
    tb.close()
    with pytest.raises(ValueError, match="backend"):
        tlog.make_logger("csv", str(tmp_path))
    # wandb is not installed here: the logger names it
    with pytest.raises(ImportError, match="wandb"):
        tlog.make_logger("wandb", str(tmp_path))
    import sys

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        tlog.TensorboardLogger(str(tmp_path))
