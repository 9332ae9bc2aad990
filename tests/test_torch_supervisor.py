"""Parity of the port's supervision layer (``scalerl_torch/runtime/
supervisor.py``) with the JAX package's.

Decisions are compared exactly on one injected input: the backoff schedule
for one ``random.Random`` seed, ``CheckpointCadence``'s verdicts on one
frame and clock sequence, the step where ``DivergenceTripwire`` trips on one
metric sequence.  The watchdog and the preemption guard are held to the
JAX package's own tests (tests/test_supervisor.py): the watchdog fires with
its report and stays quiet under progress, and SIGTERM sets the guard's
flag without killing the process.
"""

import os
import random
import signal
import threading
import time

import pytest

from scalerl_torch.runtime import supervisor as tsup
from scalerl_tpu.runtime import supervisor as jsup


@pytest.mark.parametrize("jitter", [False, True])
def test_exp_backoff_schedules_match_jax(jitter):
    jr, tr = random.Random(7), random.Random(7)
    for attempt in range(12):
        for base, cap in ((0.5, 10.0), (1.0, 8.0), (0.0, 1.0)):
            assert (tsup.exp_backoff(attempt, base, cap, jitter=jitter, rng=tr)
                    == jsup.exp_backoff(attempt, base, cap, jitter=jitter, rng=jr))


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("frames,interval_s", [(100, 0.0), (0, 5.0), (250, 3.0)])
def test_checkpoint_cadence_decisions_match_jax(monkeypatch, frames, interval_s):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    jc = jsup.CheckpointCadence(frames, interval_s, start_frames=10)
    tc = tsup.CheckpointCadence(frames, interval_s, start_frames=10)
    rng = random.Random(3)
    n = 10
    decisions = []
    for _ in range(200):
        n += rng.randint(0, 40)
        clock.t += rng.uniform(0.0, 1.2)
        due = tc.due(n)
        assert due == jc.due(n)
        decisions.append(due)
        if due:
            tc.mark_saved(n)
            jc.mark_saved(n)
    assert any(decisions) and not all(decisions)


def _metric_sequence(seed: int):
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        r = rng.random()
        out.append(None if r < 0.05 else {"skipped_steps": 1.0 if r < 0.45 else 0.0})
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_divergence_tripwire_trips_at_the_same_steps_as_jax(tmp_path, monkeypatch, k):
    # the JAX tripwire writes a flight-recorder dump per trip: keep it here
    monkeypatch.setenv("SCALERL_TELEMETRY_DIR", str(tmp_path))
    jtrips, ttrips = [], []
    jw = jsup.DivergenceTripwire(k, lambda: jtrips.append(len(jtrips)))
    tw = tsup.DivergenceTripwire(k, lambda: ttrips.append(len(ttrips)))
    for step, m in enumerate(_metric_sequence(k)):
        assert tw.observe(m) == jw.observe(m), step
        assert tw.consecutive == jw.consecutive
    assert tw.trips == jw.trips == len(ttrips) > 0
    assert not tsup.DivergenceTripwire(0, lambda: None).enabled


def test_watchdog_fires_with_stack_dump_and_probes():
    fired = []
    wd = tsup.StallWatchdog(deadline_s=0.3, on_stall=fired.append, name="unit")
    work = wd.counter("work")
    wd.watch("external", lambda: 7)
    wd.add_probe("queue_depth", lambda: {"free": 1, "full": 3})
    with wd:
        for _ in range(3):
            work.bump()
            time.sleep(0.1)
        assert wd.stalled is None
        deadline = time.monotonic() + 5.0
        while wd.stalled is None and time.monotonic() < deadline:
            time.sleep(0.05)
    assert fired and wd.stalled is not None and wd.fire_count == 1
    report = str(fired[0])
    assert "no progress" in report and "'work': 3" in report and "'external': 7" in report
    assert "queue_depth" in report and "'full': 3" in report
    assert "Thread" in report and "test_torch_supervisor" in report
    with pytest.raises(tsup.StallError):
        wd.check()


def test_watchdog_stays_quiet_under_progress():
    wd = tsup.StallWatchdog(deadline_s=0.4, on_stall=lambda e: None, name="busy")
    c = wd.counter("steps")
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            c.bump()
            time.sleep(0.05)

    t = threading.Thread(target=worker, daemon=True)
    with wd:
        t.start()
        time.sleep(1.2)
        stop.set()
        t.join()
    assert wd.stalled is None and wd.fire_count == 0


def test_preemption_guard_flags_sigterm_without_dying():
    with tsup.PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not guard.triggered and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.triggered and guard.received == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) != guard._handler


def test_preemption_guard_is_inert_off_the_main_thread():
    out = {}

    def run():
        g = tsup.PreemptionGuard().install()
        out["installed"] = g._installed
        g.simulate()
        out["triggered"] = g.triggered

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out == {"installed": False, "triggered": True}


def test_liveness_tracker_lists_silent_keys():
    lt = tsup.LivenessTracker()
    lt.beat("a")
    lt.beat("b")
    time.sleep(0.05)
    lt.beat("b")
    assert lt.stale(0.03) == ["a"]
    lt.forget("a")
    assert lt.last_seen("a") is None and lt.stale(10.0) == []


def test_stall_signal_and_trip_dump_the_flight_recorder(tmp_path, monkeypatch):
    """As in the JAX supervisor: a stall, a caught signal and a divergence
    trip each record their event and write the flight recorder's tail as
    JSON under ``SCALERL_TELEMETRY_DIR``; the stall report carries it as
    text."""
    import json

    from scalerl_torch.runtime import telemetry

    monkeypatch.setenv("SCALERL_TELEMETRY_DIR", str(tmp_path))
    telemetry.record_event("before_the_stall", n=1)
    fired = []
    wd = tsup.StallWatchdog(deadline_s=0.2, on_stall=fired.append, name="dumps")
    wd.counter("work").bump()  # one progress source that then stalls
    wd.add_probe("depth", lambda: 4)
    with wd:
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
    assert fired and "flight recorder" in str(fired[0]) and "before_the_stall" in str(fired[0])
    guard = tsup.PreemptionGuard()
    guard.simulate()
    trips = []
    tw = tsup.DivergenceTripwire(1, lambda: trips.append(1))
    assert tw.observe({"skipped_steps": 1.0}) and trips == [1]
    for path, kind in ((wd.flight_dump_path, "watchdog_stall"),
                       (guard.flight_dump_path, "preemption_signal"),
                       (telemetry.flight_dump_path("divergence"), "divergence_trip")):
        assert os.path.dirname(path) == str(tmp_path)
        with open(path) as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
        assert kind in kinds, (path, kinds)
    events = telemetry.get_recorder().events
    assert events("watchdog_probe") and events("divergence_trip")
    assert os.path.basename(guard.flight_dump_path).startswith("scalerl_flight_signal_sigterm")
