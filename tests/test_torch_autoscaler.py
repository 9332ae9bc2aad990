"""The port's autoscaler against the JAX package's (``scalerl_tpu/runtime/autoscaler.py``).

- The decision table: the same signal trace under an injected clock gives
  the same ``Decision`` sequence (action, delta, reason, time), the same
  counters, flap rate and flight-recorder events, across the actor-fleet
  rules, the serving-tier rules, the staleness guard and the floor;
- ``AutoscalerConfig`` validation and ``from_args``, and the elastic-fleet
  fields of ``RLArguments`` with the JAX package's errors;
- the signal readers over a fleet server and a router, ``step`` through an
  executor and the background loop;
- the drain protocol end to end on the port's fleet: a gather admitted
  mid-run, then drained, with every task answered exactly once.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import torch_fleet_helpers as helpers

from scalerl_torch import config as tconfig
from scalerl_torch.fleet import cluster as tcluster
from scalerl_torch.runtime import autoscaler as tauto
from scalerl_torch.runtime import telemetry as ttelemetry
from scalerl_tpu import config as jconfig
from scalerl_tpu.runtime import autoscaler as jauto
from scalerl_tpu.runtime import telemetry as jtelemetry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    ttelemetry.reset()
    jtelemetry.reset()
    yield
    ttelemetry.reset()
    jtelemetry.reset()


def _trace(seed: int, n: int = 60):
    """A seeded signal trace: occupancy, sheds, latency, staleness and the
    live count wander, with floor breaches and jitter."""
    rng = np.random.default_rng(seed)
    out = []
    now = 0.0
    for _ in range(n):
        now += float(rng.choice([0.5, 1.0, 5.0, 12.0]))
        out.append((dict(
            fps=float(rng.uniform(0, 600)),
            learn_steps_per_s=float(rng.uniform(0, 5)),
            queue_occupancy=float(rng.choice([0.0, 0.1, 0.5, 0.95, 1.0])),
            shed_delta=float(rng.choice([0.0, 0.0, 0.0, 2.0])),
            serving_p95_ms=float(rng.choice([0.0, 3.0, 20.0, 80.0])),
            snapshot_staleness=float(rng.choice([0.0, 2.0, 9.0])),
            live_workers=int(rng.integers(0, 10)),
        ), now))
    return out


CONFIGS = {
    "defaults": {},
    "eager": dict(min_workers=2, max_workers=6, up_hysteresis=1, down_hysteresis=1,
                  cooldown_s=0.0),
    "fps_target": dict(fps_per_learn_step=100.0, cooldown_s=3.0),
    "serving_slo": dict(serving_p95_slo_ms=50.0, cooldown_s=1.0, scale_step=2),
    "serving_tier": dict(serving_scale_up_p95_ms=50.0, serving_scale_down_p95_ms=5.0,
                         min_workers=1, max_workers=4, cooldown_s=2.0),
    "staleness": dict(max_staleness=5.0, low_occupancy=-1.0, up_hysteresis=2),
}


def _events(recorder):
    return [{k: v for k, v in e.items() if k not in ("t_wall", "t_mono", "seq")}
            for e in recorder.events("autoscale_decision")]


def _run_trace(auto, telemetry, cfg_kw, trace):
    a = auto.Autoscaler(auto.AutoscalerConfig(**cfg_kw))
    decisions = []
    for kw, now in trace:
        d = a.evaluate(auto.FleetSignals(**kw), now=now)
        decisions.append((d.action, d.delta, d.reason, d.t, dataclasses.asdict(d.signals)))
    end = trace[-1][1]
    return {
        "decisions": decisions,
        "counts": (a.decisions, a.scale_ups, a.scale_downs, a.holds),
        "flap": [a.actions_per_min(w, now=end) for w in (10.0, 60.0, 600.0)],
        "events": _events(telemetry.get_recorder()),
        "snapshot": {k: v for k, v in telemetry.get_registry().snapshot()["autoscaler"].items()
                     if k != "actions_per_min"},
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decision_sequence_matches_jax_under_an_injected_clock(name, seed):
    trace = _trace(seed)
    want = _run_trace(jauto, jtelemetry, CONFIGS[name], trace)
    got = _run_trace(tauto, ttelemetry, CONFIGS[name], trace)
    assert got == want
    assert any(d[0] != tauto.HOLD for d in got["decisions"])


@pytest.mark.parametrize("kw", [
    dict(min_workers=-1), dict(min_workers=4, max_workers=2), dict(scale_step=0),
    dict(up_hysteresis=0), dict(down_hysteresis=0),
    dict(serving_scale_up_p95_ms=10.0, serving_scale_down_p95_ms=20.0),
    dict(serving_scale_up_p95_ms=10.0, serving_p95_slo_ms=10.0),
])
def test_autoscaler_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jauto.AutoscalerConfig(**kw)
    with pytest.raises(ValueError) as got:
        tauto.AutoscalerConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, dict(autoscale=True, autoscale_min_workers=3, autoscale_max_workers=12,
             autoscale_interval_s=2.0, autoscale_cooldown_s=7.0, autoscale_hysteresis=3),
    dict(autoscale_max_staleness=8.0),
    dict(autoscale_serving_up_p95_ms=40.0, autoscale_serving_down_p95_ms=4.0),
])
def test_from_args_matches_jax(kw):
    j, t = jconfig.RLArguments(**kw), tconfig.RLArguments(**kw)
    j.validate()
    t.validate()
    assert (dataclasses.asdict(tauto.AutoscalerConfig.from_args(t))
            == dataclasses.asdict(jauto.AutoscalerConfig.from_args(j)))


@pytest.mark.parametrize("kw", [
    dict(autoscale_min_workers=-1), dict(autoscale_min_workers=5, autoscale_max_workers=4),
    dict(autoscale=True, autoscale_interval_s=0.0), dict(autoscale_hysteresis=0),
])
def test_elastic_fleet_fields_refuse_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        jconfig.RLArguments(**kw).validate()
    with pytest.raises(ValueError) as got:
        tconfig.RLArguments(**kw).validate()
    assert str(got.value) == str(want.value)
    assert {f.name for f in dataclasses.fields(tconfig.RLArguments)
            if f.name.startswith("autoscale")} == {
        f.name for f in dataclasses.fields(jconfig.RLArguments) if f.name.startswith("autoscale")}


class _FakeHub:
    shed_total = 0


class _FakeServer:
    def __init__(self):
        import queue

        self.hub = _FakeHub()
        self.dropped_results = 0
        self.results = queue.Queue(8)

    def live_worker_count(self):
        return 3


class _FakeRouter:
    shed = 0

    def aggregate_p95_ms(self):
        return 42.0

    def replica_count(self):
        return 2


def test_signal_sources_match_jax():
    reads = []
    for auto in (jauto, tauto):
        server, router = _FakeServer(), _FakeRouter()
        for i in range(3):
            server.results.put(i)
        fleet, route = auto.fleet_signal_source(server), auto.router_signal_source(router)
        seq = [dataclasses.asdict(fleet()), dataclasses.asdict(route())]
        server.hub.shed_total, server.dropped_results, router.shed = 4, 1, 3
        seq += [dataclasses.asdict(fleet()), dataclasses.asdict(route())]
        seq += [dataclasses.asdict(fleet()), dataclasses.asdict(route())]
        reads.append(seq)
    assert reads[1] == reads[0]
    assert [r["shed_delta"] for r in reads[1]] == [0.0, 0.0, 5.0, 3.0, 0.0, 0.0]


class _FakeExecutor:
    def __init__(self, workers: int) -> None:
        self.workers = workers
        self.calls = []

    def worker_count(self) -> int:
        return self.workers

    def scale_up(self, n: int) -> None:
        self.calls.append(("up", n))
        self.workers += n

    def scale_down(self, n: int) -> None:
        self.calls.append(("down", n))
        self.workers -= n


def test_step_takes_capacity_from_the_executor_and_applies_the_action():
    for auto in (jauto, tauto):
        ex = _FakeExecutor(workers=2)
        a = auto.Autoscaler(auto.AutoscalerConfig(min_workers=4, max_workers=8), executor=ex,
                            signal_source=lambda: auto.FleetSignals(live_workers=99,
                                                                    queue_occupancy=0.5))
        d = a.step(now=0.0)
        assert (d.action, d.delta, ex.calls, ex.workers) == (tauto.SCALE_UP, 2, [("up", 2)], 4)
        assert a.step(now=1.0).action == tauto.HOLD


def test_background_loop_backfills():
    ex = _FakeExecutor(workers=1)
    a = tauto.Autoscaler(tauto.AutoscalerConfig(min_workers=2, max_workers=4, interval_s=0.05),
                         executor=ex, signal_source=lambda: tauto.FleetSignals(queue_occupancy=0.5))
    with a:
        deadline = time.monotonic() + 5.0
        while not ex.calls and time.monotonic() < deadline:
            time.sleep(0.02)
    assert ("up", 1) in ex.calls


def test_router_tier_executor_drives_the_ports_router():
    """``router_signal_source`` and the serving-tier rules over the port's
    ``RouterTierExecutor``: a tier past its p95 threshold gets a replica."""
    from scalerl_torch.serving.router import RouterTierExecutor

    class _Router(_FakeRouter):
        def __init__(self):
            self.replicas = ["r0"]

        def replica_count(self):
            return len(self.replicas)

        def add_replica(self, handle):
            self.replicas.append(handle)

    router = _Router()
    executor = RouterTierExecutor(router, replica_factory=lambda i: f"r{i}")
    a = tauto.Autoscaler(
        tauto.AutoscalerConfig(serving_scale_up_p95_ms=20.0, serving_scale_down_p95_ms=2.0,
                               min_workers=1, max_workers=3, up_hysteresis=1, cooldown_s=0.0),
        executor=executor, signal_source=tauto.router_signal_source(router))
    d = a.step(now=0.0)
    assert (d.action, d.reason) == (tauto.SCALE_UP, "tier_over_capacity")
    assert router.replicas == ["r0", "r1"]


def test_scale_up_then_drain_answers_every_task_exactly_once():
    state = {"n": 0, "stop": False}
    lock = threading.Lock()

    def source():
        with lock:
            if state["stop"]:
                return None
            state["n"] += 1
            return {"role": "rollout", "seed": state["n"]}

    config = tcluster.FleetConfig(num_workers=2, workers_per_gather=2, upload_batch=1,
                                  heartbeat_interval_s=0.2)
    server = tcluster.WorkerServer(config, source)
    server.start(listen=False)
    cluster = tcluster.LocalCluster(server, config, helpers.slow_bandit_runner,
                                    mp_context="spawn")
    cluster.start()
    executor = tcluster.ClusterExecutor(server, cluster)
    try:
        results = helpers.drain(server, 4)
        assert len(results) == 4
        assert executor.scale_up(2) == 2
        deadline = time.monotonic() + 60.0
        while server.live_worker_count() < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.live_worker_count() == 4 and executor.worker_count() == 4
        assert executor.scale_down(2) == 2  # the newest gather drains
        deadline = time.monotonic() + 60.0
        while server.gathers_drained < 1 and time.monotonic() < deadline:
            r = server.get_result(timeout=0.1)
            if r is not None:
                results.append(r)
        assert server.gathers_drained >= 1, "drain_done never arrived"
        with lock:
            state["stop"] = True
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with lock:
                handed = state["n"]
            if len(results) >= handed:
                break
            r = server.get_result(timeout=0.2)
            if r is not None:
                results.append(r)
        seeds = [r["seed"] for r in results]
        assert len(seeds) == len(set(seeds)), "a task was answered twice"
        assert set(seeds) == set(range(1, handed + 1)), (
            f"lost: handed {handed}, answered {len(set(seeds))}, "
            f"requeued {server.requeued_tasks}")
        drained = cluster.procs[-1]
        drained.join(timeout=30.0)
        assert not drained.is_alive() and drained.exitcode == 0
        assert ttelemetry.get_recorder().events("gather_drained")
    finally:
        cluster.join(timeout=20.0)
        server.stop()
