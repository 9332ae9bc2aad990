"""The port's fault injection against the JAX package's, and its four hooks.

- ``ChaosPlan.parse``/``spec`` round-trip to the JAX plan's values and
  strings; the same plan and seed give the same ``decide``,
  ``frame_faults``, ``mass_kill_victims``, ``preempt_victim`` and
  ``tear_slot`` sequence as the JAX injector, draw for draw (exact);
- the transport's frame faults: a bit-flipped or truncated frame raises
  ``ProtocolError`` at the receiver, a peer killed mid-frame surfaces as a
  connection error, a duplicate arrives twice and a dropped frame never,
  over sockets and over pipes;
- the hooks: a partial checkpoint falls back to ``.prev``, a poisoned
  off-policy batch is skipped by the learn step's guard (the replay stays
  finite), ``PreemptionGuard.poll_chaos`` trips the guard, and
  ``SCALERL_CHAOS`` activates a plan (invalid values are ignored).
"""

import os
import signal
import socket
import threading

import numpy as np
import pytest
import torch

from scalerl_torch.fleet import transport as tt
from scalerl_torch.fleet.framing import ProtocolError
from scalerl_torch.runtime import chaos as tchaos
from scalerl_torch.runtime import telemetry as ttel
from scalerl_torch.runtime.supervisor import PreemptionGuard
from scalerl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from scalerl_tpu.runtime import chaos as jchaos

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Every test starts and ends with no injector and a fresh env verdict."""
    tchaos.clear()
    saved = os.environ.pop(tchaos.ENV_VAR, None)
    yield
    tchaos.clear()
    if saved is not None:
        os.environ[tchaos.ENV_VAR] = saved


SPECS = [
    "42:frame_bitflip=0.25@3,grad_nan=0.5,minframe=512,sites=sock",
    "7:frame_drop=0.3,frame_dup=0.2,frame_truncate=0.2,peer_kill=0.1@2,frame_delay=0.01,delay=0",
    "11:slot_tear=0.4,ckpt_partial=0.5@1,grad_inf=0.3,mass_kill=0.5,kills=3,preempt=0.25@2",
    "0:",
]


@pytest.mark.parametrize("text", SPECS)
def test_plan_parse_and_spec_round_trip_as_the_jax_plan(text):
    ours, theirs = tchaos.ChaosPlan.parse(text), jchaos.ChaosPlan.parse(text)
    assert ours.spec() == theirs.spec()
    assert tchaos.ChaosPlan.parse(ours.spec()) == ours
    for field in ("seed", "min_frame_bytes", "site_prefixes", "delay_s", "kill_count"):
        assert getattr(ours, field) == getattr(theirs, field)
    assert dict(ours.rates) == dict(theirs.rates) and dict(ours.limits) == dict(theirs.limits)
    assert tchaos.KINDS == jchaos.KINDS and tchaos.ENV_VAR == jchaos.ENV_VAR


def test_plan_rejects_garbage():
    for bad, match in (("1:frame_warp=0.5", "unknown chaos"), ("x:frame_drop=0.5", "seed"),
                       ("no-colon-at-all", "must look like"), ("1:bogus=3", "spec key"),
                       ("1:frame_drop", "key=value")):
        with pytest.raises(ValueError, match=match):
            tchaos.ChaosPlan.parse(bad)
    with pytest.raises(ValueError, match="unknown chaos fault kind"):
        tchaos.ChaosPlan(seed=1, rates={"frame_warp": 0.5})


def _schedule(mod, seed: int):
    """Every decision kind, interleaved over sites, as one comparable list."""
    plan = mod.ChaosPlan.parse(
        f"{seed}:frame_drop=0.1,frame_dup=0.1,frame_truncate=0.15,frame_bitflip=0.2@9,"
        "peer_kill=0.05,slot_tear=0.3,mass_kill=0.2,preempt=0.3@4,grad_nan=0.2,grad_inf=0.2,"
        "ckpt_partial=0.5,minframe=16,kills=0")
    inj = mod.FaultInjector(plan)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        site = ("sock", "pipe", "sock:gather")[i % 3]
        data = rng.integers(0, 255, size=int(rng.integers(8, 200)), dtype=np.uint8).tobytes()
        out.append(("frame", inj.frame_faults(data, site)))
        out.append(("decide", inj.decide("grad_nan", "batch"), inj.decide("grad_inf", "batch")))
        out.append(("mass_kill", inj.mass_kill_victims(1 + i % 9, site="fleet")))
        out.append(("preempt", inj.preempt_victim(1 + i % 5, site=("learner", "router")[i % 2])))
        buf = bytearray(rng.integers(0, 255, size=128, dtype=np.uint8).tobytes())
        out.append(("tear", inj.tear_slot(buf), bytes(buf)))
    out.append(("fired", dict(inj.fired), dict(inj.opportunities)))
    return out


@pytest.mark.parametrize("seed", [0, 6, 1234])
def test_same_seed_same_schedule_as_the_jax_injector(seed):
    ours, theirs = _schedule(tchaos, seed), _schedule(jchaos, seed)
    assert ours == theirs
    assert any(entry[1] for entry in ours if entry[0] == "mass_kill")  # not trivially empty


def test_per_site_streams_are_independent_and_limits_cap():
    plan = tchaos.ChaosPlan(seed=3, rates={"frame_drop": 0.5})
    a, b = tchaos.FaultInjector(plan), tchaos.FaultInjector(plan)
    solo = [a.decide("frame_drop", "sock") for _ in range(30)]
    interleaved = []
    for i in range(30):
        b.decide("frame_drop", f"other{i}")
        interleaved.append(b.decide("frame_drop", "sock"))
    assert interleaved == solo
    capped = tchaos.FaultInjector(tchaos.ChaosPlan(seed=1, rates={"frame_drop": 1.0},
                                                   limits={"frame_drop": 2}))
    hits = [capped.decide("frame_drop", "s") for _ in range(10)]
    assert hits == [True, True] + [False] * 8


def test_decisions_count_and_record_flight_events():
    ttel.reset()
    inj = tchaos.FaultInjector(tchaos.ChaosPlan(seed=2, rates={"frame_dup": 1.0}))
    inj.frame_faults(b"x" * 64, "pipe")
    assert ttel.get_registry().scalars()["chaos.frame_dup"] == 1.0
    (evt,) = ttel.get_recorder().events("chaos_injection")
    assert evt["fault"] == "frame_dup" and evt["site"] == "pipe"
    ttel.reset()


def test_env_var_activation_invalid_value_and_clear(monkeypatch):
    monkeypatch.setenv(tchaos.ENV_VAR, "9:frame_dup=1.0")
    tchaos.clear()
    inj = tchaos.active()
    assert inj is not None and inj.plan.seed == 9 and tchaos.active() is inj
    monkeypatch.setenv(tchaos.ENV_VAR, "9:not_a_fault=1.0")
    tchaos.clear()
    assert tchaos.active() is None  # invalid plans are logged and ignored
    monkeypatch.delenv(tchaos.ENV_VAR)
    tchaos.clear()
    assert tchaos.active() is None
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=1)))
    assert tchaos.active() is not None


# ---------------------------------------------------------------------------
# transport frame faults


def _sock_pair():
    srv = tt.listen_socket(0, host="127.0.0.1")
    port = srv.getsockname()[1]
    out = {}
    t = threading.Thread(target=lambda: out.update(conn=tt.accept_connection(srv, timeout=5.0)))
    t.start()
    client = tt.connect_socket("127.0.0.1", port)
    t.join(timeout=5.0)
    srv.close()
    return client, out["conn"]


def _pipe_pair():
    import multiprocessing as mp

    a, b = mp.get_context("spawn").Pipe(duplex=True)
    return tt.PipeConnection(a), tt.PipeConnection(b)


PAIRS = {"sock": _sock_pair, "pipe": _pipe_pair}


@pytest.mark.parametrize("transport", sorted(PAIRS))
@pytest.mark.parametrize("kind", ["frame_bitflip", "frame_truncate"])
def test_corrupt_frame_is_rejected_typed(kind, transport):
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=13, rates={kind: 1.0})))
    a, b = PAIRS[transport]()
    try:
        a.send({"x": np.arange(256, dtype=np.float32)})
        with pytest.raises(ProtocolError):
            b.recv(timeout=5.0)
    finally:
        tchaos.clear()
        a.close()
        b.close()


@pytest.mark.parametrize("transport", sorted(PAIRS))
def test_peer_kill_mid_frame_surfaces_as_connection_error(transport):
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=13, rates={"peer_kill": 1.0})))
    a, b = PAIRS[transport]()
    try:
        with pytest.raises(ProtocolError, match="mid-frame"):
            a.send({"x": np.arange(256, dtype=np.float32)})  # the sender dies
        with pytest.raises((ConnectionError, EOFError, OSError)):
            b.recv(timeout=5.0)
            b.recv(timeout=5.0)  # a pipe delivers the half frame, then EOF
    finally:
        tchaos.clear()
        b.close()


@pytest.mark.parametrize("transport", sorted(PAIRS))
def test_frame_dup_delivers_twice_and_drop_never(transport):
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=13, rates={"frame_dup": 1.0})))
    a, b = PAIRS[transport]()
    try:
        a.send({"n": 1})
        assert b.recv(timeout=5.0) == {"n": 1}
        assert b.recv(timeout=5.0) == {"n": 1}  # the duplicate
        tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=13,
                                                             rates={"frame_drop": 1.0})))
        a.send({"n": 2})
        assert not b.poll(0.3)  # dropped on the floor
    finally:
        tchaos.clear()
        a.close()
        b.close()


def test_frame_faults_respect_sites_and_minimum_size():
    inj = tchaos.FaultInjector(tchaos.ChaosPlan(seed=5, rates={"frame_drop": 1.0},
                                                min_frame_bytes=100, site_prefixes=("sock",)))
    assert inj.frame_faults(b"x" * 50, "sock") == ([b"x" * 50], None)
    assert inj.frame_faults(b"x" * 200, "pipe") == ([b"x" * 200], None)
    assert inj.frame_faults(b"x" * 200, "sock") == ([], None)


def _pipe_echo(conn, n):
    for _ in range(n):
        conn.send({"echo": conn.recv(timeout=10.0)})


def test_open_worker_pipes_spawns_workers_over_the_codec(monkeypatch):
    import multiprocessing as mp

    from scalerl_torch.utils.platform import safe_mp_context

    assert safe_mp_context("forkserver") == "forkserver"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert safe_mp_context() == "spawn"  # a live CUDA context is never forked
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert safe_mp_context() is None
    # this test process holds JAX's threads: spawn, as a CUDA parent would
    conns, procs = tt.open_worker_pipes(2, _pipe_echo, lambda i: (1,),
                                        ctx=mp.get_context("spawn"))
    try:
        for i, c in enumerate(conns):
            assert tt.send_recv(c, {"i": i}) == {"echo": {"i": i}}
        for p in procs:
            p.join(timeout=30.0)
        assert all(p.exitcode == 0 for p in procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for c in conns:
            c.close()


# ---------------------------------------------------------------------------
# the hooks in ported modules


def _state(v: float):
    return {"w": torch.full((16,), v), "step": np.asarray(3, np.int64)}


def test_partial_checkpoint_falls_back_to_prev(tmp_path):
    ttel.reset()
    path = str(tmp_path / "ck")
    save_checkpoint(path, _state(1.0))
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(
        seed=4, rates={"ckpt_partial": 1.0}, limits={"ckpt_partial": 1})))
    save_checkpoint(path, _state(2.0))  # chaos leaves the new latest partial
    tchaos.clear()
    out = load_checkpoint(path, _state(0.0))  # detected -> .prev fallback
    assert torch.equal(out["w"], torch.full((16,), 1.0))
    with pytest.raises(Exception):
        load_checkpoint(path, _state(0.0), fallback=False)
    scal = ttel.get_registry().scalars()
    assert scal["chaos.ckpt_partial"] == 1.0 and scal["checkpoint.fallbacks"] == 1.0
    assert [e["kind"] for e in ttel.get_recorder().events()
            if e["kind"].startswith("checkpoint")] == [
        "checkpoint_save", "checkpoint_save", "checkpoint_fallback", "checkpoint_restore"]
    ttel.reset()


def test_poison_batch_writes_a_copy_of_the_first_float_leaf():
    inj = tchaos.FaultInjector(tchaos.ChaosPlan(seed=1, rates={"grad_inf": 1.0}))
    live = torch.ones(4)
    batch = {"action": torch.zeros(4, dtype=torch.int64), "obs": live,
             "reward": np.ones(3, np.float32)}
    assert inj.poison_batch(batch)
    assert torch.isinf(batch["obs"][0]) and batch["obs"] is not live
    assert torch.equal(live, torch.ones(4))  # the replay's tensor is untouched
    host = {"a": np.zeros(2, np.int32), "b": np.ones(3, np.float32)}
    assert inj.poison_batch(host) and np.isinf(host["b"][0])
    calm = tchaos.FaultInjector(tchaos.ChaosPlan(seed=1))
    assert not calm.poison_batch({"obs": torch.ones(2)})


def test_poisoned_offpolicy_batch_is_skipped_by_the_guard(tmp_path):
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    args = DQNArguments(hidden_sizes="16,16", batch_size=8, buffer_size=64, num_envs=2,
                        warmup_learn_steps=8, logger_backend="none", telemetry_interval_s=0.0,
                        save_model=False, work_dir=str(tmp_path), use_per=True)
    envs = make_host_envs("CartPole-v1", 2, env_backend="jax")
    agent = DQNAgent(args, (4,), 2, device="cpu")
    trainer = OffPolicyTrainer(args, agent, envs)
    obs, _ = envs.reset(seed=0)
    for _ in range(8):
        nxt, rew, term, trunc, infos = envs.step(np.zeros(2, np.int64))
        trainer.store_experience(obs, nxt, np.zeros(2, np.int64), rew, term, infos, trunc)
        obs = nxt
    before = {k: v.clone() for k, v in agent.state.params.items()}
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=3, rates={"grad_nan": 1.0},
                                                         limits={"grad_nan": 1})))
    metrics = trainer.train_step()  # the sampled batch is poisoned
    assert float(metrics["skipped_steps"]) == 1.0
    assert all(torch.equal(before[k], v) for k, v in agent.state.params.items())
    storage = trainer.sampler.buffer.state.replay.storage
    assert all(bool(torch.isfinite(v.float()).all()) for v in storage.values())
    metrics = trainer.train_step()  # the limit is spent: a clean step
    assert float(metrics["skipped_steps"]) == 0.0
    assert not all(torch.equal(before[k], v) for k, v in agent.state.params.items())
    trainer.close()


def test_poll_chaos_trips_the_guard_by_simulation_and_by_a_real_signal():
    guard = PreemptionGuard()
    assert not guard.poll_chaos("learner")  # no injector: never
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=21, rates={"preempt": 1.0},
                                                         limits={"preempt": 1})))
    assert guard.poll_chaos("learner")  # not installed: simulate()
    assert guard.triggered and guard.received == signal.SIGTERM
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=21, rates={"preempt": 1.0})))
    with PreemptionGuard() as installed:
        assert installed.poll_chaos("learner")  # a real SIGTERM through the handler
        assert installed.received == signal.SIGTERM
    calm = PreemptionGuard()
    tchaos.install(tchaos.FaultInjector(tchaos.ChaosPlan(seed=21, rates={"preempt": 0.0})))
    assert not calm.poll_chaos("learner")


def test_connect_socket_backs_off_until_a_late_listener():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    ttel.reset()
    holder = {}

    def late_listener():
        import time

        time.sleep(0.3)
        srv = tt.listen_socket(port, host="127.0.0.1")
        holder["conn"] = tt.accept_connection(srv, timeout=10.0)
        srv.close()

    t = threading.Thread(target=late_listener)
    t.start()
    conn = tt.connect_socket("127.0.0.1", port, retries=50, delay=0.05, backoff_cap=0.2)
    t.join(timeout=10.0)
    try:
        assert ttel.get_registry().scalars()["transport.connect_retries"] >= 1
        assert ttel.get_recorder().events("connect_retried")
    finally:
        conn.close()
        holder["conn"].close()
        ttel.reset()
