"""Parity and behaviour of the port's actor-learner trainers
(``scalerl_torch/trainer/actor_learner.py``) and the host plane's parts.

- ``fill_rollout_slot`` with a scripted agent and env fills bit-equal slots
  in both packages; ``RolloutQueue`` reports the same ``stats`` after one
  acquire/commit/recycle/shed sequence; ``check_queue_depth`` raises the
  same errors;
- with converted weights, the port's host ``act`` gives the JAX agent's
  logits and core to 1e-5 (float32);
- actor threads act while a learner thread trains: every act sees one whole
  parameter set, and the locked generator hands out every draw once;
- the host trainer's smoke, elastic restart and prefetch runs
  (tests/test_impala.py:196, 238, 293), the fused trainer's save/resume and
  SIGTERM-resume (tests/test_preempt.py, tests/test_supervisor.py:225), a
  no-op resume of a finished run, ``--resume`` without a checkpoint, and the
  DQN kill-and-resume (tests/test_dqn_e2e.py:152);
- ``examples/train_impala_torch.py --device cpu`` on both backends, with the
  JAX example's run-directory layout.
"""

import importlib.util
import os
import signal
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import torch_port_helpers as H
from scalerl_torch import config as tconfig
from scalerl_torch.agents import dqn as tdqn
from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.data.trajectory import TrajectorySpec as TSpec
from scalerl_torch.envs.gym_env import SyncVectorView, TensorVectorView, make_vect_envs
from scalerl_torch.envs.synthetic_gym import RecallGymEnv
from scalerl_torch.envs.tensor_envs import TensorCartPole, make_tensor_vec_env
from scalerl_torch.runtime.rollout_queue import RolloutQueue as TQueue
from scalerl_torch.trainer import actor_learner as tal
from scalerl_torch.trainer.off_policy import OffPolicyTrainer
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.data.trajectory import TrajectorySpec as JSpec
from scalerl_tpu.runtime.rollout_queue import RolloutQueue as JQueue
from scalerl_tpu.trainer import actor_learner as jal

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


class _ScriptedAgent:
    """Deterministic acting: actions and logits from a counter, a core
    that adds the obs sum each step."""

    def __init__(self, A: int) -> None:
        self.A, self.calls = A, 0

    def act(self, obs, last_action, reward, done, core):
        self.calls += 1
        B = obs.shape[0]
        action = (np.arange(B) + self.calls) % self.A
        logits = np.tile(np.arange(self.A, dtype=np.float32), (B, 1)) * self.calls
        s = np.asarray(obs, np.float32).reshape(B, -1).sum(-1, keepdims=True)
        core = tuple((np.asarray(c) + s, np.asarray(h) - s) for c, h in core)
        return action, logits, core


@pytest.mark.parametrize("layers", [0, 2])
def test_fill_rollout_slot_matches_jax(layers):
    T, B, A = 7, 3, 2
    kw = dict(unroll_length=T, batch_size=B, obs_shape=(6, 6, 1), num_actions=A,
              core_state_shapes=((B, 5),) * layers)
    tslot, jslot = TSpec(**kw).host_zeros(), JSpec(**kw).host_zeros()
    assert {k: (v.shape, v.dtype) for k, v in tslot.items()} == \
        {k: (v.shape, v.dtype) for k, v in jslot.items()}
    outs = []
    for fill, slot in ((tal.fill_rollout_slot, tslot), (jal.fill_rollout_slot, jslot)):
        envs = SyncVectorView([lambda: RecallGymEnv(size=6, delay=2, num_cues=2)] * B)
        obs, _ = envs.reset(seed=1)
        core = tuple((np.full((B, 5), 0.5, np.float32), np.zeros((B, 5), np.float32))
                     for _ in range(layers))
        carried = (obs, np.zeros(B, np.int32), np.zeros(B, np.float32), np.ones(B, bool), core)
        agent = _ScriptedAgent(A)
        for _ in range(2):  # two slots: the second starts from the carry
            carried = fill(slot, agent, envs, *carried, T)
        outs.append((dict(slot), carried))
    (ts, tc), (js, jc) = outs
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rollout_queue_stats_match_jax():
    kw = dict(unroll_length=2, batch_size=2, obs_shape=(3,), num_actions=2,
              obs_dtype=np.float32)
    tq = TQueue(TSpec(**kw), num_slots=6, max_pending=2)
    jq = JQueue(JSpec(**{**kw, "obs_dtype": jnp.float32}), num_slots=6, max_pending=2)
    script = ["acq", "acq", "acq", "commit", "commit", "commit", "acq", "commit", "get",
              "acq", "commit", "acq", "commit", "recycle", "get"]
    held = {"t": [], "j": []}
    got = {"t": [], "j": []}
    for step in script:
        for tag, q in (("t", tq), ("j", jq)):
            if step == "acq":
                idx = q.acquire(timeout=0.1)
                held[tag].append(idx)
                q.slots[idx]["reward"][:] = idx
            elif step == "commit":
                q.commit(held[tag].pop(0))
            elif step == "get":
                batch, idxs = q.get_batch(1, timeout=0.1)
                got[tag].append((idxs, batch["reward"].tolist()))
            else:
                q.recycle([i for i, _ in got[tag][-1:] for i in i])
        assert tq.stats() == jq.stats(), step
    assert got["t"] == got["j"] and tq.shed_total == jq.shed_total > 0
    err = RuntimeError("actor died")
    tq.report_error(err)
    jq.report_error(err)
    assert tq.stats() == jq.stats()
    for q in (tq, jq):
        with pytest.raises(RuntimeError, match="actor worker died"):
            q.get_batch(1)


@pytest.mark.parametrize("kw,envs_per_actor", [
    (dict(num_buffers=4, num_actors=2, batch_size=8), 2),
    (dict(num_buffers=8, num_actors=8, batch_size=8), 1),
    (dict(num_buffers=16, num_actors=4, batch_size=32), 4),
    (dict(num_buffers=32, num_actors=8, batch_size=8), 1),
])
def test_check_queue_depth_raises_like_jax(kw, envs_per_actor):
    jargs, targs = H.args_pair(**kw)
    errs = []
    for fn, args in ((tal.check_queue_depth, targs), (jal.check_queue_depth, jargs)):
        try:
            fn(args, envs_per_actor)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("use_lstm", [False, True])
def test_host_act_logits_match_jax(use_lstm):
    T, B, A, obs_shape = 4, 3, 5, (24, 24, 4)
    jargs, targs = H.args_pair(rollout_length=T, batch_size=B, use_lstm=use_lstm)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=obs_shape, num_actions=A)
    tagent = ImpalaAgent(targs, obs_shape, A, device="cpu")
    tagent.state = H.state_to_torch(jagent.state)
    rng = np.random.default_rng(0)
    jcore, tcore = jagent.initial_state(B), tagent.initial_state(B)
    done = np.ones(B, bool)
    for t in range(3):
        obs = rng.integers(0, 255, (B,) + obs_shape).astype(np.uint8)
        last_a = rng.integers(0, A, B).astype(np.int32)
        rew = rng.normal(size=B).astype(np.float32)
        ja, jl, jcore = jagent.act(obs, last_a, rew, done, jcore)
        ta, tl, tcore = tagent.act(obs, last_a, rew, done, tcore)
        assert isinstance(tl, np.ndarray) and ta.dtype == np.int32 and ta.shape == (B,)
        np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-5, rtol=1e-5)
        assert ((ta >= 0) & (ta < A)).all()
        for (jc, jh), (tc, th) in zip(jcore, tcore):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
        done = rng.uniform(size=B) < 0.3
    g = tagent.predict(obs)
    assert g.shape == (B,) and g.dtype == np.int32


def test_actor_threads_see_whole_parameter_sets_while_the_learner_trains():
    T, B, A, obs_shape = 4, 2, 3, (24, 24, 4)
    _, targs = H.args_pair(rollout_length=T, batch_size=B)
    agent = ImpalaAgent(targs, obs_shape, A, device="cpu")
    obs = np.random.default_rng(1).integers(0, 255, (B,) + obs_shape).astype(np.uint8)
    zeros_a, zeros_r, done = np.zeros(B, np.int32), np.zeros(B, np.float32), np.ones(B, bool)
    states = [agent.state]
    seen, errors = [], []
    stop = threading.Event()

    def actor():
        try:
            while not stop.is_set():
                _, logits, _ = agent.act(obs, zeros_a, zeros_r, done)
                seen.append(logits)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    # more threads than cores, switching often: a lost generator update or
    # a torn parameter read would show
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=actor) for _ in range((os.cpu_count() or 4) + 2)]
    try:
        for t in threads:
            t.start()
        for seed in range(6):
            agent.learn(H.torch_traj(H.random_traj(T, B, obs_shape, A, seed=seed)))
            states.append(agent.state)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(seen) > len(threads)
    # the learner never wrote into a parameter set an actor could read
    assert all(not torch.equal(states[0].params[k], states[-1].params[k])
               for k in ("policy.weight",))
    model = agent.model
    ref = []
    with torch.no_grad():
        for st in states:
            out, _ = functional_call(model, st.params, (
                torch.from_numpy(obs)[None], torch.zeros(1, B, dtype=torch.int32),
                torch.zeros(1, B), torch.ones(1, B, dtype=torch.bool), ()))
            ref.append(out.policy_logits[0].numpy())
    for logits in seen:
        assert any(np.array_equal(logits, r) for r in ref)
    # every draw was handed out once: the generator advanced by exactly the
    # acts made, as one thread drawing them in turn would have left it
    fresh = torch.Generator().manual_seed(targs.seed)
    for _ in range(len(seen)):
        torch.rand((B, A), generator=fresh)
    assert torch.equal(fresh.get_state(), agent.generator.get_state())


class _SigtermWhenGuarded:
    """SIGTERM to this process ``delay`` seconds after a handler other than
    the default is installed (the trainer's guard), so the signal never
    lands unguarded."""

    def __init__(self, delay: float) -> None:
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(delay,), daemon=True)

    def _run(self, delay: float) -> None:
        while signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            if self.done.wait(0.01):
                return
        if not self.done.wait(delay):
            os.kill(os.getpid(), signal.SIGTERM)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()


def _host_args(tmp_path, **kw):
    base = dict(env_id="CartPole-v1", rollout_length=8, batch_size=4, num_actors=2,
                num_buffers=8, use_lstm=False, hidden_size=32, logger_backend="none",
                logger_frequency=10**9, work_dir=str(tmp_path), max_timesteps=0)
    base.update(kw)
    return tconfig.ImpalaArguments(**base)


def _cartpole_fns(n_actors, envs_per_actor):
    return [(lambda i=i: make_vect_envs("CartPole-v1", num_envs=envs_per_actor, seed=i,
                                        async_envs=False)) for i in range(n_actors)]


def test_host_actor_learner_trainer_smoke(tmp_path):
    args = _host_args(tmp_path, telemetry_interval_s=0.5, logger_frequency=128)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    trainer = tal.HostActorLearnerTrainer(args, agent, _cartpole_fns(2, 2))
    result = trainer.train(total_frames=512)
    trainer.close()
    assert result["env_frames"] >= 512 and np.isfinite(result["total_loss"])
    assert int(agent.state.step) == trainer.learn_steps > 0
    assert trainer.param_server.version == trainer.learn_steps
    assert os.path.isdir(trainer.resume_ckpt_path)
    logged = [m for _, kind, m in trainer.log_history if kind == "train"]
    assert logged and all(np.isfinite(m["total_loss"]) for m in logged)
    prom = Path(trainer.work_dir) / "telemetry" / "metrics.prom"
    assert "scalerl_train_sps" in prom.read_text()
    assert "scalerl_queue_slots 8" in prom.read_text()


class _CrashOnceVec:
    """The first instance raises after ``crash_after`` steps; rebuilds run."""

    built = 0

    def __init__(self, inner, crash_after: int) -> None:
        type(self).built += 1
        self._inner = inner
        self._crash_after = crash_after if type(self).built == 1 else None
        self._steps = 0

    def step(self, actions):
        self._steps += 1
        if self._crash_after is not None and self._steps >= self._crash_after:
            raise RuntimeError("env backend died")
        return self._inner.step(actions)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_host_actor_elastic_restart(tmp_path):
    _CrashOnceVec.built = 0
    args = _host_args(tmp_path, num_actors=1)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")

    def env_fn():
        return _CrashOnceVec(make_vect_envs("CartPole-v1", num_envs=4, seed=0,
                                            async_envs=False), crash_after=12)

    trainer = tal.HostActorLearnerTrainer(args, agent, [env_fn], max_actor_restarts=1)
    result = trainer.train(total_frames=512)
    trainer.close()
    assert result["env_frames"] >= 512
    assert trainer.actor_restarts == 1 and _CrashOnceVec.built == 2


def test_host_actor_crash_without_budget_reraises(tmp_path):
    _CrashOnceVec.built = 0
    args = _host_args(tmp_path, num_actors=1, save_model=False)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    trainer = tal.HostActorLearnerTrainer(args, agent, [lambda: _CrashOnceVec(
        make_vect_envs("CartPole-v1", num_envs=4, seed=0, async_envs=False), 5)])
    with pytest.raises(RuntimeError, match="actor worker died"):
        trainer.train(total_frames=10**6)
    trainer.close()


def test_host_actor_learner_prefetch_thread(tmp_path):
    args = _host_args(tmp_path, num_learner_threads=2, logger_frequency=256)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    trainer = tal.HostActorLearnerTrainer(args, agent, _cartpole_fns(2, 2))
    result = trainer.train(total_frames=512)
    trainer.close()
    assert result["env_frames"] >= 512 and np.isfinite(result["total_loss"])
    assert int(agent.state.step) > 0


def test_host_trainer_on_tensor_env_views_and_sigterm_resume(tmp_path):
    args = _host_args(tmp_path, save_frequency=10**9)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    fns = [lambda: TensorVectorView(TensorCartPole(2, device="cpu")) for _ in range(2)]
    trainer = tal.HostActorLearnerTrainer(args, agent, fns)
    with _SigtermWhenGuarded(0.5):
        trainer.train(total_frames=10**9)
    trainer.close()
    frames, step = trainer.env_frames, int(agent.state.step)
    assert frames > 0 and step > 0 and os.path.isdir(trainer.resume_ckpt_path)
    args_b = _host_args(tmp_path, save_frequency=10**9, resume=trainer.work_dir)
    agent_b = ImpalaAgent(args_b, (4,), 2, device="cpu")
    trainer_b = tal.HostActorLearnerTrainer(args_b, agent_b, fns)
    assert trainer_b.try_resume() and trainer_b.env_frames == frames
    assert int(agent_b.state.step) == step
    H_leaves = zip(agent.state.params.values(), agent_b.state.params.values())
    assert all(torch.equal(a, b) for a, b in H_leaves)
    trainer_b.close()


def test_unported_actor_modes_name_their_modules(tmp_path):
    # process is ported in its own trainer's module, which the refusal
    # names; serving is this trainer's own: a server and a client an actor,
    # which close() stops
    args = _host_args(tmp_path, actor_mode="process")
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    with pytest.raises(ValueError, match="trainer/process_actor_learner.py"):
        tal.HostActorLearnerTrainer(args, agent, _cartpole_fns(2, 2))
    args = _host_args(tmp_path, actor_mode="serving")
    trainer = tal.HostActorLearnerTrainer(args, ImpalaAgent(args, (4,), 2, device="cpu"),
                                          _cartpole_fns(2, 2))
    server = trainer.inference_server
    assert server is not None and len(trainer._serving_clients) == 2
    trainer.close()
    assert not any(t.is_alive() for t in server._threads)


def _device_args(tmp_path, **kw):
    base = dict(env_id="CartPole-v1", rollout_length=4, num_envs=4, batch_size=4,
                use_lstm=False, hidden_size=16, logger_backend="none",
                logger_frequency=10**9, work_dir=str(tmp_path), max_timesteps=0,
                save_frequency=10**9, telemetry_interval_s=0.0)
    base.update(kw)
    return tconfig.ImpalaArguments(**base)


def _device_trainer(args, iters=2):
    venv = make_tensor_vec_env("CartPole-v1", args.num_envs, device="cpu")
    agent = ImpalaAgent(args, venv.observation_shape, venv.num_actions, device="cpu")
    return tal.DeviceActorLearnerTrainer(args, agent, venv, iters_per_call=iters), agent


def test_device_trainer_save_resume_and_finished_noop(tmp_path):
    per_call = 4 * 4 * 2
    trainer, agent = _device_trainer(_device_args(tmp_path, checkpoint_keep_last=1))
    out = trainer.train(total_frames=3 * per_call)
    trainer.close()
    assert out["env_frames"] == 3 * per_call and out["chunks_done"] == 3
    assert int(agent.state.step) == 6
    saved = {k: v.clone() for k, v in agent.state.params.items()}
    run_dir = trainer.work_dir
    assert os.path.exists(os.path.join(trainer.resume_ckpt_path, "integrity_manifest.json"))
    # resume to a budget of 5 calls: 2 more, from the saved state
    t2, a2 = _device_trainer(_device_args(tmp_path, resume=run_dir, checkpoint_keep_last=1))
    state = t2.load_resume_checkpoint(t2._resume_pytree())
    assert int(state["env_frames"]) == 3 * per_call
    assert all(torch.equal(state["agent"].params[k], v) for k, v in saved.items())
    out2 = t2.train(total_frames=5 * per_call)
    t2.close()
    assert out2["env_frames"] == 5 * per_call and int(a2.state.step) == 10
    assert os.path.isdir(t2.resume_ckpt_path + ".prev")
    # a finished run resumes as a no-op
    t3, a3 = _device_trainer(_device_args(tmp_path, resume=run_dir))
    assert t3.train(total_frames=4 * per_call) == {"env_frames": 5.0 * per_call, "sps": 0.0}
    assert int(a3.state.step) == 10  # restored, and trained no further
    t3.close()


def test_resume_without_a_checkpoint_raises(tmp_path):
    trainer, _ = _device_trainer(_device_args(tmp_path, resume=str(tmp_path / "nowhere")))
    with pytest.raises(FileNotFoundError, match="no resume checkpoint"):
        trainer.train(total_frames=64)
    trainer.close()


def test_device_trainer_sigterm_checkpoints_chunks_done_and_resumes(tmp_path):
    args = _device_args(tmp_path)
    trainer, agent = _device_trainer(args, iters=1)
    per_call = 4 * 4
    with _SigtermWhenGuarded(0.5):
        out = trainer.train(total_frames=10**7)
    trainer.close()
    chunks = int(out["chunks_done"])
    assert 0 < chunks < 10**7 // per_call and out["env_frames"] == chunks * per_call
    assert int(agent.state.step) == chunks
    t2, a2 = _device_trainer(_device_args(tmp_path, resume=trainer.work_dir), iters=1)
    out2 = t2.train(total_frames=(chunks + 3) * per_call)
    t2.close()
    assert out2["env_frames"] == (chunks + 3) * per_call
    assert int(a2.state.step) == chunks + 3


def _dqn_args(root, **kw):
    base = dict(env_id="CartPole-v1", num_envs=4, buffer_size=2000, batch_size=32,
                max_timesteps=600, warmup_learn_steps=100, train_frequency=4,
                learning_rate=2.5e-3, eval_frequency=10**9, logger_frequency=200,
                save_frequency=10**9, work_dir=str(root), logger_backend="none",
                hidden_sizes="32,32", use_per=True, telemetry_interval_s=0.0)
    base.update(kw)
    return tconfig.DQNArguments(**base)


def _dqn(args):
    envs = make_vect_envs("CartPole-v1", num_envs=args.num_envs, seed=args.seed,
                          async_envs=False)
    return envs, tdqn.DQNAgent(args, (4,), 2, device="cpu")


def test_dqn_kill_and_resume(tmp_path):
    args_full = _dqn_args(tmp_path / "full", save_frequency=300)
    envs, agent = _dqn(args_full)
    full = OffPolicyTrainer(args_full, agent, envs)
    full.run()
    full.close()
    args_a = _dqn_args(tmp_path / "killed", max_timesteps=300, save_frequency=300)
    envs_a, agent_a = _dqn(args_a)
    trainer_a = OffPolicyTrainer(args_a, agent_a, envs_a)
    trainer_a.run()
    trainer_a.close()
    assert os.path.isdir(os.path.join(trainer_a.model_save_dir, "ckpt_300"))
    saved_prio = trainer_a.sampler.buffer.state.priorities.clone()
    args_b = _dqn_args(tmp_path / "killed", save_frequency=300, resume=trainer_a.work_dir)
    envs_b, agent_b = _dqn(args_b)
    trainer_b = OffPolicyTrainer(args_b, agent_b, envs_b)
    assert trainer_b.work_dir == trainer_a.work_dir
    assert trainer_b.try_resume()
    assert trainer_b.global_step == trainer_a.global_step
    assert trainer_b.learn_steps == trainer_a.learn_steps
    assert torch.equal(trainer_b.sampler.buffer.state.priorities, saved_prio)
    assert all(torch.equal(agent_b.state.params[k], v) for k, v in agent_a.state.params.items())
    assert agent_b.eps == agent_a.eps
    trainer_b.resuming = False  # resumed above
    trainer_b.run()
    trainer_b.close()
    assert trainer_b.global_step == full.global_step
    assert os.path.isdir(os.path.join(trainer_b.model_save_dir, "ckpt_final"))


def test_dqn_tripwire_restores_the_last_good_checkpoint(tmp_path):
    args = _dqn_args(tmp_path, max_timesteps=400, divergence_rollback_steps=3)
    envs, agent = _dqn(args)
    trainer = OffPolicyTrainer(args, agent, envs)
    sample = trainer.sampler.sample
    poison = {"left": 0}

    def poisoned(*a, **kw):
        batch = sample(*a, **kw)
        if poison["left"] > 0:
            poison["left"] -= 1
            batch = dict(batch, reward=batch["reward"] * float("nan"))
        return batch

    trainer.sampler.sample = poisoned
    orig_step = trainer.train_step
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        if calls["n"] == 20:  # three poisoned batches in a row, once
            poison["left"] = 3
        return orig_step()

    trainer.train_step = step
    trainer.run()
    trainer.close()
    assert trainer.tripwire.trips == 1 and float(trainer.skipped_steps) == 3.0
    # the rollback restored the step-0 checkpoint, and learning went on
    assert 0 < trainer.learn_steps < calls["n"]
    assert all(bool(torch.isfinite(v).all()) for v in agent.state.params.values())


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(run_dir):
    out = set()
    for root, dirs, _ in os.walk(run_dir):
        rel = os.path.relpath(root, run_dir)
        out |= {os.path.normpath(os.path.join(rel, d)) for d in dirs}
    # two levels: the checkpoint directories' insides differ by design
    return {p for p in out if p.count(os.sep) <= 1 and ".tmp" not in p}


@pytest.mark.parametrize("backend", ["jax", "gym"])
def test_example_runs_on_the_host_with_the_jax_examples_layout(tmp_path, backend, monkeypatch):
    argv = ["--env-backend", backend, "--env-id", "CartPole-v1", "--max-timesteps", "256",
            "--use-lstm", "false", "--hidden-size", "16", "--rollout-length", "8",
            "--num-envs", "4", "--num-actors", "2", "--batch-size", "4", "--num-buffers", "4",
            "--logger-frequency", "64", "--telemetry-interval-s", "0.2", "--seed", "3"]
    port = _load_example("train_impala_torch")
    out = port.main(argv + ["--device", "cpu", "--work-dir", str(tmp_path / "torch")])
    assert out["result"]["env_frames"] >= 256 and out["agent"].device.type == "cpu"
    monkeypatch.setattr(sys, "argv", ["train_impala.py"] + argv + [
        "--platform", "cpu", "--work-dir", str(tmp_path / "jax")])
    _load_example("train_impala").main()
    tdir = tmp_path / "torch" / "scalerl_tpu" / "CartPole-v1" / "impala"
    jdir = tmp_path / "jax" / "scalerl_tpu" / "CartPole-v1" / "impala"
    (trun,), (jrun,) = os.listdir(tdir), os.listdir(jdir)
    assert trun.startswith("impala_3_") and jrun.startswith("impala_3_")
    assert _layout(tdir / trun) == _layout(jdir / jrun)
    assert {"model_dir/resume", "model_dir/ckpt_final", "tb_log", "text_log",
            "telemetry"} <= _layout(tdir / trun)
