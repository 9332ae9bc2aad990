"""Ape-X on the PyTorch port against the JAX package, and its trainer on the host.

- ``fold_n_step`` on random rollouts with terminations and truncations:
  exactly the JAX package's transitions;
- ``ApexTrainer`` end to end on the CPU (the twin of
  ``tests/test_apex.py::test_apex_trainer_e2e_learns_cartpole``), with the
  PER kernels' wrappers and with the plain versions; the resume round trip
  bit for bit; an actor's crash re-raised in the learner; the refusals.
"""

import numpy as np
import pytest
import torch

from scalerl_torch.agents.dqn import DQNAgent
from scalerl_torch.config import ApexArguments
from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
from scalerl_torch.envs.gym_env import TensorVectorView
from scalerl_torch.envs.tensor_envs import TensorCartPole
from scalerl_torch.trainer.apex import ApexTrainer, fold_n_step
from scalerl_torch.utils.checkpoint import flatten_tree
from scalerl_tpu.trainer.apex import fold_n_step as jax_fold_n_step

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_fold_n_step_matches_jax_exactly(n):
    rng = np.random.default_rng(n)
    T, W = 12, 5
    obs = rng.normal(size=(T, W, 3)).astype(np.float32)
    next_obs = rng.normal(size=(T, W, 3)).astype(np.float32)
    action = rng.integers(0, 4, size=(T, W)).astype(np.int32)
    reward = rng.normal(size=(T, W)).astype(np.float32)
    term = rng.uniform(size=(T, W)) < 0.15
    trunc = (rng.uniform(size=(T, W)) < 0.1) & ~term
    got = fold_n_step(obs, action, reward, next_obs, term, trunc, 0.97, n)
    want = jax_fold_n_step(obs, action, reward, next_obs, term, trunc, 0.97, n)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _args(**kw):
    base = dict(env_id="CartPole-v1", num_actors=2, num_envs=2, rollout_length=10, n_steps=3,
                batch_size=16, buffer_size=4096, warmup_learn_steps=32, hidden_sizes="32,32",
                logger_backend="none", telemetry_interval_s=0.0, save_model=False, use_per=True)
    base.update(kw)
    return ApexArguments(**base)


def _make_envs(args):
    def make(actor_id):
        return TensorVectorView(TensorCartPole(args.num_envs, device="cpu"))

    return make


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_wrappers"])
def test_apex_trainer_e2e_on_the_host(tmp_path, use_pallas):
    args = _args(max_timesteps=3000, logger_frequency=1000, eval_frequency=1500,
                 work_dir=str(tmp_path), learning_rate=3e-3, use_pallas=use_pallas,
                 actor_update_frequency=5)
    agent = DQNAgent(args, (4,), 2, device="cpu")
    eval_envs = TensorVectorView(TensorCartPole(2, device="cpu"))
    trainer = ApexTrainer(args, agent, _make_envs(args), eval_envs)
    assert (trainer.buffer.sample_method, trainer.buffer.update_method) == (
        ("pallas", "pallas") if use_pallas else ("hierarchical", "xla"))
    try:
        summary = trainer.run()
        assert trainer.global_step >= args.max_timesteps
        assert trainer.learn_steps > 0 and int(agent.state.step) == trainer.learn_steps
        assert len(trainer.buffer) > 0 and summary.get("episodes", 0) > 0
        assert trainer.param_server.version >= 1
        logged = [m for _, kind, m in trainer.log_history if kind == "train"]
        assert logged and all(np.isfinite(m["loss"]) for m in logged if "loss" in m)
        assert [kind for _, kind, _ in trainer.log_history].count("eval") >= 1
        # the slabs store each transition's realised window length
        n_steps = trainer.buffer.state.replay.storage["n_steps"]
        assert set(torch.unique(n_steps[: trainer.buffer.state.replay.size]).tolist()) <= {1, 2, 3}
        assert float(trainer.buffer.state.max_priority) > 0.0
        assert np.isfinite(trainer.run_evaluate_episodes(n_episodes=2)["reward_mean"])
        for actor in trainer.actors:
            assert not actor.is_alive() and actor.error is None
            assert set(actor.timings.means()) >= {"rollout", "fold", "priority", "enqueue"}
    finally:
        trainer.close()


def _host_leaves(tree):
    return {p: (v.detach().clone() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_tree(tree)}


def test_apex_resume_roundtrip(tmp_path):
    """Twin of tests/test_apex.py::test_apex_resume_roundtrip: the learner,
    the whole prioritised replay and the counters come back bit for bit."""
    args_a = _args(max_timesteps=1500, logger_frequency=10**9, eval_frequency=10**9,
                   work_dir=str(tmp_path), save_model=True, save_frequency=1000)
    agent_a = DQNAgent(args_a, (4,), 2, device="cpu")
    tr_a = ApexTrainer(args_a, agent_a, _make_envs(args_a))
    tr_a.run()
    assert tr_a.learn_steps > 0
    tr_a.save_resume()
    saved = _host_leaves(tr_a._resume_pytree())
    tr_a.close()

    args_b = _args(max_timesteps=1500, logger_frequency=10**9, eval_frequency=10**9,
                   work_dir=str(tmp_path), resume=tr_a.work_dir)
    agent_b = DQNAgent(args_b, (4,), 2, device="cpu")
    tr_b = ApexTrainer(args_b, agent_b, _make_envs(args_b))
    assert tr_b.try_resume()
    restored = _host_leaves(tr_b._resume_pytree())
    assert set(restored) == set(saved)
    for p, v in saved.items():
        w = restored[p]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), p
        else:
            assert np.array_equal(v, w), p
    assert tr_b.global_step == tr_a.global_step and tr_b.learn_steps == tr_a.learn_steps
    assert tr_b.param_server.version >= 1
    tr_b.close()


class _Boom:
    num_envs = 2

    def reset(self, seed=None):
        raise RuntimeError("env exploded")

    def close(self):
        pass


def test_apex_actor_crash_funnels():
    """Twin of tests/test_apex.py::test_apex_actor_crash_funnels."""
    args = _args(max_timesteps=10**9)
    envs0 = TensorVectorView(TensorCartPole(2, device="cpu"))
    agent = DQNAgent(args, (4,), 2, device="cpu")
    trainer = ApexTrainer(args, agent, lambda i: envs0 if i == 0 else _Boom())
    try:
        with pytest.raises(RuntimeError, match="apex actor 1 crashed"):
            trainer.run()
    finally:
        trainer.close()
    assert all(not a.is_alive() for a in trainer.actors)


def test_apex_refuses_c51_and_shards_replay_for_a_meshed_agent():
    """C51 is refused; a meshed agent gets the sharded replay (here on a
    one-device mesh, which needs no process group)."""
    args = _args(categorical_dqn=True, num_atoms=11)
    agent = DQNAgent(args, (4,), 2, device="cpu")
    with pytest.raises(ValueError, match="categorical_dqn"):
        ApexTrainer(args, agent, _make_envs(args))
    args = _args()
    agent = DQNAgent(args, (4,), 2, device="cpu")
    agent.enable_mesh("dp=1")
    trainer = ApexTrainer(args, agent, _make_envs(args))
    try:
        assert isinstance(trainer.buffer, ShardedPrioritizedReplay)
        assert trainer.buffer.n_shards == 1
        assert agent._learn.batch_mode == "replay_shard"
    finally:
        trainer.close()
