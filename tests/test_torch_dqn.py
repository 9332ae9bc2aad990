"""The DQN slice of the PyTorch port against the JAX package.

Same weights (converted from the JAX agent's init), same batches and the
same uniform draws (numpy seeds, and the JAX side's own ``jax.random``
output where it samples).  float32 throughout:

- ``QNet`` logits, the DQN losses and one guarded learn step (loss, |TD|,
  params, target params, Adam moments) at 1e-5;
- the slice as a whole: 20 iterations of PER sample -> learn -> priority
  update on both packages from one buffer, indices exact, the priority
  plane and the params at 1e-5 (each learn step rounds differently in XLA
  and PyTorch, and Adam carries the difference forward);
- the off-policy trainer end to end on gym CartPole, on the host.
"""

import dataclasses

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import dqn as tdqn
from scalerl_torch.data import prioritized as tprio
from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
from scalerl_torch.models.mlp import QNet as TQNet
from scalerl_torch.ops import losses as tlosses
from scalerl_torch.trainer.off_policy import OffPolicyTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics as TEpisodeMetrics
from scalerl_torch.utils.schedulers import LinearDecayScheduler as TLinearDecay
from scalerl_torch.utils.tree import soft_target_update as tsoft
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import dqn as jdqn
from scalerl_tpu.data import prioritized as jprio
from scalerl_tpu.models.mlp import QNet as JQNet
from scalerl_tpu.ops import losses as jlosses
from scalerl_tpu.utils.metrics import EpisodeMetrics as JEpisodeMetrics
from scalerl_tpu.utils.schedulers import LinearDecayScheduler as JLinearDecay
from scalerl_tpu.utils.tree import soft_target_update as jsoft

torch.set_num_threads(1)

OBS, A, B = (4,), 2, 16
SMALL = dict(hidden_sizes="32,32", max_timesteps=1000, batch_size=B, buffer_size=64)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_to_torch(jstate) -> tdqn.DQNTrainState:
    return tdqn.DQNTrainState(
        params=convert.dense_stack_to_torch(_to_numpy(jstate.params)),
        target_params=convert.dense_stack_to_torch(_to_numpy(jstate.target_params)),
        opt_state=convert.adam_state_to_torch(_to_numpy(jstate.opt_state)),
        step=torch.tensor(int(jstate.step), dtype=torch.int32),
    )


def _close(got: torch.Tensor, want, atol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=1e-5,
                               err_msg=msg)


def _assert_state_close(tstate, jstate, atol=1e-5):
    want = _state_to_torch(jstate)
    for group in ("params", "target_params"):
        for k, v in getattr(want, group).items():
            _close(getattr(tstate, group)[k], v, atol, f"{group}.{k}")
    for moment in ("mu", "nu"):
        for k, v in want.opt_state[moment].items():
            _close(tstate.opt_state[moment][k], v, atol, f"{moment}.{k}")
    assert int(tstate.opt_state["count"]) == int(want.opt_state["count"])
    assert int(tstate.step) == int(jstate.step)


def _batch(seed, with_weights=True):
    rng = np.random.default_rng(seed)
    batch = dict(
        obs=rng.normal(size=(B,) + OBS).astype(np.float32),
        next_obs=rng.normal(size=(B,) + OBS).astype(np.float32),
        action=rng.integers(0, A, size=B).astype(np.int32),
        reward=rng.normal(size=B).astype(np.float32),
        done=rng.uniform(size=B) < 0.2,
    )
    if with_weights:
        batch["weights"] = rng.uniform(0.2, 1.0, size=B).astype(np.float32)
        batch["n_steps"] = rng.integers(1, 4, size=B).astype(np.int32)
    return batch


def _pair(**kw):
    fields = {**SMALL, **kw}
    jargs, targs = jconfig.DQNArguments(**fields), tconfig.DQNArguments(**fields)
    jagent = jdqn.DQNAgent(jargs, OBS, A, donate_state=False)
    tagent = tdqn.DQNAgent(targs, OBS, A, device="cpu")
    tagent.state = _state_to_torch(jagent.state)
    return jagent, tagent


def test_config_defaults_match_jax():
    jargs, targs = jconfig.DQNArguments(), tconfig.DQNArguments()
    for f in dataclasses.fields(targs):
        assert getattr(targs, f.name) == getattr(jargs, f.name), f.name


def test_unported_features_are_refused():
    """NoisyNet and C51 are ported; what the replay family still refuses is
    its multi-device paths, each naming the module it needs, and C51 in
    Ape-X, as the JAX package refuses it."""
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole, TensorRecall
    from scalerl_torch.trainer.apex import ApexTrainer
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

    # resume, the tripwire and the checkpoint fields are ported: accepted
    tconfig.DQNArguments(resume="runs/x", divergence_rollback_steps=3,
                         save_frequency=100).validate()
    tdqn.DQNAgent(tconfig.DQNArguments(noisy_dqn=True, categorical_dqn=True), OBS, A,
                  device="cpu")

    def envs(_):
        return TensorVectorView(TensorCartPole(2, device="cpu"))

    apex = dict(logger_backend="none", telemetry_interval_s=0.0, save_model=False, num_actors=1,
                buffer_size=512, batch_size=8)
    c51 = tconfig.ApexArguments(categorical_dqn=True, **apex)
    with pytest.raises(ValueError, match="categorical_dqn"):
        ApexTrainer(c51, tdqn.DQNAgent(c51, OBS, A, device="cpu"), envs)
    args = tconfig.ApexArguments(**apex)
    meshed = tdqn.DQNAgent(args, OBS, A, device="cpu")
    meshed.enable_mesh("dp=1")  # a one-device mesh: Ape-X builds its sharded replay
    trainer = ApexTrainer(args, meshed, envs)
    assert isinstance(trainer.buffer, ShardedPrioritizedReplay)
    trainer.close()
    rargs = tconfig.R2D2Arguments(hidden_size=8, logger_backend="none", save_model=False,
                                  telemetry_interval_s=0.0)
    env = TensorRecall(2, device="cpu")
    agent = R2D2Agent(rargs, env.observation_shape, env.num_actions, device="cpu")
    # one process: a two-device mesh needs a process group of two ranks
    with pytest.raises(ValueError, match="init_process_group"):
        agent.enable_mesh("dp=2")
    # the mesh-fused loop on a one-device mesh builds
    assert DeviceR2D2Trainer(rargs, agent, env, mesh="dp=1").mesh.shape["dp"] == 1


@pytest.mark.parametrize("dueling", [False, True])
def test_qnet_matches_jax(dueling):
    obs = np.random.default_rng(0).normal(size=(8, 2, 3)).astype(np.float32)  # flattened
    jnet = JQNet(action_dim=3, hidden_sizes=(32, 16), dueling=dueling)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    tnet = TQNet((2, 3), 3, hidden_sizes="32,16", dueling=dueling, device="cpu")
    state = convert.dense_stack_to_torch(_to_numpy(jparams))
    assert set(state) == set(tnet.state_dict())
    tnet.load_state_dict(state)
    with torch.no_grad():
        _close(tnet(torch.from_numpy(obs)), jnet.apply(jparams, jnp.asarray(obs)))


@pytest.mark.parametrize("double_dqn", [True, False])
def test_losses_match_jax(double_dqn):
    rng = np.random.default_rng(3)
    q, qo, qt = (rng.normal(size=(B, 4)).astype(np.float32) * 3 for _ in range(3))
    r, d, w = (rng.uniform(size=B).astype(np.float32) for _ in range(3))
    a = rng.integers(0, 4, size=B).astype(np.int32)
    jt = jlosses.double_dqn_targets(*map(jnp.asarray, (qo, qt, r, d)), double_dqn=double_dqn)
    tt = tlosses.double_dqn_targets(*map(torch.from_numpy, (qo, qt, r, d)), double_dqn=double_dqn)
    _close(tt, jt)
    for weights in (None, w):
        jl, jtd = jlosses.dqn_loss(jnp.asarray(q), jnp.asarray(a), jt,
                                   None if weights is None else jnp.asarray(weights))
        tl, ttd = tlosses.dqn_loss(torch.from_numpy(q), torch.from_numpy(a), tt,
                                   None if weights is None else torch.from_numpy(weights))
        _close(tl, jl)
        _close(ttd, jtd)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(5)
    o, t = rng.normal(size=(3, 7)).astype(np.float32), rng.normal(size=(3, 7)).astype(np.float32)
    got = tsoft({"w": torch.from_numpy(o)}, {"w": torch.from_numpy(t)}, 0.005)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsoft({"w": o}, {"w": t}, 0.005)["w"]))
    js, ts = JLinearDecay(1.0, 0.05, 37), TLinearDecay(1.0, 0.05, 37)
    assert [js.step(4) for _ in range(12)] == [ts.step(4) for _ in range(12)]
    jm, tm = JEpisodeMetrics(4), TEpisodeMetrics(4)
    for _ in range(30):
        rew, done = rng.normal(size=4), rng.uniform(size=4) < 0.2
        assert jm.step(rew, done) == tm.step(rew, done)
    assert jm.summary() == tm.summary()
    assert jm.episode_lengths == tm.episode_lengths


LEARN_CASES = {
    "per_soft": dict(),
    "hard_linear_lr_dueling_clip": dict(use_soft_update=False, target_update_frequency=3,
                                        lr_scheduler="linear", dueling_dqn=True,
                                        double_dqn=False, max_grad_norm=0.5),
}


@pytest.mark.parametrize("case", list(LEARN_CASES), ids=list(LEARN_CASES))
def test_learn_step_matches_jax(case):
    jagent, tagent = _pair(**LEARN_CASES[case])
    jlearn = jax.jit(jagent._learn_raw)
    jstate = jagent.state
    with_weights = case == "per_soft"
    for i in range(2):  # warm the state: params != target params, moments != 0
        jstate, _, _ = jlearn(jstate, _batch(10 + i, with_weights))
    tagent.state = _state_to_torch(jstate)
    batch = _batch(1, with_weights)
    jstate, jm, jtd = jlearn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, td_abs = tagent.learn_device(batch)
    for k in ("loss", "td_error_mean", "q_mean", "skipped_steps"):
        _close(metrics[k], jm[k], msg=k)
    _close(td_abs, jtd)
    _assert_state_close(tagent.state, jstate)


def test_guard_skips_a_nonfinite_step_and_zeroes_its_td():
    jagent, tagent = _pair()
    batch = _batch(2)
    batch["reward"][3] = np.nan
    before = _state_to_torch(jagent.state)
    jstate, jm, jtd = jax.jit(jagent._learn_raw)(jagent.state, batch)
    metrics = tagent.learn(batch)
    td_abs = metrics["td_abs"]
    assert metrics["skipped_steps"] == 1.0 == float(jm["skipped_steps"])
    assert metrics["eps"] == tagent.eps
    assert float(td_abs[3]) == 0.0 and bool(torch.isfinite(td_abs).all())
    _close(td_abs, jtd)
    for k, v in before.params.items():
        assert torch.equal(tagent.state.params[k], v)
    assert int(tagent.state.step) == 0


def test_actions_are_greedy_at_eps_zero_and_match_jax():
    jagent, tagent = _pair()
    obs = np.random.default_rng(6).normal(size=(32,) + OBS).astype(np.float32)
    want = np.asarray(jagent.predict(obs))
    np.testing.assert_array_equal(tagent.predict(obs).numpy(), want)
    tagent.eps = 0.0
    np.testing.assert_array_equal(tagent.get_action(obs).numpy(), want)
    assert tagent.get_action(obs[0]).shape == ()
    tagent.eps = 1.0
    acts = tagent.get_action(np.zeros((256,) + OBS, np.float32))
    assert set(acts.tolist()) == {0, 1}


def test_slice_matches_jax_over_20_learn_steps():
    """PER sample -> learn -> update_priorities, 20 times on both packages
    from one buffer; the port runs its kernel wrappers (plain on the host)."""
    cap, envs, S, n_step = 32, 4, B, 3
    jagent, tagent = _pair(buffer_size=cap * envs, use_per=True, n_steps=n_step)
    jbuf = jprio.PrioritizedReplayBuffer(OBS, cap, num_envs=envs, alpha=0.6, n_step=n_step,
                                         sample_method="hierarchical", update_method="xla")
    tbuf = tprio.PrioritizedReplayBuffer(OBS, cap, num_envs=envs, alpha=0.6, n_step=n_step,
                                         sample_method="pallas", update_method="pallas",
                                         device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(cap + 5):  # wraps the ring
        done = rng.uniform(size=envs) < 0.1
        step = dict(obs=rng.normal(size=(envs, 4)).astype(np.float32),
                    next_obs=rng.normal(size=(envs, 4)).astype(np.float32),
                    action=rng.integers(0, A, size=envs), reward=rng.normal(size=envs).astype(np.float32),
                    done=done, boundary=done | (rng.uniform(size=envs) < 0.05))
        jbuf.save_to_memory(**step)
        tbuf.save_to_memory(**step)
    jlearn = jax.jit(jagent._learn_raw)
    jstate = jagent.state
    for i in range(20):
        key = jax.random.PRNGKey(100 + i)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (S,))))
        beta = 0.4 + 0.03 * i
        jb = jprio.per_sample(jbuf.state, key, S, jnp.float32(0.6), jnp.float32(beta),
                              n_step=n_step, gamma=0.99, method="hierarchical")
        tb = tprio.per_sample_from_uniforms(tbuf.state, u, 0.6, beta, n_step, 0.99, "pallas")
        np.testing.assert_array_equal(tb["indices"].numpy(), np.asarray(jb["indices"]),
                                      err_msg=f"iteration {i}")
        jstate, _, jtd = jlearn(jstate, jb)
        _, ttd = tagent.learn_device(tb)
        jbuf.update_priorities(jb["indices"], jtd + 1e-6)
        tbuf.update_priorities(tb["indices"], ttd + 1e-6)
    _close(tbuf.state.priorities, jbuf.state.priorities)
    _assert_state_close(tagent.state, jstate)


def _cartpole(num_envs):
    return gym.vector.SyncVectorEnv(
        [lambda: gym.make("CartPole-v1") for _ in range(num_envs)],
        autoreset_mode=gym.vector.AutoresetMode.SAME_STEP,
    )


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_wrappers"])
def test_off_policy_trainer_per_nstep_smoke(use_pallas):
    """Twin of tests/test_dqn_e2e.py::test_dqn_per_nstep_smoke, on the host."""
    args = tconfig.DQNArguments(
        num_envs=4, buffer_size=5000, batch_size=64, max_timesteps=800, warmup_learn_steps=200,
        train_frequency=4, learning_rate=2.5e-3, eval_frequency=400, logger_frequency=400,
        eval_episodes=2, use_per=True, n_steps=3, use_pallas=use_pallas,
    )
    envs, eval_envs = _cartpole(4), _cartpole(2)
    agent = tdqn.DQNAgent(args, envs.single_observation_space.shape,
                          envs.single_action_space.n, device="cpu")
    trainer = OffPolicyTrainer(args, agent, envs, eval_envs=eval_envs)
    summary = trainer.run()
    assert trainer.global_step >= args.max_timesteps
    assert trainer.learn_steps > 50 and summary["episodes"] > 0
    assert float(trainer.skipped_steps) == 0.0
    logged = [m for _, kind, m in trainer.log_history if kind == "train"]
    assert len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged)
    assert [kind for _, kind, _ in trainer.log_history].count("eval") == 2
    assert float(trainer.sampler.buffer.state.max_priority) >= 1.0
    trainer.close()
    envs.close()
    eval_envs.close()


def test_trainer_refuses_continuous_actions():
    """The refusal is lifted (SAC and TD3 are ported): a ``Box`` action
    space gives a float32 action plane of its shape, as in the JAX trainer,
    and a ``Discrete`` one an int64 plane of scalars."""
    envs = gym.vector.SyncVectorEnv([lambda: gym.make("Pendulum-v1")])
    args = tconfig.DQNArguments(num_envs=1, batch_size=8, buffer_size=64)
    agent = tdqn.DQNAgent(args, (3,), 2, device="cpu")
    trainer = OffPolicyTrainer(args, agent, envs)
    assert trainer.sampler.buffer.spec["action"] == ((1,), torch.float32)
    trainer.close()
    envs.close()
    envs = gym.vector.SyncVectorEnv([lambda: gym.make("CartPole-v1")])
    trainer = OffPolicyTrainer(args, tdqn.DQNAgent(args, (4,), 2, device="cpu"), envs)
    assert trainer.sampler.buffer.spec["action"] == ((), torch.int64)
    trainer.close()
    envs.close()
