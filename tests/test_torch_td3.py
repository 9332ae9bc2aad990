"""TD3 on the PyTorch port against the JAX package.

Same weights and Adam states (the JAX agent's, converted with
``convert.td3_state_to_torch``), the same replay batches (numpy seeds) and
the same smoothing noise (the JAX step's own ``jax.random`` draw, injected
through the port's ``noise`` argument).  float32 throughout:

- four learn steps at ``policy_delay`` 2 (and three at 3): every param,
  target and Adam moment at 1e-5 after each, so the delayed actor update is
  held both skipped and applied; the actor's Adam count advances only on
  applied steps, as the JAX masked select makes it;
- the smoothing noise is clipped at ``target_noise_clip x action_scale``
  (a large injected draw lands on the bound, as in JAX);
- actions stay inside asymmetric Box bounds, and ``predict`` is
  deterministic;
- ``OffPolicyTrainer`` on gym's ``Pendulum-v1`` with PER through both PER
  halves' plain versions.
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
from scalerl_torch.agents import td3 as ttd3
from scalerl_torch.trainer.off_policy import OffPolicyTrainer
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import td3 as jtd3

torch.set_num_threads(1)

OBS, ACT, B = 3, 2, 16
LOW, HIGH = np.array([-2.0, -0.5], np.float32), np.array([1.0, 1.5], np.float32)
SMALL = dict(hidden_sizes="32,32", batch_size=B, buffer_size=64, max_timesteps=1000)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(**kw):
    fields = {**SMALL, **kw}
    jargs, targs = jconfig.TD3Arguments(**fields), tconfig.TD3Arguments(**fields)
    jagent = jtd3.TD3Agent(jargs, (OBS,), LOW, HIGH)
    tagent = ttd3.TD3Agent(targs, (OBS,), LOW, HIGH, device="cpu")
    tagent.state = convert.td3_state_to_torch(_to_numpy(jagent.state))
    return jagent, tagent


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(B, OBS)).astype(np.float32),
        next_obs=rng.normal(size=(B, OBS)).astype(np.float32),
        action=rng.uniform(LOW, HIGH, size=(B, ACT)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        done=rng.uniform(size=B) < 0.3,
        weights=rng.uniform(0.2, 1.0, size=B).astype(np.float32),
    )


def _jax_noise(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 0x7D3), step)
    return torch.tensor(np.asarray(jax.random.normal(key, (B, ACT))))


def _close(got, want, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=1e-5,
                               err_msg=msg)


def _assert_state_close(tstate, jstate, atol=1e-5):
    want = convert.td3_state_to_torch(_to_numpy(jstate))
    for f in dataclasses.fields(want):
        got, exp = getattr(tstate, f.name), getattr(want, f.name)
        if f.name.endswith("_opt"):
            for moment in ("mu", "nu"):
                for k, v in exp[moment].items():
                    _close(got[moment][k], v, atol, f"{f.name}.{moment}.{k}")
            assert int(got["count"]) == int(exp["count"]), f.name
            assert got["count"].dtype == torch.int32
        elif f.name == "step":
            assert int(got) == int(exp)
        else:
            for k, v in exp.items():
                _close(got[k], v, atol, f"{f.name}.{k}")


@pytest.mark.parametrize("policy_delay,steps", [(2, 4), (3, 3)])
def test_learn_steps_match_jax_with_the_delayed_actor(policy_delay, steps):
    jagent, tagent = _pair(policy_delay=policy_delay)
    for step in range(steps):
        batch = _batch(step)
        before = {k: v.clone() for k, v in tagent.state.actor_params.items()}
        jstate, jmetrics, jtd = jagent._learn(
            jagent.state, {k: jnp.asarray(v) for k, v in batch.items()})
        jagent.state = jstate
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        tagent.state, tmetrics, ttd = tagent._learn(tagent.state, tbatch,
                                                    _jax_noise(jagent.args.seed, step))
        _assert_state_close(tagent.state, jstate)
        _close(ttd, jtd, msg="td_abs")
        for k, v in jmetrics.items():
            _close(tmetrics[k], v, 1e-4 if "loss" in k else 1e-5, k)
        applied = (step + 1) % policy_delay == 0
        moved = any(not torch.equal(before[k], v) for k, v in tagent.state.actor_params.items())
        assert moved == applied, step
        assert int(tagent.state.actor_opt["count"]) == (step + 1) // policy_delay
        assert int(tagent.state.critic_opt["count"]) == step + 1


def test_target_smoothing_noise_is_clipped():
    jagent, tagent = _pair(target_noise_clip=0.1)
    batch = _batch(7)
    big = torch.full((B, ACT), 50.0)
    big[::2] = -50.0
    jnoise = jnp.asarray(big.numpy())
    # the JAX step with the same large draw: its key is replaced by a
    # normal() that returns the injected values
    orig = jax.random.normal
    try:
        jax.random.normal = lambda key, shape, *a, **k: jnoise
        jstate, _, jtd = jax.jit(jagent._learn_raw)(
            jagent.state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jax.random.normal = orig
    tstate, _, ttd = tagent._learn(tagent.state, {k: torch.tensor(v) for k, v in batch.items()},
                                   big)
    _close(ttd, jtd)
    _assert_state_close(tstate, jstate)


def test_actions_respect_bounds_and_predict_is_deterministic():
    _, tagent = _pair(explore_noise_std=0.5)
    obs = np.random.default_rng(0).normal(size=(256, OBS)).astype(np.float32) * 10
    for a in (tagent.get_action(obs), tagent.predict(obs)):
        assert a.shape == (256, ACT) and a.dtype == torch.float32
        assert (a >= torch.tensor(LOW)).all() and (a <= torch.tensor(HIGH)).all()
    assert torch.equal(tagent.predict(obs), tagent.predict(obs))
    assert not torch.equal(tagent.get_action(obs), tagent.get_action(obs))
    # one process: a two-device mesh needs a process group of two ranks
    with pytest.raises(ValueError, match="init_process_group"):
        tagent.enable_mesh("dp=2")


def test_offpolicy_trainer_with_a_box_space_and_per(tmp_path):
    args = tconfig.TD3Arguments(
        num_envs=2, batch_size=32, buffer_size=1024, warmup_learn_steps=64, train_frequency=2,
        max_timesteps=300, hidden_sizes="32,32", logger_backend="none", logger_frequency=100,
        save_model=False, telemetry_interval_s=0.0, use_per=True, use_pallas=True,
        work_dir=str(tmp_path))
    envs = gym.vector.SyncVectorEnv([lambda: gym.make("Pendulum-v1")] * 2,
                                    autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    sp = envs.single_action_space
    agent = ttd3.TD3Agent(args, (3,), sp.low, sp.high, device="cpu")
    trainer = OffPolicyTrainer(args, agent, envs)
    try:
        trainer.run()
    finally:
        trainer.close()
        envs.close()
    assert trainer.sampler.buffer.spec["action"] == ((1,), torch.float32)
    assert trainer.learn_steps == int(agent.state.step) > 0
    assert int(agent.state.actor_opt["count"]) == trainer.learn_steps // args.policy_delay
    info = trainer.log_history[-1][2]
    assert np.isfinite(info["loss"]) and info["skipped_steps"] == 0.0
    assert len(torch.unique(trainer.sampler.buffer.state.priorities)) > 2
