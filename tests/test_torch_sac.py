"""SAC on the PyTorch port against the JAX package.

Same weights and optimizer states (the JAX agent's, converted with
``convert.sac_state_to_torch``), the same replay batches (numpy seeds) and
the same normal draws (the JAX step's own ``jax.random`` output, injected
through the port's ``noise`` argument).  float32 throughout:

- ``squash_log_prob`` against JAX at 1e-5 (relative) for |u| up to 30,
  where ``log(1 - tanh(u)^2)`` would be -inf, and against the change of
  variables in float64 at 1e-4 (relative);
- one and two learn steps (params, target critics, temperature, all three
  Adam states, metrics and |TD|) at 1e-5, with PER weights and without,
  with the temperature learned and fixed;
- the counter-based draws of a step are a pure function of ``(seed,
  step)``, and two agents from one seed take the same steps;
- actions stay inside asymmetric Box bounds;
- ``OffPolicyTrainer`` on gym's ``Pendulum-v1`` (a ``Box`` space) with PER
  and both PER halves' plain versions, and a resume.
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
from scalerl_torch.agents import sac as tsac
from scalerl_torch.parallel.train_step import tensor_leaves
from scalerl_torch.trainer.off_policy import OffPolicyTrainer
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import sac as jsac

torch.set_num_threads(1)

OBS, ACT, B = 3, 2, 16
LOW, HIGH = np.array([-2.0, -0.5], np.float32), np.array([1.0, 1.5], np.float32)
SMALL = dict(hidden_sizes="32,32", batch_size=B, buffer_size=64, max_timesteps=1000)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(**kw):
    fields = {**SMALL, **kw}
    jargs, targs = jconfig.SACArguments(**fields), tconfig.SACArguments(**fields)
    jagent = jsac.SACAgent(jargs, (OBS,), LOW, HIGH)
    tagent = tsac.SACAgent(targs, (OBS,), LOW, HIGH, device="cpu")
    tagent.state = convert.sac_state_to_torch(_to_numpy(jagent.state))
    return jagent, tagent


def _batch(seed, weights=True):
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(B, OBS)).astype(np.float32),
        next_obs=rng.normal(size=(B, OBS)).astype(np.float32),
        action=rng.uniform(LOW, HIGH, size=(B, ACT)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        done=rng.uniform(size=B) < 0.3,
    )
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, size=B).astype(np.float32)
    return b


def _jax_noise(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 0x5AC), step)
    k_next, k_pi = jax.random.split(key)
    return {"next": torch.tensor(np.asarray(jax.random.normal(k_next, (B, ACT)))),
            "pi": torch.tensor(np.asarray(jax.random.normal(k_pi, (B, ACT))))}


def _close(got, want, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=1e-5,
                               err_msg=msg)


def _assert_state_close(tstate, jstate, atol=1e-5):
    want = convert.sac_state_to_torch(_to_numpy(jstate))
    for f in dataclasses.fields(want):
        got, exp = getattr(tstate, f.name), getattr(want, f.name)
        if f.name.endswith("_opt"):
            for moment in ("mu", "nu"):
                for k, v in exp[moment].items():
                    _close(got[moment][k], v, atol, f"{f.name}.{moment}.{k}")
            assert int(got["count"]) == int(exp["count"]), f.name
        elif f.name == "step":
            assert int(got) == int(exp)
        else:
            for k, v in exp.items():
                _close(got[k], v, atol, f"{f.name}.{k}")


def test_squash_log_prob_matches_jax_and_the_change_of_variables():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(64, ACT)).astype(np.float32)
    log_std = rng.uniform(-1.0, 0.5, size=(64, ACT)).astype(np.float32)
    u = np.concatenate([rng.normal(size=(32, ACT)) * 3,
                        rng.uniform(-30, 30, size=(32, ACT))]).astype(np.float32)
    u[0] = [30.0, -30.0]
    scale = np.array([2.0, 0.5], np.float32)
    got = tsac.squash_log_prob(*(torch.tensor(x) for x in (u, log_std, mean, scale)))
    want = jsac.squash_log_prob(*(jnp.asarray(x) for x in (u, log_std, mean, scale)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # the plain form is -inf out there: the stable one is what keeps it finite
    assert not torch.isfinite(torch.log(1 - torch.tanh(torch.tensor(30.0)) ** 2))
    # log N(u) - log|da/du| with da/du = scale (1 - tanh(u)^2), in float64
    # where the plain form is exact enough (|u| < 5)
    small = slice(1, 32)  # row 0 holds |u| = 30
    u64, m64, s64 = (x[small].astype(np.float64) for x in (u, mean, log_std))
    std = np.exp(s64)
    normal = np.sum(-0.5 * ((u64 - m64) / std) ** 2 - s64 - 0.5 * np.log(2 * np.pi), axis=-1)
    jac = np.sum(np.log(scale.astype(np.float64) * (1 - np.tanh(u64) ** 2)), axis=-1)
    np.testing.assert_allclose(got.numpy()[small], normal - jac, rtol=1e-4, atol=1e-4)


def test_squash_matches_jax():
    u = np.linspace(-12, 12, 50, dtype=np.float32).reshape(25, 2)
    scale, bias = np.array([1.5, 0.5], np.float32), np.array([-0.5, 0.5], np.float32)
    got = tsac.squash(torch.tensor(u), torch.tensor(scale), torch.tensor(bias))
    _close(got, jsac.squash(jnp.asarray(u), jnp.asarray(scale), jnp.asarray(bias)))


@pytest.mark.parametrize("weights,auto_alpha", [(True, True), (False, True), (True, False)])
def test_two_learn_steps_match_jax(weights, auto_alpha):
    jagent, tagent = _pair(auto_alpha=auto_alpha)
    _assert_state_close(tagent.state, jagent.state, atol=0)
    for step in range(2):
        batch = _batch(step, weights)
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


def test_drawn_noise_is_a_pure_function_of_the_step():
    _, a = _pair()
    _, b = _pair()
    batch = {k: torch.tensor(v) for k, v in _batch(3).items()}
    for _ in range(2):
        a.state, ma, ta = a._learn(a.state, batch)
        b.state, mb, tb = b._learn(b.state, batch)
        assert torch.equal(ta, tb) and torch.equal(ma["actor_loss"], mb["actor_loss"])
    # the same step retried (a resume, a skipped step) takes the same draws
    state = a.state
    _, m1, _ = a._learn(state, batch)
    _, m2, _ = a._learn(state, batch)
    assert torch.equal(m1["entropy"], m2["entropy"])


def test_actions_respect_bounds_and_enable_mesh_is_refused():
    _, tagent = _pair()
    obs = np.random.default_rng(0).normal(size=(256, OBS)).astype(np.float32) * 10
    for a in (tagent.get_action(obs), tagent.predict(obs)):
        assert a.shape == (256, ACT) and a.dtype == torch.float32
        assert (a >= torch.tensor(LOW)).all() and (a <= torch.tensor(HIGH)).all()
    # one process: a two-device mesh needs a process group of two ranks
    with pytest.raises(ValueError, match="init_process_group"):
        tagent.enable_mesh("dp=2")
    with pytest.raises(ValueError, match="1-D Box"):
        tsac.SACAgent(tconfig.SACArguments(**SMALL), (OBS,), np.zeros((2, 2)), np.ones((2, 2)),
                      device="cpu")


def _pendulum(n):
    return gym.vector.SyncVectorEnv([lambda: gym.make("Pendulum-v1")] * n,
                                    autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)


@pytest.mark.parametrize("use_per", [False, True])
def test_offpolicy_trainer_with_a_box_space(tmp_path, use_per):
    args = tconfig.SACArguments(
        num_envs=2, batch_size=32, buffer_size=1024, warmup_learn_steps=64, train_frequency=2,
        max_timesteps=300, hidden_sizes="32,32", logger_backend="none", logger_frequency=100,
        save_model=True, save_frequency=10**9, telemetry_interval_s=0.0, use_per=use_per,
        use_pallas=use_per, work_dir=str(tmp_path))
    envs = _pendulum(2)
    sp = envs.single_action_space
    agent = tsac.SACAgent(args, (3,), sp.low, sp.high, device="cpu")
    trainer = OffPolicyTrainer(args, agent, envs)
    try:
        trainer.run()
    finally:
        trainer.close()
    assert trainer.sampler.buffer.spec["action"] == ((1,), torch.float32)
    assert trainer.learn_steps == int(agent.state.step) > 0
    assert int(agent.state.step) == (300 - 64) // 2 + 1
    info = trainer.log_history[-1][2]
    assert np.isfinite(info["loss"]) and info["skipped_steps"] == 0.0
    if use_per:  # the |TD| feedback moved the priorities off their initial max
        prio = trainer.sampler.buffer.state.priorities
        assert len(torch.unique(prio)) > 2
    # resume: the agent's state comes back bit for bit
    saved = trainer.agent.state
    args2 = dataclasses.replace(args, resume=trainer.work_dir)
    agent2 = tsac.SACAgent(args2, (3,), sp.low, sp.high, device="cpu")
    trainer2 = OffPolicyTrainer(args2, agent2, envs)
    assert trainer2.try_resume()
    trainer2.close()
    envs.close()
    for x, y in zip(tensor_leaves(saved), tensor_leaves(agent2.state), strict=True):
        assert torch.equal(x, y)
