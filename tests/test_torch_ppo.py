"""PPO on the PyTorch port against the JAX package.

Same weights and Adam state (the JAX agent's, converted), the same
trajectories (numpy seeds) and the same lane shuffle: the JAX step's
permutations (``fold_in(PRNGKey(seed), step)``, one ``permutation`` an
epoch) injected through the port's ``perms`` argument.  float32:

- ``clipped_surrogate_loss`` and ``ppo_loss`` (with and without the value
  clip, ``loss_reduction`` sum and mean) at 1e-5 (relative);
- two learn steps (params, Adam moments and count, step, frames, the mean
  metrics of the epoch x minibatch schedule) at 1e-5, for ``MLPPolicyNet``
  and for ``AtariNet`` with its LSTM, whose lane minibatches carry each
  lane's entering core state.  On pixels the conv weights are held at 1e-4
  after the 16 Adam steps of two calls: Adam moves a weight whose gradient
  is at rounding level (~1e-8, where the moments still agree) by about
  ``lr * sign(g)``, and 4 of 8,192 first-conv weights differ by up to 1.7e-5
  (the R2D2 case, ROADMAP §C);
- the drawn shuffle is a pure function of ``(seed, step)``: one
  permutation of the lanes each epoch, the same for the same step;
- the learn step inside ``DeviceActorLearnerLoop`` (the JAX package's
  fused-loop case); the batch-divisibility and config checks;
- ``OnPolicyTrainer`` on ``TensorCartPole`` for a few chunks and a resume
  that restores the agent's state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import ppo as tppo
from scalerl_torch.envs.gym_env import TensorVectorView
from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv, TensorCartPole
from scalerl_torch.ops import losses as tlosses
from scalerl_torch.parallel.train_step import tensor_leaves
from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop
from scalerl_torch.trainer.on_policy import OnPolicyTrainer
from scalerl_torch.utils import counter_rng
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import ppo as jppo
from scalerl_tpu.ops import losses as jlosses

from torch_port_helpers import (
    assert_onpolicy_state_close,
    flat_traj,
    jax_traj,
    onpolicy_state_to_torch,
    random_traj,
    torch_traj,
)

torch.set_num_threads(1)

SMALL = dict(hidden_sizes="32,32", hidden_size=16, rollout_length=5, num_workers=4,
             num_minibatches=2, ppo_epochs=2, max_timesteps=0)
PIXELS = (24, 24, 4)


def _tree(obs_shape):
    return convert.flax_to_torch if len(obs_shape) == 3 else convert.mlp_policy_to_torch


def _pair(obs_shape, num_actions, **kw):
    fields = {**SMALL, **kw}
    jargs = jconfig.PPOArguments(**fields, logger_backend="none", telemetry_interval_s=0.0)
    targs = tconfig.PPOArguments(**fields)
    dtype = jnp.uint8 if len(obs_shape) == 3 else jnp.float32
    jagent = jppo.PPOAgent(jargs, obs_shape, num_actions, obs_dtype=dtype)
    tagent = tppo.PPOAgent(targs, obs_shape, num_actions, device="cpu")
    tagent.state = onpolicy_state_to_torch(jagent.state, _tree(obs_shape))
    return jagent, tagent


def _trajs(obs_shape, num_actions, seed, jagent):
    T, B = SMALL["rollout_length"], SMALL["num_workers"]
    fields = (random_traj(T, B, obs_shape, num_actions, seed) if len(obs_shape) == 3
              else flat_traj(seed, T, B, num_actions))
    core = jagent.initial_state(B)
    tcore = tuple((torch.tensor(np.asarray(c)), torch.tensor(np.asarray(h))) for c, h in core)
    return (dataclasses.replace(jax_traj(fields), core_state=core),
            dataclasses.replace(torch_traj(fields), core_state=tcore))


def _jax_perms(seed, step, epochs, B):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    perms = jax.vmap(lambda k: jax.random.permutation(k, B))(jax.random.split(key, epochs))
    return torch.tensor(np.asarray(perms))


def test_clipped_surrogate_matches_jax():
    rng = np.random.default_rng(0)
    new, old, adv = (rng.normal(size=(6, 4)).astype(np.float32) * s for s in (0.3, 0.3, 2.0))
    for clip in (0.1, 0.2):
        tl, ta = tlosses.clipped_surrogate_loss(*(torch.tensor(x) for x in (new, old, adv)), clip)
        jl, ja = jlosses.clipped_surrogate_loss(*(jnp.asarray(x) for x in (new, old, adv)), clip)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        for k, v in ja.items():
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("clip_range_vf,loss_reduction", [(0.0, "sum"), (0.2, "mean")])
def test_ppo_loss_matches_jax(clip_range_vf, loss_reduction):
    jagent, tagent = _pair((4,), 3)
    rng = np.random.default_rng(1)
    fields = flat_traj(2, 5, 4, 3)
    extra = {k: rng.normal(size=(5, 4)).astype(np.float32)
             for k in ("advantages", "value_targets", "behavior_logp", "old_values")}
    jmb = {**{k: jnp.asarray(v) for k, v in {**fields, **extra}.items()}, "core_state": ()}
    tmb = {**{k: torch.tensor(v) for k, v in {**fields, **extra}.items()}, "core_state": ()}
    tmb["action"] = tmb["action"].long()
    kw = dict(clip_range=0.2, clip_range_vf=clip_range_vf, value_loss_coef=0.5,
              entropy_coef=0.01, normalize_advantage=True, loss_reduction=loss_reduction)
    jl, jm = jppo.ppo_loss(jagent.state.params, jagent.model, jmb, **kw)
    tl, tm = tppo.ppo_loss(tagent.state.params, tagent.model, tmb, **kw)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("obs_shape,num_actions,kw", [
    ((4,), 2, {}),
    ((4,), 2, dict(clip_range_vf=0.2, loss_reduction="mean", normalize_advantage=False)),
    (PIXELS, 3, dict(use_lstm=True)),
])
def test_learn_steps_match_jax_with_injected_permutations(obs_shape, num_actions, kw):
    jagent, tagent = _pair(obs_shape, num_actions, **kw)
    learn = tagent.make_learn_fn()
    args = tagent.args
    for step in range(2):
        jt, tt = _trajs(obs_shape, num_actions, step, jagent)
        jm = jagent.learn(jt)
        perms = _jax_perms(args.seed, step, args.ppo_epochs, args.num_workers)
        tagent.state, tm = learn(tagent.state, tt, perms)
        # pixels: the conv weights at 1e-4 after the schedule's 8 Adam steps
        # a call (Adam moves weights whose gradient is at rounding level by
        # about lr * sign(g)); every moment and every other leaf at 1e-5
        conv_atol = 1e-4 if len(obs_shape) == 3 else 1e-5
        assert_onpolicy_state_close(tagent.state, jagent.state, _tree(obs_shape),
                                    conv_atol=conv_atol)
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), v, rtol=1e-5, atol=1e-4, err_msg=k)


def test_the_drawn_shuffle_is_a_pure_function_of_the_step():
    step = torch.tensor(7, dtype=torch.int32)
    perms = counter_rng.permutations(42, tppo.PERM_STREAM, step, 4, 16)
    assert perms.shape == (4, 16)
    for row in perms:
        assert sorted(row.tolist()) == list(range(16))
    assert torch.equal(perms, counter_rng.permutations(42, tppo.PERM_STREAM, step, 4, 16))
    assert not torch.equal(perms, counter_rng.permutations(42, tppo.PERM_STREAM, step + 1, 4, 16))
    # the learn step draws them from its state's step: the same state, the
    # same update
    jagent, tagent = _pair((4,), 2)
    _, tt = _trajs((4,), 2, 0, jagent)
    learn = tagent.make_learn_fn()
    a, _ = learn(tagent.state, tt)
    b, _ = learn(tagent.state, tt)
    for x, y in zip(tensor_leaves(a), tensor_leaves(b), strict=True):
        assert torch.equal(x, y)


def test_learn_step_runs_in_the_device_loop():
    T, B = 4, 4
    env = SyntheticPixelEnv(B, size=16, device="cpu")
    args = tconfig.PPOArguments(rollout_length=T, num_workers=B, num_minibatches=2,
                                ppo_epochs=2, use_lstm=False, hidden_size=16, max_timesteps=0)
    agent = tppo.PPOAgent(args, env.observation_shape, env.num_actions, device="cpu")
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), T, iters_per_call=2,
                                  device="cpu")
    state, _, m = loop.train_chunk(agent.state, loop.init_carry())
    assert int(state.step) == 2 and int(state.env_frames) == 2 * T * B
    assert torch.isfinite(m["total_loss"])


def test_batch_and_config_checks():
    with pytest.raises(ValueError, match="num_minibatches"):
        tppo.PPOAgent(tconfig.PPOArguments(num_workers=3, num_minibatches=2), (4,), 2,
                      device="cpu")
    with pytest.raises(ValueError, match="loss_reduction"):
        tconfig.PPOArguments(loss_reduction="max").validate()
    jagent, tagent = _pair((4,), 2)
    fields = flat_traj(0, 5, 3, 2)
    with pytest.raises(ValueError, match="must divide by"):
        tagent.learn(torch_traj(fields))


def test_on_policy_trainer_runs_and_resumes_bit_equal(tmp_path):
    args = tconfig.PPOArguments(
        hidden_sizes="32,32", rollout_length=8, num_workers=4, num_minibatches=2,
        max_timesteps=256, logger_frequency=64, logger_backend="none",
        telemetry_interval_s=0.0, save_frequency=10**9, work_dir=str(tmp_path))
    envs = TensorVectorView(TensorCartPole(4, device="cpu"))
    agent = tppo.PPOAgent(args, (4,), 2, device="cpu")
    trainer = OnPolicyTrainer(args, agent, envs)
    try:
        trainer.run()
    finally:
        trainer.close()
    assert trainer.learn_steps == int(agent.state.step) == 8
    assert int(agent.state.opt_state["count"]) == 8 * args.ppo_epochs * args.num_minibatches
    train = [m for _, kind, m in trainer.log_history if kind == "train"]
    assert train and all(np.isfinite(m["total_loss"]) for m in train)
    saved = agent.state
    resumed = dataclasses.replace(args, resume=trainer.work_dir)
    agent2 = tppo.PPOAgent(resumed, (4,), 2, device="cpu")
    trainer2 = OnPolicyTrainer(resumed, agent2, envs)
    try:
        assert trainer2.try_resume()
        for x, y in zip(tensor_leaves(saved), tensor_leaves(agent2.state), strict=True):
            assert torch.equal(x, y)
    finally:
        trainer2.close()
