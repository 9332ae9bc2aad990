"""A3C on the PyTorch port against the JAX package, and the on-policy trainer.

Same weights and Adam state (the JAX agent's, converted), the same
trajectories (numpy seeds).  float32:

- the loss and its metrics at 1e-5 (relative), and two learn steps (params,
  Adam moments and count, step, frames) at 1e-5, for ``MLPPolicyNet`` and
  for ``AtariNet`` with its LSTM (hidden 16, the A3C pixel model at a small
  width);
- the optimizer's clip: at ``max_grad_norm`` 0.01 every step is clipped
  (the logged norm is above it) and the steps still match JAX's at 1e-5;
- ``build_model``: pixels -> ``AtariNet`` with the LSTM of ``hidden_size``,
  flat -> ``MLPPolicyNet`` over ``hidden_sizes``; ``normalized_init`` heads;
- ``OnPolicyTrainer`` on ``TensorCartPole`` for a few chunks: frames,
  learn steps, finite losses, evaluation, and a resume that restores the
  agent's state bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import a3c as ta3c
from scalerl_torch.envs.gym_env import TensorVectorView
from scalerl_torch.envs.tensor_envs import TensorCartPole
from scalerl_torch.models.atari import AtariNet
from scalerl_torch.models.policy import MLPPolicyNet
from scalerl_torch.parallel.train_step import tensor_leaves
from scalerl_torch.trainer.on_policy import OnPolicyTrainer
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import a3c as ja3c

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
             max_timesteps=0)
PIXELS = (24, 24, 4)


def _pair(obs_shape, num_actions, **kw):
    fields = {**SMALL, **kw}
    jargs = jconfig.A3CArguments(**fields, logger_backend="none", telemetry_interval_s=0.0)
    targs = tconfig.A3CArguments(**fields)
    dtype = jnp.uint8 if len(obs_shape) == 3 else jnp.float32
    jagent = ja3c.A3CAgent(jargs, obs_shape, num_actions, obs_dtype=dtype)
    tagent = ta3c.A3CAgent(targs, obs_shape, num_actions, device="cpu")
    tagent.state = onpolicy_state_to_torch(jagent.state, _tree(obs_shape))
    return jagent, tagent


def _tree(obs_shape):
    return convert.flax_to_torch if len(obs_shape) == 3 else convert.mlp_policy_to_torch


def _trajs(obs_shape, num_actions, seed, jagent):
    T, B = SMALL["rollout_length"], SMALL["num_workers"]
    fields = (random_traj(T, B, obs_shape, num_actions, seed) if len(obs_shape) == 3
              else flat_traj(seed, T, B, num_actions))
    core = jagent.initial_state(B)
    tcore = tuple((torch.tensor(np.asarray(c)), torch.tensor(np.asarray(h))) for c, h in core)
    return (dataclasses.replace(jax_traj(fields), core_state=core),
            dataclasses.replace(torch_traj(fields), core_state=tcore))


@pytest.mark.parametrize("obs_shape,num_actions", [((4,), 2), (PIXELS, 3)])
def test_loss_and_learn_steps_match_jax(obs_shape, num_actions):
    jagent, tagent = _pair(obs_shape, num_actions)
    args = tagent.args
    jt, tt = _trajs(obs_shape, num_actions, 0, jagent)
    jloss, jm = ja3c.a3c_loss(jagent.state.params, jagent.model, jt, args.gamma,
                              args.gae_lambda, args.value_loss_coef, args.entropy_coef)
    tloss, tm = ta3c.a3c_loss(tagent.state.params, tagent.model, tt, args.gamma,
                              args.gae_lambda, args.value_loss_coef, args.entropy_coef)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5, err_msg=k)
    for seed in range(2):
        jt, tt = _trajs(obs_shape, num_actions, seed, jagent)
        jm = jagent.learn(jt)
        tm = tagent.learn(tt)
        assert_onpolicy_state_close(tagent.state, jagent.state, _tree(obs_shape))
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k], v, rtol=1e-5, atol=1e-4, err_msg=k)


def test_the_clip_then_adam_optimizer_matches_optax():
    jagent, tagent = _pair((4,), 2, max_grad_norm=0.01)
    for seed in range(2):
        jt, tt = _trajs((4,), 2, seed, jagent)
        jm, tm = jagent.learn(jt), tagent.learn(tt)
        assert tm["grad_norm"] > 0.01  # clipped
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        assert_onpolicy_state_close(tagent.state, jagent.state)


def test_build_model_dispatch_and_normalized_init():
    args = tconfig.A3CArguments(**SMALL)
    pixel = ta3c.build_model(args, (84, 84, 4), 6, device="cpu")
    assert isinstance(pixel, AtariNet) and pixel.use_lstm and len(pixel.core) == 2
    assert tconfig.A3CArguments().hidden_size == 256
    flat = ta3c.build_model(args, (4,), 2, device="cpu")
    assert isinstance(flat, MLPPolicyNet) and [m.out_features for m in flat.dense] == [32, 32]
    norm = dataclasses.replace(args, normalized_init=True)
    for net in (ta3c.build_model(norm, (4,), 2, device="cpu"),
                ta3c.build_model(norm, (24, 24, 4), 3, device="cpu")):
        np.testing.assert_allclose(net.policy.weight.norm(dim=1).detach(), 0.01, rtol=1e-5)
        np.testing.assert_allclose(net.baseline.weight.norm(dim=1).detach(), 1.0, rtol=1e-5)


def test_on_policy_trainer_runs_and_resumes_bit_equal(tmp_path):
    args = tconfig.A3CArguments(
        hidden_sizes="32,32", rollout_length=8, num_workers=4, max_timesteps=320,
        logger_frequency=64, eval_frequency=160, eval_episodes=2, logger_backend="none",
        telemetry_interval_s=0.0, save_frequency=10**9, work_dir=str(tmp_path))
    envs = TensorVectorView(TensorCartPole(4, device="cpu"))
    agent = ta3c.A3CAgent(args, (4,), 2, device="cpu")
    trainer = OnPolicyTrainer(args, agent, envs, envs)
    try:
        trainer.run()
    finally:
        trainer.close()
    assert trainer.global_step == 320 and trainer.learn_steps == 10
    assert int(agent.state.step) == 10 and int(agent.state.env_frames) == 320
    train = [m for _, kind, m in trainer.log_history if kind == "train"]
    assert train and all(np.isfinite(m["total_loss"]) and m["skipped_steps"] == 0.0
                         for m in train)
    assert [kind for _, kind, _ in trainer.log_history].count("eval") == 2
    saved = agent.state
    resumed_args = dataclasses.replace(args, resume=trainer.work_dir, max_timesteps=640)
    agent2 = ta3c.A3CAgent(resumed_args, (4,), 2, device="cpu")
    trainer2 = OnPolicyTrainer(resumed_args, agent2, envs)
    try:
        assert trainer2.try_resume()
        assert trainer2.global_step == 320 and trainer2.learn_steps == 10
        for x, y in zip(tensor_leaves(saved), tensor_leaves(agent2.state), strict=True):
            assert torch.equal(x, y)
    finally:
        trainer2.close()
