"""IMPACT on the PyTorch port against the JAX package.

- The circular surrogate buffer: the JAX buffer's own cases (credits,
  overdraws, round-robin, eviction, validation), then 400 random adds and
  samples on both buffers, which must hand out the same chunks and the same
  stats at every step.
- The learner, from the JAX agent's weights (converted), on the same
  trajectories (numpy seeds): three ``learn()`` calls at ``replay_times`` 2
  and ``target_update_frequency`` 3, so the target is held fixed, then
  refreshed; params, target params, RMSProp's ``nu``, step and frames at
  1e-5 after each call, and the last update's metrics.  On the first update
  the learner and the target are one network: the ratio is exactly 1 and
  nothing is clipped.  Frames count once per inserted chunk.
- One learn step of the pixel model (``AtariNet`` with its LSTM, small
  width) against JAX's at 1e-5.
- ``HostActorLearnerTrainer`` with the IMPACT agent on ``TensorCartPole``
  lanes: replays per chunk, frames and the buffer's stats.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import impact as timpact
from scalerl_torch.data.circular import CircularTrajectoryBuffer as TBuffer
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impact as jimpact
from scalerl_tpu.data.circular import CircularTrajectoryBuffer as JBuffer

from torch_port_helpers import jax_traj, random_traj, to_numpy, torch_traj

torch.set_num_threads(1)

SMALL = dict(rollout_length=6, batch_size=8, use_lstm=False, max_timesteps=0, num_actors=2,
             num_buffers=4, hidden_size=32, replay_times=2, surrogate_capacity=4,
             target_update_frequency=3)


def _pair(obs_shape, num_actions, tree_to_torch, **kw):
    fields = {**SMALL, **kw}
    jargs = jconfig.ImpactArguments(**fields, logger_backend="none", telemetry_interval_s=0.0)
    targs = tconfig.ImpactArguments(**fields)
    dtype = jnp.uint8 if len(obs_shape) == 3 else jnp.float32
    jagent = jimpact.ImpactAgent(jargs, obs_shape, num_actions, obs_dtype=dtype)
    tagent = timpact.ImpactAgent(targs, obs_shape, num_actions, device="cpu")
    tagent.state = _state_to_torch(jagent.state, tree_to_torch)
    return jagent, tagent


def _state_to_torch(jstate, tree_to_torch):
    return timpact.ImpactTrainState(
        params=tree_to_torch(to_numpy(jstate.params)),
        target_params=tree_to_torch(to_numpy(jstate.target_params)),
        opt_state=convert.rmsprop_state_to_torch(to_numpy(jstate.opt_state),
                                                 tree_to_torch=tree_to_torch),
        step=torch.tensor(int(jstate.step), dtype=torch.int32),
        env_frames=torch.tensor(int(jstate.env_frames), dtype=torch.int64),
    )


def _assert_state_close(tstate, jstate, tree_to_torch, atol=1e-5):
    want = _state_to_torch(jstate, tree_to_torch)
    for group in ("params", "target_params"):
        for k, v in getattr(want, group).items():
            np.testing.assert_allclose(getattr(tstate, group)[k].numpy(), v.numpy(), atol=atol,
                                       rtol=1e-5, err_msg=f"{group}.{k}")
    for k, v in want.opt_state["nu"].items():
        np.testing.assert_allclose(tstate.opt_state["nu"][k].numpy(), v.numpy(), atol=atol,
                                   rtol=1e-5, err_msg=f"nu.{k}")
    assert int(tstate.step) == int(want.step)
    assert int(tstate.env_frames) == int(want.env_frames)


def _flat_traj(seed, T=6, B=8, A=2):
    fields = random_traj(T, B, (), A, seed)
    rng = np.random.default_rng(seed + 100)
    fields["obs"] = rng.normal(size=(T + 1, B, 4)).astype(np.float32)
    return fields


# ---------------------------------------------------------------------------
# the circular surrogate buffer


@pytest.mark.parametrize("Buffer", [TBuffer, JBuffer])
def test_circular_buffer_credits_round_robin_and_eviction(Buffer):
    buf = Buffer(capacity=2, replay_times=2)
    buf.add("a")
    assert buf.sample() == "a" and buf.sample() == "a"
    assert buf.sample() == "a" and buf.overdraws == 1  # spent: the freshest, counted
    buf.add("b")
    assert [buf.sample(), buf.sample()] == ["b", "b"]
    buf = Buffer(capacity=2, replay_times=2)
    buf.add("a")
    buf.add("b")
    assert sorted(buf.sample() for _ in range(4)) == ["a", "a", "b", "b"]
    buf.add("c")  # full: overwrites the oldest
    assert "a" not in buf._chunks and len(buf) == 2 and buf.stats()["inserted"] == 3
    for bad in (dict(capacity=0, replay_times=1), dict(capacity=1, replay_times=0)):
        with pytest.raises(ValueError):
            Buffer(**bad)
    with pytest.raises(ValueError, match="empty"):
        Buffer(capacity=1, replay_times=1).sample()


@pytest.mark.parametrize("capacity,replay_times", [(1, 1), (3, 2), (4, 3)])
def test_circular_buffer_matches_jax_on_random_traffic(capacity, replay_times):
    rng = np.random.default_rng(capacity * 10 + replay_times)
    tbuf, jbuf = TBuffer(capacity, replay_times), JBuffer(capacity, replay_times)
    n = 0
    for _ in range(400):
        if n == 0 or rng.uniform() < 0.3:
            tbuf.add(n)
            jbuf.add(n)
            n += 1
        else:
            assert tbuf.sample() == jbuf.sample()
        assert tbuf.stats() == jbuf.stats()


# ---------------------------------------------------------------------------
# the clipped-target learner


def test_learn_calls_match_jax_and_the_target_cadence():
    jagent, tagent = _pair((4,), 2, convert.mlp_policy_to_torch)
    initial_target = {k: v.clone() for k, v in tagent.state.target_params.items()}
    for call in range(3):
        fields = _flat_traj(call)
        jm = jagent.learn(jax_traj(fields))
        tm = tagent.learn(torch_traj(fields))
        _assert_state_close(tagent.state, jagent.state, convert.mlp_policy_to_torch)
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k], v, rtol=1e-5, atol=1e-4, err_msg=k)
        assert int(tagent.state.step) == 2 * (call + 1)
        assert int(tagent.state.env_frames) == 6 * 8 * (call + 1)  # once per chunk
        same = all(torch.equal(initial_target[k], v)
                   for k, v in tagent.state.target_params.items())
        assert same == (call == 0), call  # the refresh lands at step 3
    assert tagent.surrogate.stats() == jagent.surrogate.stats()


def test_first_update_ratio_is_one():
    jagent, tagent = _pair((4,), 2, convert.mlp_policy_to_torch, replay_times=1)
    fields = _flat_traj(5)
    tm = tagent.learn(torch_traj(fields))
    jm = jagent.learn(jax_traj(fields))
    assert tm["mean_ratio"] == 1.0 and tm["mean_clip_frac"] == 0.0
    assert jm["mean_ratio"] == 1.0 and jm["mean_clip_frac"] == 0.0


def test_pixel_lstm_learn_step_matches_jax():
    jagent, tagent = _pair((24, 24, 4), 3, convert.flax_to_torch, use_lstm=True, hidden_size=16,
                           replay_times=1, batch_size=4)
    fields = random_traj(6, 4, (24, 24, 4), 3, seed=9)
    core = jagent.initial_state(4)
    jm = jagent.learn(dataclasses.replace(jax_traj(fields), core_state=core))
    tcore = tuple((torch.tensor(np.asarray(c)), torch.tensor(np.asarray(h))) for c, h in core)
    tm = tagent.learn(dataclasses.replace(torch_traj(fields), core_state=tcore))
    _assert_state_close(tagent.state, jagent.state, convert.flax_to_torch)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=1e-5, atol=1e-4, err_msg=k)


def test_host_actor_learner_trainer_runs_impact(tmp_path):
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    args = tconfig.ImpactArguments(
        rollout_length=8, batch_size=8, use_lstm=False, hidden_size=16, num_actors=2,
        num_buffers=4, replay_times=3, surrogate_capacity=4, max_timesteps=800,
        logger_backend="none", logger_frequency=200, telemetry_interval_s=0.0,
        save_model=False, work_dir=str(tmp_path), use_pallas=True)
    agent = timpact.ImpactAgent(args, (4,), 2, device="cpu")
    env_fns = [lambda: TensorVectorView(TensorCartPole(4, device="cpu")) for _ in range(2)]
    trainer = HostActorLearnerTrainer(args, agent, env_fns)
    try:
        result = trainer.train(total_frames=800)
    finally:
        trainer.close()
    stats = agent.surrogate.stats()
    assert stats["inserted"] == trainer.learn_steps > 0
    assert int(agent.state.step) == 3 * trainer.learn_steps == stats["sampled"]
    assert int(agent.state.env_frames) == 8 * 8 * trainer.learn_steps
    assert np.isfinite(result["total_loss"]) and result["skipped_steps"] == 0.0
