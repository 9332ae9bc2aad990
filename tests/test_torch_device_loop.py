"""The fused IMPALA loop as a whole: the slice of the port, end to end.

- A trajectory collected by the JAX ``DeviceActorLearnerLoop._unroll`` goes
  through the JAX learn step and the port's, from the same converted
  weights: the next params agree at 1e-5 (float32).
- The port's loop runs a few chunks on the host and returns the JAX loop's
  metric keys, with one batched metric copy per chunk.
- The port's trajectories follow the row convention of ``Trajectory``.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import args_pair, assert_params_close, state_to_torch, to_numpy

from scalerl_torch.agents import impala as timpala
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
from scalerl_torch.ops import cuda_vtrace
from scalerl_torch.runtime import dispatch
from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.envs.jax_envs.base import JaxVecEnv
from scalerl_tpu.envs.jax_envs.synthetic import SyntheticPixelEnv as JaxSyntheticPixelEnv
from scalerl_tpu.runtime.device_loop import DeviceActorLearnerLoop as JaxLoop

torch.set_num_threads(1)

T, B, ITERS = 5, 4, 2
SIZE = 24  # 24x24x4 frames, one stripe column per cell


def _jax_loop(jargs, iters_per_call=1):
    env = JaxSyntheticPixelEnv(size=SIZE)
    agent = jimpala.ImpalaAgent(jargs, obs_shape=env.observation_shape,
                                num_actions=env.num_actions)
    loop = JaxLoop(agent.model, JaxVecEnv(env, num_envs=B), agent.make_learn_fn(),
                   unroll_length=T, iters_per_call=iters_per_call)
    return agent, loop


def _port_loop(targs, seed=0):
    env = SyntheticPixelEnv(num_envs=B, size=SIZE, device="cpu")
    agent = timpala.ImpalaAgent(targs, env.observation_shape, env.num_actions, device="cpu")
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(),
                                  unroll_length=T, iters_per_call=ITERS, seed=seed,
                                  device="cpu")
    return agent, loop


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "kernel"])
def test_learn_on_a_jax_unroll_matches_jax(use_pallas):
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=use_pallas)
    jagent, jloop = _jax_loop(jargs)
    key = jax.random.PRNGKey(0)
    carry = jloop.init_carry(key)
    _, jtraj = jax.jit(jloop._unroll)(jagent.state.params, carry, jax.random.PRNGKey(1))
    model = timpala.build_model(targs, (SIZE, SIZE, 4), 6, device="cpu")
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    tstate = state_to_torch(jagent.state)
    ttraj = Trajectory(**{
        k: torch.tensor(np.asarray(v)) for k, v in vars(to_numpy(jtraj)).items()
        if k != "core_state"
    })
    jstate, jm = jax.jit(jagent.make_learn_fn())(jagent.state, jtraj)
    tstate, tm = tlearn(tstate, ttraj)
    assert_params_close(tstate.params, jstate.params)
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-5)


def test_port_loop_runs_chunks_with_the_jax_metric_keys(monkeypatch):
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=True)
    jagent, jloop = _jax_loop(jargs)
    key = jax.random.PRNGKey(0)
    _, _, jmetrics = jloop.run(jagent.state, jloop.init_carry(key), key, num_calls=1,
                               instrument=False)

    copies = []
    real_get = dispatch._device_get
    monkeypatch.setattr(dispatch, "_device_get", lambda x: copies.append(1) or real_get(x))
    monkeypatch.setattr(cuda_vtrace, "launches", 0)
    agent, loop = _port_loop(targs)
    seen = []
    state, carry, metrics = loop.run(agent.state, loop.init_carry(), num_calls=3,
                                     on_metrics=lambda i, m: seen.append(i))
    assert set(metrics) == set(jmetrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert seen == [0, 1, 2] and len(copies) == 3  # one batched copy per chunk
    assert int(state.env_frames) == 3 * T * B * ITERS
    assert int(state.step) == 3 * ITERS
    assert cuda_vtrace.launches == 0  # host tensors take the plain version


def test_trajectory_follows_the_row_convention():
    _, targs = args_pair(rollout_length=T, batch_size=B)
    agent, loop = _port_loop(targs, seed=3)
    carry = loop.init_carry()
    new_carry, traj = loop._unroll(agent.state.params, carry)
    A = loop.venv.num_actions
    assert traj.obs.shape == (T + 1, B, SIZE, SIZE, 4)
    assert traj.logits.shape == (T + 1, B, A)
    assert bool((traj.logits[-1] == 0).all())  # last row unused, left zero
    torch.testing.assert_close(traj.obs[0], carry.obs)
    torch.testing.assert_close(traj.action[0], carry.last_action)
    torch.testing.assert_close(traj.obs[-1], new_carry.obs)
    # the action taken at obs[t] is action[t+1]; it earns reward[t+1], which
    # is 1 exactly when it is the correct action of the cell shown in obs[t]
    cell = (traj.obs[:-1, :, 0, :, 0] == 255).int().argmax(-1)  # stripe column
    correct = traj.action[1:] == cell % A
    torch.testing.assert_close(traj.reward[1:], correct.float())
