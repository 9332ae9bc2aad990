"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Builds the JAX package's IMPALA pieces and the port's from one argument set,
converts JAX train states into the port's, and makes trajectories from a
numpy seed in the JAX package's layout.
"""

import jax
import numpy as np
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents.impala import ImpalaTrainState
from scalerl_torch.data.trajectory import Trajectory
from scalerl_tpu import config as jconfig
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory

SMALL = dict(use_lstm=False, hidden_size=32, max_timesteps=0)


def args_pair(**kw):
    """The same ImpalaArguments for both packages."""
    fields = {**SMALL, **kw}
    return jconfig.ImpalaArguments(**fields), tconfig.ImpalaArguments(**fields)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def state_to_torch(jax_state) -> ImpalaTrainState:
    """A JAX ``ImpalaTrainState`` -> the port's, on the host."""
    return ImpalaTrainState(
        params=convert.flax_to_torch(to_numpy(jax_state.params)),
        opt_state=convert.rmsprop_state_to_torch(to_numpy(jax_state.opt_state)),
        step=torch.tensor(int(jax_state.step), dtype=torch.int32),
        env_frames=torch.tensor(int(jax_state.env_frames), dtype=torch.int64),
    )


def random_traj(T, B, obs_shape, A, seed=0):
    """numpy fields of a [T+1, B] trajectory; the last logits row is zero."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T + 1, B, A)).astype(np.float32)
    logits[-1] = 0.0
    return dict(
        obs=rng.integers(0, 256, size=(T + 1, B) + tuple(obs_shape)).astype(np.uint8),
        action=rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
        reward=(rng.normal(size=(T + 1, B)) * 1.5).astype(np.float32),
        done=rng.uniform(size=(T + 1, B)) < 0.2,
        logits=logits,
    )


def jax_traj(fields) -> JaxTrajectory:
    return JaxTrajectory(**{k: jax.numpy.asarray(v) for k, v in fields.items()})


def torch_traj(fields) -> Trajectory:
    return Trajectory(
        **{k: torch.tensor(np.asarray(v)) for k, v in fields.items() if k != "core_state"}
    )


def assert_params_close(port_params, jax_params, atol=1e-5, rtol=1e-5):
    want = convert.flax_to_torch(to_numpy(jax_params))
    assert set(port_params) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(
            port_params[k].detach().numpy(), v.numpy(), atol=atol, rtol=rtol, err_msg=k
        )
