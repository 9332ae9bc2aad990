"""Batched environments that step on the device.

Port of ``scalerl_tpu/envs/jax_envs/base.py``.  The JAX package writes one
env and lifts it over the batch with ``vmap`` (``JaxVecEnv``); here the batch
axis is written out: a ``TensorEnv`` holds ``num_envs`` lanes on one device,
and every state leaf, observation, reward and done flag leads with that axis.

Protocol:

- ``env.reset(generator) -> (state, obs)``
- ``env.step(state, action, generator) -> (state, obs, reward, done)`` with
  **auto-reset**: where an episode ends the returned state and obs are
  already reset (``done`` flags the boundary), so fixed-shape rollouts never
  branch on the host.

Randomness comes from the caller's ``torch.Generator``, which must live on
the env's device.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from scalerl_torch.utils.platform import DeviceLike, resolve_device

State = Any


class TensorEnv:
    """Interface for batched device envs (subclass and implement the fns)."""

    def __init__(self, num_envs: int, device: DeviceLike = "cuda") -> None:
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self.num_envs = num_envs
        self.device = resolve_device(device)

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def num_actions(self) -> int:
        raise NotImplementedError

    def reset(self, generator: torch.Generator) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def step(
        self, state: State, action: torch.Tensor, generator: torch.Generator
    ) -> Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError


def make_tensor_vec_env(
    env_id: str, num_envs: int, device: DeviceLike = "cuda", **kwargs
) -> TensorEnv:
    """``num_envs`` lanes of the env registered as ``env_id`` (the ids of
    ``scalerl_tpu/envs/jax_envs/base.py::make_jax_vec_env``); ``kwargs`` go
    to the env's constructor, except for CartPole, whose id fixes it."""
    from scalerl_torch.envs.tensor_envs.breakout import TensorBreakout
    from scalerl_torch.envs.tensor_envs.cartpole import TensorCartPole
    from scalerl_torch.envs.tensor_envs.catch import TensorCatch
    from scalerl_torch.envs.tensor_envs.recall import TensorRecall
    from scalerl_torch.envs.tensor_envs.synthetic import SyntheticPixelEnv

    registry = {
        "CartPole-v1": lambda: TensorCartPole(num_envs, max_steps=500, device=device),
        "CartPole-v0": lambda: TensorCartPole(num_envs, max_steps=200, device=device),
        "SyntheticPixel-v0": lambda: SyntheticPixelEnv(num_envs, device=device, **kwargs),
        "Catch-v0": lambda: TensorCatch(num_envs, device=device, **kwargs),
        "Recall-v0": lambda: TensorRecall(num_envs, device=device, **kwargs),
        "Breakout-v0": lambda: TensorBreakout(num_envs, device=device, **kwargs),
    }
    if env_id not in registry:
        raise KeyError(
            f"unknown jax env {env_id!r}; available: {sorted(registry)} "
            "(use env_backend='gym' for host envs)"
        )
    return registry[env_id]()
