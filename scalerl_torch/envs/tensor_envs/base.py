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
