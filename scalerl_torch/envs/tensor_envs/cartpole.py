"""Batched CartPole that steps on the device, with auto-reset.

Port of ``scalerl_tpu/envs/jax_envs/cartpole.py``: gymnasium's CartPole-v1
physics (gravity 9.8, cart mass 1.0, pole mass 0.1, pole half-length 0.5,
force 10, tau 0.02, Euler integration; terminate at |x| > 2.4 or
|theta| > 12 degrees; reward 1 per step; truncate at ``max_steps``), in
float32 over ``num_envs`` lanes.

A step is split in two so tests can hold it against the JAX env:
:meth:`TensorCartPole.draw` takes the ``[B, 4]`` reset values (uniform in
[-0.05, 0.05)) from the generator, and :meth:`TensorCartPole.transition`
is the pure step given them.  ``done`` is termination or truncation, as in
the JAX env.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.utils.platform import DeviceLike


class CartPoleState(NamedTuple):
    x: torch.Tensor  # [B] float32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # [B] int64 step counter


class TensorCartPole(TensorEnv):
    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    def __init__(self, num_envs: int, max_steps: int = 500, device: DeviceLike = "cuda") -> None:
        super().__init__(num_envs, device)
        self.max_steps = max_steps

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        return (4,)

    @property
    def num_actions(self) -> int:
        return 2

    @staticmethod
    def _obs(s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """``[B, 4]`` initial (x, x_dot, theta, theta_dot) for a new episode."""
        u = torch.rand((self.num_envs, 4), generator=generator, device=self.device)
        return u * 0.1 - 0.05

    def _initial(self, vals: torch.Tensor) -> CartPoleState:
        t = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
        return CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], t)

    def reset(self, generator: torch.Generator) -> Tuple[CartPoleState, torch.Tensor]:
        state = self._initial(self.draw(generator))
        return state, self._obs(state)

    def transition(self, state: CartPoleState, action: torch.Tensor, reset_vals: torch.Tensor):
        """The pure step given the reset values: ``(state, obs, reward, done)``;
        where ``done``, the state and obs are already the reset ones."""
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (force + self.POLEMASS_LENGTH * state.theta_dot**2 * sintheta) / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / self.TOTAL_MASS)
        )
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta / self.TOTAL_MASS

        stepped = CartPoleState(
            state.x + self.TAU * state.x_dot,
            state.x_dot + self.TAU * xacc,
            state.theta + self.TAU * state.theta_dot,
            state.theta_dot + self.TAU * thetaacc,
            state.t + 1,
        )
        terminated = (stepped.x.abs() > self.X_LIMIT) | (stepped.theta.abs() > self.THETA_LIMIT)
        done = terminated | (stepped.t >= self.max_steps)
        fresh = self._initial(reset_vals)
        new_state = CartPoleState(*(torch.where(done, a, b) for a, b in zip(fresh, stepped)))
        reward = torch.ones(done.shape, dtype=torch.float32, device=done.device)
        return new_state, self._obs(new_state), reward, done

    def step(self, state: CartPoleState, action: torch.Tensor, generator: torch.Generator):
        return self.transition(state, action, self.draw(generator))
