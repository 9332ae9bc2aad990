"""Batched Catch that steps on the device, with auto-reset.

Port of ``scalerl_tpu/envs/jax_envs/catch.py``: a ball falls one row per
step from a random column of a ``size`` x ``size`` field; the agent slides
a ``paddle_width``-wide paddle along the bottom row (left / stay / right)
and earns +1 for catching the ball, -1 for missing it, at the episode's
last step (the ball reaching the row above the paddle's).  Observations
are ``[size, size, stack]`` uint8 frames: ball and paddle at 255 over a
black field, the same frame in every channel.

A step is split in two so tests can hold it against the JAX env exactly:
:meth:`TensorCatch.draw` takes the one random draw (the column a new
episode's ball starts in) from the generator, and
:meth:`TensorCatch.transition` is the pure step given it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.utils.platform import DeviceLike


class CatchState(NamedTuple):
    ball_row: torch.Tensor  # [B] int64, 0 = top
    ball_col: torch.Tensor  # [B] int64
    paddle_col: torch.Tensor  # [B] int64
    t: torch.Tensor  # [B] int64 step counter


class CatchDraws(NamedTuple):
    ball_col: torch.Tensor  # [B] int64 column a new episode's ball starts in


class TensorCatch(TensorEnv):
    """``size`` x ``size`` Catch; an episode lasts ``size - 1`` steps."""

    def __init__(
        self,
        num_envs: int,
        size: int = 24,
        stack: int = 1,
        paddle_width: int = 3,
        device: DeviceLike = "cuda",
    ) -> None:
        if paddle_width % 2 != 1:
            raise ValueError("paddle_width must be odd (centered on paddle_col)")
        super().__init__(num_envs, device)
        self.size = size
        self.stack = stack
        self.paddle_width = paddle_width
        self._rows = torch.arange(size, device=self.device)[None, :, None]
        self._cols = torch.arange(size, device=self.device)[None, None, :]

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        return (self.size, self.size, self.stack)

    @property
    def num_actions(self) -> int:
        return 3  # left / stay / right

    def _render(self, state: CatchState) -> torch.Tensor:
        """``[B, size, size, stack]`` uint8 frames."""
        ball = (self._rows == state.ball_row[:, None, None]) & (
            self._cols == state.ball_col[:, None, None])
        paddle = (self._rows == self.size - 1) & (
            (self._cols - state.paddle_col[:, None, None]).abs() <= self.paddle_width // 2)
        frame = (ball | paddle).to(torch.uint8) * 255
        return frame[..., None].expand(-1, -1, -1, self.stack).contiguous()

    def _spawn(self, draws: CatchDraws) -> CatchState:
        zeros = torch.zeros_like(draws.ball_col)
        return CatchState(zeros, draws.ball_col, torch.full_like(zeros, self.size // 2), zeros)

    def draw(self, generator: torch.Generator) -> CatchDraws:
        """The random numbers of one step (or reset), for every lane."""
        return CatchDraws(torch.randint(0, self.size, (self.num_envs,), generator=generator,
                                        device=self.device))

    def reset(self, generator: torch.Generator) -> Tuple[CatchState, torch.Tensor]:
        state = self._spawn(self.draw(generator))
        return state, self._render(state)

    def transition(self, state: CatchState, action: torch.Tensor, draws: CatchDraws):
        """The pure step given the draws: ``(state, obs, reward, done)``;
        where ``done``, the state and obs are already the new episode's."""
        paddle = torch.clamp(state.paddle_col + action.long() - 1, 0, self.size - 1)
        ball_row = state.ball_row + 1
        done = ball_row >= self.size - 1
        caught = (state.ball_col - paddle).abs() <= self.paddle_width // 2
        reward = torch.where(done, caught.to(torch.float32) * 2 - 1, 0.0)
        stepped = CatchState(ball_row, state.ball_col, paddle, state.t + 1)
        new_state = CatchState(*(torch.where(done, a, b)
                                 for a, b in zip(self._spawn(draws), stepped)))
        return new_state, self._render(new_state), reward, done

    def step(self, state: CatchState, action: torch.Tensor, generator: torch.Generator):
        return self.transition(state, action, self.draw(generator))
