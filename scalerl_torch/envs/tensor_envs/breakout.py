"""Batched Breakout that steps on the device, with auto-reset.

Port of ``scalerl_tpu/envs/jax_envs/breakout.py``, a MinAtar-style game on
a ``size`` x ``size`` grid.  One step:

1. the 3-wide paddle moves left / stay / right, kept on the field;
2. the ball moves one cell diagonally; side walls and the ceiling reflect
   it in its cell (both velocity components are always +-1);
3. entering a brick cell removes the brick, pays +1 and reflects the
   vertical velocity (the ball goes back to its previous row);
4. on the paddle's row the ball bounces up if the paddle is under it, and
   the episode ends otherwise;
5. a cleared wall comes back full at once;
6. an episode also ends after ``max_steps`` steps.

Observations are ``[side, side, stack]`` uint8 frames, bricks at 128, ball
and paddle at 255; ``render_size`` upscales the grid to ``render_size``
square by nearest neighbour (integer index arithmetic, bit-exact with the
JAX env), as ``impala_breakout_84`` renders it at 84 x 84.

A step is split in two so tests can hold it against the JAX env exactly:
:meth:`TensorBreakout.draw` takes a new episode's random draws (the ball's
column and horizontal direction) from the generator, and
:meth:`TensorBreakout.transition` is the pure step given them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.utils.platform import DeviceLike


class BreakoutState(NamedTuple):
    ball_x: torch.Tensor  # [B] int64 column
    ball_y: torch.Tensor  # [B] int64 row, 0 = top
    dx: torch.Tensor  # [B] int64 +-1
    dy: torch.Tensor  # [B] int64 +-1
    paddle_x: torch.Tensor  # [B] int64 column of the paddle's centre
    bricks: torch.Tensor  # [B, brick_rows, size] bool
    t: torch.Tensor  # [B] int64 step counter


class BreakoutDraws(NamedTuple):
    ball_x: torch.Tensor  # [B] int64 column a new episode's ball starts in
    dx: torch.Tensor  # [B] int64 its horizontal direction, +-1


class TensorBreakout(TensorEnv):
    """``size`` x ``size`` Breakout with ``brick_rows`` rows of bricks."""

    def __init__(
        self,
        num_envs: int,
        size: int = 10,
        stack: int = 1,
        brick_rows: int = 3,
        brick_top: int = 2,
        max_steps: int = 500,
        render_size: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        if brick_top + brick_rows >= size - 2:
            raise ValueError("brick wall must leave room above the paddle row")
        if render_size is not None and render_size < size:
            raise ValueError("render_size must be >= the logical grid size")
        super().__init__(num_envs, device)
        self.size = size
        self.stack = stack
        self.brick_rows = brick_rows
        self.brick_top = brick_top
        self.max_steps = max_steps
        self.render_size = render_size
        self._rows = torch.arange(size, device=self.device)[None, :, None]
        self._cols = torch.arange(size, device=self.device)[None, None, :]
        self._brick_rows = torch.arange(brick_rows, device=self.device)[None, :, None]
        self._upscale = None
        if render_size is not None:
            self._upscale = (torch.arange(render_size, device=self.device) * size) // render_size

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        side = self.render_size or self.size
        return (side, side, self.stack)

    @property
    def num_actions(self) -> int:
        return 3  # left / stay / right

    def _render(self, state: BreakoutState) -> torch.Tensor:
        """``[B, side, side, stack]`` uint8 frames."""
        B, top = state.bricks.shape[0], self.brick_top
        frame = torch.zeros((B, self.size, self.size), dtype=torch.uint8, device=self.device)
        frame[:, top:top + self.brick_rows] = state.bricks.to(torch.uint8) * 128
        ball = (self._rows == state.ball_y[:, None, None]) & (
            self._cols == state.ball_x[:, None, None])
        paddle = (self._rows == self.size - 1) & (
            (self._cols - state.paddle_x[:, None, None]).abs() <= 1)
        frame = torch.where(ball | paddle, 255, frame)
        if self._upscale is not None:
            frame = frame[:, self._upscale][:, :, self._upscale]
        return frame[..., None].expand(-1, -1, -1, self.stack).contiguous()

    def _spawn(self, draws: BreakoutDraws) -> BreakoutState:
        B = draws.ball_x.shape[0]
        ones = torch.ones_like(draws.ball_x)
        return BreakoutState(
            ball_x=draws.ball_x,
            ball_y=ones * (self.brick_top + self.brick_rows),
            dx=draws.dx,
            dy=ones,  # heading down toward the paddle
            paddle_x=ones * (self.size // 2),
            bricks=torch.ones((B, self.brick_rows, self.size), dtype=torch.bool,
                              device=self.device),
            t=torch.zeros_like(draws.ball_x),
        )

    def draw(self, generator: torch.Generator) -> BreakoutDraws:
        """The random numbers of one step (or reset), for every lane."""
        ball_x = torch.randint(0, self.size, (self.num_envs,), generator=generator,
                               device=self.device)
        right = torch.randint(0, 2, (self.num_envs,), generator=generator, device=self.device)
        return BreakoutDraws(ball_x, right * 2 - 1)

    def reset(self, generator: torch.Generator) -> Tuple[BreakoutState, torch.Tensor]:
        state = self._spawn(self.draw(generator))
        return state, self._render(state)

    def transition(self, state: BreakoutState, action: torch.Tensor, draws: BreakoutDraws):
        """The pure step given the draws: ``(state, obs, reward, done)``;
        where ``done``, the state and obs are already the new episode's."""
        W = self.size
        paddle = torch.clamp(state.paddle_x + action.long() - 1, 1, W - 2)

        # advance; with unit velocity the clipped cell is the reflected one
        nx = state.ball_x + state.dx
        dx = torch.where((nx < 0) | (nx >= W), -state.dx, state.dx)
        nx = torch.clamp(nx, 0, W - 1)
        ny = state.ball_y + state.dy
        hit_ceiling = ny < 0
        dy = torch.where(hit_ceiling, 1, state.dy)
        ny = torch.where(hit_ceiling, 1, ny)

        # the brick in the entered cell, if any (no cell outside the band)
        brow = ny - self.brick_top
        cell = (self._brick_rows == brow[:, None, None]) & (self._cols == nx[:, None, None])
        hit_brick = (state.bricks & cell).flatten(1).any(dim=1)
        bricks = state.bricks & ~cell  # clears the cell's brick, if it has one
        reward = hit_brick.to(torch.float32)
        ny = torch.where(hit_brick, state.ball_y, ny)
        dy = torch.where(hit_brick, -dy, dy)

        # the paddle's row
        at_bottom = ny >= W - 1
        caught = at_bottom & ((nx - paddle).abs() <= 1)
        ny = torch.where(caught, W - 2, ny)
        dy = torch.where(caught, -1, dy)
        missed = at_bottom & ~caught

        # a cleared wall comes back full
        cleared = ~bricks.flatten(1).any(dim=1)
        bricks = bricks | cleared[:, None, None]

        t = state.t + 1
        done = missed | (t >= self.max_steps)
        stepped = BreakoutState(nx, ny, dx, dy, paddle, bricks, t)
        fresh = self._spawn(draws)
        new_state = BreakoutState(*(
            torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(fresh, stepped)))
        return new_state, self._render(new_state), reward, done

    def step(self, state: BreakoutState, action: torch.Tensor, generator: torch.Generator):
        return self.transition(state, action, self.draw(generator))
