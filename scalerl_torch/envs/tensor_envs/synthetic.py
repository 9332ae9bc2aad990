"""Synthetic pixel environment with Atari-shaped observations.

Port of ``scalerl_tpu/envs/jax_envs/synthetic.py``: a hidden cell walks a
ring of ``num_states`` cells; each cell renders a deterministic
``[84, 84, 4]`` uint8 frame (a bright stripe over a dim texture); the action
``cell % num_actions`` advances the walk (reward 1), any other teleports it
to a uniformly random cell (reward 0); episodes end after
``episode_length`` steps.  ``sticky_prob`` repeats the previously executed
action with that probability (ALE sticky actions).

A step is split in two so tests can hold it against the JAX env exactly:
:meth:`SyntheticPixelEnv.draw` takes the three random draws (teleport cell,
reset cell, sticky coin) as ``[B]`` tensors from the generator, and
:meth:`SyntheticPixelEnv.transition` is the pure transition given them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.utils.platform import DeviceLike


class SyntheticState(NamedTuple):
    cell: torch.Tensor  # [B] int64 ring position
    t: torch.Tensor  # [B] int64 step counter
    last_action: torch.Tensor  # [B] int64 previous *executed* action (sticky)


class SyntheticDraws(NamedTuple):
    teleport: torch.Tensor  # [B] int64 cell a wrong action teleports to
    reset_cell: torch.Tensor  # [B] int64 cell a new episode starts in
    sticky: Optional[torch.Tensor]  # [B] bool, None when sticky_prob == 0


class SyntheticPixelEnv(TensorEnv):
    def __init__(
        self,
        num_envs: int,
        size: int = 84,
        stack: int = 4,
        num_actions: int = 6,
        num_states: int = 16,
        episode_length: int = 128,
        sticky_prob: float = 0.0,
        device: DeviceLike = "cuda",
    ) -> None:
        super().__init__(num_envs, device)
        if num_states > size:
            raise ValueError(
                f"num_states ({num_states}) must be <= size ({size}) so every "
                "cell renders a distinct observation"
            )
        self.size = size
        self.stack = stack
        self._num_actions = num_actions
        self.num_states = num_states
        self.episode_length = episode_length
        self.sticky_prob = float(sticky_prob)
        # the per-cell frame is the texture with one stripe of columns lit
        rows = torch.arange(size, device=self.device)[:, None, None]
        cols = torch.arange(size, device=self.device)[None, :, None]
        chans = torch.arange(stack, device=self.device)[None, None, :]
        self._texture = ((rows * 2 + cols * 5 + chans * 17) % 128).to(torch.uint8)
        stripe_w = max(size // num_states, 1)
        self._col_block = torch.arange(size, device=self.device) // stripe_w

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        return (self.size, self.size, self.stack)

    @property
    def num_actions(self) -> int:
        return self._num_actions

    def _render(self, cell: torch.Tensor) -> torch.Tensor:
        """``[B]`` cells -> ``[B, size, size, stack]`` uint8 frames."""
        in_stripe = self._col_block[None, :] == cell[:, None]  # [B, W]
        return torch.where(
            in_stripe[:, None, :, None],
            torch.full((), 255, dtype=torch.uint8, device=self.device),
            self._texture[None],
        )

    def _correct_action(self, cell: torch.Tensor) -> torch.Tensor:
        return cell % self._num_actions

    def _randint(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randint(
            0, self.num_states, (self.num_envs,), generator=generator,
            device=self.device,
        )

    def reset(self, generator: torch.Generator):
        cell = self._randint(generator)
        zeros = torch.zeros_like(cell)
        return SyntheticState(cell, zeros, zeros.clone()), self._render(cell)

    def draw(self, generator: torch.Generator) -> SyntheticDraws:
        """The random numbers of one step, for every lane."""
        teleport = self._randint(generator)
        reset_cell = self._randint(generator)
        sticky = None
        if self.sticky_prob > 0.0:
            u = torch.rand(self.num_envs, generator=generator, device=self.device)
            sticky = u < self.sticky_prob
        return SyntheticDraws(teleport, reset_cell, sticky)

    def transition(
        self, state: SyntheticState, action: torch.Tensor, draws: SyntheticDraws
    ):
        """The pure step given the draws: ``(state, obs, reward, done)``."""
        action = action.long()
        if draws.sticky is not None:
            executed = torch.where(draws.sticky, state.last_action, action)
        else:
            executed = action
        correct = executed == self._correct_action(state.cell)
        reward = correct.to(torch.float32)
        cell = torch.where(
            correct, (state.cell + 1) % self.num_states, draws.teleport
        )
        t = state.t + 1
        done = t >= self.episode_length
        new_cell = torch.where(done, draws.reset_cell, cell)
        zeros = torch.zeros_like(t)
        new_state = SyntheticState(
            new_cell,
            torch.where(done, zeros, t),
            # the sticky carry resets with the episode
            torch.where(done, zeros, executed),
        )
        return new_state, self._render(new_cell), reward, done

    def step(
        self, state: SyntheticState, action: torch.Tensor,
        generator: torch.Generator,
    ):
        return self.transition(state, action, self.draw(generator))
