"""Batched delayed recall that steps on the device, with auto-reset.

Port of ``scalerl_tpu/envs/jax_envs/recall.py``: a cue (one of
``num_cues`` quadrant patterns, or left/right halves with 2 cues) shows in
the first frame of an episode only; ``delay`` blank frames follow, and at
the last step the agent must answer with the action of the cue (+1 right,
-1 wrong).  A policy without memory is held to ``2 / num_cues - 1`` in
expectation, so crossing a high threshold needs the recurrent core to
carry the cue.  Observations are ``[size, size, 1]`` uint8 frames.

A step is split in two so tests can hold it against the JAX env exactly:
:meth:`TensorRecall.draw` takes the one random draw (a new episode's cue)
from the generator, and :meth:`TensorRecall.transition` is the pure step
given it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.utils.platform import DeviceLike


class RecallState(NamedTuple):
    cue: torch.Tensor  # [B] int64 in [0, num_cues)
    t: torch.Tensor  # [B] int64 step counter


class RecallDraws(NamedTuple):
    cue: torch.Tensor  # [B] int64 cue of a new episode


class TensorRecall(TensorEnv):
    """Show a cue, wait ``delay`` blank steps, ask for it back."""

    def __init__(
        self,
        num_envs: int,
        size: int = 16,
        delay: int = 6,
        num_cues: int = 4,
        device: DeviceLike = "cuda",
    ) -> None:
        if num_cues not in (2, 4):
            raise ValueError("num_cues must be 2 or 4 (quadrant patterns)")
        super().__init__(num_envs, device)
        self.size = size
        self.delay = delay
        self.num_cues = num_cues
        half = torch.arange(size, device=self.device) >= size // 2
        # quadrant q lights (row half, col half) = (q // 2, q % 2); with 2
        # cues only the column half counts
        self._row_half = half.long()[None, :, None]
        self._col_half = half.long()[None, None, :]

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        return (self.size, self.size, 1)

    @property
    def num_actions(self) -> int:
        return self.num_cues

    def _render(self, state: RecallState) -> torch.Tensor:
        """``[B, size, size, 1]`` uint8 frames."""
        cue = state.cue[:, None, None]
        in_q = self._col_half == cue % 2
        if self.num_cues == 4:
            in_q = in_q & (self._row_half == cue // 2)
        lit = in_q.expand(-1, self.size, self.size) & (state.t == 0)[:, None, None]
        return (lit.to(torch.uint8) * 255)[..., None]

    def draw(self, generator: torch.Generator) -> RecallDraws:
        """The random numbers of one step (or reset), for every lane."""
        return RecallDraws(torch.randint(0, self.num_cues, (self.num_envs,),
                                         generator=generator, device=self.device))

    def reset(self, generator: torch.Generator) -> Tuple[RecallState, torch.Tensor]:
        cue = self.draw(generator).cue
        state = RecallState(cue, torch.zeros_like(cue))
        return state, self._render(state)

    def transition(self, state: RecallState, action: torch.Tensor, draws: RecallDraws):
        """The pure step given the draws: ``(state, obs, reward, done)``;
        where ``done``, the state and obs are already the new episode's."""
        t = state.t + 1
        done = t > self.delay  # an episode is the cue frame and delay blanks
        right = action.long() == state.cue
        reward = torch.where(done, right.to(torch.float32) * 2 - 1, 0.0)
        new_state = RecallState(torch.where(done, draws.cue, state.cue),
                                torch.where(done, 0, t))
        return new_state, self._render(new_state), reward, done

    def step(self, state: RecallState, action: torch.Tensor, generator: torch.Generator):
        return self.transition(state, action, self.draw(generator))
