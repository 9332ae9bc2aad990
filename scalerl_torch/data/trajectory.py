"""The time-major trajectory chunk ``[T+1, B, ...]``.

Port of the ``Trajectory`` container of ``scalerl_tpu/data/trajectory.py``.
Row convention (the reference's env-output layout):

- ``obs[t]``: observation at step t.
- ``action[t]``: the action that *led to* ``obs[t]`` (last-action
  semantics; ``action[0]`` carries in from the previous chunk).  The action
  *taken at* ``obs[t]`` is therefore ``action[t+1]``.
- ``reward[t]`` / ``done[t]``: consequences of ``action[t]``; both are model
  inputs at row t.
- ``logits[t]``: behavior-policy logits at ``obs[t]`` (V-trace input); the
  last row's are unused by the learner and left zero.
- ``core_state``: recurrent state entering row 0 (empty for FF models).

So the T valid transitions are
``(obs[t], action[t+1]) -> reward[t+1], done[t+1], obs[t+1]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class Trajectory:
    obs: torch.Tensor  # [T+1, B, ...]
    action: torch.Tensor  # [T+1, B] int64
    reward: torch.Tensor  # [T+1, B] float32
    done: torch.Tensor  # [T+1, B] bool
    logits: torch.Tensor  # [T+1, B, A] float32
    core_state: Any = ()
