"""The time-major trajectory chunk ``[T+1, B, ...]``, its host staging
buffers and their assembly.

Port of ``scalerl_tpu/data/trajectory.py``: ``Trajectory``,
``TrajectorySpec`` (with ``host_zeros``, one rollout slot of numpy staging
buffers for the host actor plane), ``batch_to_trajectory`` (a drained
batch of slots onto the device) and ``stack_trajectories``.
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
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclass
class Trajectory:
    obs: torch.Tensor  # [T+1, B, ...]
    action: torch.Tensor  # [T+1, B] int64
    reward: torch.Tensor  # [T+1, B] float32
    done: torch.Tensor  # [T+1, B] bool
    logits: torch.Tensor  # [T+1, B, A] float32
    core_state: Any = ()


@dataclass(frozen=True)
class TrajectorySpec:
    """Static description of a trajectory chunk."""

    unroll_length: int  # T
    batch_size: int  # B
    obs_shape: Tuple[int, ...]
    num_actions: int
    obs_dtype: Any = np.uint8  # a numpy dtype
    core_state_shapes: Tuple[Tuple[int, ...], ...] = ()  # per-layer [B, ...] shapes

    def host_zeros(self) -> Dict[str, np.ndarray]:
        """One rollout slot of numpy staging buffers.  Recurrent core-state
        leaves are flat ``core_{i}_{c|h}`` keys with a leading batch axis
        (row 0's state, no time axis): ``RolloutQueue.get_batch``
        concatenates them on axis 0 and the time-major fields on axis 1."""
        T1 = self.unroll_length + 1
        B = self.batch_size
        out = {
            "obs": np.zeros((T1, B) + tuple(self.obs_shape), np.dtype(self.obs_dtype)),
            "action": np.zeros((T1, B), np.int32),
            "reward": np.zeros((T1, B), np.float32),
            "done": np.ones((T1, B), bool),
            "logits": np.zeros((T1, B, self.num_actions), np.float32),
        }
        for i, s in enumerate(self.core_state_shapes):
            out[f"core_{i}_c"] = np.zeros(s, np.float32)
            out[f"core_{i}_h"] = np.zeros(s, np.float32)
        return out


def batch_to_trajectory(batch: Dict[str, np.ndarray], device: torch.device) -> Trajectory:
    """A host batch (``RolloutQueue.get_batch``'s output) as a Trajectory on
    ``device``; actions widen to int64, as the learner indexes with them."""

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    core = []
    i = 0
    while f"core_{i}_c" in batch:
        core.append((put(batch[f"core_{i}_c"]), put(batch[f"core_{i}_h"])))
        i += 1
    return Trajectory(
        obs=put(batch["obs"]),
        action=put(batch["action"]).long(),
        reward=put(batch["reward"]),
        done=put(batch["done"]),
        logits=put(batch["logits"]),
        core_state=tuple(core),
    )


def host_chunk_to_trajectory(fields: Dict[str, np.ndarray], core_state: Any,
                             device: torch.device) -> Trajectory:
    """A chunk of host staging buffers (``obs``, ``action``, ``reward``,
    ``done``, ``logits``) as a Trajectory on ``device`` with ONE
    host-to-device copy (``agents/policy_value.py::pack_to_device``);
    ``core_state`` (the entering recurrent state) is already on the device
    and is kept as it is."""
    from scalerl_torch.agents.policy_value import pack_to_device

    obs, action, reward, done, logits = pack_to_device(
        [fields[k] for k in ("obs", "action", "reward", "done", "logits")], device)
    return Trajectory(obs=obs, action=action.long(), reward=reward, done=done, logits=logits,
                      core_state=core_state)


def stack_trajectories(trajs: list) -> Trajectory:
    """Concatenate trajectories along the batch axis: dim 1 of the
    time-major fields, dim 0 of the ``core_state`` leaves (``[B, ...]``).
    The JAX function concatenates every leaf on axis 1, core leaves too."""

    def cat_core(*cores):
        if isinstance(cores[0], torch.Tensor):
            return torch.cat(cores, dim=0)
        return type(cores[0])(cat_core(*xs) for xs in zip(*cores))

    return Trajectory(
        obs=torch.cat([t.obs for t in trajs], dim=1),
        action=torch.cat([t.action for t in trajs], dim=1),
        reward=torch.cat([t.reward for t in trajs], dim=1),
        done=torch.cat([t.done for t in trajs], dim=1),
        logits=torch.cat([t.logits for t in trajs], dim=1),
        core_state=cat_core(*[t.core_state for t in trajs]),
    )
