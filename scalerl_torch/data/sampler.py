"""One ``sample()`` facade over the replay variants.

Port of ``scalerl_tpu/data/sampler.py``: uniform or prioritized, one-step
or n-step, picked at construction.  ``use_pallas`` (``RLArguments.
use_pallas``) pins both halves of PER to the CUDA kernels (``"pallas"``);
otherwise PER takes the plain ``hierarchical`` search and the plain
(``"xla"``) update, which is what the JAX package resolves to off the TPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scalerl_torch.data.prioritized import PrioritizedReplayBuffer
from scalerl_torch.data.replay import ReplayBuffer
from scalerl_torch.utils.platform import DeviceLike


class Sampler:
    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        capacity: int,
        num_envs: int = 1,
        obs_dtype: torch.dtype = torch.float32,
        use_per: bool = False,
        per_alpha: float = 0.6,
        n_step: int = 1,
        gamma: float = 0.99,
        action_shape: Tuple[int, ...] = (),
        action_dtype: torch.dtype = torch.int64,
        use_pallas: bool = False,
        device: DeviceLike = "cuda",
    ) -> None:
        self.use_per = use_per
        self.n_step = n_step
        common = dict(
            num_envs=num_envs, obs_dtype=obs_dtype, n_step=n_step, gamma=gamma,
            action_shape=tuple(action_shape), action_dtype=action_dtype, device=device,
        )
        if use_per:
            self.buffer = PrioritizedReplayBuffer(
                obs_shape, capacity, alpha=per_alpha,
                sample_method="pallas" if use_pallas else "hierarchical",
                update_method="pallas" if use_pallas else "xla",
                **common,
            )
        else:
            self.buffer = ReplayBuffer(obs_shape, capacity, **common)

    def __len__(self) -> int:
        return len(self.buffer)

    def add(self, obs, next_obs, action, reward, done, boundary=None) -> None:
        self.buffer.save_to_memory(obs, next_obs, action, reward, done, boundary=boundary)

    def sample(
        self,
        batch_size: int,
        beta: float = 0.4,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        if self.use_per:
            return self.buffer.sample(batch_size, beta=beta, generator=generator)
        return self.buffer.sample(batch_size, generator=generator)

    def update_priorities(self, indices, priorities) -> None:
        if self.use_per:
            self.buffer.update_priorities(indices, priorities)
