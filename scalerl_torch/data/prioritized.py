"""Prioritized experience replay with proportional sampling on the device.

Port of ``scalerl_tpu/data/prioritized.py``.  Priorities are stored raw in
a ``[capacity, num_envs]`` float32 plane beside the ring buffer; ``alpha``
is applied at sample time, and importance weights use the
``(N * P)^-beta / max`` normalisation.

The priority plane is contiguous, so its flat view addresses the flat
physical slot ``row * num_envs + env`` that ``batch["indices"]`` carries,
and :func:`per_update_priorities` writes it IN PLACE through that view.

The sample is split in two so a test can feed both packages the same
uniform draw: :func:`per_sample` draws ``u`` from a ``torch.Generator``
and :func:`per_sample_from_uniforms` is the rest.

Ape-X inserts through :func:`per_add_with_priorities` (the actors'
priorities, not the running max) and stores each transition's realised
window length as an ``extra_fields`` plane.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from scalerl_torch.data.replay import (
    ReplayState,
    Spec,
    _logical_start,
    as_step,
    gather_transitions,
    replay_add,
    replay_init,
    transition_spec,
)
from scalerl_torch.ops.per import (
    SAMPLE_METHODS,
    UPDATE_METHODS,
    proportional_sample,
    update_priorities_blocks,
)
from scalerl_torch.utils.platform import DeviceLike, resolve_device


@dataclass
class PrioritizedState:
    replay: ReplayState
    priorities: torch.Tensor  # [capacity, num_envs] float32, raw (no alpha)
    max_priority: torch.Tensor  # float32 scalar on the device


def per_init(
    spec: Spec, capacity: int, num_envs: int, device: DeviceLike = "cuda"
) -> PrioritizedState:
    device = resolve_device(device)
    return PrioritizedState(
        replay=replay_init(spec, capacity, num_envs, device),
        priorities=torch.zeros((capacity, num_envs), dtype=torch.float32, device=device),
        max_priority=torch.ones((), dtype=torch.float32, device=device),
    )


def per_add(state: PrioritizedState, step) -> PrioritizedState:
    """Add one vector step; new transitions get the current max priority."""
    pos = state.replay.pos
    replay = replay_add(state.replay, step)
    state.priorities[pos].copy_(state.max_priority.expand(state.priorities.shape[1]))
    return dataclasses.replace(state, replay=replay)


def per_add_with_priorities(
    state: PrioritizedState, step, priorities: torch.Tensor
) -> PrioritizedState:
    """Add one vector step with caller-supplied raw priorities ``[num_envs]``
    (the Ape-X protocol: actors prioritise their own transitions): clamped
    to 1e-6, written at the row, and the running max raised to them."""
    pos = state.replay.pos
    replay = replay_add(state.replay, step)
    priorities = priorities.to(torch.float32).clamp_min(1e-6)
    state.priorities[pos].copy_(priorities)
    new_max = torch.maximum(state.max_priority, priorities.max())
    return dataclasses.replace(state, replay=replay, max_priority=new_max)


def per_sample_from_uniforms(
    state: PrioritizedState,
    u: torch.Tensor,  # [batch_size] uniforms in [0, 1)
    alpha: float,
    beta: float,
    n_step: int = 1,
    gamma: float = 0.99,
    method: str = "hierarchical",
) -> Dict[str, torch.Tensor]:
    """Stratified proportional sample from the uniforms ``u``; returns the
    transitions and their importance ``weights``.

    The distribution is ``p_i^alpha`` over valid logical rows (those with a
    full n-step window).  ``method``: ``cumsum``, ``hierarchical`` or
    ``pallas`` (the CUDA kernel), as in ``ops/per.py``."""
    num_envs = state.priorities.shape[1]
    flat_logical, probs, n_rows = per_draw(state, u, alpha, n_step, method)
    n_valid = float(max(n_rows * num_envs, 1))
    weights = (n_valid * probs.clamp_min(1e-12)) ** (-beta)
    weights = weights / weights.max().clamp_min(1e-12)

    batch = gather_transitions(
        state.replay, flat_logical // num_envs, flat_logical % num_envs, n_step, gamma
    )
    batch["weights"] = weights
    return batch


def per_draw(
    state: PrioritizedState, u: torch.Tensor, alpha: float, n_step: int, method: str
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The draw of :func:`per_sample_from_uniforms`: ``(flat logical
    indices [B], their probabilities [B], the valid rows)``, stratified
    over the plane's ``p^alpha`` mass from the uniforms ``u``."""
    capacity = state.priorities.shape[0]
    batch_size = u.shape[0]
    device = state.priorities.device
    start = _logical_start(state.replay, capacity)
    # priorities in logical order (row 0 = oldest): a copy, as jnp.roll is
    logical_prio = torch.roll(state.priorities, -start, dims=0)
    # the window at L reads rows L..L+n_step-1, so L <= size - n_step
    n_rows = max(state.replay.size - n_step + 1, 1)
    valid = (torch.arange(capacity, device=device) < n_rows)[:, None]
    p = torch.where(valid, logical_prio, 0.0) ** alpha
    p = torch.where(valid, p.clamp_min(1e-12), 0.0)
    flat_p = p.reshape(-1)
    total = flat_p.sum()

    targets = (torch.arange(batch_size, device=device) + u) / batch_size * total
    flat_logical = proportional_sample(flat_p, targets, method=method)
    probs = flat_p[flat_logical] / total.clamp_min(1e-12)
    return flat_logical, probs, n_rows


def per_sample(
    state: PrioritizedState,
    generator: Optional[torch.Generator],
    batch_size: int,
    alpha: float,
    beta: float,
    n_step: int = 1,
    gamma: float = 0.99,
    method: str = "hierarchical",
) -> Dict[str, torch.Tensor]:
    """:func:`per_sample_from_uniforms` with ``u`` drawn from ``generator``
    (on the plane's device; ``None`` takes the device's default)."""
    u = torch.rand(batch_size, generator=generator, device=state.priorities.device)
    return per_sample_from_uniforms(state, u, alpha, beta, n_step, gamma, method)


def per_update_priorities(
    state: PrioritizedState,
    flat_physical: torch.Tensor,  # [B] as returned in batch["indices"]
    priorities: torch.Tensor,  # [B] new raw priorities (e.g. |td| + eps)
    method: str = "xla",
) -> PrioritizedState:
    """Write new priorities at the sampled PHYSICAL slots, in place;
    duplicate slots resolve last-wins.  ``method``: ``"xla"`` (the plain
    version) or ``"pallas"`` (the CUDA kernel)."""
    priorities = priorities.clamp_min(1e-6)
    update_priorities_blocks(
        state.priorities.view(-1), flat_physical, priorities, method=method
    )
    new_max = torch.maximum(state.max_priority, priorities.max())
    return dataclasses.replace(state, max_priority=new_max)


class PrioritizedReplayBuffer:
    """Host-side wrapper with the reference PER API (``sample(batch_size,
    beta)`` and ``update_priorities``)."""

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        capacity: int,
        num_envs: int = 1,
        obs_dtype: torch.dtype = torch.float32,
        alpha: float = 0.6,
        n_step: int = 1,
        gamma: float = 0.99,
        sample_method: str = "hierarchical",
        update_method: str = "xla",
        action_shape: Tuple[int, ...] = (),
        action_dtype: torch.dtype = torch.int64,
        extra_fields: Optional[Dict[str, Tuple[Tuple[int, ...], torch.dtype]]] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        """``extra_fields``: name -> (per-transition shape, dtype) planes
        stored beside the transition and returned at the window head."""
        if sample_method not in SAMPLE_METHODS:
            raise ValueError(f"sample_method must be one of {SAMPLE_METHODS}, got {sample_method!r}")
        if update_method not in UPDATE_METHODS:
            raise ValueError(f"update_method must be one of {UPDATE_METHODS}, got {update_method!r}")
        self.spec = transition_spec(
            obs_shape, obs_dtype, action_dtype=action_dtype,
            action_shape=action_shape, include_boundary=n_step > 1,
        )
        self.spec.update(extra_fields or {})
        self.capacity = capacity
        self.num_envs = num_envs
        self.alpha = alpha
        self.n_step = n_step
        self.gamma = gamma
        self.sample_method = sample_method
        self.update_method = update_method
        self.device = resolve_device(device)
        self.state = per_init(self.spec, capacity, num_envs, self.device)

    def __len__(self) -> int:
        return self.state.replay.size * self.num_envs

    def save_to_memory(self, obs, next_obs, action, reward, done, boundary=None) -> None:
        step = as_step(self.spec, self.num_envs, self.device, dict(
            obs=obs, next_obs=next_obs, action=action, reward=reward, done=done,
            boundary=boundary,
        ))
        self.state = per_add(self.state, step)

    def add_with_priorities(self, step: Dict[str, object], priorities) -> None:
        """Add one vector step (every field of the spec, ``[num_envs, ...]``
        each) with actor-computed priorities: the Ape-X insert path."""
        step = as_step(self.spec, self.num_envs, self.device, step)
        self.state = per_add_with_priorities(
            self.state, step, torch.as_tensor(priorities, device=self.device))

    def sample(
        self, batch_size: int, beta: float = 0.4, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        return per_sample(
            self.state, generator, batch_size, alpha=self.alpha, beta=beta,
            n_step=self.n_step, gamma=self.gamma, method=self.sample_method,
        )

    def update_priorities(self, indices: torch.Tensor, priorities: torch.Tensor) -> None:
        self.state = per_update_priorities(
            self.state, torch.as_tensor(indices, device=self.device),
            torch.as_tensor(priorities, dtype=torch.float32, device=self.device),
            method=self.update_method,
        )
