"""Uniform and n-step experience replay as a fixed-shape ring buffer on one device.

Port of ``scalerl_tpu/data/replay.py``.  Storage is a dict of
``[capacity, num_envs, ...]`` tensors on the buffer's device; ``add``
writes one vector-env step at the head, and the n-step fold happens at
sample time over the gathered ``[B, n]`` window.

Two differences from the JAX package, both for the card:

- ``replay_add`` writes the storage IN PLACE (the JAX version returns new
  arrays and relies on buffer donation).
- The ring cursors ``pos`` and ``size`` are host integers, not device
  scalars.  The host drives every add, so it knows them; keeping them there
  lets the sampler roll and mask the planes with no device->host read.

Actions are stored as int64 (the JAX package stores int32), the index type
``torch.gather`` takes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from scalerl_torch.utils.platform import DeviceLike, resolve_device

# name -> (per-env trailing shape, dtype)
Spec = Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]


def transition_spec(
    obs_shape: Tuple[int, ...],
    obs_dtype: torch.dtype = torch.float32,
    action_dtype: torch.dtype = torch.int64,
    action_shape: Tuple[int, ...] = (),
    include_boundary: bool = False,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The (obs, next_obs, action, reward, done) transition layout.

    ``done`` is the bootstrap mask: terminations only.  ``include_boundary``
    adds the episode-boundary plane (termination or truncation) that stops
    the n-step fold at a time-limit reset; buffers enable it iff
    ``n_step > 1``, and writers that do not supply it get ``done``."""
    spec = {
        "obs": (tuple(obs_shape), obs_dtype),
        "next_obs": (tuple(obs_shape), obs_dtype),
        "action": (tuple(action_shape), action_dtype),
        "reward": ((), torch.float32),
        "done": ((), torch.bool),
    }
    if include_boundary:
        spec["boundary"] = ((), torch.bool)
    return spec


@dataclass
class ReplayState:
    storage: Dict[str, torch.Tensor]  # each [capacity, num_envs, ...]
    pos: int  # next write row
    size: int  # number of valid rows


def replay_init(
    spec: Spec, capacity: int, num_envs: int, device: DeviceLike = "cuda"
) -> ReplayState:
    device = resolve_device(device)
    storage = {
        name: torch.zeros((capacity, num_envs) + tuple(shape), dtype=dtype, device=device)
        for name, (shape, dtype) in spec.items()
    }
    return ReplayState(storage=storage, pos=0, size=0)


def replay_add(state: ReplayState, step: Mapping[str, torch.Tensor]) -> ReplayState:
    """Write one vector step (each field ``[num_envs, ...]``) at the head,
    in place; returns the state with the cursors advanced."""
    capacity = next(iter(state.storage.values())).shape[0]
    for name, arr in state.storage.items():
        arr[state.pos].copy_(step[name])
    return dataclasses.replace(
        state, pos=(state.pos + 1) % capacity, size=min(state.size + 1, capacity)
    )


def _logical_start(state: ReplayState, capacity: int) -> int:
    """Physical row of the logically oldest entry."""
    return state.pos if state.size == capacity else 0


def _gather_window(arr: torch.Tensor, rows: torch.Tensor, envs: torch.Tensor) -> torch.Tensor:
    """``arr[rows, envs]`` for ``[B]`` (or ``[B, n]``) row/env index tensors."""
    return arr[rows, envs]


def n_step_fold(
    rewards: torch.Tensor,  # [B, n]
    dones: torch.Tensor,  # [B, n] bool: terminations (bootstrap mask)
    gamma: float,
    boundaries: Optional[torch.Tensor] = None,  # [B, n] bool: term | trunc
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold an n-step window into (reward, done, last_index).

    The reward at the first episode boundary is included and later steps
    are masked; ``last_index`` is the offset whose ``next_obs`` bootstraps
    the return (the first boundary, else n-1).  ``done`` holds iff the
    realised window ends on a termination."""
    n = rewards.shape[1]
    boundaries = dones if boundaries is None else boundaries | dones
    boundsf = boundaries.to(rewards.dtype)
    alive = torch.cumprod(1.0 - boundsf, dim=1)  # survived steps 0..k
    alive = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)
    gammas = gamma ** torch.arange(n, dtype=rewards.dtype, device=rewards.device)
    terms = rewards * alive * gammas[None, :]
    # summed in window order, as XLA reduces this axis (torch.sum pairs
    # the terms differently and rounds differently)
    reward = terms[:, 0]
    for k in range(1, n):
        reward = reward + terms[:, k]
    any_bound = boundaries.any(dim=1)
    first_bound = boundaries.to(torch.uint8).argmax(dim=1)  # the first maximum
    last_index = torch.where(any_bound, first_bound, n - 1)
    done = torch.gather(dones, 1, last_index[:, None])[:, 0] & any_bound
    return reward, done, last_index


STANDARD_FIELDS = ("obs", "next_obs", "action", "reward", "done", "boundary")


def gather_transitions(
    state: ReplayState,
    logical: torch.Tensor,  # [B] logical row indices (0 = oldest)
    envs: torch.Tensor,  # [B] env column indices
    n_step: int = 1,
    gamma: float = 0.99,
) -> Dict[str, torch.Tensor]:
    """Gather (n-step) transitions at logical (row, env) pairs.

    ``indices`` is the flat PHYSICAL slot ``row0 * num_envs + env`` of the
    window head: physical rows do not move when later adds advance the
    logical start, so a priority update keyed on it stays addressable."""
    capacity, num_envs = next(iter(state.storage.values())).shape[:2]
    start = _logical_start(state, capacity)
    offs = torch.arange(n_step, device=logical.device)
    rows = (start + logical[:, None] + offs[None, :]) % capacity  # [B, n]
    env_col = envs[:, None]
    store = state.storage
    bounds = _gather_window(store["boundary"], rows, env_col) if "boundary" in store else None
    reward_n, done_n, last_idx = n_step_fold(
        _gather_window(store["reward"], rows, env_col),
        _gather_window(store["done"], rows, env_col),
        gamma,
        bounds,
    )
    row0 = rows[:, 0]
    row_last = torch.gather(rows, 1, last_idx[:, None])[:, 0]
    batch = {
        "obs": store["obs"][row0, envs],
        "action": store["action"][row0, envs],
        "reward": reward_n,
        "next_obs": store["next_obs"][row_last, envs],
        "done": done_n,
        "n_steps": (last_idx + 1).to(torch.int32),
        "indices": row0 * num_envs + envs,
    }
    for name, arr in store.items():  # extra fields ride at the window head
        if name not in STANDARD_FIELDS:
            batch[name] = arr[row0, envs]
    return batch


def replay_sample(
    state: ReplayState,
    generator: Optional[torch.Generator],
    batch_size: int,
    n_step: int = 1,
    gamma: float = 0.99,
) -> Dict[str, torch.Tensor]:
    """Uniformly sample ``batch_size`` (n-step) transitions on the device.

    Valid logical rows leave room for the n-step window (``L <= size -
    n_step``); callers warm up past ``n_step`` rows before sampling."""
    ref = next(iter(state.storage.values()))
    num_envs, device = ref.shape[1], ref.device
    max_l = max(state.size - n_step + 1, 1)
    logical = torch.randint(0, max_l, (batch_size,), generator=generator, device=device)
    envs = torch.randint(0, num_envs, (batch_size,), generator=generator, device=device)
    return gather_transitions(state, logical, envs, n_step, gamma)


def as_step(
    spec: Spec, num_envs: int, device: torch.device, fields: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """One vector step's fields (numpy arrays, numbers or tensors) as
    ``[num_envs, ...]`` tensors of the spec's dtypes on ``device``.  A
    missing ``boundary`` is ``done``; a ``boundary`` the spec has no plane
    for (n_step = 1) is dropped."""
    fields = dict(fields)
    if "boundary" in spec:
        if fields.get("boundary") is None:
            fields["boundary"] = fields["done"]
    else:
        fields.pop("boundary", None)
    step = {}
    for name, value in fields.items():
        shape, dtype = spec[name]
        step[name] = torch.as_tensor(value, device=device).to(dtype).reshape(
            (num_envs,) + tuple(shape)
        )
    return step


class ReplayBuffer:
    """Host-side wrapper over the ring buffer (``save_to_memory`` /
    ``sample``, the reference API)."""

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        capacity: int,
        num_envs: int = 1,
        obs_dtype: torch.dtype = torch.float32,
        n_step: int = 1,
        gamma: float = 0.99,
        action_shape: Tuple[int, ...] = (),
        action_dtype: torch.dtype = torch.int64,
        device: DeviceLike = "cuda",
    ) -> None:
        self.spec = transition_spec(
            obs_shape, obs_dtype, action_dtype=action_dtype,
            action_shape=action_shape, include_boundary=n_step > 1,
        )
        self.capacity = capacity
        self.num_envs = num_envs
        self.n_step = n_step
        self.gamma = gamma
        self.device = resolve_device(device)
        self.state = replay_init(self.spec, capacity, num_envs, self.device)

    def __len__(self) -> int:
        return self.state.size * self.num_envs

    def save_to_memory(self, obs, next_obs, action, reward, done, boundary=None) -> None:
        """Add one vector step (``[num_envs, ...]`` each; numpy or tensors).
        ``boundary`` (termination or truncation) bounds the n-step fold and
        defaults to ``done``."""
        step = as_step(self.spec, self.num_envs, self.device, dict(
            obs=obs, next_obs=next_obs, action=action, reward=reward, done=done,
            boundary=boundary,
        ))
        self.state = replay_add(self.state, step)

    def save_chunk(self, **chunk) -> None:
        """Add a ``[T, num_envs, ...]`` chunk of vector steps (numpy or
        tensors; fields as :meth:`save_to_memory` takes them), oldest first:
        one host->device copy a field and one indexed write a plane, the
        same contents as ``T`` single adds."""
        T = len(next(iter(chunk.values())))
        if T > self.capacity:
            raise ValueError(f"chunk of {T} steps exceeds the capacity {self.capacity}")
        if "boundary" in self.spec:
            if chunk.get("boundary") is None:
                chunk["boundary"] = chunk["done"]
        else:
            chunk.pop("boundary", None)
        rows = (self.state.pos + torch.arange(T, device=self.device)) % self.capacity
        for name, arr in self.state.storage.items():
            shape, dtype = self.spec[name]
            value = torch.as_tensor(chunk[name], device=self.device).to(dtype)
            arr[rows] = value.reshape((T, self.num_envs) + tuple(shape))
        self.state = dataclasses.replace(
            self.state, pos=(self.state.pos + T) % self.capacity,
            size=min(self.state.size + T, self.capacity))

    def sample(
        self, batch_size: int, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        return replay_sample(self.state, generator, batch_size, self.n_step, self.gamma)
