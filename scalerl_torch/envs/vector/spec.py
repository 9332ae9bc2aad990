"""Shared-memory observation plane for vectorized (multi-agent) envs.

Port of ``scalerl_tpu/envs/vector/spec.py`` (plain numpy there too).
Parity target: the ``SharedMemory`` / ``Observations`` /
``PettingZooExperienceSpec`` trio of the reference's largest file
(``scalerl/envs/vector/pz_async_vec_env.py:544-788``): N env subprocesses
write observations into one process-shared buffer, and the parent reads
per-agent views without a copy.

Each agent gets its own dtype-matched ``RawArray`` laid out agent-major,
``[num_envs, *shape]`` contiguous, so an agent's batch is its staging buffer
(one host-to-device copy an agent); uint8 pixel planes stay uint8.
"""

from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class AgentSlot:
    shape: Tuple[int, ...]
    dtype: np.dtype

    @property
    def width(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class ExperienceSpec:
    """Per-agent observation layout for a fleet of ``num_envs`` envs."""

    def __init__(
        self, obs_spaces: Mapping[str, Tuple[Tuple[int, ...], Any]], num_envs: int
    ) -> None:
        self.num_envs = num_envs
        self.slots: Dict[str, AgentSlot] = {
            agent: AgentSlot(tuple(shape), np.dtype(dtype))
            for agent, (shape, dtype) in obs_spaces.items()
        }

    @property
    def agents(self) -> Sequence[str]:
        return list(self.slots.keys())

    def total_bytes(self) -> int:
        return sum(
            s.width * s.dtype.itemsize * self.num_envs for s in self.slots.values()
        )


class SharedObservationPlane:
    """Process-shared, zero-copy observation buffers (one per agent).

    Both the parent and the env subprocesses hold numpy views over the same
    ``mp.RawArray`` memory: workers write rows, the parent reads batches —
    no serialization on the obs path (the design that made the reference's
    async vec env its fastest component).
    """

    def __init__(self, spec: ExperienceSpec, ctx=None) -> None:
        ctx = ctx or mp.get_context()
        self.spec = spec
        self._raw: Dict[str, Any] = {}
        self._view_cache: Dict[str, np.ndarray] = {}
        for agent, slot in spec.slots.items():
            nbytes = slot.width * slot.dtype.itemsize * spec.num_envs
            self._raw[agent] = ctx.RawArray("b", nbytes)

    def __getstate__(self):
        # numpy views over shared memory don't pickle; each process
        # rebuilds its own cache lazily over the (picklable) RawArrays
        state = self.__dict__.copy()
        state["_view_cache"] = {}
        return state

    def view(self, agent: str) -> np.ndarray:
        """Writable ``[num_envs, *shape]`` view of the agent's plane
        (cached per process — this is the hot obs path)."""
        cached = self._view_cache.get(agent)
        if cached is not None:
            return cached
        slot = self.spec.slots[agent]
        arr = np.frombuffer(self._raw[agent], dtype=slot.dtype).reshape(
            (self.spec.num_envs,) + slot.shape
        )
        self._view_cache[agent] = arr
        return arr

    def views(self) -> Dict[str, np.ndarray]:
        return {agent: self.view(agent) for agent in self.spec.slots}

    def write_env(self, env_index: int, obs: Mapping[str, np.ndarray]) -> None:
        """Write one env's per-agent observations (worker side)."""
        for agent, value in obs.items():
            slot = self.spec.slots[agent]
            self.view(agent)[env_index] = np.asarray(value, dtype=slot.dtype).reshape(
                slot.shape
            )

    def zero_env(self, env_index: int, agent: str) -> None:
        self.view(agent)[env_index] = 0

    def read_batch(self, copy: bool = True) -> Dict[str, np.ndarray]:
        """Per-agent ``[num_envs, ...]`` batches; ``copy=False`` returns the
        live shared views (valid until the next ``step``)."""
        out = self.views()
        if copy:
            out = {k: v.copy() for k, v in out.items()}
        return out
