"""Prioritized SEQUENCE replay: whole sequences (or packed rows) as units.

Port of ``scalerl_tpu/data/sequence_replay.py``.  The buffer stores
fixed-shape units with one priority each, all in device tensors: inserts
are ring writes at the cursor, sampling is the proportional two-level
search of transition PER (``ops/per.py``; ``method="pallas"`` is the CUDA
sample kernel of ``ops/cuda_per.py``), priority updates are scatter writes.

What differs from the JAX module:

- :func:`seq_add` and the priority updates write the state's tensors IN
  PLACE and return a state that shares them (the JAX functions donate the
  old state and return new arrays).
- ``pos`` and ``size`` are Python ints: every insert size is known on the
  host, so the cursors never need a device read.
- :func:`seq_sample` draws its stratification uniforms from a
  ``torch.Generator`` on the buffer's device (``jax.random`` gives other
  numbers from the same seed); ``u`` injects them instead.
- ``core`` (per-layer recurrent state for R2D2) is carried as in the JAX
  module; the sequence-RL trainer passes an empty one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from scalerl_torch.ops.per import proportional_sample, update_priorities_blocks
from scalerl_torch.utils.platform import DeviceLike, resolve_device

Core = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@dataclass
class SequenceReplayState:
    storage: Dict[str, torch.Tensor]  # field -> [capacity, ...]
    core: Core  # per-layer (c, h): [capacity, core_dim]
    priorities: torch.Tensor  # [capacity] float32, 0 = empty slot
    pos: int  # next write cursor
    size: int  # filled count


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def seq_init(
    field_shapes: Mapping[str, Tuple[Tuple[int, ...], Any]],
    core_shapes: Sequence[Tuple[int, ...]],
    capacity: int,
    device: DeviceLike = "cuda",
) -> SequenceReplayState:
    """``field_shapes``: name -> (per-unit shape, numpy or torch dtype);
    ``core_shapes``: per-LSTM-layer ``(core_dim,)`` shapes (c and h alike)."""
    device = resolve_device(device)
    storage = {
        name: torch.zeros((capacity,) + tuple(shape), dtype=_torch_dtype(dtype), device=device)
        for name, (shape, dtype) in field_shapes.items()
    }
    core = tuple(
        (torch.zeros((capacity,) + tuple(s), device=device),
         torch.zeros((capacity,) + tuple(s), device=device))
        for s in core_shapes
    )
    return SequenceReplayState(
        storage=storage, core=core,
        priorities=torch.zeros(capacity, dtype=torch.float32, device=device), pos=0, size=0,
    )


def _ring_write(dst: torch.Tensor, src: Any, pos: int) -> None:
    """``dst[(pos + arange(B)) % capacity] = src`` as at most two slice
    copies (the ring wraps at most once: B <= capacity)."""
    src = torch.as_tensor(src).to(device=dst.device, dtype=dst.dtype)
    head = min(src.shape[0], dst.shape[0] - pos)
    dst[pos:pos + head].copy_(src[:head])
    if head < src.shape[0]:
        dst[:src.shape[0] - head].copy_(src[head:])


def seq_add(
    state: SequenceReplayState,
    batch: Mapping[str, Any],  # field -> [B, ...]
    core: Sequence[Tuple[Any, Any]],  # per-layer (c [B, dim], h [B, dim])
    priorities: Any,  # [B]
) -> SequenceReplayState:
    """Insert B units at the ring cursor (wrapping), in place.  ``B`` may not
    exceed the capacity: slots written twice in one insert would have no
    defined winner."""
    capacity = state.priorities.shape[0]
    B = int(np.shape(priorities)[0])
    if B > capacity:
        raise ValueError(f"insert of {B} units exceeds the replay capacity {capacity}")
    for name, arr in state.storage.items():
        _ring_write(arr, batch[name], state.pos)
    for (c, h), (bc, bh) in zip(state.core, core):
        _ring_write(c, bc, state.pos)
        _ring_write(h, bh, state.pos)
    _ring_write(state.priorities, priorities, state.pos)
    return dataclasses.replace(state, pos=(state.pos + B) % capacity,
                               size=min(state.size + B, capacity))


def seq_sample(
    state: SequenceReplayState,
    generator: Optional[torch.Generator],
    batch_size: int,
    alpha: float = 0.6,
    beta: float = 0.4,
    method: str = "hierarchical",
    u: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], Core, torch.Tensor, torch.Tensor]:
    """Proportional sample of ``batch_size`` units, stratified over the live
    mass: ``(fields [B, ...], core, indices [B] int64, importance weights
    [B] normalised by their max)``.  Empty slots have priority 0 and
    ``0**alpha = 0``, so they are never drawn.

    ``method``: ``ops/per.py``'s (``"pallas"`` = the CUDA sample kernel;
    on host tensors its plain version).  ``u``: ``[B]`` uniforms in
    ``[0, 1)`` to use instead of drawing from ``generator``."""
    device = state.priorities.device
    scaled = torch.pow(state.priorities, alpha)
    total = scaled.sum()
    if u is None:
        u = torch.rand(batch_size, generator=generator, device=device)
    targets = (torch.arange(batch_size, device=device) + u) / batch_size * total
    idx = proportional_sample(scaled, targets, method=method)

    probs = scaled[idx] / total.clamp(min=1e-9)
    n = max(float(state.size), 1.0)
    weights = torch.pow(n * probs.clamp(min=1e-9), -beta)
    weights = weights / weights.max().clamp(min=1e-9)

    fields = {name: arr[idx] for name, arr in state.storage.items()}
    core = tuple((c[idx], h[idx]) for c, h in state.core)
    return fields, core, idx, weights


def seq_update_priorities(
    state: SequenceReplayState, idx: torch.Tensor, priorities: torch.Tensor
) -> SequenceReplayState:
    """``priorities[idx] = max(priorities, 1e-6)`` in place; duplicate
    indices resolve last-wins in ascending order."""
    update_priorities_blocks(state.priorities, idx, priorities.clamp(min=1e-6))
    return state


def seq_update_priorities_keep_empty(
    state: SequenceReplayState, idx: torch.Tensor, priorities: torch.Tensor
) -> SequenceReplayState:
    """Priority write-back that cannot resurrect empty slots: a slot whose
    priority is 0 (never written, or a pad row) keeps 0 instead of being
    floored at 1e-6 into the sampling distribution."""
    live = state.priorities[idx] > 0
    eff = torch.where(live, priorities.clamp(min=1e-6), 0.0)
    update_priorities_blocks(state.priorities, idx, eff)
    return state


def seq_export(state: SequenceReplayState) -> Dict[str, Any]:
    """The buffer's full occupancy as a host-numpy tree (storage, core,
    priorities, both cursors as plain ints); round-trips bit-exact through
    :func:`seq_import`."""
    return {
        "storage": {k: v.cpu().numpy() for k, v in state.storage.items()},
        "core": tuple((c.cpu().numpy(), h.cpu().numpy()) for c, h in state.core),
        "priorities": state.priorities.cpu().numpy(),
        "pos": int(state.pos),
        "size": int(state.size),
    }


def seq_import(host: Mapping[str, Any], device: DeviceLike = "cuda") -> SequenceReplayState:
    """Inverse of :func:`seq_export`: rebuild the device-resident state."""
    device = resolve_device(device)

    def up(x):
        return torch.tensor(np.asarray(x), device=device)

    return SequenceReplayState(
        storage={k: up(v) for k, v in host["storage"].items()},
        core=tuple((up(c), up(h)) for c, h in host["core"]),
        priorities=up(host["priorities"]),
        pos=int(host["pos"]),
        size=int(host["size"]),
    )
