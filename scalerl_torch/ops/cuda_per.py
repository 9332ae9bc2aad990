"""Prioritized-replay sampling and priority update through ``csrc/per.cu``.

Replaces the two TPU kernels of ``scalerl_tpu/ops/pallas_per.py``:

- :func:`sample_kernel` is the whole of ``pallas_sample``, both phases, in
  two kernel launches with no PyTorch op between them: one warp a block
  sums the plane's blocks into a scratch; then one warp a sample scans the
  block sums, binary-searches its target, and scans its chosen block in
  registers, counting the running sums below the residual target.  It sums
  and scans in its own order, which ``ops/per.py::kernel_order_sample``
  repeats in plain PyTorch.
- :func:`update_kernel` replaces ``_pallas_update``: an in-place,
  ascending-order last-wins scatter of M priorities through a last-writer
  table that every CTA builds in shared memory, with an optional refresh of
  the touched blocks' sums; one launch for up to ``MAX_UPDATES`` updates,
  more in ordered chunks, one launch each.

What bounds them on an H100: bytes, and at the replay path's sizes
(N = 2^20, S = M = 512) launch latency.  The sample reads the plane once
(4 MiB) and 12 bytes a sample; the update moves 12 bytes in and 4 out an
update and, with sums, each touched block once.

The wrappers take the plain versions (``ops/per.py``) for a host tensor; a
CUDA tensor launches the kernels or raises.  ``sample_launches`` counts
calls of the sample on the card (each is two kernel launches) and
``update_launches`` update kernel launches; nothing else counts.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalerl_torch.ops import per
from scalerl_torch.utils import cuda_build

# Sample calls and update kernel launches since the last reset (plain
# counts; callers zero them).
sample_launches = 0
update_launches = 0

# The kernels' limits (csrc/per.cu: kMaxBlock, kMaxUpdates).  The update
# kernel indexes the plane in int32, as the JAX package's update does.
MAX_BLOCK_SIZE = 4096
MAX_UPDATES = 4096
MAX_UPDATE_PLANE = 2**31 - 1

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("per")
    if lib.per_sample_launch.argtypes is None:
        lib.per_sample_launch.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_int, _c_int, _c_ptr, _c_ptr,
                                          _c_ptr]
        lib.per_sample_launch.restype = _c_int
        lib.per_update_launch.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int,
                                          _c_ptr]
        lib.per_update_launch.restype = _c_int
    return lib


def _check_block_size(block_size: int) -> None:
    if not (0 < block_size <= MAX_BLOCK_SIZE):
        raise ValueError(f"block_size must be in [1, {MAX_BLOCK_SIZE}], got {block_size}")


def _check_plane(flat_p: torch.Tensor) -> None:
    if flat_p.dim() != 1 or flat_p.dtype != torch.float32 or not flat_p.is_contiguous():
        raise ValueError("flat_p must be a contiguous 1-D float32 tensor")
    if flat_p.shape[0] < 1:
        raise ValueError("flat_p must hold at least one priority")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sample_kernel(
    flat_p: torch.Tensor, targets: torch.Tensor, block_size: int = 1024
) -> torch.Tensor:
    """``pallas_sample``: ``targets`` [S] points in ``[0, sum(flat_p))`` ->
    [S] int64 flat indices, through the two kernels (on a host tensor, the
    plain ``ops/per.py::hierarchical_sample``)."""
    global sample_launches
    _check_plane(flat_p)
    _check_block_size(block_size)
    targets = targets.to(torch.float32).contiguous()
    if targets.dim() != 1:
        raise ValueError(f"targets must be [S], got {tuple(targets.shape)}")
    if targets.device != flat_p.device:
        raise ValueError(f"targets is on {targets.device}, flat_p on {flat_p.device}")
    device = flat_p.device
    if device.type == "cpu":
        return per.hierarchical_sample(flat_p, targets, block_size)
    if device.type != "cuda":
        raise ValueError(f"no PER sample kernel for device {device}")
    n, S = flat_p.shape[0], targets.shape[0]
    out = torch.empty(S, dtype=torch.int64, device=device)
    if S == 0:
        return out
    sums = torch.empty(per.num_blocks(n, block_size), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().per_sample_launch(
            flat_p.data_ptr(), targets.data_ptr(), n, block_size, S, sums.data_ptr(),
            out.data_ptr(), _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"PER sample kernel launch failed: cudaError {err}")
    sample_launches += 1
    return out


def update_kernel(
    flat_p: torch.Tensor,
    idx: torch.Tensor,
    new_p: torch.Tensor,
    block_sums: Optional[torch.Tensor] = None,
    block_size: int = 1024,
) -> None:
    """Scatter ``new_p`` [M] into ``flat_p`` at ``idx`` [M] (clipped to
    ``[0, n-1]``), last-wins in ascending order, IN PLACE; refresh the
    touched blocks' entries of ``block_sums`` [nb] in place when given
    (``ops/per.py::update_priorities_plain``'s contract).  On the card the
    updates go in ordered chunks of ``MAX_UPDATES``, one launch each on the
    current stream, so a later chunk sees an earlier one's writes."""
    global update_launches
    _check_plane(flat_p)
    _check_block_size(block_size)
    idx = idx.to(torch.int64).contiguous()
    new_p = new_p.to(torch.float32).contiguous()
    per.check_update_inputs(flat_p, idx, new_p, block_sums, block_size)
    device = flat_p.device
    n = flat_p.shape[0]
    if device.type == "cuda" and n > MAX_UPDATE_PLANE:
        raise ValueError(f"the PER update kernel indexes the plane in int32: n = {n} > "
                         f"{MAX_UPDATE_PLANE}")
    if device.type == "cpu":
        per.update_priorities_plain(flat_p, idx, new_p, block_sums, block_size)
        return
    if device.type != "cuda":
        raise ValueError(f"no PER update kernel for device {device}")
    M = idx.shape[0]
    with torch.cuda.device(device):
        lib, stream = _lib(), _stream(device)
        for lo in range(0, M, MAX_UPDATES):  # chunk i at an offset of i * MAX_UPDATES
            err = lib.per_update_launch(
                flat_p.data_ptr(), None if block_sums is None else block_sums.data_ptr(),
                idx.data_ptr() + 8 * lo, new_p.data_ptr() + 4 * lo, min(M - lo, MAX_UPDATES), n,
                block_size, stream,
            )
            if err != 0:
                raise RuntimeError(f"PER update kernel launch failed: cudaError {err}")
            update_launches += 1
