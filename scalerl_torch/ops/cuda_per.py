"""Prioritized-replay sampling and priority update through ``csrc/per.cu``.

Replaces the two TPU kernels of ``scalerl_tpu/ops/pallas_per.py``:

- :func:`within_block_kernel` replaces ``pallas_sample``'s
  ``_within_block_kernel``: one CTA per sample scans the 1024-wide block
  that phase 1 chose and counts the running sums below the residual
  target.  :func:`sample_kernel` is ``pallas_sample``: phase 1 in plain
  PyTorch (``ops/per.py::split_targets``), then the kernel.
- :func:`update_kernel` replaces ``_pallas_update``: an in-place,
  ascending-order last-wins scatter of M priorities, one CTA per distinct
  block, with an optional refresh of the touched blocks' sums.

What bounds them on an H100: bytes, and at the replay path's sizes
(S = M = 512) mostly launch latency.  The sample kernel reads one 4 KiB
block per sample (~2.1 MB at S = 512); the update kernel writes M
priorities and, with sums, reads each touched block once.

The wrappers take the plain version (``ops/per.py``) for a host tensor; a
CUDA tensor launches the kernel or raises.  ``sample_launches`` and
``update_launches`` count kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalerl_torch.ops import per
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (plain counts; callers zero them).
sample_launches = 0
update_launches = 0

# The kernels' limits (csrc/per.cu: kMaxItems * kThreads, kMaxBlock).
MAX_BLOCK_SIZE = 4096

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("per")
    if lib.per_sample_launch.argtypes is None:
        lib.per_sample_launch.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_int,
                                          _c_ptr, _c_ptr]
        lib.per_sample_launch.restype = _c_int
        lib.per_update_launch.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll,
                                          _c_int, _c_ptr]
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


def within_block_kernel(
    flat_p: torch.Tensor, b_idx: torch.Tensor, within_t: torch.Tensor, block_size: int = 1024
) -> torch.Tensor:
    """Phase 2 of the two-level search (``ops/per.py::within_block_sample``'s
    contract): ``b_idx`` [S] int64 blocks, ``within_t`` [S] float32 residual
    targets -> [S] int64 flat indices."""
    global sample_launches
    _check_plane(flat_p)
    _check_block_size(block_size)
    b_idx = b_idx.to(torch.int64).contiguous()
    within_t = within_t.to(torch.float32).contiguous()
    if b_idx.dim() != 1 or within_t.shape != b_idx.shape:
        raise ValueError(f"b_idx and within_t must be [S], got {tuple(b_idx.shape)}, "
                         f"{tuple(within_t.shape)}")
    for name, x in (("b_idx", b_idx), ("within_t", within_t)):
        if x.device != flat_p.device:
            raise ValueError(f"{name} is on {x.device}, flat_p on {flat_p.device}")
    device = flat_p.device
    if device.type == "cpu":
        return per.within_block_sample(flat_p, b_idx, within_t, block_size)
    if device.type != "cuda":
        raise ValueError(f"no PER sample kernel for device {device}")
    S = b_idx.shape[0]
    out = torch.empty(S, dtype=torch.int64, device=device)
    if S == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().per_sample_launch(
            flat_p.data_ptr(), b_idx.data_ptr(), within_t.data_ptr(), flat_p.shape[0],
            block_size, S, out.data_ptr(), _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"PER sample kernel launch failed: cudaError {err}")
    sample_launches += 1
    return out


def sample_kernel(
    flat_p: torch.Tensor, targets: torch.Tensor, block_size: int = 1024
) -> torch.Tensor:
    """``pallas_sample``: phase 1 in plain PyTorch, phase 2 in the kernel
    (on a host tensor, both plain: ``ops/per.py::hierarchical_sample``)."""
    _check_plane(flat_p)
    b_idx, within_t = per.split_targets(flat_p, targets, block_size)
    return within_block_kernel(flat_p, b_idx, within_t, block_size)


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
    (``ops/per.py::update_priorities_plain``'s contract)."""
    global update_launches
    _check_plane(flat_p)
    _check_block_size(block_size)
    idx = idx.to(torch.int64).contiguous()
    new_p = new_p.to(torch.float32).contiguous()
    per.check_update_inputs(flat_p, idx, new_p, block_sums, block_size)
    device = flat_p.device
    if device.type == "cpu":
        per.update_priorities_plain(flat_p, idx, new_p, block_sums, block_size)
        return
    if device.type != "cuda":
        raise ValueError(f"no PER update kernel for device {device}")
    M = idx.shape[0]
    if M == 0:
        return
    with torch.cuda.device(device):
        err = _lib().per_update_launch(
            flat_p.data_ptr(), None if block_sums is None else block_sums.data_ptr(),
            idx.data_ptr(), new_p.data_ptr(), M, flat_p.shape[0], block_size,
            _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"PER update kernel launch failed: cudaError {err}")
    update_launches += 1
