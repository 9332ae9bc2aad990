"""Segment flash attention, forward and backward, through
``csrc/segment_attention.cu``.

Replaces the three TPU kernels behind ``scalerl_tpu/ops/pallas_attention.py
::segment_flash_attention`` (``_seg_fwd_kernel``, ``_seg_bwd_dq_kernel``,
``_seg_bwd_dkv_kernel``), with its contract: causal self-attention within
the packed segments of each row, exact zeros where a query has no live key.
All three kernels share one design: a block of 4 warps owns 16 rows of one
(batch row, head) -- queries in the forward and dq, keys in dk/dv -- and
the other axis streams through a ring of 64-row tiles filled by
asynchronous copies (tiles whose segment ids cannot meet the block's are
never loaded); each lane computes 4 x 2 micro-tiles of the products in
exact float32, and the warps' partials combine in warp order.  At the
learner's rows of 512 the kernels are bound by float32 operations (the
source says more).  No kernel uses atomics, so values and gradients repeat
bit for bit.  Every kernel takes head dims up to :data:`MAX_HEAD_DIM`; a
call past it is refused, naming the kernel.

:func:`segment_flash_attention` is differentiable in q, k and v (a
``torch.autograd.Function``; the ids and the scale get no gradient).  For
host tensors it runs the plain version
(``ops/attention.py::segment_attention_reference``) and its autograd
gradients; for CUDA tensors it launches the kernels or raises.  q, k and v
may be strided views with a unit stride along ``D`` (the slices of a fused
qkv projection): the kernels read them through their strides.  The incoming
gradient is made contiguous first (a no-op for the gradient a reshape hands
over).  ``fwd_launches``, ``dq_launches`` and ``dkv_launches`` count kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from scalerl_torch.ops.attention import segment_attention_reference
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (plain counts; callers zero them).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

# Head dims each kernel builds (csrc/segment_attention.cu): all three at 32,
# 64 and 128.  MAX_HEAD_DIM is what all three take, the limit of a
# differentiable call.
MAX_FWD_HEAD_DIM = 128
MAX_DQ_HEAD_DIM = 128
MAX_DKV_HEAD_DIM = 128
MAX_HEAD_DIM = min(MAX_FWD_HEAD_DIM, MAX_DQ_HEAD_DIM, MAX_DKV_HEAD_DIM)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_ptr = ctypes.c_void_p
_Strides = ctypes.c_longlong * 9


def _lib():
    lib = cuda_build.load("segment_attention")
    if lib.segment_attention_fwd_launch.argtypes is None:
        shape = [_c_int, _c_int, _c_int, _c_int, ctypes.POINTER(ctypes.c_longlong), _c_float,
                 _c_int, _c_ptr]
        lib.segment_attention_fwd_launch.argtypes = [_c_ptr] * 6 + shape
        lib.segment_attention_bwd_dq_launch.argtypes = [_c_ptr] * 9 + shape
        lib.segment_attention_bwd_dkv_launch.argtypes = [_c_ptr] * 9 + shape
        for fn in (lib.segment_attention_fwd_launch, lib.segment_attention_bwd_dq_launch,
                   lib.segment_attention_bwd_dkv_launch):
            fn.restype = _c_int
    return lib


def check_segment_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         segment_ids: torch.Tensor) -> None:
    """Shapes, types and devices both paths require; a host/card mix is
    refused, never copied across."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if segment_ids.shape != q.shape[:2]:
        raise ValueError(f"segment_ids must be [B, T] = {tuple(q.shape[:2])}, got "
                         f"{tuple(segment_ids.shape)}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"segment_ids must be an integer tensor, got {segment_ids.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v), ("segment_ids", segment_ids)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels can address it: unit stride along D (a copy
    only when the caller's view has another)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return _Strides(*(s for t in (q, k, v) for s in t.stride()[:3]))


def _launch(fn: Callable, pointers, q: torch.Tensor, strides, scale: float) -> None:
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        err = fn(*pointers, B, S, H, D, strides, float(scale), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment attention kernel launch failed: cudaError {err}")


def _check_cuda(q: torch.Tensor, kernel: str, max_head_dim: int) -> None:
    D = q.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"no segment attention kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must be float32 or bfloat16 on the card, got {q.dtype}")
    if D > max_head_dim:
        raise ValueError(f"head_dim {D} > {max_head_dim}, the {kernel} kernel's limit")


def segment_forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: ``(o [B, T, H, D] in q's dtype,
    lse [B, H, T] float32)``.  ``seg`` is contiguous int32."""
    global fwd_launches
    _check_cuda(q, "segment forward", MAX_FWD_HEAD_DIM)
    B, S, H, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    _launch(_lib().segment_attention_fwd_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(),
             lse.data_ptr()), q, _strides(q, k, v), scale)
    fwd_launches += 1
    return o, lse


def segment_dq_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, d_o: torch.Tensor,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel on CUDA tensors: ``(dq [B, T, H, D] in q's dtype, delta
    [B, H, T] float32)`` with ``delta = sum_d do * o``, which the dk/dv
    kernel reads.  ``d_o`` is contiguous, in q's dtype."""
    global dq_launches
    _check_cuda(q, "segment dq", MAX_DQ_HEAD_DIM)
    B, S, H, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, delta
    _launch(_lib().segment_attention_bwd_dq_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(),
             d_o.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr()),
            q, _strides(q, k, v), scale)
    dq_launches += 1
    return dq, delta


def segment_dkv_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                       lse: torch.Tensor, delta: torch.Tensor, d_o: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on CUDA tensors: ``(dk, dv)``, contiguous, in q's
    dtype.  ``delta`` comes from :func:`segment_dq_kernel`."""
    global dkv_launches
    _check_cuda(q, "segment dk/dv", MAX_DKV_HEAD_DIM)
    B, S, H, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if q.numel() == 0:
        return dk, dv
    _launch(_lib().segment_attention_bwd_dkv_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), d_o.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, _strides(q, k, v), scale)
    dkv_launches += 1
    return dk, dv


def segment_backward_kernels(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, d_o: torch.Tensor,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq kernel, then the dk/dv kernel that reads its ``delta``:
    ``(dq, dk, dv)``."""
    d_o = d_o.to(q.dtype).contiguous()
    dq, delta = segment_dq_kernel(q, k, v, seg, o, lse, d_o, scale)
    dk, dv = segment_dkv_kernel(q, k, v, seg, lse, delta, d_o, scale)
    return dq, dk, dv


class _SegmentFlash(torch.autograd.Function):
    """Saves q, k, v, the ids, o and lse; backward returns dq, dk, dv and
    ``None`` for the ids and the scale.  Host tensors take the plain
    version both ways (lse is then unused and empty)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale):
        if q.device.type == "cpu":
            o = segment_attention_reference(q, k, v, seg, scale)
            lse = q.new_empty(0, dtype=torch.float32)
        else:
            o, lse = segment_forward_kernel(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, d_o):
        q, k, v, seg, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = segment_attention_reference(*leaves, seg, ctx.scale)
                dq, dk, dv = torch.autograd.grad(out, leaves, d_o)
        else:
            dq, dk, dv = segment_backward_kernels(q, k, v, seg, o, lse, d_o, ctx.scale)
        return dq, dk, dv, None, None


def segment_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            segment_ids: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Segment-packed causal self-attention, forward and backward: q, k, v
    ``[B, T, H, D]``, ``segment_ids`` ``[B, T]`` integer (contiguous
    ascending ids from 1, 0 = pad) -> ``[B, T, H, D]`` in q's dtype.  Token
    ``i`` attends ``j <= i`` iff ``segment_ids[i] == segment_ids[j] != 0``;
    a query with no live key gives exact zeros."""
    check_segment_inputs(q, k, v, segment_ids)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.device.type == "cuda" and needs_grad and q.shape[-1] > MAX_DQ_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_DQ_HEAD_DIM}, the segment dq kernel's "
                         f"limit: no gradient past it")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    seg = segment_ids.to(torch.int32).contiguous()
    return _SegmentFlash.apply(q, k, v, seg, float(scale))


SEGMENT_ATTN_IMPLS = ("auto", "pallas", "xla")


def make_segment_attn_fn(impl: str = "auto") -> Optional[Callable]:
    """The ``TransformerPolicy.segment_attn_fn`` seam, by the JAX package's
    names: ``"pallas"`` and ``"auto"`` -> the hand kernels' wrapper
    (:func:`segment_flash_attention`), ``"xla"`` -> ``None``, and the model
    then builds the dense packed mask."""
    if impl not in SEGMENT_ATTN_IMPLS:
        raise ValueError(f"segment attention impl must be auto | pallas | xla, got {impl!r}")
    return None if impl == "xla" else segment_flash_attention
