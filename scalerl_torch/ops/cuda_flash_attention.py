"""Flash attention, forward and backward, through ``csrc/flash_attention.cu``.

Replaces the three TPU kernels behind ``scalerl_tpu/ops/pallas_attention.py
::flash_attention`` (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``), with its contract: q ``[B, Tq, H, D]`` against k, v
``[B, Tk, H, D]``, ``Tq != Tk`` allowed, causal masking top-left aligned,
lse in float32.  Each kernel owns rows of one axis (queries in the forward
and dq kernels, keys in the dk/dv kernel) and walks the other in
shared-memory tiles, skipping the tiles above the causal diagonal: on
bfloat16 all three run on the tensor cores; in float32 all three run
register-blocked micro-tiles on the FMA units; the source says what
bounds them.
No kernel uses atomics, so values and gradients repeat bit for bit.

:func:`flash_attention` is differentiable in q, k and v (a
``torch.autograd.Function``; the flags get no gradient).  For host tensors
it runs the plain version (``ops/attention.py::flash_attention_reference``)
and its autograd gradients; for CUDA tensors it launches the kernels or
raises.  q, k and v may be strided views with a unit stride along ``D``
(the slices of a fused qkv projection): the kernels read them through their
strides.  The incoming gradient is made contiguous first.  ``fwd_launches``,
``dq_launches`` and ``dkv_launches`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from scalerl_torch.ops.attention import flash_attention_reference
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (plain counts; callers zero them).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

MAX_HEAD_DIM = 128  # csrc/flash_attention.cu instantiates D <= 8, 16, 32, 64, 128
MAX_GRID_YZ = 65535  # heads ride gridDim.y, batch rows gridDim.z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_ptr = ctypes.c_void_p
_Strides = ctypes.c_longlong * 9


def _lib():
    lib = cuda_build.load("flash_attention")
    if lib.flash_attention_fwd_launch.argtypes is None:
        shape = [_c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong), _c_float, _c_int, _c_int,
                                _c_ptr]
        lib.flash_attention_fwd_launch.argtypes = [_c_ptr] * 5 + shape
        lib.flash_attention_bwd_dq_launch.argtypes = [_c_ptr] * 8 + shape
        lib.flash_attention_bwd_dkv_launch.argtypes = [_c_ptr] * 8 + shape
        for fn in (lib.flash_attention_fwd_launch, lib.flash_attention_bwd_dq_launch,
                   lib.flash_attention_bwd_dkv_launch):
            fn.restype = _c_int
    return lib


def check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What both paths require: q ``[B, Tq, H, D]``, k and v ``[B, Tk, H,
    D]``, no empty axis, ``D <= 128``, one dtype (float32 or bfloat16) and
    one device for all three; a host/card mix is refused, never copied
    across."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Tq, H, D] and k, v one [B, Tk, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q and k must share B, H and D, got {tuple(q.shape)}, {tuple(k.shape)}")
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError(f"empty axis in q {tuple(q.shape)} or k {tuple(k.shape)}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM}, the kernels' limit")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels can address it: unit stride along D (a copy
    only when the caller's view has another)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return _Strides(*(s for t in (q, k, v) for s in t.stride()[:3]))


def _launch(fn: Callable, pointers, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, causal: bool) -> None:
    B, Tq, H, D = q.shape
    with torch.cuda.device(q.device):
        err = fn(*pointers, B, Tq, k.shape[1], H, D, _strides(q, k, v), float(scale),
                 int(causal), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")


def _check_cuda(q: torch.Tensor) -> None:
    B, _, H, _ = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"heads {H} and rows {B} must each be <= {MAX_GRID_YZ}")


def flash_forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: ``(o [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] float32)``."""
    global fwd_launches
    _check_cuda(q)
    B, Tq, H, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch(_lib().flash_attention_fwd_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()),
            q, k, v, scale, causal)
    fwd_launches += 1
    return o, lse


def flash_dq_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, d_o: torch.Tensor, scale: float,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel on CUDA tensors: ``(dq [B, Tq, H, D] in q's dtype,
    delta [B, H, Tq] float32)`` with ``delta = sum_d do * o``, which the
    dk/dv kernel reads.  ``d_o`` is contiguous, in q's dtype."""
    global dq_launches
    _check_cuda(q)
    B, Tq, H, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch(_lib().flash_attention_bwd_dq_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), d_o.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), delta.data_ptr()),
            q, k, v, scale, causal)
    dq_launches += 1
    return dq, delta


def flash_dkv_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, d_o: torch.Tensor, scale: float,
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on CUDA tensors: ``(dk, dv)`` ``[B, Tk, H, D]``,
    contiguous, in q's dtype.  ``delta`` comes from :func:`flash_dq_kernel`."""
    global dkv_launches
    _check_cuda(q)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch(_lib().flash_attention_bwd_dkv_launch,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, v, scale, causal)
    dkv_launches += 1
    return dk, dv


def flash_backward_kernels(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, d_o: torch.Tensor, scale: float,
                           causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dq kernel, then the dk/dv kernel that reads its ``delta``:
    ``(dq, dk, dv)``."""
    d_o = d_o.to(q.dtype).contiguous()
    dq, delta = flash_dq_kernel(q, k, v, o, lse, d_o, scale, causal)
    dk, dv = flash_dkv_kernel(q, k, v, lse, delta, d_o, scale, causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Saves q, k, v, o and lse; backward returns dq, dk, dv and ``None``
    for the flags.  Host tensors take the plain version both ways."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal, scale)
        else:
            o, lse = flash_forward_kernel(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out, _ = flash_attention_reference(*leaves, ctx.causal, ctx.scale)
                dq, dk, dv = torch.autograd.grad(out, leaves, d_o)
        else:
            dq, dk, dv = flash_backward_kernels(q, k, v, o, lse, d_o, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention, forward and backward: q ``[B, Tq, H, D]`` against
    k, v ``[B, Tk, H, D]`` -> ``[B, Tq, H, D]`` in q's dtype.  ``scale``
    defaults to ``1/sqrt(D)``; ``causal`` lets query ``i`` see key ``j``
    iff ``j <= i``.  The JAX function's ``block_q``, ``block_k`` and
    ``interpret`` are TPU tiling and have no counterpart."""
    check_flash_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Flash.apply(q, k, v, bool(causal), float(scale))
