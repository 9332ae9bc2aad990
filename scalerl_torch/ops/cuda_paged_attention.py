"""Paged decode attention through ``csrc/paged_attention.cu``.

Replaces the TPU kernel ``scalerl_tpu/ops/pallas_paged_attention.py::
paged_decode_attention`` (``_decode_kernel``), with its signature.  The
kernel runs one warp per (lane, head), walks the lane's live tokens in
order through its page table and keeps an online softmax in registers;
it is bound by bytes (each live token's K and V read once; the source
says more).

:func:`paged_decode_attention` runs the plain version
(``ops/paged_attention.py::paged_attention_reference``) for host tensors;
for CUDA tensors it launches the kernel or raises.  It refuses inputs
that require grad: decode is inference-only, as the TPU kernel (which has
no vjp) is.  ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalerl_torch.ops.paged_attention import check_paged_inputs, paged_attention_reference
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (a plain count; callers zero it).
launches = 0

MAX_HEAD_DIM = 128  # csrc/paged_attention.cu instantiates D <= 32, 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_ptr = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_ptr,
        ]
        lib.paged_attention_launch.restype = _c_int
    return lib


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q ``[B, 1, H, D]`` against the pools ``[N, ps, H, D]`` through
    ``page_table`` ``[B, M]`` and ``lengths`` ``[B]`` (each >= 1) ->
    ``[B, 1, H, D]`` in q's dtype."""
    global launches
    check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.requires_grad:
            raise RuntimeError(f"paged decode attention is grad-free: {name} requires grad")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not q.dtype == k_pages.dtype == v_pages.dtype:
        raise ValueError(f"q, k_pages and v_pages must share a dtype, got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    device = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("page_table", page_table),
                    ("lengths", lengths)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
    if device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table, lengths, scale)
    if device.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {device}")
    B, _, H, D = q.shape
    N, ps = k_pages.shape[0], k_pages.shape[1]
    M = page_table.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}, the kernel's limit")
    if N * ps * H * D >= 2**62 or B * H >= 2**31:
        raise ValueError("paged attention shapes out of the kernel's index range")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32 on the card")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, D, N, ps, M, float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


PAGED_ATTN_IMPLS = ("auto", "pallas", "xla")


def make_paged_attn_fn(impl: str = "auto"):
    """The ``TransformerPolicy.paged_attn_fn`` seam, by the JAX package's
    names: ``"pallas"`` and ``"auto"`` -> the hand kernel's wrapper
    (:func:`paged_decode_attention`), ``"xla"`` -> the plain version."""
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"paged attention impl must be auto | pallas | xla, got {impl!r}")
    return paged_attention_reference if impl == "xla" else paged_decode_attention
