"""Paged decode attention through ``csrc/paged_attention.cu``.

Replaces the TPU kernel ``scalerl_tpu/ops/pallas_paged_attention.py::
paged_decode_attention`` (``_decode_kernel``), with its signature.  The
kernel splits each lane's context across blocks of :data:`SPLIT_TOKENS`
tokens, one block per (lane, head group, split), streams each split's
pages through shared memory with asynchronous copies, and keeps an online
softmax per head; the last split of a lane to finish combines the splits'
partials in split order, in the same launch.  It is bound by bytes (each
live token's K and V read once; the source says more).

:func:`paged_decode_attention` runs the plain version
(``ops/paged_attention.py::paged_attention_reference``) for host tensors;
for CUDA tensors it launches the kernel or raises.  It refuses inputs
that require grad: decode is inference-only, as the TPU kernel (which has
no vjp) is.  The partials go to a float32 scratch buffer allocated per
call; the arrival counters are one zeroed int32 buffer per (device,
stream), which the kernel leaves zeroed, so launches on one stream share
it in order (make the first call on a stream before capturing it in a CUDA
graph).  ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from scalerl_torch.ops.paged_attention import check_paged_inputs, paged_attention_reference
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (a plain count; callers zero it).
launches = 0

MAX_HEAD_DIM = 128  # csrc/paged_attention.cu instantiates D <= 16, 32, 64, 128
SPLIT_TOKENS = 64  # tokens of a lane's context per block (the source's kSplit)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_ptr = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_ptr,
        ]
        lib.paged_attention_launch.restype = _c_int
    return lib


# (device index, stream handle) -> int32 arrival counters, zero between launches
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def num_splits(max_tokens: int) -> int:
    """Blocks a lane's context of up to ``max_tokens`` (M * ps) is split
    across."""
    return -(-max_tokens // SPLIT_TOKENS)


def scratch_floats(B: int, H: int, D: int, max_tokens: int) -> int:
    """float32 elements of the per-call scratch: (m, l, acc[D]) per (lane,
    head, split)."""
    return B * H * num_splits(max_tokens) * (D + 2)


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged attention: call the kernel once on this stream before "
                               "capturing it, so its arrival counters exist outside the graph")
        counters = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


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
        stream = torch.cuda.current_stream(device).cuda_stream
        scratch = torch.empty(scratch_floats(B, H, D, M * ps), dtype=torch.float32, device=device)
        counters = _arrival_counters(device, stream, B * H)
        err = _lib().paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
            SPLIT_TOKENS, B, H, D, N, ps, M, float(scale), _DTYPES[q.dtype], stream,
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
