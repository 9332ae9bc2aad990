"""Plain single-device attention over ``[B, T, H, D]``.

:func:`full_attention` is the counterpart of ``scalerl_tpu/ops/
ring_attention.py::full_attention``, the default attention of
``TransformerPolicy``'s full forward.  :func:`segment_attention_reference`
is the counterpart of ``scalerl_tpu/ops/pallas_attention.py::
segment_attention_reference``: the plain version of the segment flash
kernels of ``ops/cuda_segment_attention.py``, values and (through autograd)
gradients.  :func:`flash_attention_reference` is the plain version of the
flash kernels of ``ops/cuda_flash_attention.py``, with the contract of
``scalerl_tpu/ops/pallas_attention.py::flash_attention``.  Scores and the
softmax run in float32; the output comes back in q's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention, q ``[B, Tq, H, D]`` against k/v ``[B, Tk, H, D]``,
    scaled by ``1/sqrt(D)``; ``causal`` masks key ``j > i`` with ``-inf``
    (Tq == Tk)."""
    T = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        visible = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def segment_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                segment_ids: torch.Tensor,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention within packed segments, dense: q, k, v
    ``[B, T, H, D]``, ``segment_ids`` ``[B, T]`` (0 = pad).  Token ``i``
    attends ``j <= i`` iff ``segment_ids[i] == segment_ids[j] != 0``; a
    query with no live key (pad) gives exact zeros, not a uniform average.
    Materialises the ``[T, T]`` scores."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    seg = segment_ids.to(torch.int32)
    T = q.shape[1]
    ar = torch.arange(T, device=q.device)
    causal = ar[None, :, None] >= ar[None, None, :]
    mask = causal & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)  # [B, T, T]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None, :, None], probs, 0.0)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention with the flash kernels' contract, dense: q ``[B, Tq,
    H, D]`` against k, v ``[B, Tk, H, D]`` -> ``(o [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] float32)``.  q is multiplied by ``scale`` (default
    ``1/sqrt(D)``) before the product; with ``causal`` key ``j`` is visible
    to query ``i`` iff ``j <= i``, top-left aligned also when ``Tq != Tk``.
    A query with no visible key gives ``o = 0`` and ``lse = -inf``, and no
    NaN in its gradients.  Materialises the ``[Tq, Tk]`` scores."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        visible = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).detach()  # softmax is invariant to it
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp(min=1e-30), v.float()).to(q.dtype)
    live = l > 0
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), float("-inf"))
    return o, lse[..., 0]
