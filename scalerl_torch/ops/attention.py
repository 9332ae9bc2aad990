"""Plain single-device attention over ``[B, T, H, D]``.

Counterpart of ``scalerl_tpu/ops/ring_attention.py::full_attention``, the
default attention of ``TransformerPolicy``'s full forward.  Scores and the
softmax run in float32; the output comes back in q's dtype.
"""

from __future__ import annotations

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
