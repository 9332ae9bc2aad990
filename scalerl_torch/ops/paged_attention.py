"""Paged decode attention, plain PyTorch: the kernel's reference.

One query token per lane attends to its context in a block-paged K/V pool
``[N, page_size, H, D]`` through a page table ``[B, M]`` and true lengths
``[B]``.  Port of the XLA gather of
``scalerl_tpu/ops/pallas_paged_attention.py::paged_attention_reference``:
materialise each lane's pages through one flat row gather, mask positions
``>= lengths`` with -1e30 (not -inf, like the model's masked attention),
softmax in float32, return in q's dtype.

:func:`paged_attention_reference` is the plain version that
``ops/cuda_paged_attention.py`` runs for host tensors and that
``chip_smoke.py`` holds the CUDA kernel against.  It is grad-free in use
(the kernel's wrapper refuses inputs that require grad).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_BIG = -1e30


def check_paged_inputs(q, k_pages, v_pages, page_table, lengths) -> None:
    """Shapes of the contract: q ``[B, 1, H, D]``, pools ``[N, ps, H, D]``
    (the same shape), table ``[B, M]`` and lengths ``[B]`` integer."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D] (one query token), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape[2:] != (H, D):
        raise ValueError(f"k_pages must be [N, page_size, {H}, {D}], got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} != k_pages {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [{B}, M], got {tuple(page_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name} must be int32 or int64, got {t.dtype}")


def paged_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q ``[B, 1, H, D]`` through ``page_table`` ``[B, M]`` into the pools
    ``[N, ps, H, D]``, positions ``>= lengths[b]`` masked -> ``[B, 1, H,
    D]``.  Table entries are clamped into ``[0, N)`` as JAX clamps a
    gather (junk entries are the null page 0 in practice)."""
    check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    B = q.shape[0]
    N, ps = k_pages.shape[0], k_pages.shape[1]
    M = page_table.shape[1]
    pages = page_table.long().clamp(0, N - 1)
    slots = torch.arange(ps, device=q.device)
    idx = (pages[:, :, None] * ps + slots[None, None, :]).reshape(B, M * ps)
    k = k_pages.reshape(N * ps, *k_pages.shape[2:])[idx]  # [B, S, H, D]
    v = v_pages.reshape(N * ps, *v_pages.shape[2:])[idx]
    qf = q[:, 0].float()  # [B, H, D]
    scores = torch.einsum("bhd,bshd->bhs", qf, k.float()) * scale
    valid = torch.arange(M * ps, device=q.device)[None, :] < lengths[:, None]  # [B, S]
    scores = scores.masked_fill(~valid[:, None, :], NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out[:, None].to(q.dtype)
