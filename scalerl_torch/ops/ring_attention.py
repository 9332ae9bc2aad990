"""Ring attention: exact attention over sequence blocks held by the ranks of
a mesh axis.  Port of ``scalerl_tpu/ops/ring_attention.py``.

A rank of the ``sp`` axis holds its ``[B, T/n, H, D]`` block of q, k and v.
It attends its own block first; then, ``n - 1`` times, it passes its current
k/v block one hop round the ring (rank ``i`` to ``i + 1``) and consumes the
block it receives, whose source is rank ``(i - r) mod n`` after ``r`` hops.
A streaming softmax accumulates the exact result in float32, so memory stays
O(T/n) a rank and no rank ever holds the whole k/v.  ``causal`` masks by
global position.  bfloat16 operands stay bfloat16 on the score product, as
in JAX.

Each hop is one message: k and v stacked, ``2 * B * T/n * H * D`` elements.
Its autograd backward sends the cotangent one hop back (``i + 1`` to
``i``), the transpose of JAX's ``ppermute``.  Both directions post the send
and the receive together (``batch_isend_irecv``) and then wait, so a ring
cannot deadlock on blocking sends; the backward hops run in the reverse of
the forward's order on every rank, which pairs them.  At ``n == 1`` there is
no hop and no collective.

The blocks are plain matmuls, as the JAX blocks are plain einsums.
:func:`full_attention` is ``ops/attention.py``'s, re-exported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from scalerl_torch.ops.attention import full_attention

__all__ = ["full_attention", "make_ring_attention_fn", "ring_attention"]


def _exchange(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and return what global rank
    ``recv_from`` sent, both posted before either is waited on."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group), dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    """One hop forward round the ring; the cotangent goes one hop back."""

    @staticmethod
    def forward(ctx, x, nxt: int, prev: int, group):
        ctx.nxt, ctx.prev, ctx.group = nxt, prev, group
        return _exchange(x, nxt, prev, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.prev, ctx.nxt, ctx.group), None, None, None


def _online_block_update(o, l, m, s, v):
    """Streaming softmax accumulation of one k/v block (JAX's function).

    o ``[B, Tq, H, D]`` weighted values, l ``[B, H, Tq]`` normaliser, m
    ``[B, H, Tq]`` running row max (detached: the softmax does not depend
    on it), s ``[B, H, Tq, Tk]`` scaled, masked scores, v ``[B, Tk, H, D]``.
    A row with no visible key so far keeps ``m = -inf``; 0 is subtracted
    there, so ``exp(-inf) = 0`` instead of ``exp(nan)``."""
    m_new = torch.maximum(m, s.detach().amax(dim=-1))
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    corr = torch.exp(m - safe_m)  # m = -inf gives 0
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, l_new, m_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                   axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's ``[B, T_local, H, D]`` blocks against
    the blocks of every rank of ``mesh``'s ``axis_name`` (a
    :class:`~scalerl_torch.parallel.mesh.Mesh`; None = one rank).  Every
    rank of the axis calls it with blocks of the same shape; rank ``i``'s
    block holds global positions ``[i * T_local, (i + 1) * T_local)``.
    Returns this rank's output block in q's dtype; differentiable."""
    B, T, H, D = q.shape
    group = None if mesh is None else mesh.group(axis_name)
    n = 1 if group is None else mesh.shape[axis_name]
    idx = 0 if group is None else mesh.coordinate(axis_name)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q_pos = idx * T + torch.arange(T, device=q.device)

    # float32 accumulators whatever the input dtype (bf16 operands stay
    # bf16 on the score product; the final division casts back)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), float("-inf"), dtype=torch.float32, device=q.device)

    def attend(o, l, m, k_blk, v_blk, src: int):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
        if causal:
            k_pos = src * T + torch.arange(T, device=q.device)
            visible = k_pos[None, :] <= q_pos[:, None]
            s = s.masked_fill(~visible, float("-inf"))
        return _online_block_update(o, l, m, s, v_blk.float())

    o, l, m = attend(o, l, m, k, v, idx)  # own block first, no communication
    if n > 1:
        nxt = dist.get_global_rank(group, (idx + 1) % n)
        prev = dist.get_global_rank(group, (idx - 1) % n)
        kv = torch.stack([k, v])
        for r in range(1, n):  # n - 1 hops: none wasted after the last block
            kv = _RingHop.apply(kv, nxt, prev, group)
            o, l, m = attend(o, l, m, kv[0], kv[1], (idx - r) % n)
    l = torch.where(l == 0.0, 1.0, l)  # fully masked rows -> zeros
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def make_ring_attention_fn(mesh, causal: bool = False, axis_name: str = "sp") -> Callable:
    """``fn(q, k, v)`` over this rank's ``[B, T_local, H, D]`` blocks of the
    sequence sharded on ``axis_name`` -> this rank's output block (JAX's
    function takes and returns the global arrays; a PyTorch rank holds only
    its block)."""

    def fn(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)

    return fn
