"""Sums over a process group with the autograd transposes the mesh families
need (``parallel/sequence.py``, ``parallel/expert.py``).

Every rank of the group computes the same loss from replicated outputs, so
a cotangent that reaches a replicated tensor is already the whole one on
every rank.  :class:`SumForward` (an all-reduce whose backward is the
identity) turns per-rank parts into the replicated whole; an all-reduce in
its backward too would give ``n`` times the gradient.  :class:`SumGrads`
(the identity whose backward is one all-reduce) marks replicated inputs
that each rank uses for its own part only, so their gradient is summed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class SumForward(torch.autograd.Function):
    """``all_reduce(x, SUM)`` over ``group``; the backward passes the
    (replicated) cotangent through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class SumGrads(torch.autograd.Function):
    """The identity over ``tensors``; the backward sums their gradients over
    ``group`` in one all-reduce (float32, then each back to its dtype)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.meta = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(grads, ctx.meta)]
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        parts = flat.split([g.numel() for g in grads])
        return (None, *(p.reshape(g.shape).to(g.dtype) for p, g in zip(parts, grads)))
