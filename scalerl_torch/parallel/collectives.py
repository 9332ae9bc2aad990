"""Collectives over a process group with the autograd transposes the mesh
families need (``parallel/sequence.py``, ``parallel/expert.py``,
``parallel/shard_compute.py``).

Every rank of the group computes the same loss from replicated outputs, so
a cotangent that reaches a replicated tensor is already the whole one on
every rank.  :class:`SumForward` (an all-reduce whose backward is the
identity) turns per-rank parts into the replicated whole; an all-reduce in
its backward too would give ``n`` times the gradient.  :class:`SumGrads`
(the identity whose backward is one all-reduce) marks replicated inputs
that each rank uses for its own part only, so their gradient is summed.
:class:`GatherShards` (all-gather; its backward reduce-scatters or slices)
and :class:`SliceShard` (a rank's slice; its backward all-gathers) are
each other's transposes: the first assembles a sharded weight or a
column-parallel layer's output, the second feeds a row-parallel layer its
part of a replicated input.  :func:`broadcast_int` hands one rank's host
decision to the others.
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


def broadcast_int(value: int, device, group=None) -> int:
    """The first rank of ``group`` (of the world when None) hands its
    ``value`` to every rank of it: one int64 broadcast, for a host decision
    the ranks must take alike (a seed, an admission count)."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0 if group is None else dist.get_global_rank(group, 0), group=group)
    return int(t.item())


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim``, in group order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """Chunk ``index`` of ``size`` equal chunks of ``x`` along ``dim``."""
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the group:
    one ``reduce_scatter_tensor`` (gloo has it, on the CPU and on CUDA
    tensors, as nccl does)."""
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((lead.shape[0] // size,) + tuple(lead.shape[1:]))
    dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, dim)


class GatherShards(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` (``size`` ranks, this one at
    ``index``).  The backward either reduce-scatters the cotangent (``reduce``:
    the ranks computed on different batch rows, so each holds a part of the
    gradient, the fsdp layout) or takes this rank's slice of it (the
    cotangent is already whole and replicated, the tp/mp layouts)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index, reduce):
        ctx.args = (dim, group, size, index, reduce)
        return all_gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        dim, group, size, index, reduce = ctx.args
        if reduce:
            out = reduce_scatter_dim(grad, dim, group, size)
        else:
            out = own_slice(grad, dim, size, index).contiguous()
        return out, None, None, None, None, None


class SliceShard(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a replicated tensor (the inverse of
    :class:`GatherShards`); the backward all-gathers the ranks' cotangents,
    which differ, into the whole (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.args = (dim, group, size)
        return own_slice(x, dim, size, index)

    @staticmethod
    def backward(ctx, grad):
        dim, group, size = ctx.args
        return all_gather_dim(grad, dim, group, size), None, None, None, None
