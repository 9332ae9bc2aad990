"""Sequence (context) parallelism: a transformer policy with its time axis
sharded over the mesh's ``sp`` axis.  Port of ``scalerl_tpu/parallel/
sequence.py``.

Every rank of ``sp`` runs the position-wise layers on its own ``T / sp``
steps, and each block's attention goes round the ring
(:func:`~scalerl_torch.ops.ring_attention.ring_attention` through the
model's ``attn_fn`` seam), so memory a rank stays O(T / sp).  Positional
embeddings stay global: rank ``i`` embeds positions ``[i * T/sp, (i + 1) *
T/sp)``.

Calling convention, as in JAX: the global obs ``[B, T, ...]`` in, the same
on every rank of ``sp``, and the global :class:`TransformerOutput` out,
replicated.  Gradients follow the JAX transposes for a loss that every rank
computes alike from the replicated outputs: the gather of the outputs sends
each rank its own steps' cotangent (no sum), and the params, used by every
rank, get their gradient summed over ``sp`` in one all-reduce, so every rank
holds the whole gradient.
"""

from __future__ import annotations

import copy
import functools
from typing import Mapping

import torch
import torch.distributed as dist
from torch.func import functional_call

from scalerl_torch.models.transformer import TransformerOutput, TransformerPolicy
from scalerl_torch.ops.ring_attention import ring_attention
from scalerl_torch.parallel.collectives import SumGrads


class _GatherSteps(torch.autograd.Function):
    """All-gather of each rank's ``[B, T_local, ...]`` steps along dim 1; the
    backward hands a rank the cotangent of its own steps."""

    @staticmethod
    def forward(ctx, x, group, rank: int, world: int):
        ctx.rank, ctx.t_local = rank, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.t_local, ctx.t_local), None, None, None


def make_sequence_parallel_apply(model: TransformerPolicy, mesh, axis_name: str = "sp"):
    """``apply(params, obs) -> TransformerOutput`` with ``obs`` ``[B, T, ...]``
    sequence-sharded over ``mesh``'s ``axis_name`` (see the module
    docstring).  ``params`` maps the model's parameter names to tensors
    (``dict(model.named_parameters())`` for its own).  ``model`` is not
    changed: the ring runs in a shallow copy whose ``attn_fn`` is the
    causal ring."""
    sp = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    rank = mesh.coordinate(axis_name)
    sp_model = copy.copy(model)
    sp_model.attn_fn = functools.partial(ring_attention, mesh=mesh, axis_name=axis_name,
                                         causal=True)

    def apply(params: Mapping[str, torch.Tensor], obs: torch.Tensor):
        # validate the *global* length here: inside, the model sees T / sp
        # steps, so its own max_len guard cannot catch a too-long sequence
        T = obs.shape[1]
        if T > model.max_len:
            raise ValueError(f"global sequence length {T} exceeds max_len={model.max_len}")
        if T % sp != 0:
            raise ValueError(f"global sequence length {T} not divisible by sp={sp}")
        B, T_local = obs.shape[0], T // sp
        local = obs[:, rank * T_local:(rank + 1) * T_local]
        positions = (rank * T_local + torch.arange(T_local, device=obs.device)).expand(B, T_local)
        if group is not None:
            params = dict(zip(params, SumGrads.apply(group, *params.values())))
        out = functional_call(sp_model, dict(params), (local,), {"positions": positions})
        if group is None:
            return out
        return TransformerOutput(*(_GatherSteps.apply(x, group, rank, sp) for x in out))

    return apply
