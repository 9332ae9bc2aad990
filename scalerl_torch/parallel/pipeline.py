"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp`` axis.
Port of ``scalerl_tpu/parallel/pipeline.py``.

Stage ``s`` lives on rank ``s`` of ``pp``.  A heterogeneous model is
``embed -> S blocks -> head``: params ``{"embed", "block", "head"}`` with the
block leaves stacked ``[S, ...]``; a rank keeps its own stage's slice.  The
schedule runs ``M + S - 1`` steps for ``M`` microbatches (the bubble is
``(S - 1) / (M + S - 1)``): at step ``t`` stage ``s`` works on microbatch
``t - s``, embed runs on stage 0 only, the head on the last stage only, and
each block's output goes one rank right (never round: ``i`` to ``i + 1``).
An idle stage skips its block where JAX runs it on zeros and masks the
result; the outputs are the same.  At the end the last stage's outputs are
broadcast to every rank.

Gradients: every rank computes the same loss from the replicated outputs,
and the whole schedule is one autograd node whose backward runs the
schedule in reverse by hand (not through autograd's own order, which would
prune a hand-off that leads to no requested input and leave its peer
waiting): microbatch by microbatch, latest first, the last stage takes its
cotangent from the replicated dL/dy once (not summed over the ranks), every
other stage receives it from the right, runs its local backward and sends
the cotangent of its input left.  Messages carry their microbatch as tag,
and every link sees them in one order in both directions (also under nccl,
which ignores tags).  A rank ends up holding the gradients of its own stage:
the block slice, the embed's on stage 0 and the head's on the last stage
(the input's on stage 0).

At ``pp = 1`` no message is sent and no collective runs.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from scalerl_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path

# stage_fn(stage_params, x[mb, ...]) -> y[mb, ...] (same shape)
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _identity_stage(params: Any, x: torch.Tensor) -> torch.Tensor:
    del params
    return x


class _Schedule:
    """One rank's view of the GPipe schedule: its stage, the stage ranks'
    global ranks, the step count and the three stage functions."""

    def __init__(self, embed_fn, block_fn, head_fn, mesh, M: int, axis_name: str,
                 n_steps: Optional[int]) -> None:
        self.embed_fn, self.block_fn, self.head_fn = embed_fn, block_fn, head_fn
        self.M = M
        self.S = mesh.shape[axis_name]
        self.group = mesh.group(axis_name)
        self.stage = mesh.coordinate(axis_name)
        self.ranks = ([dist.get_global_rank(self.group, i) for i in range(self.S)]
                      if self.group is not None else [0])
        self.n_steps = M + self.S - 1 if n_steps is None else n_steps

    @property
    def last(self) -> bool:
        return self.stage == self.S - 1

    def active(self, t: int) -> bool:
        return 0 <= t - self.stage < self.M


class _GPipe(torch.autograd.Function):
    """The whole schedule as one autograd node.  The forward runs it,
    keeping each microbatch's local graph; the backward runs it in reverse
    by hand: for each microbatch, latest first, the cotangent of the
    stage's output (from the replicated dL/dy on the last stage, else
    received from the right), the local backward, and the cotangent of the
    stage's input sent left.  Messages are tagged with their microbatch;
    every link sees its messages in one order (descending microbatch) in
    both directions."""

    @staticmethod
    def forward(ctx, sched: _Schedule, tree, x, *leaves):
        s = sched
        build = any(ctx.needs_input_grad[2:])
        local = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        it = iter(local)
        params = tree_map(lambda _: next(it), tree)
        mbs = x.reshape((s.M, x.shape[0] // s.M) + x.shape[1:])
        x_leaf = None
        if s.stage == 0 and ctx.needs_input_grad[2]:
            x_leaf = mbs = mbs.detach().requires_grad_(True)
        record = {}
        outputs: List[Optional[torch.Tensor]] = [None] * s.M
        sends = []
        with torch.set_grad_enabled(build):
            block = tree_map(lambda p: p[s.stage], params["block"])
            first = s.embed_fn(params["embed"], mbs[0]) if s.stage == 0 else None
            meta = [None if first is None else (first.shape, first.dtype)]
            if s.group is not None:  # the hand-off's shape, for the receivers' buffers
                dist.broadcast_object_list(meta, s.ranks[0], group=s.group)
            carry_shape, carry_dtype = meta[0]
            cur = None
            for t in range(s.n_steps):
                k = t - s.stage
                if s.active(t):
                    if s.stage == 0:
                        x_in = first if k == 0 else s.embed_fn(params["embed"], mbs[k])
                    else:
                        x_in = cur
                    y = s.block_fn(block, x_in)
                    if s.last:
                        outputs[k] = y = s.head_fn(params["head"], y)
                    else:
                        sends.append(_post(dist.isend, y.detach(), s.ranks[s.stage + 1], s, k))
                    record[k] = (None if s.stage == 0 else x_in, y)
                if s.stage > 0 and 0 <= k + 1 < s.M:
                    # the microbatch the previous stage hands on at this step
                    cur = torch.empty(carry_shape, dtype=carry_dtype, device=x.device)
                    dist.recv(cur, s.ranks[s.stage - 1], group=s.group, tag=k + 1)
                    cur.requires_grad_(build)
        _wait(sends)
        if s.last:
            done = [o for o in outputs if o is not None]
            if done:
                like = done[0]
            else:  # a cut schedule may leave the last stage nothing to show
                with torch.no_grad():
                    like = s.head_fn(params["head"], torch.zeros(carry_shape, dtype=carry_dtype,
                                                                 device=x.device))
            out = torch.stack([torch.zeros_like(like) if o is None else o.detach()
                               for o in outputs])
        if s.group is not None:
            meta = [(out.shape, out.dtype) if s.last else None]
            dist.broadcast_object_list(meta, s.ranks[-1], group=s.group)
            if not s.last:
                out = torch.empty(meta[0][0], dtype=meta[0][1], device=x.device)
            dist.broadcast(out, s.ranks[-1], group=s.group)
        ctx.sched, ctx.record, ctx.local, ctx.x_leaf = s, record, local, x_leaf
        ctx.x_shape = x.shape
        return out.reshape((x.shape[0],) + out.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        s, record = ctx.sched, ctx.record
        wanted = [t for t in ctx.local if t.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(wanted)
        x_grad = None
        grad_mb = grad.reshape((s.M, grad.shape[0] // s.M) + grad.shape[1:])
        sends = []
        for t in reversed(range(s.n_steps)):
            if not s.active(t):
                continue
            k = t - s.stage
            x_in, y = record.pop(k)
            if s.last:
                dy = grad_mb[k]
            elif k + s.stage + 1 < s.n_steps:
                dy = torch.empty_like(y)
                dist.recv(dy, s.ranks[s.stage + 1], group=s.group, tag=k)
            else:  # the next stage never consumed it (a cut schedule)
                dy = torch.zeros_like(y)
            inputs = wanted + ([x_in] if x_in is not None else [])
            if s.stage == 0 and ctx.x_leaf is not None:
                inputs.append(ctx.x_leaf)
            with torch.enable_grad():
                grads = torch.autograd.grad(y, inputs, dy, allow_unused=True, retain_graph=True)
            for i, g in enumerate(grads[:len(wanted)]):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
            if x_in is not None:
                sends.append(_post(dist.isend, grads[len(wanted)].contiguous(),
                                   s.ranks[s.stage - 1], s, k))
            elif ctx.x_leaf is not None and grads[-1] is not None:
                x_grad = grads[-1] if x_grad is None else x_grad + grads[-1]
        _wait(sends)
        it = iter(acc)
        leaf_grads = [next(it) if t.requires_grad else None for t in ctx.local]
        if x_grad is not None:
            x_grad = x_grad.reshape(ctx.x_shape)
        return (None, None, x_grad, *leaf_grads)


def _post(op, tensor: torch.Tensor, peer: int, s: _Schedule, tag: int):
    return op(tensor, peer, group=s.group, tag=tag), tensor


def _wait(posted) -> None:
    for work, _ in posted:
        work.wait()


def _leaves_with_path(tree) -> list:
    out: list = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _key(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def make_pipeline_apply(stage_fn: StageFn, mesh, num_microbatches: int,
                        axis_name: str = "pp"):
    """``apply(stacked_params, x) -> y``: stages applied in pipeline, the
    leaves of ``stacked_params`` leading with the stage axis ``[S, ...]``,
    ``x`` ``[B, ...]`` with ``B`` divisible by ``num_microbatches``.  The
    heterogeneous pipeline with identity boundary stages (one schedule)."""
    hetero = make_hetero_pipeline_apply(_identity_stage, stage_fn, _identity_stage, mesh,
                                        num_microbatches, axis_name)

    def apply(stacked_params, x):
        return hetero({"embed": {}, "block": stacked_params, "head": {}}, x)

    return apply


def sequential_apply(stage_fn: StageFn, stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
    """Reference semantics: stages applied one after another (no pipeline)."""
    S = tree_leaves(stacked_params)[0].shape[0]
    for s in range(S):
        x = stage_fn(tree_map(lambda p: p[s], stacked_params), x)
    return x


def hetero_sequential_apply(embed_fn: StageFn, block_fn: StageFn, head_fn: StageFn,
                            params: Any, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference for :func:`make_hetero_pipeline_apply`."""
    y = embed_fn(params["embed"], x)
    y = sequential_apply(block_fn, params["block"], y)
    return head_fn(params["head"], y)


def make_hetero_pipeline_apply(embed_fn: StageFn, block_fn: StageFn, head_fn: StageFn, mesh,
                               num_microbatches: int, axis_name: str = "pp",
                               _loop_steps: Optional[int] = None):
    """Heterogeneous pipeline ``embed -> S blocks -> head`` over ``pp = S``
    (see the module docstring): ``apply({"embed", "block", "head"}, x[B,
    ...]) -> y[B, ..., out]``, the same on every rank.  ``_loop_steps``
    overrides the schedule's ``M + S - 1`` steps (a test seam: one fewer
    loses the last microbatch)."""
    sched = _Schedule(embed_fn, block_fn, head_fn, mesh, num_microbatches, axis_name,
                      _loop_steps)

    def apply(params, x):
        for path, leaf in _leaves_with_path(params["block"]):
            if leaf.shape[0] != sched.S:
                raise ValueError(f"stacked block-stage axis {leaf.shape[0]} != pp={sched.S} "
                                 f"at {_key(path)}; one block per pp device")
        if x.shape[0] % sched.M != 0:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by num_microbatches={sched.M}")
        return _GPipe.apply(sched, params, x, *tree_leaves(params))

    return apply
