"""Layers that compute on their shards inside the meshed learn step.

The JAX package jits its learn step with the state laid out by the fsdp/tp
rule or the mp rule table, and GSPMD all-gathers a sharded weight where it
is used, runs the mp layers Megatron-style and updates the optimizer
moments on their shards.  Here :class:`parallel.train_step.ParallelLearnFn`
hands the learn function each rank's local shards under the same names, and
:func:`install` sets up every layer of the agent's models that holds a
sharded param so that ``torch.func.functional_call`` with those shards
computes what the layer computes on the whole weight.  Per weight dim:

- over a gathered axis (``fsdp``, or ``tp``/``mp`` on a dim that is not an
  input or output feature): the weight is gathered just before the layer
  uses it and freed after; the backward gathers it again and reduce-scatters
  its gradient over a batch axis (the ranks computed on different rows), or
  takes the rank's slice (the cotangent is already whole).  A rank holds
  about one layer's full weight at a time (:data:`GATHER_STATS`).
- over ``tp``/``mp`` on the output features or channels: column-parallel.
  The input's gradient is summed over the axis (``SumGrads``), the rank
  computes its slice of the output, and ``GatherShards`` assembles it.
- over ``tp``/``mp`` on the input features or channels: row-parallel.  The
  rank takes its slice of the input (``SliceShard``), computes, and
  ``SumForward`` sums the parts; the bias is added once, after the sum.

Every layer returns a replicated activation.  Two layer pairs skip the
gather in between: the transformer block under ``mp`` runs attention on the
rank's own ``n_heads / mp`` heads (qkv column-parallel over heads, stored
head-aligned, then ``proj`` row-parallel) and its MLP as a column/row pair
(:func:`head_parallel`); the MoE layer's expert banks over ``mp`` run
through the expert-parallel apply of ``parallel/expert.py``.

A ``torch.nn.Linear`` or ``Conv2d`` layer gets its plan (``_layer_plan``)
and a subclass whose ``forward`` is :func:`linear` / :func:`conv2d`; a
model that reads a layer's params itself calls those two functions (as
``AtariNet`` does).  Any other module with a sharded param gathers it at
the start of its ``forward``.  Outside a step on shards every layer runs
its plain code on whole tensors.

The same layers serve a forward outside a learn step (:func:`on_shards`,
:func:`call_on_shards`): ``make_parallel_act_fn`` and the generation
engines run the model on the local shards with no autograd, and a
transformer block's caches then hold the rank's own heads
(:func:`local_heads`).  The ranks that hold one model between them (the
same ``dp`` coordinate, :func:`model_axis`) run such a forward in
lockstep.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.parallel.collectives import (
    GatherShards,
    SliceShard,
    SumForward,
    SumGrads,
    all_gather_dim,
    own_slice,
    reduce_scatter_dim,
)
from scalerl_torch.parallel.mesh import Mesh
from scalerl_torch.parallel.sharding import (
    HEAD_ALIGNED_AXIS,
    QKV_GROUPS,
    ShardContext,
    Spec,
    SpecFn,
    active_shard_context,
    bound_batch_axes,
    from_head_aligned,
    shard_context,
    storage_groups,
    to_local,
)
from scalerl_torch.utils.tree import tree_map

# axes a layer splits its features over (column- or row-parallel); every
# other axis is gathered where the weight is used
PARALLEL_AXES = ("tp", "mp")

# full weights gathered by the layers (count, bytes alive now, most bytes
# alive at once since the last reset)
GATHER_STATS = {"gathers": 0, "live_bytes": 0, "peak_live_bytes": 0}


def reset_gather_stats() -> None:
    GATHER_STATS.update(gathers=0, peak_live_bytes=GATHER_STATS["live_bytes"])


def _release(nbytes: int) -> None:
    GATHER_STATS["live_bytes"] -= nbytes


def _track(full: torch.Tensor) -> torch.Tensor:
    nbytes = full.numel() * full.element_size()
    GATHER_STATS["gathers"] += 1
    GATHER_STATS["live_bytes"] += nbytes
    GATHER_STATS["peak_live_bytes"] = max(GATHER_STATS["peak_live_bytes"],
                                          GATHER_STATS["live_bytes"])
    weakref.finalize(full, _release, nbytes)
    return full


def _entries(spec: Spec) -> Tuple[Tuple[int, str], ...]:
    return tuple((d, a) for d, a in enumerate(spec) if a is not None)


@dataclass(frozen=True)
class LayerPlan:
    """How a linear or conv layer computes on its shards: ``parallel`` is
    ``(axis, "column" | "row")`` or None, ``gathers`` the ``(dim, axis)``
    of the weight gathered at use, ``bias_sharded`` whether the bias is
    split with a column layer's output, ``groups`` the head-aligned storage
    of the output dim (:func:`parallel.sharding.storage_groups`)."""

    parallel: Optional[Tuple[str, str]]
    gathers: Tuple[Tuple[int, str], ...]
    bias_sharded: bool
    groups: int


def layer_plan(weight_spec: Spec, bias_spec: Spec, groups: int) -> Optional[LayerPlan]:
    """The plan of a layer whose weight (``[out, in, ...]``) and bias are
    laid out by these specs; None where the layer must gather instead (a
    bias split in a way the weight is not)."""
    entries = _entries(weight_spec)
    if any(not isinstance(a, str) for _, a in entries):
        return None
    parallel = None
    for d, a in entries:
        if a in PARALLEL_AXES and d in (0, 1):
            parallel = (a, "column" if d == 0 else "row")
            break
    feature = None if parallel is None else (0 if parallel[1] == "column" else 1)
    gathers = tuple((d, a) for d, a in entries if d != feature)
    bias_axes = [a for _, a in _entries(bias_spec)]
    bias_sharded = bool(bias_axes)
    if bias_sharded and (parallel is None or parallel[1] != "column"
                         or bias_axes != [parallel[0]]):
        return None
    return LayerPlan(parallel, gathers, bias_sharded, groups)


# ---------------------------------------------------------------------------
# a weight gathered at use, and freed


@dataclass(frozen=True)
class _WeightGather:
    """The gathers of one weight in one call: ``(dim, group, size, index,
    reduce)`` each, ``reduce`` when the axis is a batch axis of the step."""

    steps: Tuple[Tuple[int, Any, int, int, bool], ...]

    def full(self, w: torch.Tensor) -> torch.Tensor:
        for dim, group, size, _, _ in self.steps:
            w = all_gather_dim(w, dim, group, size)
        return _track(w)

    def shard(self, g: torch.Tensor) -> torch.Tensor:
        for dim, group, size, index, reduce in reversed(self.steps):
            g = reduce_scatter_dim(g, dim, group, size) if reduce else own_slice(g, dim, size,
                                                                                  index)
        return g.contiguous()


def _weight_gather(mesh: Mesh, gathers: Tuple[Tuple[int, str], ...]) -> Optional[_WeightGather]:
    if not gathers:
        return None
    batch = bound_batch_axes()
    return _WeightGather(tuple((d, mesh.group(a), mesh.shape[a], mesh.coordinate(a), a in batch)
                               for d, a in gathers))


class _LinearOp:
    @staticmethod
    def forward(x, w, b):
        return F.linear(x, w, b)

    @staticmethod
    def backward(x, w, g, needs):
        g2 = g.reshape(-1, g.shape[-1])
        gx = g.matmul(w) if needs[0] else None
        gw = g2.t().mm(x.reshape(-1, x.shape[-1])) if needs[1] else None
        gb = g2.sum(0) if needs[2] else None
        return gx, gw, gb


@dataclass(frozen=True)
class _ConvOp:
    stride: Tuple[int, ...]
    padding: Tuple[int, ...]
    dilation: Tuple[int, ...]

    def forward(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation)

    def backward(self, x, w, g, needs):
        return torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]] if needs[2] else None, list(self.stride), list(self.padding),
            list(self.dilation), False, [0, 0], 1, list(needs))


class _GatheredOp(torch.autograd.Function):
    """``op(x, gather(w), b)`` with the full weight built in the forward,
    freed when it returns, and built again in the backward; the weight's
    gradient comes back as the rank's shard (:meth:`_WeightGather.shard`)."""

    @staticmethod
    def forward(ctx, x, w, b, op, gather):
        ctx.op, ctx.gather = op, gather
        ctx.save_for_backward(x, w)
        return op.forward(x, gather.full(w), b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx, gw, gb = ctx.op.backward(x, ctx.gather.full(w), grad, ctx.needs_input_grad[:3])
        return gx, None if gw is None else ctx.gather.shard(gw), gb, None, None


def _local(ctx: ShardContext, plan: LayerPlan, op, x, w, b):
    gather = _weight_gather(ctx.mesh, plan.gathers)
    if gather is None:
        return op.forward(x, w, b)
    return _GatheredOp.apply(x, w, b, op, gather)


def _axis(mesh: Mesh, axis: str):
    return mesh.group(axis), mesh.shape[axis], mesh.coordinate(axis)


def _column_part(ctx, plan, op, x, w, b):
    """This rank's slice of a column layer's output (its bias slice added
    when the bias is split with it)."""
    group, _, _ = _axis(ctx.mesh, plan.parallel[0])
    (x,) = SumGrads.apply(group, x)
    return _local(ctx, plan, op, x, w, b if plan.bias_sharded else None)


def _row_part(ctx, plan, op, x_part, w, b, feature_dim: int):
    """A row layer on this rank's slice of its input: the parts summed, the
    (replicated) bias added once."""
    group, _, _ = _axis(ctx.mesh, plan.parallel[0])
    y = SumForward.apply(_local(ctx, plan, op, x_part, w, None), group)
    return y if b is None else y + _bias_view(b, y, feature_dim)


def _bias_view(b: torch.Tensor, y: torch.Tensor, feature_dim: int) -> torch.Tensor:
    return b if feature_dim % y.ndim == y.ndim - 1 else b.view((-1,) + (1,) * (y.ndim - 2))


def _sharded(ctx: ShardContext, plan: LayerPlan, op, x, w, b, feature_dim: int):
    if plan.parallel is None:
        return _local(ctx, plan, op, x, w, b)
    group, size, index = _axis(ctx.mesh, plan.parallel[0])
    dim = feature_dim % x.ndim
    if plan.parallel[1] == "column":
        y = GatherShards.apply(_column_part(ctx, plan, op, x, w, b), dim, group, size, index,
                               False)
        if plan.groups > 1:
            y = from_head_aligned(y, size, plan.groups, dim)
        if b is not None and not plan.bias_sharded:
            y = y + _bias_view(b, y, feature_dim)
        return y
    return _row_part(ctx, plan, op, SliceShard.apply(x, dim, group, size, index), w, b,
                     feature_dim)


def _cast(module, x, dtype):
    w, b = module.weight, module.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return x, w, b


def linear(module: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.linear(x, module.weight, module.bias)``, all three cast to
    ``dtype`` when given; on the layer's shards inside a step on shards."""
    x, w, b = _cast(module, x, dtype)
    plan = module.__dict__.get("_layer_plan")
    ctx = active_shard_context() if plan is not None else None
    if ctx is None:
        return F.linear(x, w, b)
    return _sharded(ctx, plan, _LinearOp, x, w, b, -1)


def conv2d(module: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.conv2d`` of an NCHW input with the module's weight, bias, stride,
    padding and dilation (cast to ``dtype`` when given); on the layer's
    shards inside a step on shards (channels are dim 1)."""
    x, w, b = _cast(module, x, dtype)
    plan = module.__dict__.get("_layer_plan")
    ctx = active_shard_context() if plan is not None else None
    if ctx is None:
        return F.conv2d(x, w, b, module.stride, module.padding, module.dilation)
    op = _ConvOp(tuple(module.stride), tuple(module.padding), tuple(module.dilation))
    return _sharded(ctx, plan, op, x, w, b, 1)


# ---------------------------------------------------------------------------
# the transformer block's pairs


@dataclass(frozen=True)
class HeadParallel:
    """The block's layout over ``mp``: ``size`` ranks, each with
    ``n_heads / size`` heads; ``mlp`` whether the MLP runs as one
    column/row pair."""

    size: int
    mlp: bool

    @staticmethod
    def column(module, x, dtype=None):
        """This rank's output features of a column layer (no gather)."""
        x, w, b = _cast(module, x, dtype)
        return _column_part(active_shard_context(), module._layer_plan, _LinearOp, x, w, b)

    @staticmethod
    def row(module, x_part, dtype=None):
        """A row layer on this rank's input features, summed."""
        x_part, w, b = _cast(module, x_part, dtype)
        return _row_part(active_shard_context(), module._layer_plan, _LinearOp, x_part, w, b, -1)


def _plan(module) -> Optional[LayerPlan]:
    return module.__dict__.get("_layer_plan")


def head_parallel(block) -> Optional[HeadParallel]:
    """How a ``TransformerBlock`` runs inside a step on shards: over ``mp``
    on its own heads when its qkv is column-parallel over ``mp`` and stored
    head-aligned, its ``proj`` row-parallel over ``mp`` and the heads divide
    by the extent; else None (every layer on its own, replicated between)."""
    ctx = active_shard_context()
    if ctx is None:
        return None
    qkv, proj = _plan(block.qkv), _plan(block.proj)
    size = ctx.mesh.shape[HEAD_ALIGNED_AXIS]
    if (qkv is None or proj is None or qkv.parallel != (HEAD_ALIGNED_AXIS, "column")
            or qkv.groups != QKV_GROUPS or proj.parallel != (HEAD_ALIGNED_AXIS, "row")
            or block.num_heads % size):
        return None
    mlp_in, mlp_out = _plan(block.mlp_in), _plan(block.mlp_out)
    mlp = (mlp_in is not None and mlp_out is not None
           and mlp_in.parallel == (HEAD_ALIGNED_AXIS, "column")
           and (mlp_in.bias_sharded or block.mlp_in.bias is None)
           and mlp_out.parallel == (HEAD_ALIGNED_AXIS, "row"))
    return HeadParallel(size, mlp)


# ---------------------------------------------------------------------------
# a forward on shards outside a learn step


@contextmanager
def on_shards(ctx: Optional[ShardContext]) -> Iterator[None]:
    """Within the block a model of the state ``ctx`` describes runs its
    forward on the local shards, with no autograd: the layers issue their
    collectives as in a learn step, and nothing gathers a param whole that
    the step would not.  None (no mesh): the plain forward."""
    with torch.no_grad(), shard_context(ctx):
        yield


def call_on_shards(ctx: Optional[ShardContext], fn: Callable, params: Any, *args, **kwargs):
    """``fn(local params, *args, **kwargs)`` :func:`on_shards`, the params'
    DTensor leaves given as their local shards (as ``ParallelLearnFn``
    hands a learn function its state)."""
    with on_shards(ctx):
        return fn(tree_map(to_local, params), *args, **kwargs)


def local_heads(block, ctx: Optional[ShardContext]) -> int:
    """The heads a ``TransformerBlock`` attends on :func:`on_shards` of
    ``ctx``: ``num_heads / mp`` where it runs on the rank's own heads, else
    all of them.  A cache it writes there holds that many."""
    with shard_context(ctx):
        hp = head_parallel(block)
    return block.num_heads if hp is None else block.num_heads // hp.size


def model_axis(mesh: Mesh) -> Optional[str]:
    """The axis of the ranks that hold one model between them and so run
    its forward in lockstep (every rank of one ``dp`` coordinate): the one
    axis besides ``dp`` with more than one rank, or None where each rank
    holds the whole model.  Raises for a mesh with several such axes."""
    axes = [a for a, n in mesh.shape.items() if a != "dp" and n > 1]
    if len(axes) > 1:
        raise ValueError(f"a forward on shards outside a learn step takes one model axis "
                         f"besides dp; the mesh has {axes}")
    return axes[0] if axes else None


# ---------------------------------------------------------------------------
# installing the plans


class _LinearOnShards:
    def forward(self, x):
        return linear(self, x, getattr(self, "compute_dtype", None))


class _Conv2dOnShards:
    def forward(self, x):
        return conv2d(self, x)


def _gathered(t: torch.Tensor, spec: Spec, groups: int, ctx: ShardContext) -> torch.Tensor:
    """A param's whole tensor from its shard, differentiable (the
    gradient comes back as the shard, reduce-scattered over batch axes)."""
    mesh, batch = ctx.mesh, bound_batch_axes()
    for d, a in _entries(spec):
        group, size, index = _axis(mesh, a)
        t = GatherShards.apply(t, d, group, size, index, a in batch)
    if groups > 1:
        t = from_head_aligned(t, mesh.shape[HEAD_ALIGNED_AXIS], groups)
    return _track(t)


class _GatherOnShards:
    """Any other module: its sharded params are gathered for the call."""

    def forward(self, *args, **kwargs):
        ctx = active_shard_context()
        if ctx is None:
            return super().forward(*args, **kwargs)
        saved = {}
        try:
            for name, (spec, groups) in self._gather_plan.items():
                saved[name] = self._parameters[name]
                self._parameters[name] = _gathered(saved[name], spec, groups, ctx)
            return super().forward(*args, **kwargs)
        finally:
            self._parameters.update(saved)


class _MoEOnShards(_GatherOnShards):
    """The Switch MoE layer: expert banks over one axis (``mp`` under the
    rule table) run through ``parallel/expert.py``'s expert-parallel apply
    with that axis's group; any other layout gathers."""

    def forward(self, x):
        ctx = active_shard_context()
        axis = self.__dict__.get("_expert_axis")
        if ctx is None or axis is None:
            return super().forward(x)
        from scalerl_torch.models.moe import MoEOutput, capacity, route_top1
        from scalerl_torch.parallel.expert import expert_parallel_outputs

        group, _, index = _axis(ctx.mesh, axis)
        C = capacity(x.shape[0], self.num_experts, self.capacity_factor)
        routing = route_top1(self.gates(x), C)
        y = expert_parallel_outputs(x, routing, self.w_in, self.w_out, C, group,
                                    index * self.w_in.shape[0])
        return MoEOutput(y * routing.gate[:, None], routing.aux, routing.dispatch_frac)


_CLASSES: Dict[Tuple[type, type], type] = {}


def _swap_class(module: nn.Module, mixin: type) -> None:
    cls = type(module)
    if issubclass(cls, mixin):
        return
    new = _CLASSES.get((mixin, cls))
    if new is None:
        new = type(f"{cls.__name__}{mixin.__name__.lstrip('_')}", (mixin, cls),
                   {"__module__": __name__})
        _CLASSES[(mixin, cls)] = new
    module.__class__ = new


def _plain_linear(m: nn.Module) -> bool:
    """A linear layer running the plain code, or set up already (a model
    installed twice, such as a copy of an agent's model)."""
    if not isinstance(m, nn.Linear):
        return False
    from scalerl_torch.models.transformer import _Dense

    return isinstance(m, _LinearOnShards) or type(m).forward in (nn.Linear.forward,
                                                                 _Dense.forward)


def _plain_conv(m: nn.Module) -> bool:
    return (isinstance(m, nn.Conv2d)
            and (isinstance(m, _Conv2dOnShards) or type(m).forward is nn.Conv2d.forward)
            and m.groups == 1 and m.padding_mode == "zeros" and not isinstance(m.padding, str))


def _expert_axis(m: nn.Module, specs: Dict[str, Spec]) -> Optional[str]:
    from scalerl_torch.models.moe import MoEMLP

    if not isinstance(m, MoEMLP) or m.dense_dispatch or set(specs) != {"w_in", "w_out"}:
        return None
    axes = {_entries(s) for s in specs.values()}
    if len(axes) != 1:
        return None
    (entries,) = axes
    return entries[0][1] if len(entries) == 1 and entries[0][0] == 0 else None


def install(modules: Iterable[nn.Module], spec_fn: SpecFn) -> Set[str]:
    """Set up every layer of ``modules`` that holds a param ``spec_fn``
    shards (its spec read from the param's whole tensor at the path of its
    name in the model, as a train state's ``params`` hold it) to compute on
    its shards inside a step on shards; returns the names of those params.
    A layer keeps its class's code outside such a step."""
    covered: Set[str] = set()
    for model in modules:
        for prefix, m in model.named_modules():
            specs, names = {}, {}
            for n, p in m._parameters.items():
                if p is None:
                    continue
                qual = f"{prefix}.{n}" if prefix else n
                spec = tuple(spec_fn((qual,), p))
                if _entries(spec):
                    specs[n], names[n] = spec, qual
            if not specs:
                continue
            covered.update(names.values())
            groups = {n: storage_groups((names[n],), s) for n, s in specs.items()}
            plan = None
            if (_plain_linear(m) or _plain_conv(m)) and set(specs) <= {"weight", "bias"}:
                plan = layer_plan(specs.get("weight", ()), specs.get("bias", ()),
                                  groups.get("weight", 1))
            if plan is not None:
                m._layer_plan = plan
                _swap_class(m, _LinearOnShards if isinstance(m, nn.Linear) else _Conv2dOnShards)
                continue
            m._gather_plan = {n: (s, groups[n]) for n, s in specs.items()}
            axis = _expert_axis(m, specs)
            if axis is not None:
                m._expert_axis = axis
                _swap_class(m, _MoEOnShards)
            else:
                _swap_class(m, _GatherOnShards)
    return covered
