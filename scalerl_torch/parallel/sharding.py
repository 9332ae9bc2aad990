"""Sharding rules and the batch-axis reductions of the sharded learn step.

Port of ``scalerl_tpu/parallel/sharding.py``.  A spec is a per-leaf tuple
with one entry per dim, the twin of a ``PartitionSpec``'s entries: None
(replicated), a mesh axis name, or a tuple of names (the batch dim over
``("dp", "fsdp")``); ``()`` replicates the whole leaf.  The rule functions
are pure functions of path names, shapes and the mesh's axis extents, so a
``MeshSpec`` does for a mesh there.

Trajectories split on their batch dim over ``dp`` x ``fsdp``, params
replicate over ``dp`` and may shard over ``fsdp``/``tp``.  In the JAX
package GSPMD then inserts the gradient reduction; here the learn step
does it by hand (``parallel/train_step.py``), with the reductions below:

- :func:`batch_sum` / :func:`batch_mean` reduce a loss term over the whole
  batch.  Inside :func:`batch_reduction` the value is the sum over every
  shard's rows, and the gradient is this shard's part of it, so summing
  the shards' gradients (:func:`reduce_gradients`) gives the gradient of
  the one-process loss at the same global batch; outside, they are
  ``torch.sum`` and ``torch.mean``.
- :func:`global_batch` scales a local batch count up to the global one.
- :func:`batch_all` ands a flag over the shards.

Inside a step that computes on shards (:func:`shard_context`, entered by
``ParallelLearnFn``) the leaves are local shards: :func:`reduce_gradients`
sums a sharded leaf's gradient over the batch axes that do not shard it,
:func:`tree_square_sum` (the global norm) sums each sharded leaf's part
over its shards and counts a replicated leaf once, and :func:`all_ranks`
ands a flag over every axis that shards a leaf as well.  A qkv weight over
``mp`` is stored head-aligned (:func:`storage_groups`); :func:`place` and
:func:`gather` keep the Flax order outside.

:func:`batch_reduction` spans ``dp`` x ``fsdp`` by default, or the axes it
is given: the data-parallel loops (``runtime/device_loop.py``,
``trainer/r2d2_device.py``) run any learn function inside
``batch_reduction(mesh, (axis_name,))``, the twin of the JAX learn
functions' ``psum``/``pmean`` over their ``grad_axis``.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scalerl_torch.parallel.collectives import all_gather_dim, broadcast_int
from scalerl_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshSpec, resolve_mesh
from scalerl_torch.utils.tree import tree_map, tree_map_with_path

Spec = Tuple[Any, ...]
BATCH_AXES: Tuple[str, str] = ("dp", "fsdp")


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis: extent}`` of a :class:`Mesh` or a :class:`MeshSpec`."""
    if isinstance(mesh, MeshSpec):
        return {a: mesh.size(a) for a in AXIS_NAMES}
    return mesh.shape


def replicated(mesh: Any = None) -> Spec:
    return ()


def batch_sharding(mesh: Any = None, batch_dim: int = 0) -> Spec:
    """Dim ``batch_dim`` over the data-parallel axes ``(dp, fsdp)``."""
    return (None,) * batch_dim + (BATCH_AXES,)


def trajectory_sharding(mesh: Any = None) -> Spec:
    """Time-major ``[T+1, B, ...]`` chunks shard on dim 1."""
    return batch_sharding(mesh, batch_dim=1)


def path_names(path: Tuple[Any, ...]) -> Tuple[str, ...]:
    """Path components as strings, dict keys split at their dots (the
    port's param names, ``blocks.0.qkv.weight``, are one key each)."""
    out = []
    for p in path:
        out.extend(str(p).split("."))
    return tuple(out)


def _batch_spec(path: Tuple[str, ...], x: torch.Tensor, time_major: Optional[bool],
                batch_dim: int = 0) -> Spec:
    """One batch leaf's spec: dim ``batch_dim`` of every leaf, or with
    ``time_major`` given, dim 1 of time-major leaves and dim 0 of those
    under ``core_state`` (every leaf's dim 0 when not ``time_major``)."""
    if time_major is None:
        dim = batch_dim
    else:
        dim = 0 if (not time_major or "core_state" in path_names(path)) else 1
    return batch_sharding(None, dim) if x.ndim > dim else ()


def batch_sharding_tree(batch_example: Any, mesh: Any = None, time_major: bool = True) -> Any:
    """Per-leaf spec tree for a batch: time-major leaves shard dim 1,
    leaves under ``core_state`` (and every leaf when not ``time_major``)
    dim 0; scalars replicate."""
    return tree_map_with_path(lambda p, x: _batch_spec(p, x, time_major), batch_example)


def infer_param_spec(path: Tuple[Any, ...], x: Any, mesh: Any,
                     axes: Tuple[str, ...] = ("fsdp", "tp"), min_shard: int = 8) -> Spec:
    """The heuristic spec of one param leaf: for rank >= 2, the largest
    divisible dim over ``axes[0]`` and the next over ``axes[1]``, each
    shard keeping at least ``min_shard`` elements; rank 0-1 and
    non-divisible leaves replicate (the JAX rule, its dims read in Flax's
    order, :func:`flax_dims`)."""
    if x.ndim < 2:
        return ()
    sizes = axis_sizes(mesh)
    if not any(sizes.get(a, 1) > 1 for a in axes):
        return ()
    perm = flax_dims(path, x)
    shape = tuple(x.shape[d] for d in perm)
    spec: list = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda d: -shape[d])
    for axis_name in axes:
        n = sizes.get(axis_name, 1)
        if n <= 1:
            continue
        for d in order:
            if spec[d] is None and shape[d] % n == 0 and shape[d] >= max(2, min_shard) * n:
                spec[d] = axis_name
                break
    out: list = [None] * len(shape)
    for i, d in enumerate(perm):
        out[d] = spec[i]
    return tuple(out)


def flax_dims(path: Tuple[Any, ...], x: Any) -> Tuple[int, ...]:
    """The port's dims in the order of the Flax leaf's: a ``weight`` of a
    dense layer (``[out, in]``) or a conv (``[out, in, kh, kw]``) is the
    transpose of the Flax kernel (``[in, out]``, ``[kh, kw, in, out]``),
    so the heuristic rule, whose ties go to the earlier dim, reads it in
    Flax's order and picks the dims the JAX package picks."""
    names = path_names(path)
    if names and names[-1] == "weight" and "token_embed" not in names:
        if x.ndim == 2:
            return (1, 0)
        if x.ndim == 4:
            return (2, 3, 1, 0)
    return tuple(range(x.ndim))


def has_scanned_params(tree: Any) -> bool:
    """True when the tree holds recurrent-core params (``core.*``, the LSTM
    of ``AtariNet`` and ``RecurrentQNet``, the twin of flax's ``Scan*``
    modules).  Such trees replicate every leaf under the heuristic rule, as
    in the JAX package."""
    found = []
    tree_map_with_path(lambda p, x: found.append("core" in path_names(p)), tree)
    return any(found)


SpecFn = Callable[[Tuple[str, ...], torch.Tensor], Spec]


def param_spec_fn(params: Any, mesh: Any, axes: Tuple[str, ...] = ("fsdp", "tp")) -> SpecFn:
    """The fsdp/tp rule as a function of a leaf's path and value (every
    leaf replicated when the tree has recurrent-core params)."""
    if axes and has_scanned_params(params):
        axes = ()
    return lambda path, x: infer_param_spec(path, x, mesh, axes=axes)


def param_sharding(params: Any, mesh: Any, axes: Tuple[str, ...] = ("fsdp", "tp")) -> Any:
    """Spec tree of a param or train-state tree under the fsdp/tp rule."""
    return tree_map_with_path(param_spec_fn(params, mesh, axes), params)


# ---------------------------------------------------------------------------
# placing tensors


def placements(spec: Spec, ndim: int) -> list:
    """DTensor placements over the mesh's seven dims for one leaf's spec."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in AXIS_NAMES]
    for d, entry in enumerate(spec[:ndim]):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[AXIS_NAMES.index(a)] = Shard(d)
    return out


def spec_of(x: torch.Tensor) -> Spec:
    """The spec a placed DTensor was laid out by (``()`` for a plain
    tensor): the inverse of :func:`placements`."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return ()
    axes: list = [[] for _ in range(x.ndim)]
    for name, p in zip(AXIS_NAMES, x.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    out = tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)
    return out if any(out) else ()


# The fused qkv weight's output dim holds q, k and v, each ``d_model`` rows,
# head-major.  Over ``mp`` a contiguous shard would hold all of q and part
# of k, not whole heads, so a qkv leaf (and its optimizer moments, whose
# paths end in the same names) sharded over mp is stored head-aligned: the
# full tensor is placed with its rows permuted so that rank r's contiguous
# shard is its q, k and v rows (a strided shard of the output dim), and
# gathered back through the inverse.  The unsharded model's rows, the
# checkpoints and ``convert.py`` keep the Flax order.
QKV_GROUPS = 3
HEAD_ALIGNED_AXIS = "mp"


def storage_groups(path: Tuple[Any, ...], spec: Spec) -> int:
    """3 for a leaf stored head-aligned (a ``qkv.weight`` whose dim 0 shards
    over ``mp``), else 1."""
    names = path_names(path)
    if tuple(names[-2:]) == ("qkv", "weight") and spec and spec[0] == HEAD_ALIGNED_AXIS:
        return QKV_GROUPS
    return 1


def to_head_aligned(x: torch.Tensor, size: int, groups: int, dim: int = 0) -> torch.Tensor:
    """Rows ``[g, r, i]`` (group-major, Flax order) -> ``[r, g, i]``
    (rank-major) along ``dim``."""
    dim %= x.ndim
    return x.unflatten(dim, (groups, size, -1)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def from_head_aligned(x: torch.Tensor, size: int, groups: int, dim: int = 0) -> torch.Tensor:
    """The inverse of :func:`to_head_aligned`."""
    dim %= x.ndim
    return x.unflatten(dim, (size, groups, -1)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def place(x: torch.Tensor, spec: Spec, mesh: Mesh, src_rank: Optional[int] = None,
          path: Tuple[Any, ...] = ()) -> torch.Tensor:
    """A full tensor as a DTensor laid out by ``spec``, each rank keeping
    its own slice: of its own copy (``src_rank=None``, for a tensor that is
    the same on every rank), or of ``src_rank``'s copy, which is broadcast
    (a state each rank built from its own seed).  A leaf at ``path`` that
    :func:`storage_groups` names is stored head-aligned.  A one-device mesh
    without a process group keeps the tensor as it is."""
    if mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import distribute_tensor

    groups = storage_groups(path, spec)
    if groups > 1:
        x = to_head_aligned(x, mesh.shape[HEAD_ALIGNED_AXIS], groups)
    return distribute_tensor(x, mesh.device_mesh, placements(spec, x.ndim),
                             src_data_rank=src_rank)


def place_tree(tree: Any, spec_fn: SpecFn, mesh: Mesh, src_rank: Optional[int] = None) -> Any:
    return tree_map_with_path(lambda p, x: place(x, spec_fn(p, x), mesh, src_rank, p), tree)


# DTensor leaves gathered to full tensors (every call of :func:`gather` on a
# DTensor); the sharded learn step gathers none
GATHER_STATS = {"dtensor_gathers": 0}


def gather(x: torch.Tensor, path: Tuple[Any, ...] = ()) -> torch.Tensor:
    """A DTensor as the full tensor on every rank, in the Flax order (a
    head-aligned leaf at ``path`` is put back); others pass through.  One
    ``all_gather`` a sharding mesh dim, the innermost first, as plain
    ``torch.distributed`` calls: DTensor's own ``full_tensor`` waits on a
    functional collective, which crashes over gloo on CUDA tensors (PyTorch
    2.11 on the H100), where plain gloo collectives work."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    GATHER_STATS["dtensor_gathers"] += 1
    full, mesh = x.to_local(), x.device_mesh
    for mesh_dim in reversed(range(mesh.ndim)):
        p = x.placements[mesh_dim]
        if isinstance(p, Shard) and mesh.size(mesh_dim) > 1:
            full = all_gather_dim(full, p.dim, mesh.get_group(mesh_dim), mesh.size(mesh_dim))
    groups = storage_groups(path, spec_of(x))
    if groups > 1:
        full = from_head_aligned(full, mesh.size(AXIS_NAMES.index(HEAD_ALIGNED_AXIS)), groups)
    return full


def gather_tree(tree: Any) -> Any:
    return tree_map_with_path(lambda p, x: gather(x, p), tree)


def to_local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; others pass through."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def shard_params(params: Any, mesh) -> Any:
    """Place a param tree by the fsdp/tp rule."""
    mesh = resolve_mesh(mesh)
    return place_tree(params, param_spec_fn(params, mesh), mesh)


def flat_index(mesh: Mesh, axes: Tuple[str, ...]) -> int:
    """This rank's flat coordinate over ``axes``, the first the most
    significant."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
    return idx


def _batch_index(mesh: Mesh) -> int:
    """This rank's batch shard: its flat (dp, fsdp) coordinate."""
    return flat_index(mesh, BATCH_AXES)


def check_divisible(batch: Any, specs_fn: SpecFn, mesh: Mesh) -> None:
    """Fail with an actionable message where a batch dim does not divide
    by its mesh extent."""

    def chk(path, x):
        for d, entry in enumerate(specs_fn(path, x)):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            extent = mesh.extent(names)
            if extent > 1 and x.shape[d] % extent != 0:
                raise ValueError(
                    f"batch dim {d} of size {x.shape[d]} must divide by the mesh extent "
                    f"{extent} (axes {names}) to shard; adjust batch_size/num_envs or the "
                    "mesh shape")

    tree_map_with_path(chk, batch)


def shard_batch(batch: Any, mesh, batch_dim: int = 0, time_major: Optional[bool] = None) -> Any:
    """This rank's slice of a global batch tree (the same on every rank),
    split on its batch dim over ``dp`` x ``fsdp`` (:func:`_batch_spec`).
    Leaves stay plain tensors."""
    mesh = resolve_mesh(mesh)

    def spec_fn(p, x):
        return _batch_spec(p, x, time_major, batch_dim)

    check_divisible(batch, spec_fn, mesh)
    n = mesh.extent(BATCH_AXES)
    if n == 1:
        return batch
    idx = _batch_index(mesh)

    def take(p, x):
        spec = spec_fn(p, x)
        if not spec:
            return x
        dim = len(spec) - 1
        size = x.shape[dim] // n
        return x.narrow(dim, idx * size, size)

    return tree_map_with_path(take, batch)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int) -> np.ndarray:
    """Host-side pad so a dim divides the mesh."""
    size = x.shape[axis]
    rem = size % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, multiple - rem)
    return np.pad(x, pad)


# ---------------------------------------------------------------------------
# batch-axis reductions inside the sharded learn step

# (mesh, axes) the batch reductions span, or None outside a sharded step
_BATCH_MESH: contextvars.ContextVar = contextvars.ContextVar("scalerl_batch_mesh", default=None)


@contextmanager
def batch_reduction(mesh: Mesh, axes: Tuple[str, ...] = BATCH_AXES) -> Iterator[None]:
    """Within the block the batch reductions below span the shards of
    ``mesh``'s ``axes`` (``dp`` x ``fsdp`` by default; nothing changes on
    one shard)."""
    axes = tuple(axes)
    token = _BATCH_MESH.set((mesh, axes) if mesh.extent(axes) > 1 else None)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def axes_all_reduce(x: torch.Tensor, op, mesh: Mesh,
                    axes: Tuple[str, ...] = BATCH_AXES) -> torch.Tensor:
    """``x`` reduced in place over the ranks of ``mesh``'s ``axes``, one
    collective a dim of more than one rank (a sum or a max composes over
    the dims); the identity on one shard."""
    for axis in axes:
        group = mesh.group(axis)
        if group is not None:
            dist.all_reduce(x, op=op, group=group)
    return x


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x)`` over the global batch.  Sharded, the value is the
    shards' total and the gradient flows through this shard's part."""
    s = torch.sum(x)
    bound = _BATCH_MESH.get()
    if bound is None:
        return s
    total = axes_all_reduce(s.detach().clone(), dist.ReduceOp.SUM, *bound)
    return total + (s - s.detach())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` over the global batch (equal shards)."""
    bound = _BATCH_MESH.get()
    if bound is None:
        return torch.mean(x)
    mesh, axes = bound
    return batch_sum(x) / (x.numel() * mesh.extent(axes))


def bound_batch_axes() -> Tuple[str, ...]:
    """The axes the batch reductions span in this block (``()`` outside
    :func:`batch_reduction`, or on one shard)."""
    bound = _BATCH_MESH.get()
    return () if bound is None else bound[1]


def global_batch(n: int) -> int:
    """A local batch count as the global one."""
    bound = _BATCH_MESH.get()
    return n if bound is None else n * bound[0].extent(bound[1])


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This shard's rows of a tensor drawn for the global batch (a
    counter-based draw of the global shape)."""
    bound = _BATCH_MESH.get()
    if bound is None:
        return x
    mesh, axes = bound
    size = x.shape[dim] // mesh.extent(axes)
    return x.narrow(dim, flat_index(mesh, axes) * size, size)


def batch_all(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool that holds on every shard."""
    bound = _BATCH_MESH.get()
    if bound is None:
        return flag
    return axes_all_reduce(flag.to(torch.int32), dist.ReduceOp.MIN, *bound).to(torch.bool)


def reduce_gradients(grads: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """Sum a gradient dict over the batch shards, one flat collective a
    set of axes (None entries, unused params, stay None).  Inside a step
    that computes on shards (:func:`shard_context`), a sharded leaf's
    gradient is this rank's slice, already summed over the batch axes that
    shard it (an fsdp weight's gather reduce-scatters its gradient), so it
    is summed over the other batch axes only; a replicated leaf over all."""
    bound = _BATCH_MESH.get()
    if bound is None:
        return grads
    mesh, axes = bound
    by_axes: Dict[Tuple[str, ...], list] = {}
    for k, g in grads.items():
        if g is not None:
            done = leaf_axes(k, g)
            by_axes.setdefault(tuple(a for a in axes if a not in done), []).append(k)
    out = dict(grads)
    for todo, keys in by_axes.items():
        if not todo:
            continue
        flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in keys])
        axes_all_reduce(flat, dist.ReduceOp.SUM, mesh, todo)
        offset = 0
        for k in keys:
            g = grads[k]
            out[k] = flat[offset:offset + g.numel()].view(g.shape).to(g.dtype)
            offset += g.numel()
    return out


# ---------------------------------------------------------------------------
# the step that computes on shards


@dataclass(frozen=True)
class ShardContext:
    """What a learn step that computes on shards knows of its state:
    ``mesh``, and ``axes`` of every sharded leaf, keyed by (param name,
    local shape); param names are the last component of a state path
    (``transformer.blocks.0.qkv.weight``), the keys of the gradient dicts."""

    mesh: Mesh
    axes: Dict[Tuple[str, Tuple[int, ...]], Tuple[str, ...]]

    @property
    def shard_axes(self) -> Tuple[str, ...]:
        """The mesh axes that shard some leaf."""
        return tuple(a for a in AXIS_NAMES if any(a in ax for ax in self.axes.values()))


_SHARD_CTX: contextvars.ContextVar = contextvars.ContextVar("scalerl_shard_ctx", default=None)


@contextmanager
def shard_context(ctx: Optional[ShardContext]) -> Iterator[None]:
    """Within the block the learn step computes on the local shards of
    ``ctx``'s state (``parallel/shard_compute.py``): the sharded layers run
    their collectives, and the gradient reductions, the global norm and the
    all-finite verdict account for the leaves' shards."""
    token = _SHARD_CTX.set(ctx)
    try:
        yield
    finally:
        _SHARD_CTX.reset(token)


def active_shard_context() -> Optional[ShardContext]:
    return _SHARD_CTX.get()


def leaf_axes(name: str, x: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes that shard the leaf ``name`` of local shape
    ``x.shape`` in the active step (``()``: replicated, or no such step)."""
    ctx = _SHARD_CTX.get()
    if ctx is None:
        return ()
    return ctx.axes.get((name, tuple(x.shape)), ())


def tree_square_sum(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sum(x ** 2)`` over every leaf of the whole (unsharded) tree: inside
    a step on shards, each sharded leaf's part is summed over the axes that
    shard it, and a replicated leaf counts once."""
    ctx = _SHARD_CTX.get()
    if ctx is None or not ctx.axes:
        return sum(torch.sum(torch.square(x)) for x in tree.values())
    parts: Dict[Tuple[str, ...], list] = {}
    for k, x in tree.items():
        parts.setdefault(leaf_axes(k, x), []).append(torch.sum(torch.square(x)))
    total = 0
    for axes, terms in parts.items():
        s = sum(terms)
        if axes:
            s = axes_all_reduce(s.detach().clone(), dist.ReduceOp.SUM, ctx.mesh, axes)
        total = total + s
    return total


def all_ranks(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool that holds on every rank whose verdict can differ: over
    the batch shards (:func:`batch_all`), and inside a step on shards also
    over every axis that shards a leaf, so that a NaN in one rank's shard
    is seen by all."""
    ctx = _SHARD_CTX.get()
    if ctx is None or not ctx.axes:
        return batch_all(flag)
    bound = _BATCH_MESH.get()
    batch = bound[1] if bound is not None else ()
    axes = tuple(a for a in AXIS_NAMES if a in batch or a in ctx.shard_axes)
    return axes_all_reduce(flag.to(torch.int32), dist.ReduceOp.MIN, ctx.mesh,
                           axes).to(torch.bool)


def agreed_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """Rank 0's ``seed`` on every rank of ``mesh`` (one broadcast; as it is
    without a process group): the seed a rank's shard draws derive from."""
    if mesh is None or mesh.device_mesh is None:
        return seed
    return broadcast_int(seed, mesh.device_type)


def shard_seed(seed: int, index: int) -> int:
    """The seed of shard ``index``'s draws: ``seed`` itself for shard 0 (so
    a one-shard mesh draws what the unmeshed path draws), a mix of both for
    the others (the twin of ``jax.random.fold_in(key, index)``)."""
    if index == 0:
        return seed
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9) % (2**63 - 1)


def gather_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0,
                 axes: Tuple[str, ...] = BATCH_AXES) -> torch.Tensor:
    """Per-row outputs of this rank -> the rows of every rank along
    ``axes``, concatenated on ``dim`` in :func:`flat_index` order (for the
    batch axes: dp-major, fsdp-minor, the order :func:`shard_batch` splits
    in)."""
    for axis in reversed(axes):
        group = mesh.group(axis)
        if group is None:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
    return x


def pool_axes(mesh: Mesh, split_batch: bool = True) -> Tuple[str, ...]:
    """The axes whose ranks pool the batches they collected themselves:
    with the batch split, the axes other than ``dp`` x ``fsdp`` (every
    rank of one batch shard must see the same rows); unsplit, every axis."""
    return tuple(a for a in AXIS_NAMES
                 if mesh.shape[a] > 1 and not (split_batch and a in BATCH_AXES))


def pool_batch(batch: Any, mesh: Mesh, axes: Tuple[str, ...],
               time_major: Optional[bool] = None) -> Any:
    """Every rank's own batch tree concatenated over ``axes`` on its batch
    dim (:func:`_batch_spec`), the same on each rank of those axes."""
    if not axes:
        return batch

    def pool(p, x):
        spec = _batch_spec(p, x, time_major)
        return gather_batch(x, mesh, len(spec) - 1, axes) if spec else x

    return tree_map_with_path(pool, batch)


def own_rows(x: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...], dim: int = 0) -> torch.Tensor:
    """This rank's rows of a per-row output of :func:`pool_batch`'s
    batch (the inverse of its concatenation)."""
    if not axes:
        return x
    size = x.shape[dim] // mesh.extent(axes)
    return x.narrow(dim, flat_index(mesh, axes) * size, size)


class MeshedAgentState:
    """The ``state`` of an agent that can take a mesh, and the params its
    acting paths read.

    Under a mesh, each assignment of ``state`` gathers the acting params
    (the ``_acting_field`` of the state) to full tensors once, on the thread
    that assigns it: the learner's, which every rank runs in the same
    order.  :meth:`acting_params` returns that copy, so actor threads and
    ``get_weights`` issue no collective (collectives from threads in no
    fixed order would pair up differently on each rank).  Without a mesh it
    returns the state's own params.  An agent with no acting threads sets
    ``_acting_copy = False`` and keeps no copy: its single-threaded callers
    act on the shards (token-PPO's engines)."""

    mesh = None
    _acting_field = "params"
    _acting_copy = True
    _acting = None

    @property
    def state(self) -> Any:
        return self._state

    @state.setter
    def state(self, value: Any) -> None:
        # the copy first: a reader between the two stores sees it, not a
        # sharded state
        self._acting = (None if self.mesh is None or not self._acting_copy
                        else gather_tree(getattr(value, self._acting_field)))
        self._state = value

    def acting_params(self) -> Any:
        acting = self._acting  # one read: the learner replaces it whole
        return getattr(self._state, self._acting_field) if acting is None else acting
