"""Named logical-axis sharding rules for the big-model policy families.

Port of ``scalerl_tpu/parallel/logical.py``.  The heuristic rule of
``parallel/sharding.py`` shards whatever dims divide; for a transformer the
meaning of a dim decides its axis (the Megatron layout): the fused qkv
output, the MLP hidden and the policy head's output shard over the model
axis ``mp`` (column-parallel ``qkv``/``mlp_in``/``policy_head``), the
attention output and MLP-out input rows too (row-parallel
``proj``/``mlp_out``), and embeddings and the residual stream replicate.

Leaves are classified by their trailing path names, so one table covers the
params and the optimizer moments, whose paths end in the same param names
(``opt_state.nu.transformer.blocks.0.qkv.weight``).  The table is in the
port's layout: a ``torch.nn.Linear`` weight is ``[out, in]``, the transpose
of a Flax kernel, so each 2-D row lists the JAX row's axes reversed.  The
MoE rows (``w_in``, ``w_out``, the expert banks of ``models/moe.py``) keep
the JAX layout.

Divisibility guard: a dim shards only when the mesh extent divides it, and
a mesh axis shards at most one dim of a tensor; everything else
replicates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from scalerl_torch.parallel.mesh import AXIS_NAMES, Mesh
from scalerl_torch.parallel.sharding import Spec, axis_sizes, gather, path_names, place
from scalerl_torch.utils.tree import tree_map_with_path

# The model-parallel mesh axis of the dp x mp learner.
MP_AXIS = "mp"

# Logical axis -> mesh axis (None = replicated).
LOGICAL_RULES: Dict[str, Optional[str]] = {
    "batch": "dp",
    "embed": None,
    "heads": MP_AXIS,
    "mlp": MP_AXIS,
    "vocab": MP_AXIS,
    "experts": MP_AXIS,
}

# Trailing path names -> per-dim logical axes of the port's tensors.
PARAM_LOGICAL_AXES: Dict[Tuple[str, ...], Tuple[Optional[str], ...]] = {
    ("qkv", "weight"): ("heads", "embed"),
    ("proj", "weight"): ("embed", "heads"),
    ("mlp_in", "weight"): ("mlp", "embed"),
    ("mlp_in", "bias"): ("mlp",),
    ("mlp_out", "weight"): ("embed", "mlp"),
    ("mlp_out", "bias"): ("embed",),
    ("policy_head", "weight"): ("vocab", "embed"),
    ("policy_head", "bias"): ("vocab",),
    ("value_head", "weight"): (None, "embed"),
    ("w_in",): ("experts", "embed", None),
    ("w_out",): ("experts", None, "embed"),
}


def logical_to_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh: Any,
                    rules: Optional[Dict[str, Optional[str]]] = None) -> Spec:
    """Per-dim logical axes -> a spec on ``mesh``: a dim shards only when
    its mesh axis has extent > 1, divides the dim and is not already used
    by another dim of the tensor."""
    rules = rules if rules is not None else LOGICAL_RULES
    sizes = axis_sizes(mesh)
    parts = []
    used = set()
    for dim, logical in enumerate(axes):
        mesh_axis = rules.get(logical) if logical is not None else None
        n = sizes.get(mesh_axis, 1) if mesh_axis else 1
        if mesh_axis and mesh_axis not in used and n > 1 and shape[dim] % n == 0:
            parts.append(mesh_axis)
            used.add(mesh_axis)
        else:
            parts.append(None)
    return tuple(parts)


def _match_axes(path: Tuple[Any, ...]) -> Optional[Tuple[Optional[str], ...]]:
    names = path_names(path)
    for key in (tuple(names[-2:]), (names[-1],) if names else ()):
        if key and key in PARAM_LOGICAL_AXES:
            return PARAM_LOGICAL_AXES[key]
    return None


def mp_param_spec(path: Tuple[Any, ...], leaf: Any, mesh: Any,
                  rules: Optional[Dict[str, Optional[str]]] = None) -> Spec:
    """Spec of one param or optimizer-state leaf under the table; unmatched
    leaves (embeddings, norms, counters) replicate."""
    axes = _match_axes(path)
    if axes is None or leaf.ndim != len(axes):
        return ()
    return logical_to_spec(axes, tuple(leaf.shape), mesh, rules)


def mp_param_sharding(tree: Any, mesh: Any,
                      rules: Optional[Dict[str, Optional[str]]] = None) -> Any:
    """Spec tree of a train state under the logical rule table."""
    return tree_map_with_path(lambda p, x: mp_param_spec(p, x, mesh, rules), tree)


def has_mp_params(tree: Any) -> bool:
    """True when the tree has leaves the rule table knows how to shard (the
    model is one of the mp-aware families)."""
    found = []
    tree_map_with_path(
        lambda p, x: found.append((axes := _match_axes(p)) is not None and x.ndim == len(axes)),
        tree)
    return any(found)


def activation_constraint(mesh: Mesh, batch_axis: str = "dp") -> Callable:
    """The inter-layer activation layout: ``[B, ...]`` over ``batch_axis``,
    replicated over ``mp``.  A DTensor activation is redistributed to it; a
    plain tensor is the rank's own batch rows already, replicated over
    ``mp`` (the sharded learn step computes on local rows, and its layers
    return replicated activations), and passes through."""

    def constrain(x):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if not isinstance(x, DTensor) or x.ndim == 0:
            return x
        out = [Replicate() for _ in AXIS_NAMES]
        out[AXIS_NAMES.index(batch_axis)] = Shard(0)
        return x.redistribute(x.device_mesh, out)

    return constrain


def make_shard_and_gather_fns(specs: Any, mesh: Mesh) -> Tuple[Any, Any]:
    """Per-leaf placement and fetch functions from a spec tree: ``shard_fns``
    place a full tensor into its layout (a DTensor), ``gather_fns`` fetch a
    placed leaf back to one full tensor on every rank (the sharded
    checkpoint path); a leaf stored head-aligned (``sharding.storage_groups``)
    is permuted on the way in and back on the way out."""
    shard_fns = _map_specs(lambda s, p: (lambda x: place(x, s, mesh, path=p)), specs)
    gather_fns = _map_specs(lambda s, p: (lambda x: gather(x, p)), specs)
    return shard_fns, gather_fns


def apply_fns(fns: Any, tree: Any) -> Any:
    """Apply a function tree (``make_shard_and_gather_fns``' output) to the
    train state it was made for, leaf by leaf."""
    import dataclasses

    if dataclasses.is_dataclass(fns) and not isinstance(fns, type):
        return dataclasses.replace(tree, **{
            f.name: apply_fns(getattr(fns, f.name), getattr(tree, f.name))
            for f in dataclasses.fields(fns)})
    if isinstance(fns, dict):
        return {k: apply_fns(f, tree[k]) for k, f in fns.items()}
    return fns(tree)


def _map_specs(fn: Callable[[Spec, Tuple[str, ...]], Any], specs: Any,
               path: Tuple[str, ...] = ()) -> Any:
    """``fn(spec, path)`` over a spec tree of a train state (dataclasses and
    dicts, a tuple being one leaf's spec; the path as
    ``tree_map_with_path`` gives it)."""
    import dataclasses

    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: _map_specs(fn, getattr(specs, f.name), path + (f.name,))
            for f in dataclasses.fields(specs)})
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, path + (str(k),)) for k, v in specs.items()}
    return fn(specs, path)
