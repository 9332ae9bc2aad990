"""The all-finite update guard, the float32 optimizer-state wrapper and the
sharded learn step.

Port of ``scalerl_tpu/parallel/train_step.py``.  A learn step whose result
holds NaN/Inf is SKIPPED (the input state survives) instead of poisoning
the run, and the verdict rides the metrics as ``nonfinite_grads`` /
``skipped_steps``.

The JAX version gates with ``lax.cond``.  Here the choice is a device-side
``torch.where`` over every leaf of the state: branching on the verdict in
Python would copy it to the host and stall the device every step.  For the
same reason the check always runs; ``check_every=K`` keeps the reference's
semantics (only steps with ``step % K == 0`` can be skipped) by folding the
step test into the select, not by skipping the reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scalerl_torch.parallel.mesh import Mesh, mesh_spec_from_args, resolve_mesh
from scalerl_torch.parallel.sharding import (
    BATCH_AXES,
    ShardContext,
    Spec,
    SpecFn,
    all_ranks,
    batch_reduction,
    batch_sharding_tree,
    gather_batch,
    gather_tree,
    own_rows,
    param_spec_fn,
    place_tree,
    placements,
    pool_axes,
    pool_batch,
    shard_batch,
    shard_context,
    to_local,
)
from scalerl_torch.utils.tree import tree_map, tree_map_with_path


# A train state is a dataclass of tensors and (nested) dicts of tensors.


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of a train state (or a tuple of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    subs = tree if isinstance(tree, (tuple, list)) else tree.values()
    return [leaf for sub in subs for leaf in tensor_leaves(sub)]


def tree_select(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, a, b)`` leaf by leaf over two train states."""
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    if dataclasses.is_dataclass(on_true):
        return dataclasses.replace(on_true, **{
            f.name: tree_select(pred, getattr(on_true, f.name), getattr(on_false, f.name))
            for f in dataclasses.fields(on_true)
        })
    return {k: tree_select(pred, v, on_false[k]) for k, v in on_true.items()}


def all_finite(tree: Any) -> torch.Tensor:
    """0-dim bool tensor: every floating leaf of ``tree`` is finite.

    Integer and bool leaves (counters) cannot go NaN and are skipped."""
    checks = [torch.isfinite(x).all() for x in tensor_leaves(tree) if x.is_floating_point()]
    return torch.stack(checks).all()


def guard_nonfinite_updates(learn_fn: Callable, check_every: int = 1) -> Callable:
    """Wrap ``(state, *args) -> (state, metrics, *aux)`` so a non-finite
    result keeps the input state; ``state.step`` is the learner update
    count.  On a skipped step the aux tensors (e.g. the per-sample |TD|
    that feeds PER priorities) come back with their non-finite entries
    zeroed, so NaN cannot reach the replay through the feedback path."""

    def guarded(state, *args):
        out = learn_fn(state, *args)
        new_state, metrics, aux = out[0], dict(out[1]), tuple(out[2:])
        # sharded, each rank checks its own rows of the aux outputs and its
        # own shards of the state, and every rank must reach the same verdict
        ok = all_ranks(all_finite((new_state, aux)))
        skip = ((state.step % check_every) == 0) & ~ok
        safe_state = tree_select(~skip, new_state, state)
        safe_aux = tuple(
            torch.where(skip, torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), x)
            if x.is_floating_point() else x
            for x in aux
        )
        bad = skip.to(torch.float32)
        metrics["nonfinite_grads"] = bad
        metrics["skipped_steps"] = bad
        return (safe_state, metrics) + safe_aux

    return guarded


def maybe_guard_nonfinite(learn_fn: Callable, args: Any) -> Callable:
    """Apply :func:`guard_nonfinite_updates` unless ``args.nonfinite_guard``
    is False, in which case ``learn_fn`` comes back untouched (no check, no
    counters in the metrics)."""
    if args.nonfinite_guard:
        return guard_nonfinite_updates(learn_fn, check_every=args.nonfinite_check_every)
    return learn_fn


def _to_float32(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() if v.is_floating_point() else v for k, v in tree.items()}


class _Fp32OptimizerState:
    """bf16 params with float32 optimizer state (JAX
    ``fp32_optimizer_state``): ``init`` builds the wrapped optimizer's state
    from a float32 view of the params; ``update`` upcasts the gradients,
    runs the wrapped update in float32 and casts each update back to its
    gradient's dtype, so a bf16 leaf stays bf16 and a float32 head stays
    float32 when the update is added.  The port's optimizers read no params
    in ``update``, so there are none to upcast there."""

    def __init__(self, optimizer: Any) -> None:
        self.optimizer = optimizer

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return self.optimizer.init(_to_float32(params))

    def update(self, grads: Dict[str, torch.Tensor],
               opt_state: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        updates, opt_state = self.optimizer.update(_to_float32(grads), opt_state)
        return {k: u.to(grads[k].dtype) for k, u in updates.items()}, opt_state


def fp32_optimizer_state(optimizer: Any) -> _Fp32OptimizerState:
    """Wrap one of the port's optimizers (``init(params)`` and ``update(grads,
    state) -> (updates, state)``) so its state lives in float32."""
    return _Fp32OptimizerState(optimizer)



# ---------------------------------------------------------------------------
# the sharded learn step


BATCH_MODES = ("split", "local", "replay_shard")


class ParallelLearnFn:
    """A learn function ``(state, *batch) -> (state, metrics, *aux)`` over a
    mesh (``make_parallel_learn_fn``'s result).

    The state's leaves are DTensors placed by the spec (a one-device mesh
    with no process group keeps plain tensors).  A step runs the learn
    function on their local shards and this rank's batch rows under
    :func:`parallel.sharding.batch_reduction` (its batch reductions and
    gradients then span every shard, so the update is the one-process
    update at the same global batch), places the new state's shards back,
    and all-gathers each per-row aux output along dim 0, so
    it comes back replicated (in the other batch modes below, as this
    rank's own rows).  The metrics come out replicated.

    Helpers: :meth:`shard_state` places rank 0's full state on every rank
    (counters replicated; ranks that built their agents from seeds of their
    own start alike), :meth:`gather_state` is its inverse, :meth:`shard_batch`
    takes this rank's rows of a global batch (dim 1 of time-major
    trajectories, dim 0 of ``core_state`` and of ``[B, ...]`` batches);
    ``state_sharding`` / ``batch_sharding`` are the spec trees.  With
    ``split_batch=False`` every rank keeps the whole batch and computes the
    whole update (the state is still placed by the spec).

    ``batch_mode`` (one of :data:`BATCH_MODES`, set by a trainer through
    :func:`maybe_enable_mesh_from_args`) says what a rank's batch is:

    - ``"split"`` (the default): a global batch, which :meth:`shard_batch`
      splits over ``dp`` x ``fsdp``;
    - ``"local"``: the batch this rank collected itself; :meth:`shard_batch`
      pools the batches of the ranks that share a batch shard (the
      non-batch axes; every rank when the batch is not split), so the step
      is the one-process step on the batches of all ranks together and no
      rank's rows go unused;
    - ``"replay_shard"``: this rank's replay shard's rows
      (``data/sharded_replay.py``), which the ranks of one shard drew
      alike; the step takes them as they are, with no split and no pooling.

    In the last two the per-row aux outputs come back as this rank's own
    rows.

    The step computes on shards: the learn function gets each rank's local
    shards under the leaves' own names and never a gathered state.  The
    layers of ``modules`` (the models the learn function runs through
    ``functional_call``) are set up by ``parallel/shard_compute.py`` to
    compute on those shards: an fsdp weight is gathered where its layer
    uses it and its gradient reduce-scattered, tp/mp layers run column- and
    row-parallel, the transformer's attention on a rank's own heads.  The
    optimizer updates its moments elementwise on their shards; a sharded
    leaf's gradient is summed over the batch axes that do not shard it, the
    global norm sums each sharded leaf over its shards and counts a
    replicated one once, and the all-finite verdict spans every axis that
    shards a leaf, so a NaN in one rank's shard skips the step on all.  The
    new state is placed from the local results, with no second scatter.
    Every sharded leaf must belong to a param of ``modules``."""

    def __init__(self, learn_fn: Callable, mesh: Mesh, state_example: Any,
                 batch_example: Any = None, batch_time_major: bool = True,
                 spec_fn: Optional[SpecFn] = None, split_batch: bool = True,
                 modules: Sequence[torch.nn.Module] = ()) -> None:
        self.learn_fn = learn_fn
        self.mesh = mesh
        self.split_batch = split_batch
        self.spec_fn = spec_fn if spec_fn is not None else param_spec_fn(state_example, mesh)
        self.batch_time_major = batch_time_major
        full = gather_tree(state_example)
        self._specs, self.shard_ctx = shard_layout(mesh, self.spec_fn, full, modules,
                                                   "make_parallel_learn_fn")
        self.state_sharding = tree_map_with_path(lambda p, _: self._specs[p], full)
        self.batch_sharding = (None if batch_example is None else
                               batch_sharding_tree(batch_example, mesh, batch_time_major))
        self.batch_mode = "split"

    def _pool_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks pool their own batches (not in "split")."""
        if self.batch_mode == "replay_shard":
            return ()
        return pool_axes(self.mesh, self.split_batch)

    def shard_state(self, state: Any) -> Any:
        return place_tree(gather_tree(state), self.spec_fn, self.mesh, src_rank=0)

    def gather_state(self, state: Any) -> Any:
        return gather_tree(state)

    def shard_batch(self, batch: Any) -> Any:
        if self.batch_mode != "split":
            return pool_batch(batch, self.mesh, self._pool_axes(), self.batch_time_major)
        if not self.split_batch:
            return batch
        return shard_batch(batch, self.mesh, time_major=self.batch_time_major)

    def _placed(self, path: Tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
        """A leaf of the new state, this rank's shard, as the DTensor of its
        spec (a leaf the example did not have replicates)."""
        from torch.distributed.tensor import DTensor

        spec = self._specs.get(path, ())
        return DTensor.from_local(x, self.mesh.device_mesh, placements(spec, x.ndim),
                                  run_check=False)

    def __call__(self, state: Any, *batch: Any):
        local = tree_map(to_local, state)
        with shard_context(self.shard_ctx):
            if not self.split_batch:
                out = self.learn_fn(local, *batch)
                aux = tuple(out[2:])
            else:
                with batch_reduction(self.mesh):
                    out = self.learn_fn(local, *batch)
                own = self.batch_mode != "split"
                aux = tuple(out[2:] if own else (gather_batch(a, self.mesh) for a in out[2:]))
        if self.batch_mode != "split":
            aux = tuple(own_rows(a, self.mesh, self._pool_axes()) for a in aux)
        new_state = out[0]
        if self.mesh.device_mesh is not None:
            new_state = tree_map_with_path(self._placed, new_state)
        return (new_state, out[1]) + aux


def _extent(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    return mesh.extent((entry,) if isinstance(entry, str) else tuple(entry))


def shard_layout(mesh: Mesh, spec_fn: SpecFn, full: Any, modules: Sequence[torch.nn.Module],
                 maker: str) -> Tuple[Dict[Tuple[str, ...], Spec], Optional[ShardContext]]:
    """Each leaf's spec in the tree ``full`` (by path) and the
    :class:`ShardContext` of a computation on its shards (None without a
    process group), the layers of ``modules`` set up to compute on those
    shards (``parallel/shard_compute.py``); every sharded leaf must be a
    param of ``modules`` (``maker`` names the call to pass them to)."""
    from scalerl_torch.parallel.shard_compute import install

    specs: Dict[Tuple[str, ...], Spec] = {}
    axes: Dict[Tuple[str, Tuple[int, ...]], Tuple[str, ...]] = {}

    def record(path, x):
        spec = tuple(spec_fn(path, x))
        specs[path] = spec
        leaf_axes = tuple(a for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        if not leaf_axes or mesh.device_mesh is None:
            return
        local = tuple(n // _extent(mesh, e) for n, e in zip(x.shape, spec + (None,) * x.ndim))
        key = (path[-1], local)
        if axes.setdefault(key, leaf_axes) != leaf_axes:
            raise ValueError(f"state leaves named {path[-1]!r} of local shape {local} are "
                             f"sharded over both {axes[key]} and {leaf_axes}")

    tree_map_with_path(record, full)
    if mesh.device_mesh is None:
        return specs, None
    missing = sorted({name for name, _ in axes} - install(modules, spec_fn))
    if missing:
        raise ValueError(f"sharded leaves {missing} are no param of the modules that compute "
                         f"on them: pass those models to {maker}(modules=...)")
    return specs, ShardContext(mesh, axes)


def make_parallel_learn_fn(learn_fn: Callable, mesh, state_example: Any, batch_example: Any = None,
                           batch_time_major: bool = True, param_specs: Optional[SpecFn] = None,
                           split_batch: bool = True,
                           modules: Sequence[torch.nn.Module] = ()) -> ParallelLearnFn:
    """``learn_fn`` over ``mesh`` with the batch split over ``dp`` x ``fsdp``
    and the state laid out by ``param_specs`` (a function of a leaf's path
    and value: the mp table of ``parallel/logical.py`` for the transformer
    family), else by the heuristic fsdp/tp rule; ``modules`` are the models
    ``learn_fn`` runs, set up to compute on their shards.

    The JAX function donates the pre-update state; here the step builds new
    tensors, and the old state is freed when the caller drops it."""
    return ParallelLearnFn(learn_fn, resolve_mesh(mesh), state_example, batch_example,
                           batch_time_major, param_specs, split_batch, modules)


def maybe_enable_mesh_from_args(agent, args, batch_mode: str = "local") -> bool:
    """Resolve ``RLArguments``' ``mesh_shape``/``dp_size``/``mp_size`` into
    a mesh and enable it on the agent.  A no-op (False) when no mesh is
    asked for, the agent has no ``enable_mesh`` or already has a mesh, so
    every trainer calls it at construction.  The agent's meshed step
    (whichever call enabled it) is put in ``batch_mode``
    (:class:`ParallelLearnFn`): ``"local"`` for a trainer that feeds each
    rank the batches that rank collected, ``"replay_shard"`` for one that
    feeds it the rows of its replay shard."""
    if batch_mode not in BATCH_MODES:
        raise ValueError(f"batch_mode must be one of {BATCH_MODES}, got {batch_mode!r}")
    spec = mesh_spec_from_args(args)
    enabled = False
    if (spec is not None and hasattr(agent, "enable_mesh")
            and getattr(agent, "mesh", None) is None):
        agent.enable_mesh(spec)
        enabled = True
    learn = getattr(agent, "_learn", None)
    if isinstance(learn, ParallelLearnFn):
        learn.batch_mode = batch_mode
    return enabled


def multi_rank(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans more than one process."""
    return mesh is not None and mesh.device_mesh is not None and dist.get_world_size() > 1


class RankAgreement:
    """What the ranks of a meshed trainer must decide alike (stop, save,
    the frame count those hang on), summed over every rank in one small
    all-reduce: every rank must take the same learn steps and issue the
    same collectives.  :meth:`__call__` returns the global count and each
    flag set on any rank; without a mesh of several ranks, the local
    values."""

    def __init__(self, mesh: Optional[Mesh]) -> None:
        self.device = mesh.device_type if multi_rank(mesh) else None

    def __call__(self, count: int, *flags: bool) -> Tuple:
        if self.device is None:
            return (count,) + tuple(bool(f) for f in flags)
        t = torch.tensor([count] + [int(bool(f)) for f in flags], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t)
        total, *any_set = t.tolist()
        return (total,) + tuple(v > 0 for v in any_set)

    def least(self, count: int) -> int:
        """The smallest of the ranks' ``count``s (one all-reduce)."""
        if self.device is None:
            return count
        t = torch.tensor([count], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())


def place_agent_state(agent, state: Any) -> Any:
    """A full state (a restored checkpoint) in the meshed agent's layout;
    as it is without a mesh."""
    if getattr(agent, "mesh", None) is None:
        return state
    return agent._learn.shard_state(state)


def enable_offpolicy_mesh(agent, mesh_or_spec) -> None:
    """The data-parallel learn step of the off-policy agents (DQN, SAC,
    TD3): ``agent.args.batch_size``, ``agent.state`` and ``agent._learn``,
    ``(state, batch) -> (state, metrics, td_abs)``.  The replay batch splits
    over ``dp`` x ``fsdp``, big params over ``fsdp``/``tp`` where they
    divide, and the per-sample |TD| comes back replicated for the PER
    write-back.  Sets ``agent.mesh`` and ``agent._shard_batch``, re-lays
    out ``agent.state`` and makes ``agent._learn`` the sharded step."""
    mesh = resolve_mesh(mesh_or_spec)
    n_batch_shards = mesh.extent(BATCH_AXES)
    if agent.args.batch_size % n_batch_shards != 0:
        raise ValueError(
            f"batch_size ({agent.args.batch_size}) must divide by the mesh's dp*fsdp extent "
            f"({n_batch_shards}) to shard the replay batch")
    models = [m for m in vars(agent).values() if isinstance(m, torch.nn.Module)]
    plearn = make_parallel_learn_fn(agent._learn, mesh, agent.state, batch_time_major=False,
                                    modules=models)
    agent.mesh = mesh
    agent.state = plearn.shard_state(agent.state)
    agent._shard_batch = plearn.shard_batch
    agent._learn = plearn


def make_parallel_act_fn(act_fn: Callable[..., Any], mesh, params_example: Any,
                         param_specs: Optional[SpecFn] = None,
                         modules: Sequence[torch.nn.Module] = ()) -> Callable[..., Any]:
    """An inference function ``(params, *batch) -> ...`` for mesh serving
    that computes on shards, as the JAX one runs jitted on the placed
    params: ``.shard_params`` places params by ``param_specs`` (default the
    fsdp/tp rule; the mp table of ``parallel/logical.py`` puts a
    transformer on each rank's own heads) and ``.shard_batch`` takes this
    rank's rows (dim 0 over ``dp`` x ``fsdp``).  The call runs ``act_fn``
    on the params' local shards and the rank's rows with no autograd
    (``parallel/shard_compute.py::call_on_shards``; ``modules`` are the
    models ``act_fn`` runs through ``functional_call``, set up to compute
    on their shards) and returns the rank's rows of the result; no param
    is gathered whole.  The layers issue collectives, so every rank must
    call it in the same order: single-threaded callers only.  Actor threads
    act on ``MeshedAgentState``'s gathered copy instead."""
    from scalerl_torch.parallel.shard_compute import call_on_shards

    mesh = resolve_mesh(mesh)
    spec_fn = param_specs if param_specs is not None else param_spec_fn(params_example, mesh)
    _, ctx = shard_layout(mesh, spec_fn, gather_tree(params_example), modules,
                          "make_parallel_act_fn")

    def act(params, *batch):
        return call_on_shards(ctx, act_fn, params, *batch)

    act.shard_params = lambda p: place_tree(p, spec_fn, mesh)  # type: ignore[attr-defined]
    act.shard_batch = lambda b: shard_batch(b, mesh, batch_dim=0)  # type: ignore[attr-defined]
    return act


def save_sharded(agent, path: str) -> str:
    """Save a meshed agent's state gathered to full tensors through
    ``make_shard_and_gather_fns`` (every rank gathers; rank 0 writes, then
    every rank waits for the write)."""
    from scalerl_torch.parallel.logical import apply_fns, make_shard_and_gather_fns
    from scalerl_torch.utils.checkpoint import save_checkpoint

    _, gather_fns = make_shard_and_gather_fns(agent._learn.state_sharding, agent.mesh)
    full = apply_fns(gather_fns, agent.state)
    out = path
    if not dist.is_initialized() or dist.get_rank() == 0:
        out = save_checkpoint(path, full)
    if dist.is_initialized():
        dist.barrier()
    return out


def load_sharded(agent, path: str) -> Any:
    """A meshed agent's state from ``path``: restored full, then placed in
    the agent's layout through ``make_shard_and_gather_fns``."""
    from scalerl_torch.parallel.logical import apply_fns, make_shard_and_gather_fns
    from scalerl_torch.utils.checkpoint import load_checkpoint

    shard_fns, _ = make_shard_and_gather_fns(agent._learn.state_sharding, agent.mesh)
    return apply_fns(shard_fns, load_checkpoint(path, gather_tree(agent.state)))
