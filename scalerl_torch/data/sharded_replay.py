"""Mesh-sharded prioritized replay: Ape-X and R2D2 memory split over ranks.

Port of ``scalerl_tpu/data/sharded_replay.py``.  The big planes shard over
the mesh's ``dp`` x ``fsdp`` ranks (the replay shards, linearised
row-major, dp the most significant):

- **transitions** (Ape-X): the env-lane axis shards, so a rank holds the
  ``[capacity, num_envs / S, ...]`` block of its lanes;
- **sequences** (R2D2): the capacity ring shards, so a rank holds its
  ``[capacity / S, ...]`` block of slots.

The JAX package drives every device from one process and lets GSPMD turn
global inserts and write-backs into shard-local writes.  PyTorch runs one
process a device, so each rank keeps only its own block and writes only
its own slots; the cursors (``pos``, ``size``: host ints) and
``max_priority`` are the same on every rank, and the state gathered over
the shards (:meth:`full_state`) equals the unsharded buffer's, value for
value.  Ranks that differ only in mp hold the same shard and draw alike.

Two forms of insert and write-back:

- the JAX methods' (``save_to_memory``, ``add_with_priorities``,
  ``add``, ``update_priorities``) take the GLOBAL arguments, the same on
  every rank, and each rank keeps the part that lands in its block;
- the trainers' (``add_shard_with_priorities``, ``update_shard_priorities``)
  take this shard's rows only and share the running max priority over the
  shards with one all-reduce.

Sampling is two-level stratified, as in the JAX module: each shard draws
``B / S`` rows with the proportional search (``ops/per.py``; ``pallas``
is the CUDA sample kernel) over its own ``p^alpha`` mass, the per-draw
probability is ``q_i = p_i / M_s / S``, the valid count is known on the
host (the cursors are global) and the largest importance weight is
all-reduced (max) over the shards.  Each rank gets its own ``B / S`` rows,
their indices in global numbering.  ``u`` injects a shard's uniforms (the
JAX draws ``jax.random.uniform(fold_in(key, shard), (B / S,))``); without
it they come from a generator seeded from ``seed`` (rank 0's) and the
SHARD index (``parallel/sharding.py::shard_seed``), so shard 0 draws what
the unsharded buffer draws from ``seed``.

The collectives span the replay shards only: one all-reduce a mesh dim of
``dp`` and ``fsdp`` (``axes_all_reduce``), never the world, so mp ranks
are not counted twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scalerl_torch.data.prioritized import (
    PrioritizedState,
    per_add,
    per_add_with_priorities,
    per_draw,
    per_init,
    per_update_priorities,
)
from scalerl_torch.data.replay import as_step, gather_transitions, transition_spec
from scalerl_torch.data.sequence_replay import (
    SequenceReplayState,
    seq_init,
    seq_update_priorities_keep_empty,
)
from scalerl_torch.ops.per import (
    SAMPLE_METHODS,
    UPDATE_METHODS,
    proportional_sample,
    update_priorities_blocks,
)
from scalerl_torch.parallel.mesh import resolve_mesh
from scalerl_torch.parallel.sharding import (
    agreed_seed,
    axes_all_reduce,
    flat_index,
    gather_batch,
    shard_seed,
)
from scalerl_torch.utils.platform import DeviceLike, resolve_device


def replay_shard_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes replay shards over: dp and fsdp (where present)."""
    return tuple(a for a in ("dp", "fsdp") if a in mesh.shape)


def _check_method(name: str, method: str, methods: Tuple[str, ...]) -> None:
    if method not in methods:
        raise ValueError(f"{name} must be one of {methods}, got {method!r}")


def _check_batch(batch_size: int, n_shards: int) -> int:
    if batch_size % n_shards != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must divide by the replay shard "
            f"count ({n_shards})"
        )
    return batch_size // n_shards


def _write_owned(flat: torch.Tensor, local: torch.Tensor, owned: Optional[torch.Tensor],
                 values: torch.Tensor, method: str) -> None:
    """Scatter ``values`` into ``flat`` at ``local`` where ``owned`` (None:
    every entry), last-wins in the entries' order, in one update launch
    and with no host read: the other shards' entries go first, each
    writing slot 0's own value back, so they change nothing."""
    if owned is not None:
        order = torch.sort(owned.to(torch.int32), stable=True).indices
        local = torch.where(owned, local, 0)[order]
        values = torch.where(owned, values, flat[0])[order]
    update_priorities_blocks(flat, local, values, method=method)


def _share_max(x: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """``x`` (a 0-dim device tensor) maxed over the replay shards."""
    axes_all_reduce(x.reshape(1), dist.ReduceOp.MAX, mesh, axes)
    return x


# ---------------------------------------------------------------------------
# transitions (Ape-X): env-lane axis sharded


class ShardedPrioritizedReplay:
    """Lane-sharded transition PER over a mesh: ``PrioritizedReplayBuffer``'s
    surface, so ``ApexTrainer`` swaps it in under a meshed agent.
    ``num_envs`` must divide by the mesh's dp x fsdp extent; a rank holds
    the contiguous block of lanes of its shard."""

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        capacity: int,
        mesh,
        num_envs: int,
        obs_dtype: torch.dtype = torch.float32,
        alpha: float = 0.6,
        n_step: int = 1,
        gamma: float = 0.99,
        extra_fields: Optional[Dict[str, Tuple[Tuple[int, ...], torch.dtype]]] = None,
        action_shape: Tuple[int, ...] = (),
        action_dtype: torch.dtype = torch.int64,
        sample_method: str = "hierarchical",
        update_method: str = "xla",
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> None:
        _check_method("sample_method", sample_method, SAMPLE_METHODS)
        _check_method("update_method", update_method, UPDATE_METHODS)
        self.mesh = resolve_mesh(mesh)
        self.axes = replay_shard_axes(self.mesh)
        if not self.axes:
            raise ValueError(
                f"mesh {tuple(self.mesh.shape)} has neither a 'dp' nor an 'fsdp' "
                "axis to shard replay lanes over"
            )
        self.n_shards = self.mesh.extent(self.axes)
        if num_envs % self.n_shards != 0:
            raise ValueError(
                f"num_envs ({num_envs}) must divide by the mesh's dp*fsdp "
                f"extent ({self.n_shards}) to shard the lane axis"
            )
        self.spec = transition_spec(
            obs_shape, obs_dtype, action_dtype=action_dtype,
            action_shape=action_shape, include_boundary=n_step > 1,
        )
        self.spec.update(extra_fields or {})
        self.capacity = capacity
        self.num_envs = num_envs
        self.local_envs = num_envs // self.n_shards
        self.shard = flat_index(self.mesh, self.axes)
        self.lanes = slice(self.shard * self.local_envs, (self.shard + 1) * self.local_envs)
        self.alpha = alpha
        self.n_step = n_step
        self.gamma = gamma
        self.sample_method = sample_method
        self.update_method = update_method
        self.device = resolve_device(device)
        self.state = per_init(self.spec, capacity, self.local_envs, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            shard_seed(agreed_seed(seed, self.mesh), self.shard))

    def __len__(self) -> int:
        return self.state.replay.size * self.num_envs

    def _own_lanes(self, step: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        full = as_step(self.spec, self.num_envs, self.device, step)
        return {k: v[self.lanes] for k, v in full.items()}

    def save_to_memory(self, obs, next_obs, action, reward, done, boundary=None) -> None:
        """Add one global vector step; its new rows get the running max."""
        self.state = per_add(self.state, self._own_lanes(dict(
            obs=obs, next_obs=next_obs, action=action, reward=reward, done=done,
            boundary=boundary)))

    def add_with_priorities(self, step: Mapping[str, Any], priorities) -> None:
        """Add one global vector step with its ``[num_envs]`` priorities."""
        p = torch.as_tensor(priorities, device=self.device).to(torch.float32).clamp_min(1e-6)
        top = torch.maximum(self.state.max_priority, p.max())
        state = per_add_with_priorities(self.state, self._own_lanes(step), p[self.lanes])
        self.state = dataclasses.replace(state, max_priority=top)

    def add_shard_with_priorities(self, step: Mapping[str, Any], priorities) -> None:
        """Add this shard's lane block of one global step (``[num_envs /
        S, ...]``, alike on the ranks of the shard) with its priorities; the
        ranks of every shard add in lockstep."""
        step = as_step(self.spec, self.local_envs, self.device, step)
        state = per_add_with_priorities(self.state, step,
                                        torch.as_tensor(priorities, device=self.device))
        _share_max(state.max_priority, self.mesh, self.axes)
        self.state = state

    def _local_flat(self, idx: torch.Tensor) -> torch.Tensor:
        """Global flat physical indices as this block's (right for the
        lanes of this shard); one shard's are the global ones."""
        if self.n_shards == 1:
            return idx
        row, lane = idx // self.num_envs, idx % self.num_envs
        return row * self.local_envs + lane - self.shard * self.local_envs

    def update_priorities(self, indices, priorities) -> None:
        """Write back at GLOBAL flat physical indices (``row * num_envs +
        lane``), the same on every rank: each rank writes its lanes."""
        idx = torch.as_tensor(indices, device=self.device).to(torch.int64)
        p = torch.as_tensor(priorities, device=self.device).to(torch.float32).clamp_min(1e-6)
        owned = None
        if self.n_shards > 1:
            owned = (idx % self.num_envs) // self.local_envs == self.shard
        _write_owned(self.state.priorities.view(-1), self._local_flat(idx), owned, p,
                     self.update_method)
        self.state = dataclasses.replace(
            self.state, max_priority=torch.maximum(self.state.max_priority, p.max()))

    def update_shard_priorities(self, indices: torch.Tensor, priorities: torch.Tensor) -> None:
        """Write back this shard's own sampled rows (global indices, as
        :meth:`sample` returned them); the running max is shared."""
        idx = torch.as_tensor(indices, device=self.device).to(torch.int64)
        state = per_update_priorities(self.state, self._local_flat(idx),
                                      priorities.to(torch.float32), method=self.update_method)
        _share_max(state.max_priority, self.mesh, self.axes)
        self.state = state

    def sample(self, batch_size: int, beta: float = 0.4,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """This shard's ``batch_size / S`` rows of a stratified sample, with
        global ``indices`` and globally normalised ``weights``.  ``u``: the
        shard's ``[batch_size / S]`` uniforms, else drawn from
        ``generator`` (default: the buffer's shard generator)."""
        b_local = _check_batch(batch_size, self.n_shards)
        if u is None:
            u = torch.rand(b_local, generator=generator or self.generator, device=self.device)
        flat_logical, q, n_rows = per_draw(self.state, u.to(self.device), self.alpha,
                                           self.n_step, self.sample_method)
        if self.n_shards > 1:
            q = q / self.n_shards  # the per-draw probability of the two-level scheme
        n_valid = float(max(n_rows * self.num_envs, 1))
        weights = (n_valid * q.clamp_min(1e-12)) ** (-float(beta))
        wmax = _share_max(weights.max(), self.mesh, self.axes)
        weights = weights / wmax.clamp_min(1e-12)
        L = self.local_envs
        batch = gather_transitions(self.state.replay, flat_logical // L, flat_logical % L,
                                   self.n_step, self.gamma)
        if self.n_shards > 1:  # the physical index from local to GLOBAL lane numbering
            row0, env_l = batch["indices"] // L, batch["indices"] % L
            batch["indices"] = row0 * self.num_envs + self.shard * L + env_l
        batch["weights"] = weights
        return batch

    # -- the whole buffer -------------------------------------------------
    def full_state(self) -> PrioritizedState:
        """The state gathered over the replay shards (every rank of them
        takes part): the unsharded buffer's state."""
        replay = self.state.replay
        storage = {k: gather_batch(v, self.mesh, 1, self.axes) for k, v in replay.storage.items()}
        return PrioritizedState(
            replay=dataclasses.replace(replay, storage=storage),
            priorities=gather_batch(self.state.priorities, self.mesh, 1, self.axes),
            max_priority=self.state.max_priority.clone(),
        )

    def load_full_state(self, full: PrioritizedState) -> None:
        """Take this rank's lane block of a whole state (a restored
        checkpoint)."""
        replay = full.replay
        storage = {k: v[:, self.lanes].to(self.device).clone() for k, v in replay.storage.items()}
        self.state = PrioritizedState(
            replay=dataclasses.replace(replay, storage=storage),
            priorities=full.priorities[:, self.lanes].to(self.device).clone(),
            max_priority=full.max_priority.to(self.device).clone(),
        )


# ---------------------------------------------------------------------------
# sequences (R2D2): capacity ring sharded


def seq_sample_sharded_local(
    state: SequenceReplayState,
    u: torch.Tensor,
    b_local: int,
    *,
    mesh,
    axes: Tuple[str, ...],
    n_shards: int,
    local_capacity: int,
    alpha: float = 0.6,
    beta: float = 0.4,
    global_size: Optional[int] = None,
    method: str = "hierarchical",
):
    """One shard's sequence sample: ``(fields, core, idx, weights)`` from
    this rank's capacity block ``state`` (``[capacity / S, ...]``), ``idx``
    in GLOBAL slot numbering, the weights normalised over the shards
    (exact per-draw ``q``, the max all-reduced over ``axes``).  ``u``: the
    shard's ``[b_local]`` uniforms.

    ``global_size``: the live sequences of all shards, the weights' ``N``;
    default ``state.size``, right when the cursor walks the GLOBAL ring
    (:class:`ShardedSequenceReplay`).  A loop whose shards keep rings of
    their own passes the sum of their sizes."""
    shard = flat_index(mesh, axes)
    device = state.priorities.device
    scaled = torch.pow(state.priorities, alpha)  # empty slots: 0^a = 0
    m_local = scaled.sum()
    targets = (torch.arange(b_local, device=device) + u) / b_local * m_local
    idx = proportional_sample(scaled, targets, method=method)

    q = scaled[idx] / m_local.clamp(min=1e-9)
    if n_shards > 1:
        q = q / n_shards
    n = max(float(state.size if global_size is None else global_size), 1.0)
    weights = torch.pow(n * q.clamp(min=1e-9), -beta)
    # a shard whose block the ring has not reached (or an empty slot at a
    # cumsum edge) has no mass there: zero the weights of such draws, and
    # keep them out of the max that normalises the rest
    weights = torch.where(q > 0, weights, 0.0)
    wmax = _share_max(weights.max(), mesh, axes)
    weights = weights / wmax.clamp(min=1e-9)

    fields = {name: arr[idx] for name, arr in state.storage.items()}
    core = tuple((c[idx], h[idx]) for c, h in state.core)
    return fields, core, idx if n_shards == 1 else shard * local_capacity + idx, weights


class ShardedSequenceReplay:
    """Capacity-sharded sequence PER over a mesh (R2D2 across ranks).

    ``add`` / ``sample`` / ``update_priorities`` as the JAX class has them.
    The ring cursor walks the GLOBAL capacity, so inserts sweep the shard
    blocks in turn; ``state`` is this rank's block, its ``pos`` and
    ``size`` the global cursors."""

    def __init__(
        self,
        field_shapes: Mapping[str, Tuple[Tuple[int, ...], Any]],
        core_shapes: Sequence[Tuple[int, ...]],
        capacity: int,
        mesh,
        alpha: float = 0.6,
        beta: float = 0.4,
        sample_method: str = "hierarchical",
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> None:
        _check_method("sample_method", sample_method, SAMPLE_METHODS)
        self.mesh = resolve_mesh(mesh)
        self.axes = replay_shard_axes(self.mesh)
        if not self.axes:
            raise ValueError(
                f"mesh {tuple(self.mesh.shape)} has neither a 'dp' nor an 'fsdp' "
                "axis to shard sequence capacity over"
            )
        self.n_shards = self.mesh.extent(self.axes)
        if capacity % self.n_shards != 0:
            raise ValueError(
                f"capacity ({capacity}) must divide by the mesh's dp*fsdp "
                f"extent ({self.n_shards}) to shard the ring"
            )
        self.capacity = capacity
        self.local_capacity = capacity // self.n_shards
        self.shard = flat_index(self.mesh, self.axes)
        self.lo = self.shard * self.local_capacity
        self.alpha = alpha
        self.beta = beta
        self.sample_method = sample_method
        self.device = resolve_device(device)
        self.state = seq_init(field_shapes, core_shapes, self.local_capacity, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            shard_seed(agreed_seed(seed, self.mesh), self.shard))

    def __len__(self) -> int:
        return self.state.size

    def _runs(self, B: int):
        """``(dst, src)`` slice pairs of a ``B``-unit insert at the cursor
        that land in this rank's block: the ring wraps at most once, so the
        insert is at most two runs of global slots."""
        pos, cap, lo, hi = self.state.pos, self.capacity, self.lo, self.lo + self.local_capacity
        out = []
        for a, b, off in ((pos, min(pos + B, cap), 0), (0, pos + B - cap, cap - pos)):
            s, e = max(a, lo), min(b, hi)
            if s < e:
                out.append((slice(s - lo, e - lo), slice(off + s - a, off + e - a)))
        return out

    def add(self, batch: Mapping[str, Any], core: Sequence[Tuple[Any, Any]], priorities) -> None:
        """Insert a global batch of ``B`` units (the same on every rank) at
        the ring cursor; each rank writes the slots of its block."""
        B = int(priorities.shape[0])
        if B > self.capacity:
            raise ValueError(f"insert of {B} units exceeds the replay capacity {self.capacity}")
        st = self.state
        planes = [(arr, batch[name]) for name, arr in st.storage.items()]
        for (c, h), (bc, bh) in zip(st.core, core):
            planes += [(c, bc), (h, bh)]
        planes.append((st.priorities, priorities))
        for dst, src in self._runs(B):
            for arr, value in planes:
                value = torch.as_tensor(value)
                arr[dst].copy_(value[src].to(device=arr.device, dtype=arr.dtype))
        self.state = dataclasses.replace(st, pos=(st.pos + B) % self.capacity,
                                         size=min(st.size + B, self.capacity))

    def update_priorities(self, idx, priorities) -> None:
        """Keep-empty write-back at GLOBAL slots, the same on every rank:
        a draw of an empty slot (zero weight) does not make it live."""
        local = torch.as_tensor(idx, device=self.device).to(torch.int64)
        p = torch.as_tensor(priorities, device=self.device).to(torch.float32)
        owned = None
        if self.n_shards > 1:
            owned = (local // self.local_capacity) == self.shard
            local = torch.where(owned, local - self.lo, 0)
        prio = self.state.priorities
        eff = torch.where(prio[local] > 0, p.clamp(min=1e-6), 0.0)
        _write_owned(prio, local, owned, eff, "xla")

    def max_over_shards(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-dim device tensor maxed over the replay shards, in place."""
        return _share_max(x, self.mesh, self.axes)

    def update_shard_priorities(self, idx: torch.Tensor, priorities: torch.Tensor) -> None:
        """Keep-empty write-back of this shard's own sampled rows."""
        local = idx if self.n_shards == 1 else idx - self.lo
        self.state = seq_update_priorities_keep_empty(self.state, local, priorities)

    def sample(self, batch_size: int, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None):
        """This shard's ``batch_size / S`` sequences (see
        :func:`seq_sample_sharded_local`)."""
        b_local = _check_batch(batch_size, self.n_shards)
        if u is None:
            u = torch.rand(b_local, generator=generator or self.generator, device=self.device)
        return seq_sample_sharded_local(
            self.state, u.to(self.device), b_local, mesh=self.mesh, axes=self.axes,
            n_shards=self.n_shards, local_capacity=self.local_capacity, alpha=self.alpha,
            beta=self.beta, method=self.sample_method)

    # -- the whole buffer -------------------------------------------------
    def full_state(self) -> SequenceReplayState:
        """The ring gathered over the replay shards (every rank of them
        takes part): the unsharded ring's state."""
        st = self.state

        def whole(x):
            return gather_batch(x, self.mesh, 0, self.axes)

        return SequenceReplayState(
            storage={k: whole(v) for k, v in st.storage.items()},
            core=tuple((whole(c), whole(h)) for c, h in st.core),
            priorities=whole(st.priorities), pos=st.pos, size=st.size,
        )

    def load_full_state(self, full: SequenceReplayState) -> None:
        """Take this rank's block of a whole ring (a restored checkpoint)."""
        block = slice(self.lo, self.lo + self.local_capacity)

        def mine(x):
            return x[block].to(self.device).clone()

        self.state = SequenceReplayState(
            storage={k: mine(v) for k, v in full.storage.items()},
            core=tuple((mine(c), mine(h)) for c, h in full.core),
            priorities=mine(full.priorities), pos=int(full.pos), size=int(full.size),
        )
