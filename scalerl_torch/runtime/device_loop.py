"""The fused on-device actor-learner loop (the flagship throughput path).

Port of the single-device ``scalerl_tpu/runtime/device_loop.py::
DeviceActorLearnerLoop``: each chunk runs ``iters_per_call`` iterations of
(env step -> policy forward -> action sample, over ``unroll_length`` steps)
then one V-trace learn step, all on the device, and the host reads the
chunk's metrics with one batched copy, ``chunks_in_flight - 1`` chunks
behind the dispatch.  Within an iteration the behaviour policy equals the
target policy (V-trace rhos = 1).

The JAX package compiles a chunk into one XLA program; PyTorch runs it
eagerly, op by op, from this Python loop, and no operation in a warm chunk
synchronises with the host: ``run`` holds every chunk after the loop's
first under ``torch.cuda.set_sync_debug_mode("error")``.  Actions come from
the loop's own ``torch.Generator`` (Gumbel-max, replacing
``jax.random.categorical``), so the stream differs from JAX's for the same
seed.

:meth:`DeviceActorLearnerLoop.run_anakin` drives N chunks as one dispatch
(Anakin): on a CUDA device :meth:`~DeviceActorLearnerLoop.train_superchunk`
replays one ``torch.cuda.CUDAGraph`` holding the N chunks, the twin of the
JAX package's one XLA program for N chunks; on the CPU it runs the N chunks
eagerly, the same Python as :meth:`~DeviceActorLearnerLoop.run`'s body.
The graph is captured once per N, after one warm eager chunk run on copies
(cuDNN's algorithm search and the first allocations happen there), with the
loop's generator registered so that every replay advances it as the eager
chunks would: a replay from a given state, carry and generator state draws
what the eager chunks draw.  State and carry live in the graph's own
buffers, which the graph overwrites with the new ones at its end, so the
state and carry a replay returns are overwritten by the next (the twin of
the JAX inputs' donation).

:meth:`DeviceActorLearnerLoop.run_until` drives chunks until the windowed
mean episode return reaches a threshold; the reference's learning curves
(``examples/curves/common.py``) run on it.  Both take the
reference's supervision hooks: ``progress`` (a supervisor
``ProgressCounter`` bumped per dispatched chunk, the stall watchdog's
source), ``should_stop`` (polled before each dispatch; the preemption
guard's flag) and ``instrument`` (feed each chunk's host metrics and the
``rates.fps`` / ``rates.chunks_per_s`` meters into the telemetry registry),
and mark each chunk for ``utils/profiling.py``'s traces.

``mesh=`` runs the loop data-parallel (the JAX ``shard_map`` path, the
Podracer "Anakin" layout): each rank steps its ``num_envs / n`` lanes and
carry (``n`` the extent of ``axis_name``) and draws from its own generator
(rank r along the axis from ``shard_seed(seed, r)``, ``seed`` rank 0's:
rank 0 keeps the loop's stream, so a one-rank mesh is the unmeshed loop bit
for bit).  The learn function runs inside
``parallel.sharding.batch_reduction(mesh, (axis_name,))``: its gradients,
batch sums and means and frame count span the axis (the JAX learn
function's ``psum``/``pmean`` over its ``grad_axis``), so every rank keeps
the same params.  Any learn function of the port's agents serves as it is,
so there is no unsynced one for the loop to refuse, as the JAX loop does.
The episode sums are summed over the axis.  A ``should_stop`` set on any
rank stops every rank.  ``train_superchunk`` and ``run_anakin`` refuse a
mesh, as the JAX loop's do: no collective is captured in a graph.
``iter_mode`` has no twin: it picks between ``lax.scan`` and an unrolled body for XLA, and a
Python loop (or a graph captured from one) has one form.
"""

from __future__ import annotations

import copy
import math
from contextlib import nullcontext
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from scalerl_torch.agents.impala import ImpalaTrainState, sample_categorical
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.parallel.mesh import resolve_mesh
from scalerl_torch.parallel.sharding import (
    agreed_seed,
    axes_all_reduce,
    batch_reduction,
    shard_seed,
)
from scalerl_torch.parallel.train_step import RankAgreement
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics, pipelined_drive, steady_state_guard
from scalerl_torch.utils.platform import DeviceLike, resolve_device
from scalerl_torch.utils.profiling import step_marker
from scalerl_torch.utils.tree import tree_leaves, tree_map

LearnFn = Callable[[ImpalaTrainState, Trajectory], Tuple[ImpalaTrainState, Dict]]


class ActorCarry(NamedTuple):
    """Per-env actor state threaded across rollout chunks ([B]-leading)."""

    env_state: Any
    obs: torch.Tensor  # [B, ...]
    last_action: torch.Tensor  # [B]
    reward: torch.Tensor  # [B]
    done: torch.Tensor  # [B]
    core_state: Any  # model recurrent state
    episode_return: torch.Tensor  # [B] running return accumulator
    return_sum: torch.Tensor  # [B] per-env sum of completed-episode returns
    episode_count: torch.Tensor  # [B] per-env completed-episode count


class DeviceActorLearnerLoop:
    def __init__(
        self,
        model: torch.nn.Module,
        venv: TensorEnv,
        learn_fn: LearnFn,
        unroll_length: int,
        iters_per_call: int = 10,
        seed: int = 0,
        device: DeviceLike = "cuda",
        mesh=None,
        axis_name: str = "dp",
    ) -> None:
        """``venv`` must live on ``device``; ``seed`` seeds the loop's
        generator, which draws the env resets, env steps and actions.

        ``mesh``: shard the loop over the mesh axis ``axis_name`` (module
        docstring); ``venv`` holds the lanes of every rank, and
        ``venv.num_envs`` must divide by the axis size."""
        self.device = resolve_device(device)
        if venv.device != self.device:
            raise ValueError(f"venv is on {venv.device}, the loop on {self.device}")
        self.model = model
        self.venv = venv
        self.learn_fn = learn_fn
        self.unroll_length = unroll_length
        self.iters_per_call = iters_per_call
        self.mesh = None if mesh is None else resolve_mesh(mesh)
        self.axis_name = axis_name
        # the lanes this rank steps: all of them without a mesh
        self.local_venv = venv
        rank = 0
        if self.mesh is not None:
            n = self.mesh.shape[axis_name]
            if venv.num_envs % n != 0:
                raise ValueError(
                    f"num_envs ({venv.num_envs}) must divide by mesh axis "
                    f"{axis_name!r} size ({n})")
            rank = self.mesh.coordinate(axis_name)
            self.local_venv = copy.copy(venv)
            self.local_venv.num_envs = venv.num_envs // n
        self._agree = RankAgreement(self.mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(
            shard_seed(agreed_seed(seed, self.mesh), rank))
        # the first chunk may synchronise (cuDNN's algorithm search, first
        # allocations); every later one runs under the sync guard
        self._warm = False
        # Anakin: one captured graph per superchunk length, and the lengths
        # whose first run is behind them (their later runs are guarded)
        self._superchunks: Dict[int, _SuperchunkGraph] = {}
        self._superchunk_warm: set = set()

    # ------------------------------------------------------------------
    def init_carry(self) -> ActorCarry:
        """This rank's carry (every lane's without a mesh)."""
        B = self.local_venv.num_envs
        env_state, obs = self.local_venv.reset(self.generator)
        zeros = torch.zeros(B, dtype=torch.float32, device=self.device)
        return ActorCarry(
            env_state=env_state,
            obs=obs,
            last_action=torch.zeros(B, dtype=torch.int64, device=self.device),
            reward=zeros,
            done=torch.ones(B, dtype=torch.bool, device=self.device),
            core_state=self.model.initial_state(B),
            episode_return=zeros,
            return_sum=zeros,
            episode_count=zeros,
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _unroll(self, params, carry: ActorCarry) -> Tuple[ActorCarry, Trajectory]:
        """Collect one [T+1, B] trajectory chunk; row T's logits are unused
        by the learner (behavior_logits[:-1]) and left zero."""
        core0 = carry.core_state
        rows = []
        c = carry
        for _ in range(self.unroll_length):
            out, new_core = functional_call(
                self.model, params,
                (c.obs[None], c.last_action[None], c.reward[None], c.done[None],
                 c.core_state),
            )
            logits = out.policy_logits[0]
            action = sample_categorical(logits, self.generator)
            env_state, next_obs, reward, done = self.local_venv.step(
                c.env_state, action, self.generator
            )
            rows.append((c.obs, c.last_action, c.reward, c.done, logits))
            ep_ret = c.episode_return + reward
            c = ActorCarry(
                env_state=env_state,
                obs=next_obs,
                last_action=action,
                reward=reward,
                done=done,
                core_state=new_core,
                episode_return=torch.where(done, 0.0, ep_ret),
                return_sum=c.return_sum + torch.where(done, ep_ret, 0.0),
                episode_count=c.episode_count + done.to(torch.float32),
            )
        obs_rows, la_rows, rew_rows, done_rows, logit_rows = zip(*rows)
        # final row T from the carry after the loop (logits zero: unused)
        traj = Trajectory(
            obs=torch.stack(obs_rows + (c.obs,)),
            action=torch.stack(la_rows + (c.last_action,)),
            reward=torch.stack(rew_rows + (c.reward,)),
            done=torch.stack(done_rows + (c.done,)),
            logits=torch.stack(logit_rows + (torch.zeros_like(logit_rows[0]),)),
            core_state=core0,
        )
        return c, traj

    # ------------------------------------------------------------------
    def train_chunk(
        self, state: ImpalaTrainState, carry: ActorCarry
    ) -> Tuple[ImpalaTrainState, ActorCarry, Dict[str, torch.Tensor]]:
        """``iters_per_call`` unroll+update iterations; metrics stay on the
        device: the per-iteration learn metrics averaged over the chunk, and
        the episode sums (over every rank of a mesh)."""
        per_iter = []
        reduction = (nullcontext() if self.mesh is None else
                     batch_reduction(self.mesh, (self.axis_name,)))
        with reduction:
            for _ in range(self.iters_per_call):
                carry, traj = self._unroll(state.params, carry)
                state, metrics = self.learn_fn(state, traj)
                per_iter.append(metrics)
        mean_metrics = {
            k: torch.stack([m[k] for m in per_iter]).mean() for k in per_iter[0]
        }
        (mean_metrics["episode_return_sum"],
         mean_metrics["episode_count_sum"]) = self.episode_sums(carry)
        return state, carry, mean_metrics

    def episode_sums(self, carry: ActorCarry) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sum of completed episodes' returns and their count, over
        every rank of the mesh axis (one all-reduce of the pair)."""
        ret, cnt = torch.sum(carry.return_sum), torch.sum(carry.episode_count)
        if self.mesh is None or self.mesh.group(self.axis_name) is None:
            return ret, cnt
        pair = axes_all_reduce(torch.stack([ret, cnt]), dist.ReduceOp.SUM, self.mesh,
                               (self.axis_name,))
        return pair[0], pair[1]

    def _superchunk_eager(self, state, carry, num_chunks: int):
        per_chunk = []
        for _ in range(num_chunks):
            state, carry, m = self.train_chunk(state, carry)
            per_chunk.append(m)
        return state, carry, {k: torch.stack([m[k] for m in per_chunk]) for k in per_chunk[0]}

    def train_superchunk(
        self, state: ImpalaTrainState, carry: ActorCarry, num_chunks: int
    ) -> Tuple[ImpalaTrainState, ActorCarry, Dict[str, torch.Tensor]]:
        """``num_chunks`` chunks as one dispatch (Anakin): one CUDA graph
        replay on a card, the chunks eagerly on the CPU.  Metrics come back
        as device tensors stacked ``[num_chunks]`` per key; read them with
        one ``dispatch.get_metrics`` call.  On a card the returned state and
        carry are the graph's buffers (module docstring).  A mesh is
        refused, as the JAX loop refuses it."""
        if self.mesh is not None:
            raise NotImplementedError(
                "train_superchunk composes with the single-device fused loop; the mesh "
                "path runs a chunk at a time (drive it through run())")
        if self.device.type != "cuda":
            return self._superchunk_eager(state, carry, num_chunks)
        graph = self._superchunks.get(num_chunks)
        if graph is None:
            graph = _SuperchunkGraph(self, state, carry, num_chunks)
            self._superchunks[num_chunks] = graph
        return graph.replay(state, carry)

    def run_anakin(
        self,
        state: ImpalaTrainState,
        carry: ActorCarry,
        num_calls: int,
        on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
        progress=None,
        instrument: bool = True,
    ) -> Tuple[ImpalaTrainState, ActorCarry, Dict[str, float]]:
        """Drive ``num_calls`` chunks as ONE dispatch and ONE batched metric
        read after it.  ``on_metrics(i, metrics)`` fires per chunk, in
        order, with :meth:`run`'s keys; the telemetry meters are marked once
        for the superchunk.  Every call after the first for a given
        ``num_calls`` runs under the sync guard.  The returned metrics are
        the last chunk's, with ``chunks_done`` / ``nonfinite_chunks``."""
        guard = steady_state_guard() if num_calls in self._superchunk_warm else nullcontext()
        with guard:
            with step_marker(0):
                state, carry, stacked = self.train_superchunk(state, carry, num_calls)
            if progress is not None:
                progress.bump()
            host = get_metrics(stacked)  # one batched copy for every chunk
        self._superchunk_warm.add(num_calls)
        tally = _ChunkTally(telemetry.observe_train_metrics if instrument else None, on_metrics)
        for i in range(num_calls):
            # get_metrics gives one-element tensors back as floats: N = 1
            tally.run_chunk(i, {k: float(np.atleast_1d(v)[i]) for k, v in host.items()})
        if instrument:
            reg = telemetry.get_registry()
            reg.meter("rates.chunks_per_s").mark(num_calls)
            reg.meter("rates.fps").mark(self._frames_per_call() * num_calls)
        return state, carry, tally.summary(num_calls)

    def _guard(self):
        """The sync guard once the loop is warm, else nothing."""
        return steady_state_guard() if self._warm else nullcontext()

    def _frames_per_call(self) -> int:
        return self.unroll_length * self.venv.num_envs * self.iters_per_call

    def _drive(self, state, carry, num_calls: int, on_ready: Callable[[int, Dict[str, float]], None],
               depth: int, progress, stop: Callable[[], bool]):
        """Dispatch up to ``num_calls`` chunks through
        :func:`dispatch.pipelined_drive`, each warm chunk under the sync
        guard: ``on_ready(i, host_metrics)`` fires in chunk order ``depth -
        1`` chunks behind, and ``stop()`` is polled before the first
        dispatch and after each read (a True is kept, not polled again).
        Returns the new state and carry and the chunks dispatched."""
        box = [state, carry]
        stopped = False

        def latched() -> bool:
            nonlocal stopped
            stopped = stopped or stop()
            return stopped

        def dispatch(i: int):
            with self._guard(), step_marker(i):
                box[0], box[1], dev_metrics = self.train_chunk(box[0], box[1])
                if progress is not None:
                    progress.bump()
            self._warm = True
            return dev_metrics

        done = 0 if latched() else pipelined_drive(dispatch, num_calls, on_ready, depth, latched)
        return box[0], box[1], done

    # ------------------------------------------------------------------
    def run(
        self,
        state: ImpalaTrainState,
        carry: ActorCarry,
        num_calls: int,
        on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
        chunks_in_flight: int = 2,
        progress=None,
        should_stop: Optional[Callable[[], bool]] = None,
        instrument: bool = True,
    ) -> Tuple[ImpalaTrainState, ActorCarry, Dict[str, float]]:
        """Drive ``num_calls`` chunks, each read back with ONE batched copy
        ``chunks_in_flight - 1`` chunks behind the dispatch (1 reads after
        every chunk).  ``on_metrics(i, metrics)`` fires once per chunk, in
        order.  ``progress`` / ``should_stop`` / ``instrument``: the
        supervision and telemetry hooks (module docstring); after an early
        stop the chunks already in flight still land and count.  The
        returned metrics are the last chunk's, with ``episodes`` /
        ``return_mean`` / ``chunks_done`` (the chunks dispatched: a
        preemption checkpoint records these, not ``num_calls``) /
        ``nonfinite_chunks``."""
        tally = _ChunkTally(self._observer(instrument), on_metrics)
        state, carry, chunks_done = self._drive(
            state, carry, num_calls, tally.run_chunk, chunks_in_flight, progress,
            self._stop_fn(should_stop))
        return state, carry, tally.summary(chunks_done)

    def _stop_fn(self, should_stop: Optional[Callable[[], bool]]) -> Callable[[], bool]:
        """``should_stop`` as the drive polls it: under a mesh of several
        ranks, set on any rank stops every rank (one small all-reduce a
        poll), so the ranks take the same chunks."""
        if should_stop is None:
            return lambda: False
        if self._agree.device is None:
            return should_stop
        return lambda: self._agree(0, should_stop())[1]

    def _observer(self, instrument: bool) -> Optional[Callable[[Dict[str, float]], None]]:
        """Per-chunk registry feed (host floats only), or None."""
        if not instrument:
            return None
        reg = telemetry.get_registry()
        chunk_meter, fps_meter = reg.meter("rates.chunks_per_s"), reg.meter("rates.fps")
        frames_per_call = self._frames_per_call()

        def observe(m: Dict[str, float]) -> None:
            telemetry.observe_train_metrics(m)
            chunk_meter.mark()
            fps_meter.mark(frames_per_call)

        return observe

    # ------------------------------------------------------------------
    def run_until(
        self,
        state: ImpalaTrainState,
        carry: ActorCarry,
        threshold: float,
        max_calls: int,
        on_metrics: Optional[Callable[[int, float, Dict[str, float]], None]] = None,
        chunks_in_flight: int = 2,
        should_stop: Optional[Callable[[], bool]] = None,
        progress=None,
        instrument: bool = True,
    ) -> Tuple[ImpalaTrainState, ActorCarry, Dict[str, Any]]:
        """Drive chunks until the *windowed* mean episode return (over the
        episodes completed since the previous chunk that completed any)
        reaches ``threshold``, or ``max_calls`` chunks have run.

        ``should_stop`` is polled before each dispatch; True stops cleanly;
        ``progress`` and ``instrument`` as in :meth:`run`.
        Metrics are read ``chunks_in_flight - 1`` chunks behind the
        dispatch, so a hit stops further dispatch but the chunks already in
        flight still land: they count in ``frames`` and in the returned
        state.  The metric stream (chunk order, values, and the frames
        passed to ``on_metrics(frames, windowed_return, chunk_metrics)``) is
        the same for every ``chunks_in_flight``.  Returns ``(state, carry,
        summary)``, the summary with ``windowed_return`` / ``frames`` /
        ``hit`` / ``nonfinite_chunks``."""
        frames_per_call = self._frames_per_call()
        stop = self._stop_fn(should_stop)
        ret, cnt = self.episode_sums(carry)
        init = get_metrics({"s": ret, "c": cnt})
        prev_sum, prev_cnt = init["s"], init["c"]
        windowed = math.nan
        hit = False
        tally = _ChunkTally(self._observer(instrument))

        def consume(i: int, m: Dict[str, float]) -> None:
            nonlocal windowed, prev_sum, prev_cnt, hit
            tally.add(m)
            s, c = m["episode_return_sum"], m["episode_count_sum"]
            if c > prev_cnt:
                windowed = (s - prev_sum) / (c - prev_cnt)
                prev_sum, prev_cnt = s, c
            if on_metrics is not None:
                on_metrics((i + 1) * frames_per_call, windowed, dict(m))
            if windowed >= threshold:
                hit = True

        state, carry, dispatched = self._drive(
            state, carry, max_calls, consume, chunks_in_flight, progress,
            lambda: hit or stop())
        summary = {
            "windowed_return": windowed,
            "frames": float(dispatched * frames_per_call),
            "hit": hit,
            "nonfinite_chunks": float(tally.nonfinite_chunks),
        }
        return state, carry, summary


class _ChunkTally:
    """The per-chunk consume that ``run``, ``run_until`` and ``run_anakin``
    share: :meth:`add` feeds a chunk's host metrics to ``observe`` and
    counts the chunks whose update the non-finite guard skipped;
    :meth:`run_chunk` also renames the episode sums to ``run``'s keys
    (``episodes``, ``return_mean``) and hands the chunk to ``on_metrics``;
    :meth:`summary` is the last such chunk with ``chunks_done`` /
    ``nonfinite_chunks``."""

    def __init__(self, observe: Optional[Callable[[Dict[str, float]], None]] = None,
                 on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None) -> None:
        self.observe = observe
        self.on_metrics = on_metrics
        self.nonfinite_chunks = 0
        self.last: Dict[str, float] = {}

    def add(self, m: Dict[str, float]) -> None:
        if self.observe is not None:
            self.observe(m)
        if m.get("skipped_steps", 0.0) > 0.0:
            self.nonfinite_chunks += 1

    def run_chunk(self, i: int, host_m: Dict[str, float]) -> None:
        m = dict(host_m)
        self.add(m)
        m["episodes"] = m.pop("episode_count_sum")
        m["return_mean"] = m.pop("episode_return_sum") / max(m["episodes"], 1.0)
        self.last = m
        if self.on_metrics is not None:
            self.on_metrics(i, m)

    def summary(self, chunks_done: int) -> Dict[str, float]:
        self.last["chunks_done"] = float(chunks_done)
        self.last["nonfinite_chunks"] = float(self.nonfinite_chunks)
        return self.last


class _SuperchunkGraph:
    """``num_chunks`` chunks of a loop captured as one ``torch.cuda.CUDAGraph``.

    The capture follows one warm eager chunk, run on copies of the state
    and carry on a side stream, after which the loop's generator is set
    back, so the warm-up draws nothing the caller sees.  The graph reads
    the state and carry from its own static buffers and copies the new ones
    back into them at its end; the metrics are one stacked ``[keys, N]``
    buffer, cloned after each replay.  A capture that fails raises."""

    def __init__(self, loop: DeviceActorLearnerLoop, state, carry, num_chunks: int) -> None:
        gen = loop.generator
        saved = gen.get_state()
        main = torch.cuda.current_stream(loop.device)
        side = torch.cuda.Stream(device=loop.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loop.train_chunk(tree_map(torch.clone, state), tree_map(torch.clone, carry))
        main.wait_stream(side)
        gen.set_state(saved)
        self.state = tree_map(torch.clone, state)
        self.carry = tree_map(torch.clone, carry)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph):
            new_state, new_carry, stacked = loop._superchunk_eager(
                self.state, self.carry, num_chunks)
            for dst, src in zip(self._leaves(), tree_leaves((new_state, new_carry))):
                dst.copy_(src)
            self.keys = list(stacked)
            self.metrics = torch.stack([stacked[k].to(torch.float32) for k in self.keys])

    def _leaves(self):
        return tree_leaves((self.state, self.carry))

    def replay(self, state, carry):
        leaves, given = self._leaves(), tree_leaves((state, carry))
        if len(leaves) != len(given):
            raise ValueError(
                f"the superchunk was captured for {len(leaves)} state and carry tensors, "
                f"got {len(given)}")
        for dst, src in zip(leaves, given):
            if src is not dst:
                dst.copy_(src)
        self.graph.replay()
        metrics = self.metrics.clone()
        return self.state, self.carry, {k: metrics[i] for i, k in enumerate(self.keys)}
