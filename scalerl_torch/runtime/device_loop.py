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

:meth:`DeviceActorLearnerLoop.run_until` drives chunks until the windowed
mean episode return reaches a threshold; the reference's learning curves
(``examples/curves/common.py``) run on it.  Both take the
reference's supervision hooks: ``progress`` (a supervisor
``ProgressCounter`` bumped per dispatched chunk, the stall watchdog's
source), ``should_stop`` (polled before each dispatch; the preemption
guard's flag) and ``instrument`` (feed each chunk's host metrics and the
``rates.fps`` / ``rates.chunks_per_s`` meters into the telemetry registry),
and mark each chunk for ``utils/profiling.py``'s traces.

Not ported yet: the mesh (``shard_map``) path, ``train_superchunk`` /
``run_anakin`` (one program for N chunks) and ``iter_mode`` (a Python loop
needs none).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import math

import torch
from torch.func import functional_call

from scalerl_torch.agents.impala import ImpalaTrainState, sample_categorical
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import MetricsPipeline, get_metrics, steady_state_guard
from scalerl_torch.utils.platform import DeviceLike, resolve_device
from scalerl_torch.utils.profiling import step_marker

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
    ) -> None:
        """``venv`` must live on ``device``; ``seed`` seeds the loop's
        generator, which draws the env resets, env steps and actions."""
        self.device = resolve_device(device)
        if venv.device != self.device:
            raise ValueError(f"venv is on {venv.device}, the loop on {self.device}")
        self.model = model
        self.venv = venv
        self.learn_fn = learn_fn
        self.unroll_length = unroll_length
        self.iters_per_call = iters_per_call
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the first chunk may synchronise (cuDNN's algorithm search, first
        # allocations); every later one runs under the sync guard
        self._warm = False

    # ------------------------------------------------------------------
    def init_carry(self) -> ActorCarry:
        B = self.venv.num_envs
        env_state, obs = self.venv.reset(self.generator)
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
            env_state, next_obs, reward, done = self.venv.step(
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
        the episode sums."""
        per_iter = []
        for _ in range(self.iters_per_call):
            carry, traj = self._unroll(state.params, carry)
            state, metrics = self.learn_fn(state, traj)
            per_iter.append(metrics)
        mean_metrics = {
            k: torch.stack([m[k] for m in per_iter]).mean() for k in per_iter[0]
        }
        mean_metrics["episode_return_sum"] = torch.sum(carry.return_sum)
        mean_metrics["episode_count_sum"] = torch.sum(carry.episode_count)
        return state, carry, mean_metrics

    def _guard(self):
        """The sync guard once the loop is warm, else nothing."""
        return steady_state_guard() if self._warm else nullcontext()

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
        metrics: Dict[str, float] = {}
        nonfinite_chunks = 0
        pipe = MetricsPipeline(depth=chunks_in_flight)
        observe = self._observer(instrument)

        def consume(ready) -> None:
            nonlocal metrics, nonfinite_chunks
            for i, host_m in ready:
                m = dict(host_m)
                observe(m)
                if m.get("skipped_steps", 0.0) > 0.0:
                    nonfinite_chunks += 1
                m["episodes"] = m.pop("episode_count_sum")
                m["return_mean"] = m.pop("episode_return_sum") / max(m["episodes"], 1.0)
                metrics = m
                if on_metrics is not None:
                    on_metrics(i, m)

        chunks_done = 0
        for i in range(num_calls):
            if should_stop is not None and should_stop():
                break
            with self._guard(), step_marker(i):
                state, carry, dev_metrics = self.train_chunk(state, carry)
                chunks_done += 1
                if progress is not None:
                    progress.bump()
                consume(pipe.push(i, dev_metrics))
            self._warm = True
        consume(pipe.drain())
        metrics["chunks_done"] = float(chunks_done)
        metrics["nonfinite_chunks"] = float(nonfinite_chunks)
        return state, carry, metrics

    def _observer(self, instrument: bool) -> Callable[[Dict[str, float]], None]:
        """Per-chunk registry feed (host floats only), or nothing."""
        if not instrument:
            return lambda m: None
        reg = telemetry.get_registry()
        chunk_meter, fps_meter = reg.meter("rates.chunks_per_s"), reg.meter("rates.fps")
        frames_per_call = self.unroll_length * self.venv.num_envs * self.iters_per_call

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
        frames_per_call = self.unroll_length * self.venv.num_envs * self.iters_per_call
        init = get_metrics({"s": carry.return_sum.sum(), "c": carry.episode_count.sum()})
        prev_sum, prev_cnt = init["s"], init["c"]
        windowed = math.nan
        frames = 0
        hit = False
        nonfinite_chunks = 0
        pipe = MetricsPipeline(depth=chunks_in_flight)
        observe = self._observer(instrument)

        def consume(ready) -> None:
            nonlocal windowed, prev_sum, prev_cnt, hit, nonfinite_chunks
            for i, m in ready:
                observe(m)
                if m.get("skipped_steps", 0.0) > 0.0:
                    nonfinite_chunks += 1
                s, c = m["episode_return_sum"], m["episode_count_sum"]
                if c > prev_cnt:
                    windowed = (s - prev_sum) / (c - prev_cnt)
                    prev_sum, prev_cnt = s, c
                if on_metrics is not None:
                    on_metrics((i + 1) * frames_per_call, windowed, dict(m))
                if windowed >= threshold:
                    hit = True

        for i in range(max_calls):
            if should_stop is not None and should_stop():
                break
            with self._guard(), step_marker(i):
                state, carry, dev_metrics = self.train_chunk(state, carry)
                frames += frames_per_call
                if progress is not None:
                    progress.bump()
                consume(pipe.push(i, dev_metrics))
            self._warm = True
            if hit:
                break
        consume(pipe.drain())
        summary = {
            "windowed_return": windowed,
            "frames": float(frames),
            "hit": hit,
            "nonfinite_chunks": float(nonfinite_chunks),
        }
        return state, carry, summary
