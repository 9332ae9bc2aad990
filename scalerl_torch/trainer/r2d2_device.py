"""Device-native R2D2: collection on the card feeding a replay on the card.

Port of ``scalerl_tpu/trainer/r2d2_device.py``: env stepping (one of the
port's tensor envs), recurrent-Q inference and epsilon-greedy selection
run on the device over the unroll, the ``[B, T+1]`` sequences go into the
prioritized sequence replay with one batched ring write, and the R2D2 learn
step (burn-in, n-step double-Q, priority write-back) is the one the host
plane uses.  No trajectory visits host memory.

The JAX trainer compiles an iteration into one XLA program (``fused=True``)
or one program a stage.  Here both run eagerly from Python and draw from
one ``torch.Generator`` in one order, so they give bit-equal results on one
seed: ``fused=True`` calls :meth:`DeviceR2D2Trainer.fused_iteration`, the
whole iteration (collect, insert, ``train_intensity`` x sample, learn and
write-back) in one function; ``fused=False`` drives the stages one by one
through the agent's public ``learn_sequences``.  Every warm iteration runs
under ``torch.cuda.set_sync_debug_mode("error")``: no host sync, the running
max priority included, until a log boundary reads the metrics in one copy.

``mesh=`` runs the fused iteration data-parallel over the mesh axis
``axis_name`` (the JAX trainer's sharded fused loop): each rank steps its
``num_envs / n`` lanes from its own generator (rank r along the axis from
``shard_seed(seed, r)``; rank 0 keeps the trainer's stream) and keeps an
independent local ring of ``replay_capacity / n`` slots fed by them, so
inserts need no communication.  Sampling is
``data/sharded_replay.py::seq_sample_sharded_local`` (``batch_size / n``
a rank, weights over the global size, which every rank knows without a
collective: each adds ``num_envs / n`` sequences an iteration), the
agent's learn step runs inside ``parallel.sharding.batch_reduction(mesh,
(axis_name,))``, so every rank keeps the same params, the write-back is the keep-empty one at local slots, and
the running max priority is maxed over the axis.  As in the JAX trainer,
``mesh=`` needs ``fused=True`` and a plain agent, and an ``enable_mesh``'d
agent needs ``fused=False``.
"""

from __future__ import annotations

import copy
import time
from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call

from scalerl_torch.agents.r2d2 import R2D2Agent
from scalerl_torch.config import R2D2Arguments
from scalerl_torch.data.sequence_replay import (
    seq_add,
    seq_init,
    seq_sample,
    seq_update_priorities,
    seq_update_priorities_keep_empty,
)
from scalerl_torch.data.sharded_replay import seq_sample_sharded_local
from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.parallel.mesh import resolve_mesh
from scalerl_torch.parallel.sharding import (
    agreed_seed,
    axes_all_reduce,
    batch_reduction,
    shard_seed,
)
from scalerl_torch.parallel.train_step import tensor_leaves
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics, steady_state_guard
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.trainer.r2d2 import sequence_fields


class CollectCarry(NamedTuple):
    env_state: object
    obs: torch.Tensor  # [B, ...]
    last_action: torch.Tensor  # [B] int32
    reward: torch.Tensor  # [B] float32
    done: torch.Tensor  # [B] bool
    core: tuple  # the model's recurrent state
    return_sum: torch.Tensor  # [B] sum of completed episodes' returns
    episode_return: torch.Tensor  # [B] running
    episode_count: torch.Tensor  # [B]


class DeviceR2D2Trainer(BaseTrainer):
    """R2D2 over one of the port's tensor envs (``envs/tensor_envs``)."""

    def __init__(
        self,
        args: R2D2Arguments,
        agent: R2D2Agent,
        venv: TensorEnv,
        run_name: Optional[str] = None,
        fused: bool = True,
        mesh=None,
        axis_name: str = "dp",
    ) -> None:
        """``mesh``: the sharded fused loop over the mesh axis ``axis_name``
        (module docstring); ``venv`` holds the lanes of every rank."""
        super().__init__(args, run_name=run_name)
        if getattr(agent, "mesh", None) is not None:
            if mesh is not None:
                raise ValueError(
                    "pass EITHER DeviceR2D2Trainer(mesh=...) (fused sharded loop, replay "
                    "included) OR agent.enable_mesh (DDP learn step only, piecewise loop) "
                    "— not both")
            if fused:
                raise ValueError(
                    "fused=True runs the raw single-device learn fn and would silently "
                    "bypass agent.enable_mesh's sharded learner; use "
                    "DeviceR2D2Trainer(mesh=...) for the fused sharded loop, or fused=False "
                    "for the piecewise DDP combination")
        if mesh is not None and not fused:
            raise ValueError("mesh= requires fused=True (the sharded fused loop)")
        if venv.device != agent.device:
            raise ValueError(f"the env runs on {venv.device}, the agent on {agent.device}")
        self.fused = fused
        self.agent = agent
        self.venv = venv
        self.mesh = None if mesh is None else resolve_mesh(mesh)
        self.axis_name = axis_name
        self.local_venv = venv  # the lanes this rank steps
        capacity, rank, self.n_shards = args.replay_capacity, 0, 1
        if self.mesh is not None:
            n = self.n_shards = self.mesh.shape[axis_name]
            for what, val in (("venv.num_envs", venv.num_envs),
                              ("replay_capacity", args.replay_capacity),
                              ("batch_size", args.batch_size)):
                if val % n != 0:
                    raise ValueError(
                        f"{what} ({val}) must divide by mesh axis {axis_name!r} size ({n}) "
                        "for the fused sharded loop")
            rank, capacity = self.mesh.coordinate(axis_name), capacity // n
            self.local_venv = copy.copy(venv)
            self.local_venv.num_envs = venv.num_envs // n
            group = self.mesh.group(axis_name)
            if group is not None:  # one state on every rank: rank 0's
                for leaf in tensor_leaves(agent.state):
                    dist.broadcast(leaf, src=dist.get_global_rank(group, 0), group=group)
        self.shard = rank
        core = agent.initial_state(1)
        self.replay = seq_init(sequence_fields(venv.observation_shape, args.rollout_length + 1),
                               tuple(tuple(c.shape[1:]) for c, _ in core),
                               capacity, agent.device)
        self.generator = torch.Generator(device=agent.device).manual_seed(
            shard_seed(agreed_seed(args.seed, self.mesh), rank))
        self.seq_method = "pallas" if args.use_pallas else "hierarchical"
        self.max_priority = torch.ones((), dtype=torch.float32, device=agent.device)
        self.env_frames = 0
        self.inserted = 0
        self.nonfinite_events = 0

    # ------------------------------------------------------------------
    def init_carry(self) -> CollectCarry:
        """This rank's carry (every lane's without a mesh)."""
        B, device = self.local_venv.num_envs, self.agent.device
        env_state, obs = self.local_venv.reset(self.generator)
        zeros = torch.zeros(B, dtype=torch.float32, device=device)
        return CollectCarry(
            env_state=env_state, obs=obs, last_action=torch.zeros(B, dtype=torch.int32,
                                                                  device=device),
            reward=zeros, done=torch.ones(B, dtype=torch.bool, device=device),
            core=self.agent.initial_state(B), return_sum=zeros, episode_return=zeros,
            episode_count=zeros,
        )

    @torch.no_grad()
    def collect(self, carry: CollectCarry, eps: float
                ) -> Tuple[CollectCarry, Dict[str, torch.Tensor], tuple]:
        """One ``[T+1, B]`` chunk under epsilon-greedy -> the carry, the
        sequences in replay layout (``[B, T1, ...]``) and the core the chunk
        was entered with."""
        agent, model = self.agent, self.agent.model
        params = agent.state.params
        entry_core = carry.core
        rows = []
        c = carry
        for _ in range(self.args.rollout_length):
            out, new_core = functional_call(model, params, (
                c.obs[None], c.last_action[None], c.reward[None], c.done[None], c.core))
            q = out.q_values[0]
            greedy = torch.argmax(q, dim=-1)
            explore = torch.rand(greedy.shape, generator=self.generator,
                                 device=q.device) < eps
            random_a = torch.randint(0, q.shape[-1], greedy.shape, generator=self.generator,
                                     device=q.device)
            action = torch.where(explore, random_a, greedy)
            env_state, next_obs, rew, done = self.local_venv.step(c.env_state, action,
                                                                  self.generator)
            rows.append((c.obs, c.last_action, c.reward, c.done))
            ep_ret = c.episode_return + rew
            c = CollectCarry(
                env_state=env_state, obs=next_obs, last_action=action.to(torch.int32),
                reward=rew.to(torch.float32), done=done, core=new_core,
                return_sum=c.return_sum + torch.where(done, ep_ret, 0.0),
                episode_return=torch.where(done, 0.0, ep_ret),
                episode_count=c.episode_count + done.to(torch.float32),
            )
        rows.append((c.obs, c.last_action, c.reward, c.done))
        fields = {name: torch.stack(col, dim=1)
                  for name, col in zip(("obs", "action", "reward", "done"), zip(*rows))}
        return c, fields, entry_core

    def _insert(self, fields, entry_core) -> None:
        self.replay = seq_add(self.replay, fields, entry_core,
                              self.max_priority.expand(self.local_venv.num_envs))
        self.inserted += self.venv.num_envs
        self.env_frames += self.args.rollout_length * self.venv.num_envs

    def _sample(self):
        args = self.args
        if self.mesh is None:
            return seq_sample(self.replay, self.generator, args.batch_size,
                              alpha=args.per_alpha, beta=args.per_beta, method=self.seq_method)
        b_local = args.batch_size // self.n_shards
        u = torch.rand(b_local, generator=self.generator, device=self.agent.device)
        # every rank's ring holds as many sequences: the global size needs
        # no collective
        return seq_sample_sharded_local(
            self.replay, u, b_local, mesh=self.mesh, axes=(self.axis_name,),
            n_shards=self.n_shards, local_capacity=self.replay.priorities.shape[0],
            alpha=args.per_alpha, beta=args.per_beta,
            global_size=self.n_shards * self.replay.size, method=self.seq_method)

    def _write_back(self, idx, prio) -> None:
        if self.mesh is None:
            self.replay = seq_update_priorities(self.replay, idx, prio)
            self.max_priority = torch.maximum(self.max_priority, prio.max())
            return
        # keep-empty: a zero-weighted draw of an empty slot stays out of
        # the distribution
        local = idx - self.shard * self.replay.priorities.shape[0]
        self.replay = seq_update_priorities_keep_empty(self.replay, local, prio)
        top = axes_all_reduce(prio.max().reshape(1), dist.ReduceOp.MAX, self.mesh,
                              (self.axis_name,))[0]
        self.max_priority = torch.maximum(self.max_priority, top)

    def fused_iteration(self, carry: CollectCarry, eps: float, learn: bool):
        """One whole iteration: collect and insert a chunk, then (``learn``)
        ``train_intensity`` x sample, learn and write back."""
        carry, fields, entry_core = self.collect(carry, eps)
        self._insert(fields, entry_core)
        metrics: Dict[str, torch.Tensor] = {}
        reduction = (nullcontext() if self.mesh is None else
                     batch_reduction(self.mesh, (self.axis_name,)))
        with reduction:
            for _ in range(self.args.train_intensity if learn else 0):
                f, c, idx, w = self._sample()
                self.agent.state, metrics, prio = self.agent._learn(self.agent.state, f, c, w)
                self._write_back(idx, prio)
        return carry, metrics

    def _episode_sums(self, carry: CollectCarry) -> Dict[str, torch.Tensor]:
        """The completed episodes' return sum and count, over every rank of
        the mesh axis."""
        pair = torch.stack([carry.return_sum.sum(), carry.episode_count.sum()])
        if self.mesh is not None:
            axes_all_reduce(pair, dist.ReduceOp.SUM, self.mesh, (self.axis_name,))
        return {"_ret_sum": pair[0], "_ep_cnt": pair[1]}

    def piecewise_iteration(self, carry: CollectCarry, eps: float, learn: bool):
        """The same iteration stage by stage, through ``learn_sequences``."""
        carry, fields, entry_core = self.collect(carry, eps)
        self._insert(fields, entry_core)
        metrics: Dict[str, torch.Tensor] = {}
        if learn:
            for _ in range(self.args.train_intensity):
                f, c, idx, w = self._sample()
                metrics, prio = self.agent.learn_sequences(f, c, w)
                self._write_back(idx, prio)
        return carry, metrics

    # ------------------------------------------------------------------
    def eps(self, frames: int) -> float:
        """Linear decay 1.0 -> ``eps_base`` over the first 4 x
        ``warmup_sequences`` inserted sequences (``rollout_length`` frames
        each), then constant."""
        horizon = max(self.args.warmup_sequences * 4 * self.args.rollout_length, 1)
        frac = min(frames / horizon, 1.0)
        return 1.0 + (self.args.eps_base - 1.0) * frac

    def train(self, total_frames: Optional[int] = None) -> Dict[str, float]:
        args = self.args
        total_frames = total_frames or args.max_timesteps
        carry = self.init_carry()
        iteration = self.fused_iteration if self.fused else self.piecewise_iteration
        metrics: Dict = {}
        start = time.time()
        last_log = 0
        prev_sum = prev_cnt = 0.0
        windowed = float("nan")
        final_mark = None  # the summary's window: the last quarter of the run
        steady = {False: False, True: False}  # per branch, after its first call
        while self.env_frames < total_frames:
            eps = self.eps(self.env_frames)
            # count this iteration's insert: learning starts on the
            # iteration that reaches the warm-up
            warm = self.inserted + self.venv.num_envs >= args.warmup_sequences
            with steady_state_guard() if steady[warm] else nullcontext():
                carry, step_metrics = iteration(carry, eps, warm)
            steady[warm] = True
            metrics = step_metrics or metrics
            if final_mark is None and self.env_frames >= 0.75 * total_frames:
                mark = get_metrics(self._episode_sums(carry))
                final_mark = (mark["_ret_sum"], mark["_ep_cnt"])
            if self.env_frames - last_log >= args.logger_frequency:
                last_log = self.env_frames
                host = get_metrics({**metrics, **self._episode_sums(carry)})
                s, c = host.pop("_ret_sum"), host.pop("_ep_cnt")
                if host.get("skipped_steps", 0.0) > 0.0:
                    self.nonfinite_events += 1
                if c > prev_cnt:  # episodes completed since the previous log
                    windowed = (s - prev_sum) / (c - prev_cnt)
                    prev_sum, prev_cnt = s, c
                self.log(self.env_frames, "train", {**host, "return_windowed": windowed,
                                                    "eps": eps})
                if self._instrument:
                    telemetry.observe_train_metrics(host)
                    telemetry.get_registry().set_gauges(
                        {**host, "return_windowed": windowed, "eps": eps}, prefix="train.")
                    self.logger.log_registry(self.env_frames, step_type="train",
                                             include_prefixes=("train.",))
                if self.is_main_process:
                    self.text_logger.info(
                        f"frames {self.env_frames} | eps {eps:.2f} | return {windowed:.2f}")
        final = get_metrics({**metrics, **self._episode_sums(carry)})
        s, c = final.pop("_ret_sum"), final.pop("_ep_cnt")
        mark_s, mark_c = final_mark if final_mark is not None else (0.0, 0.0)
        if c > mark_c:
            windowed = (s - mark_s) / (c - mark_c)
        if final.get("skipped_steps", 0.0) > 0.0:
            self.nonfinite_events += 1
        sps = self.env_frames / max(time.time() - start, 1e-8)
        return {
            **final,
            "env_frames": float(self.env_frames),
            "sps": float(sps),
            "learn_steps": int(self.agent.state.step),
            "return_mean": s / max(c, 1.0),
            "return_windowed": windowed,
            "episodes": c,
            "nonfinite_events": float(self.nonfinite_events),
        }
