"""R2D2 trainer: host actor plane -> sequence replay -> recurrent learner.

Port of ``scalerl_tpu/trainer/r2d2.py``:

- actor threads drive vector envs and fill ``[T+1, B]`` trajectory slots
  with ``fill_rollout_slot`` (which stores each slot's entering LSTM state),
  each acting through its own epsilon-greedy view of the agent
  (``R2D2Agent.actor_view``: central inference on the card, the Ape-X
  epsilon ladder);
- the learner drains slots, inserts every env lane as one sequence into the
  prioritized sequence replay on the device (``data/sequence_replay.py``)
  at the running max priority, then runs ``train_intensity`` updates a
  drained batch: sample (the CUDA sample kernel under ``use_pallas``),
  burn-in and n-step double-Q, priority write-back (a plain scatter, as the
  JAX package writes sequence priorities).

The running max priority stays on the device: no learn step reads it to
the host; a checkpoint reads it once.  Resume restores the agent, the whole
replay (storage, stored cores, priorities, cursors), the frame counter and
the max priority.

Under a meshed agent (``R2D2Agent.enable_mesh``, or the args' ``mesh_shape``
/ ``dp_size`` / ``mp_size``; one process a device)
the replay is a ``ShardedSequenceReplay`` (``data/sharded_replay.py``):
the ring's capacity splits over the ``dp`` x ``fsdp`` ranks and its cursor
walks the global capacity, so every insert is the same global batch on
every rank.  Each drain is pooled: the ranks' drained sequences are
all-gathered in rank order (each rank receives the others' drains), and
each rank writes the slots of its block.  Each rank then samples its
shard's ``batch_size / S`` sequences, learns on them (the agent's step in
its ``"replay_shard"`` batch mode), writes their priorities back to its own block
(keep-empty) and maxes the running max priority over the shards.  The
frame count and stopping are agreed across ranks (``RankAgreement``), and
a checkpoint holds the ring gathered whole.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from scalerl_torch.agents.r2d2 import R2D2Agent
from scalerl_torch.config import R2D2Arguments
from scalerl_torch.data.sequence_replay import (
    seq_add,
    seq_init,
    seq_sample,
    seq_update_priorities,
)
from scalerl_torch.data.sharded_replay import ShardedSequenceReplay
from scalerl_torch.data.trajectory import TrajectorySpec
from scalerl_torch.parallel.mesh import AXIS_NAMES
from scalerl_torch.parallel.sharding import gather, gather_batch
from scalerl_torch.parallel.train_step import (
    RankAgreement,
    maybe_enable_mesh_from_args,
    place_agent_state,
)
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.rollout_queue import RolloutQueue
from scalerl_torch.trainer.actor_learner import HostPlaneMixin, _ActorThread, check_queue_depth
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics


def sequence_fields(obs_shape, T1: int) -> Dict[str, tuple]:
    """The sequence replay's fields for ``[T1]`` rows of ``obs_shape``
    (uint8 pixels or float32 vectors), as both R2D2 trainers store them."""
    obs_dtype = torch.uint8 if len(obs_shape) == 3 else torch.float32
    return {
        "obs": ((T1,) + tuple(obs_shape), obs_dtype),
        "action": ((T1,), torch.int32),
        "reward": ((T1,), torch.float32),
        "done": ((T1,), torch.bool),
    }


class R2D2Trainer(HostPlaneMixin, BaseTrainer):
    def __init__(
        self,
        args: R2D2Arguments,
        agent: R2D2Agent,
        env_fns,  # one callable per actor, each building a vector env
        run_name: Optional[str] = None,
        max_actor_restarts: int = 0,
    ) -> None:
        super().__init__(args, run_name=run_name)
        self.agent = agent
        # RLArguments' mesh_shape / dp_size / mp_size, before any actor
        # starts; a meshed step learns on the rows of this rank's replay shard
        maybe_enable_mesh_from_args(agent, args, batch_mode="replay_shard")
        self.env_fns = env_fns
        self.stop_event = threading.Event()
        self.frame_lock = threading.Lock()
        self.env_frames = 0
        self.max_actor_restarts = max_actor_restarts
        self.actor_restarts = 0
        self._restart_lock = threading.Lock()
        self.param_server = ParameterServer()

        probe_env = env_fns[0]()
        self.envs_per_actor = probe_env.num_envs
        obs_shape = tuple(probe_env.single_observation_space.shape)
        num_actions = probe_env.single_action_space.n
        self._probe_env = probe_env

        core = agent.initial_state(self.envs_per_actor)
        self.spec = TrajectorySpec(
            unroll_length=args.rollout_length,
            batch_size=self.envs_per_actor,
            obs_shape=obs_shape,
            num_actions=num_actions,
            obs_dtype=np.uint8 if len(obs_shape) == 3 else np.float32,
            core_state_shapes=tuple(tuple(c.shape) for c, _ in core),
        )
        check_queue_depth(args, self.envs_per_actor)
        self.queue = RolloutQueue(self.spec, num_slots=args.num_buffers)
        self.episode_metrics = [EpisodeMetrics(self.envs_per_actor) for _ in env_fns]
        self.seq_method = "pallas" if args.use_pallas else "hierarchical"
        fields = sequence_fields(obs_shape, args.rollout_length + 1)
        core_shapes = tuple(tuple(c.shape[1:]) for c, _ in core)
        self.mesh = getattr(agent, "mesh", None)
        self.sharded_replay: Optional[ShardedSequenceReplay] = None
        if self.mesh is None:
            self.replay = seq_init(fields, core_shapes, args.replay_capacity, agent.device)
            self.generator = torch.Generator(device=agent.device).manual_seed(args.seed + 13)
        else:
            self.replay = None
            self.sharded_replay = ShardedSequenceReplay(
                fields, core_shapes, args.replay_capacity, self.mesh, alpha=args.per_alpha,
                beta=args.per_beta, sample_method=self.seq_method, seed=args.seed + 13,
                device=agent.device)
            self.generator = self.sharded_replay.generator
            # a drain is pooled over every rank, in rank order
            self._pool = tuple(a for a in AXIS_NAMES if self.mesh.shape[a] > 1)
        self._max_prio_dev = torch.ones((), dtype=torch.float32, device=agent.device)
        self.learn_steps = 0

    @property
    def max_priority(self) -> float:
        """The running max priority, read to the host (one copy; never on
        the learn path)."""
        return float(self._max_prio_dev)

    def _resume_pytree(self) -> Dict:
        tree = super()._resume_pytree()
        # a sharded ring is saved whole (every rank gathers)
        tree["replay"] = (self.replay if self.sharded_replay is None
                          else self.sharded_replay.full_state())
        tree["max_priority"] = np.asarray(self.max_priority, np.float64)
        return tree

    def try_resume(self) -> bool:
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = place_agent_state(self.agent, state["agent"])
        self.env_frames = int(state["env_frames"])
        if self.sharded_replay is None:
            self.replay = state["replay"]
        else:
            self.sharded_replay.load_full_state(state["replay"])
        self._max_prio_dev = torch.tensor(float(state["max_priority"]), dtype=torch.float32,
                                          device=self.agent.device)
        self.param_server.push(self.agent.get_weights(), to_host=False)
        if self.is_main_process:
            self.text_logger.info(f"resumed from {self.resume_ckpt_path}: frames {self.env_frames}")
        return True

    # ------------------------------------------------------------------
    def _insert_slots(self, n_slots: int) -> None:
        """Drain ``n_slots`` slots and insert each env lane as one sequence."""
        batch, idxs = self.queue.get_batch(n_slots)
        # time-major [T1, B*] host arrays -> sequence-major [B*, T1, ...]
        fields = {k: np.ascontiguousarray(np.moveaxis(batch[k], 0, 1))
                  for k in ("obs", "action", "reward", "done")}
        core = tuple((batch[f"core_{i}_c"], batch[f"core_{i}_h"])
                     for i in range(len(self.spec.core_state_shapes)))
        if self.sharded_replay is not None:
            self._insert_pooled(fields, core)
        else:
            self.replay = seq_add(self.replay, fields, core,
                                  self._max_prio_dev.expand(fields["action"].shape[0]))
        self.queue.recycle(idxs)

    def _insert_pooled(self, fields, core) -> None:
        """Every rank's drain, gathered in rank order, as one global insert."""
        device = self.agent.device

        def pooled(x):
            return gather_batch(torch.as_tensor(x, device=device), self.mesh, 0, self._pool)

        fields = {k: pooled(v) for k, v in fields.items()}
        core = tuple((pooled(c), pooled(h)) for c, h in core)
        self.sharded_replay.add(fields, core,
                                self._max_prio_dev.expand(fields["action"].shape[0]))

    def _learn_once(self) -> Dict[str, torch.Tensor]:
        args = self.args
        if self.sharded_replay is not None:
            fields, core, idx, weights = self.sharded_replay.sample(args.batch_size,
                                                                    generator=self.generator)
            metrics, prio = self.agent.learn_sequences(fields, core, weights)
            self.sharded_replay.update_shard_priorities(idx, prio)
            top = self.sharded_replay.max_over_shards(prio.max())
        else:
            fields, core, idx, weights = seq_sample(
                self.replay, self.generator, args.batch_size, alpha=args.per_alpha,
                beta=args.per_beta, method=self.seq_method)
            metrics, prio = self.agent.learn_sequences(fields, core, weights)
            self.replay = seq_update_priorities(self.replay, idx, prio)
            top = prio.max()
        self._max_prio_dev = torch.maximum(self._max_prio_dev, top)
        self.learn_steps += 1
        return metrics

    # ------------------------------------------------------------------
    def train(self, total_frames: Optional[int] = None) -> Dict[str, float]:
        args = self.args
        total_frames = total_frames or args.max_timesteps
        if self.resuming:
            self.try_resume()
        actors = [_ActorThread(i, self, self._probe_env if i == 0 else fn(),
                               policy=self.agent.actor_view(i))
                  for i, fn in enumerate(self.env_fns)]
        self.actors = actors
        for a in actors:
            a.start()

        start = time.time()
        start_frames = self.env_frames
        last_log_frames = last_save_frames = start_frames
        n_slots = max(args.batch_size // self.envs_per_actor, 1)
        seqs_per_drain = n_slots * self.envs_per_actor
        saving = args.save_model and not args.disable_checkpoint
        metrics: Dict = {}
        inserted = 0
        # under a mesh of several ranks total_frames counts the frames of
        # every rank, and the ranks stop on the same drain
        agree = RankAgreement(self.mesh)
        if self.mesh is not None:
            (start_frames,) = agree(self.env_frames)
            last_log_frames = last_save_frames = start_frames
            seqs_per_drain *= self.mesh.size
        try:
            while True:
                frames, halted = agree(self.env_frames, self.stop_event.is_set())
                if frames >= total_frames or halted:
                    break
                self._insert_slots(n_slots)
                inserted += seqs_per_drain
                if inserted >= args.warmup_sequences:
                    for _ in range(args.train_intensity):
                        metrics = self._learn_once()
                    self.param_server.push(self.agent.get_weights(), to_host=False)
                if saving and frames - last_save_frames >= args.save_frequency:
                    # periodic, not only at exit: a restart must find a
                    # fresh replay and learner
                    last_save_frames = frames
                    self.save_resume()
                if frames - last_log_frames >= args.logger_frequency:
                    last_log_frames = frames
                    sps = (frames - start_frames) / max(time.time() - start, 1e-8)
                    rets = [r for m in self.episode_metrics for r in m.episode_returns[-20:]]
                    ret_mean = float(np.mean(rets)) if rets else float("nan")
                    host_metrics = get_metrics(metrics)  # one batched copy
                    self.log(frames, "train", {**host_metrics, "sps": sps,
                                                        "return_mean": ret_mean,
                                                        "learn_steps": self.learn_steps})
                    if self._instrument:
                        telemetry.observe_train_metrics(host_metrics)
                        telemetry.get_registry().set_gauges(
                            {**host_metrics, "sps": sps, "return_mean": ret_mean},
                            prefix="train.")
                        self.logger.log_registry(frames, step_type="train",
                                                 include_prefixes=("train.", "queue."))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"frames {frames} | sps {sps:.0f} | return {ret_mean:.2f}"
                            f" | loss {host_metrics.get('total_loss', float('nan')):.3f}")
        finally:
            self.stop_event.set()
            self.queue.close()
            for a in actors:
                a.join(timeout=5.0)
            for a in actors:
                try:
                    a.envs.close()
                except Exception:  # noqa: BLE001 — teardown goes on
                    pass
        if saving:
            self.save_resume()
        # the frames of every rank, as start_frames counts them
        (end_frames,) = agree(self.env_frames)
        sps = (end_frames - start_frames) / max(time.time() - start, 1e-8)
        rets = [r for m in self.episode_metrics for r in m.episode_returns]
        return {
            **get_metrics(metrics),
            "env_frames": float(end_frames),
            "sps": float(sps),
            "learn_steps": int(gather(self.agent.state.step)),
            "return_mean": float(np.mean(rets[-100:])) if rets else float("nan"),
            "episodes": float(len(rets)),
        }
