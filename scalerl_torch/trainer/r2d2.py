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
the max priority.  A meshed agent (``R2D2Agent.enable_mesh``) learns on its
rows of each sampled batch and hands back every priority; the JAX
trainer's sharded replay (``data/sharded_replay.py``) is not ported.
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
from scalerl_torch.data.trajectory import TrajectorySpec
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
        self.replay = seq_init(sequence_fields(obs_shape, args.rollout_length + 1),
                               tuple(tuple(c.shape[1:]) for c, _ in core),
                               args.replay_capacity, agent.device)
        self._max_prio_dev = torch.ones((), dtype=torch.float32, device=agent.device)
        self.generator = torch.Generator(device=agent.device).manual_seed(args.seed + 13)
        self.seq_method = "pallas" if args.use_pallas else "hierarchical"
        self.learn_steps = 0

    @property
    def max_priority(self) -> float:
        """The running max priority, read to the host (one copy; never on
        the learn path)."""
        return float(self._max_prio_dev)

    def _resume_pytree(self) -> Dict:
        tree = super()._resume_pytree()
        tree["replay"] = self.replay
        tree["max_priority"] = np.asarray(self.max_priority, np.float64)
        return tree

    def try_resume(self) -> bool:
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = state["agent"]
        self.env_frames = int(state["env_frames"])
        self.replay = state["replay"]
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
        self.replay = seq_add(self.replay, fields, core,
                              self._max_prio_dev.expand(fields["action"].shape[0]))
        self.queue.recycle(idxs)

    def _learn_once(self) -> Dict[str, torch.Tensor]:
        args = self.args
        fields, core, idx, weights = seq_sample(
            self.replay, self.generator, args.batch_size, alpha=args.per_alpha,
            beta=args.per_beta, method=self.seq_method)
        metrics, prio = self.agent.learn_sequences(fields, core, weights)
        self.replay = seq_update_priorities(self.replay, idx, prio)
        self._max_prio_dev = torch.maximum(self._max_prio_dev, prio.max())
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
        try:
            while self.env_frames < total_frames and not self.stop_event.is_set():
                self._insert_slots(n_slots)
                inserted += seqs_per_drain
                if inserted >= args.warmup_sequences:
                    for _ in range(args.train_intensity):
                        metrics = self._learn_once()
                    self.param_server.push(self.agent.get_weights(), to_host=False)
                if saving and self.env_frames - last_save_frames >= args.save_frequency:
                    # periodic, not only at exit: a restart must find a
                    # fresh replay and learner
                    last_save_frames = self.env_frames
                    self.save_resume()
                if self.env_frames - last_log_frames >= args.logger_frequency:
                    last_log_frames = self.env_frames
                    sps = (self.env_frames - start_frames) / max(time.time() - start, 1e-8)
                    rets = [r for m in self.episode_metrics for r in m.episode_returns[-20:]]
                    ret_mean = float(np.mean(rets)) if rets else float("nan")
                    host_metrics = get_metrics(metrics)  # one batched copy
                    self.log(self.env_frames, "train", {**host_metrics, "sps": sps,
                                                        "return_mean": ret_mean,
                                                        "learn_steps": self.learn_steps})
                    if self._instrument:
                        telemetry.observe_train_metrics(host_metrics)
                        telemetry.get_registry().set_gauges(
                            {**host_metrics, "sps": sps, "return_mean": ret_mean},
                            prefix="train.")
                        self.logger.log_registry(self.env_frames, step_type="train",
                                                 include_prefixes=("train.", "queue."))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"frames {self.env_frames} | sps {sps:.0f} | return {ret_mean:.2f}"
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
        sps = (self.env_frames - start_frames) / max(time.time() - start, 1e-8)
        rets = [r for m in self.episode_metrics for r in m.episode_returns]
        return {
            **get_metrics(metrics),
            "env_frames": float(self.env_frames),
            "sps": float(sps),
            "learn_steps": int(self.agent.state.step),
            "return_mean": float(np.mean(rets[-100:])) if rets else float("nan"),
            "episodes": float(len(rets)),
        }
