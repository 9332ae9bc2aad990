"""Parallel DQN: actor *processes* and a central learner over the shm ring.

Port of ``scalerl_tpu/trainer/parallel_dqn.py``; parity target
``ParallelDQNv2`` (``scalerl/algorithms/dqn/parallel_dqn.py:106-443``): N
actor processes run epsilon-greedy episodes and hand transitions to a
learner that drains them into replay and trains.

- Transport is the lock-free C++ shared-memory slot ring
  (``runtime/shm_ring.py``): actors write fixed ``[T, ...]`` rollout slabs
  through zero-copy numpy views; the learner pops them verified (a torn
  slot is detected by its CRC and skipped), one slab at a time.
- Actors are **spawned** (the learner holds a CUDA context a forked child
  must not inherit).  They act by numpy inference (``models/
  np_forward.py``) on versioned weight snapshots pulled over a pipe
  (``{"kind": "params", "have": v}``), each with its own epsilon from the
  Ape-X ladder ``eps_i = base^(1 + i/(N-1) * alpha)``.  They reach their
  env through ``envs/gym_env.py::make_host_envs`` (one env each) and never
  initialize CUDA; each reports ``torch.cuda.is_initialized()`` and the
  top-level modules it loaded once, with its env built, before its first
  request (:attr:`ParallelDQNTrainer.child_reports`).
- The learner's agent and replay live on the trainer's device.  With
  ``use_per`` and ``use_pallas`` the sample and the priority write-back are
  the CUDA kernels of ``ops/cuda_per.py``.  Uniform replay takes a slab in
  one chunked write; PER inserts it row by row (each row at the running
  max priority), as the JAX trainer does.  Weights are pushed every 10
  learn steps.

Episode returns ride the weight-service pipes (tiny), never the data ring.
Spawning, the weight service, the error funnel and the teardown ladder are
``runtime/process_plane.py``'s, shared with the process-actor IMPALA: an
actor that fails, or dies, while the ring is open fails the learner (this
trainer grants no restarts).  C51 is refused: the actors run scalar-Q numpy
inference.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from scalerl_torch.config import DQNArguments
from scalerl_torch.fleet.transport import PipeConnection, send_recv
from scalerl_torch.models.np_forward import mlp_qnet_forward
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.process_plane import ProcessPlaneMixin, run_actor
from scalerl_torch.runtime.shm_ring import ShmRolloutRing, SlotSpec
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.platform import ACTOR_TORCH_THREADS, process_report
from scalerl_torch.utils.timers import Timings

# learn steps between weight pushes to the actors (the JAX trainer's)
PUSH_EVERY = 10


@dataclass
class _ActorConfig:
    actor_id: int
    env_id: str
    env_backend: str
    obs_shape: tuple
    rollout_length: int
    eps: float
    seed: int
    dueling: bool
    pull_timeout_s: float
    max_episode_steps: int = 500


def _actor_main(conn: PipeConnection, cfg: _ActorConfig, ring: ShmRolloutRing) -> None:
    """Actor process: one host env + numpy inference + slab writes.

    Pipe protocol: ``{"kind": "params", "have": v}`` -> ``{"version",
    "weights"}`` or None; ``{"kind": "stats", ...}``, ``{"kind":
    "report", ...}`` and ``{"kind": "error", ...}`` fire-and-forget.  A
    closed ring is the stop flag; any failure before it funnels to the
    learner (``runtime/process_plane.py::run_actor``)."""
    run_actor(conn, cfg.actor_id, ring, lambda: _act(conn, cfg, ring))


def _act(conn: PipeConnection, cfg: _ActorConfig, ring: ShmRolloutRing) -> None:
    torch.set_num_threads(ACTOR_TORCH_THREADS)  # a tensor env steps on the CPU
    from scalerl_torch.envs.gym_env import make_host_envs

    envs = make_host_envs(cfg.env_id, 1, seed=cfg.seed, env_backend=cfg.env_backend)
    try:
        n_actions = int(envs.single_action_space.n)
        rng = np.random.default_rng(cfg.seed)
        obs = envs.reset(seed=cfg.seed)[0][0]
        weights: Any = None
        version = -1
        T = cfg.rollout_length
        ep_ret, ep_len = 0.0, 0
        # read by the weight service before it answers the first request
        conn.send({"kind": "report", "actor_id": cfg.actor_id, **process_report()})
        while not ring.closed:
            reply = send_recv(conn, {"kind": "params", "have": version},
                              timeout=cfg.pull_timeout_s)
            if reply is not None:
                version = int(reply["version"])
                weights = reply["weights"]
            idx = ring.acquire(timeout=1.0)
            if idx is None:
                continue
            slot = ring.slot(idx)
            returns: List[float] = []
            for t in range(T):
                if weights is None or rng.random() < cfg.eps:
                    a = int(rng.integers(n_actions))
                else:
                    q = mlp_qnet_forward(weights, obs[None], cfg.dueling)
                    a = int(np.argmax(q[0]))
                nxt, r, term, trunc, infos = envs.step(np.array([a]))
                term, trunc, r = bool(term[0]), bool(trunc[0]), float(r[0])
                real_next = nxt[0]
                final = infos.get("_final_obs") if isinstance(infos, dict) else None
                if final is not None and final[0]:
                    real_next = infos["final_obs"][0]  # SAME_STEP autoreset
                ep_ret += r
                ep_len += 1
                ep_end = term or trunc or ep_len >= cfg.max_episode_steps
                slot["obs"][t] = obs
                slot["action"][t] = a
                slot["reward"][t] = r
                slot["next_obs"][t] = real_next
                slot["done"][t] = term
                # episode boundary incl. truncation/step-cap: bounds the
                # n-step fold so windows never cross this actor's resets
                slot["boundary"][t] = ep_end
                if ep_end:
                    returns.append(ep_ret)
                    ep_ret, ep_len = 0.0, 0
                    # the env reset itself on term/trunc; a step cap resets here
                    obs = nxt[0] if (term or trunc) else envs.reset()[0][0]
                else:
                    obs = nxt[0]
            slot["meta"][0] = cfg.actor_id
            slot["meta"][1] = version
            slot = None  # drop the views: a live one keeps the mapping exported
            ring.commit(idx)
            if returns:
                conn.send({"kind": "stats", "actor_id": cfg.actor_id, "returns": returns})
    finally:
        envs.close()


class ParallelDQNTrainer(ProcessPlaneMixin, BaseTrainer):
    """N actor processes -> shm ring -> device replay + learner."""

    def __init__(
        self,
        args: DQNArguments,
        agent,  # DQNAgent
        env_id: str,
        obs_shape: tuple,
        num_actors: int = 4,
        num_slots: int = 16,
        eps_base: float = 0.4,
        eps_alpha: float = 7.0,
        use_per: Optional[bool] = None,
        run_name: Optional[str] = None,
    ) -> None:
        super().__init__(args, run_name=run_name)
        if getattr(args, "categorical_dqn", False):
            raise ValueError(
                "categorical_dqn (C51) is not supported by ParallelDQNTrainer: "
                "actor processes run scalar-Q numpy inference "
                "(models/np_forward.py); use DQNAgent with OffPolicyTrainer"
            )
        self.agent = agent
        self.num_actors = num_actors
        self.env_id = env_id
        T = args.rollout_length
        spec = SlotSpec({
            "obs": ((T,) + tuple(obs_shape), np.float32),
            "action": ((T,), np.int32),
            "reward": ((T,), np.float32),
            "next_obs": ((T,) + tuple(obs_shape), np.float32),
            "done": ((T,), np.bool_),
            "boundary": ((T,), np.bool_),  # term | trunc | step-cap
            "meta": ((2,), np.int64),  # actor_id, weight version
        })
        # built here, before any child spawns: children load the same library
        self.ring = ShmRolloutRing(spec, num_slots=num_slots)
        self.param_server = ParameterServer()
        self.param_server.push(agent.get_weights())

        use_per = args.use_per if use_per is None else use_per
        common = dict(num_envs=1, n_step=args.n_steps, gamma=args.gamma, device=agent.device)
        if use_per:
            from scalerl_torch.data.prioritized import PrioritizedReplayBuffer

            self.replay: Any = PrioritizedReplayBuffer(
                obs_shape, args.buffer_size, alpha=args.per_alpha,
                sample_method="pallas" if args.use_pallas else "hierarchical",
                update_method="pallas" if args.use_pallas else "xla", **common)
        else:
            from scalerl_torch.data.replay import ReplayBuffer

            self.replay = ReplayBuffer(obs_shape, args.buffer_size, **common)
        self.use_per = use_per
        # replay sampling draws from its own seeded stream on the device
        self.generator = torch.Generator(device=agent.device).manual_seed(args.seed + 0x53A1)
        self.stop_event = threading.Event()
        self.returns: List[float] = []
        self.env_steps = 0
        self.learn_steps = 0
        self.max_actor_version = -1  # the newest weight version a drained slab acted on
        self.learn_timings = Timings()  # drain / learn, mean seconds a loop
        self._eps = [
            float(eps_base ** (1 + (i / max(num_actors - 1, 1)) * eps_alpha))
            for i in range(num_actors)
        ]
        self._init_process_plane(_actor_main)

    def _actor_configs(self) -> List[_ActorConfig]:
        return [
            _ActorConfig(
                actor_id=i,
                env_id=self.env_id,
                env_backend=self.args.env_backend,
                obs_shape=tuple(self.agent.obs_shape),
                rollout_length=self.args.rollout_length,
                eps=self._eps[i],
                seed=self.args.seed + 7919 * i,
                dueling=self.args.dueling_dqn,
                pull_timeout_s=self.pull_timeout_s,
            )
            for i in range(self.num_actors)
        ]

    # -- learner -------------------------------------------------------
    def _drain(self, max_slabs: int = 8) -> int:
        drained = 0
        while drained < max_slabs:
            # verified pop: torn slots are detected/released, never trained on
            idx = self.ring.pop_full_verified(timeout=0.05 if drained else 0.5)
            if idx is None:
                break
            slab = self.ring.gather_batch([idx])
            self.ring.release(idx)
            self.max_actor_version = max(self.max_actor_version, int(slab["meta"][0, 1]))
            if self.use_per:
                self._per_insert(slab)
            else:
                self.replay.save_chunk(
                    obs=slab["obs"][0, :, None],
                    action=slab["action"][0, :, None],
                    reward=slab["reward"][0, :, None],
                    next_obs=slab["next_obs"][0, :, None],
                    done=slab["done"][0, :, None],
                    boundary=slab["boundary"][0, :, None],
                )
            self.env_steps += self.args.rollout_length
            drained += 1
        return drained

    def _per_insert(self, slab: Dict[str, np.ndarray]) -> None:
        for t in range(self.args.rollout_length):  # each row at max priority
            self.replay.save_to_memory(
                obs=slab["obs"][0, t][None],
                next_obs=slab["next_obs"][0, t][None],
                action=slab["action"][0, t][None],
                reward=slab["reward"][0, t][None],
                done=slab["done"][0, t][None],
                boundary=slab["boundary"][0, t][None],
            )

    def learn_step(self) -> Dict[str, torch.Tensor]:
        """Sample, learn and (PER) write the new priorities back; the
        metrics stay on the device."""
        args = self.args
        if self.use_per:
            batch = self.replay.sample(args.batch_size, beta=args.per_beta,
                                       generator=self.generator)
            metrics, td_abs = self.agent.learn_device(batch)
            self.replay.update_priorities(batch["indices"], td_abs + 1e-6)
        else:
            metrics, _ = self.agent.learn_device(
                self.replay.sample(args.batch_size, generator=self.generator))
        self.learn_steps += 1
        if self.learn_steps % PUSH_EVERY == 0:
            self.param_server.push(self.agent.get_weights())
        return metrics

    def train(self, total_steps: Optional[int] = None) -> Dict[str, float]:
        from scalerl_torch.runtime.dispatch import get_metrics

        args = self.args
        total_steps = total_steps or args.max_timesteps
        self.start_actors()
        info: Dict[str, Any] = {}
        start = time.time()
        last_log = 0
        try:
            while self.env_steps < total_steps and not self.stop_event.is_set():
                self.raise_actor_error()  # a failed actor fails the run
                self.learn_timings.reset()
                self._drain()
                self.learn_timings.time("drain")
                if len(self.replay) >= args.warmup_learn_steps:
                    info = self.learn_step()
                    self.learn_timings.time("learn")
                if self.env_steps - last_log >= args.logger_frequency:
                    last_log = self.env_steps
                    sps = self.env_steps / max(time.time() - start, 1e-8)
                    ret = float(np.mean(self.returns[-20:])) if self.returns else float("nan")
                    info = get_metrics(info)  # one batched device->host copy
                    self.log(self.env_steps, "train", {**info, "sps": sps, "return_mean": ret,
                                                       "learn_steps": float(self.learn_steps)})
                    if self._instrument:
                        telemetry.observe_train_metrics(info)
                        telemetry.get_registry().set_gauges(
                            {**info, "sps": sps, "return_mean": ret}, prefix="train.")
                        self.logger.log_registry(self.env_steps, step_type="train",
                                                 include_prefixes=("train.", "ring."))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"steps {self.env_steps} | sps {sps:.0f} | return {ret:.1f} | "
                            f"learn {self.learn_steps} | weights v{self.param_server.version}")
        finally:
            self.stop()
        ret = float(np.mean(self.returns[-20:])) if self.returns else float("nan")
        return {
            **get_metrics(info),
            "env_steps": float(self.env_steps),
            "learn_steps": float(self.learn_steps),
            "episodes": float(len(self.returns)),
            "return_mean": ret,
        }
