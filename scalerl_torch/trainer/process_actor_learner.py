"""Process-actor IMPALA: monobeast-topology actors over the C++ shm ring.

Port of ``scalerl_tpu/trainer/process_actor_learner.py``.  The reference's
IMPALA runs each actor as a *process* with its own CPU model copy
(``scalerl/algorithms/impala/impala_atari.py:153-220,420-434``), the
torchbeast/monobeast topology, where V-trace exists precisely to correct
the actor-side policy lag.  ``HostActorLearnerTrainer`` (threads, central
inference on the card) covers the other topology; this trainer covers the
reference's:

- rollout hand-off is the lock-free C++ shared-memory slot ring
  (``runtime/shm_ring.py``), not pickled queues: actors write trajectory
  slots through zero-copy numpy views, and the learner pops them verified
  (a torn slot is detected by its CRC and skipped);
- actors are **spawned** (the learner holds a CUDA context).  Each builds
  the port's ``ImpalaAgent`` on ``device="cpu"`` and fills slots with
  ``fill_rollout_slot``: actors that infer on the host CPU are the topology
  itself, not a fallback.  Each child runs torch with
  ``ACTOR_TORCH_THREADS`` (1) intra-op threads, so actors x threads stay
  within the host's cores;
- the learner (the caller's thread) owns the agent on the trainer's device
  and takes one learn step per ``batch_size`` lanes of slots; with
  ``use_pallas`` V-trace is the CUDA kernel.

Weight sync mirrors the reference's ``actor_model.load_state_dict``
(``impala_atari.py:348``) as a versioned pull over a pipe: actors request
``{"kind": "params", "have": v}`` between slots and the learner's weight
service replies with the newest numpy weights (or ``None`` if current);
weights cross as numpy, so no child ever unpickles a CUDA tensor.
Failure handling: actor exceptions (a weight-pull timeout included)
funnel back as ``{"kind": "error"}`` messages and re-raise in the learner,
or respawn the actor within ``max_actor_restarts``; teardown closes the
ring (the shared stop flag), then the pipes, then joins with timeouts and
terminates stragglers (``impala_atari.py:473-494``).  Spawning, the weight
service, the error funnel and the teardown are ``runtime/
process_plane.py``'s, shared with the parallel DQN.  Resume checkpoints, the preemption guard,
the stall watchdog and the checkpoint cadence are the host plane's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.config import ImpalaArguments
from scalerl_torch.fleet.transport import PipeConnection, send_recv
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.process_plane import ProcessPlaneMixin, run_actor
from scalerl_torch.runtime.shm_ring import ShmRolloutRing, SlotSpec
from scalerl_torch.runtime.supervisor import CheckpointCadence, PreemptionGuard, StallWatchdog
from scalerl_torch.trainer.actor_learner import HostPlaneMixin, check_queue_depth
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.platform import ACTOR_TORCH_THREADS, process_report
from scalerl_torch.utils.timers import Timings


@dataclass
class _ProcActorConfig:
    actor_id: int
    args: ImpalaArguments
    obs_shape: Tuple[int, ...]
    num_actions: int
    envs_per_actor: int
    seed: int
    pull_timeout_s: float
    atari: bool = False


def _proc_actor_main(conn: PipeConnection, cfg: _ProcActorConfig, ring: ShmRolloutRing) -> None:
    """Actor process: host vector env + CPU policy + shm slot writes.  Any
    failure before the ring closes funnels to the learner
    (``runtime/process_plane.py::run_actor``)."""
    run_actor(conn, cfg.actor_id, ring, lambda: _act(conn, cfg, ring))


def _act(conn: PipeConnection, cfg: _ProcActorConfig, ring: ShmRolloutRing) -> None:
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.actor_learner import fill_rollout_slot

    torch.set_num_threads(ACTOR_TORCH_THREADS)
    agent = ImpalaAgent(cfg.args, cfg.obs_shape, cfg.num_actions, device="cpu")
    # the port's host-env factory with the thread plane's SAME_STEP
    # autoreset: the learner sees one trajectory convention whichever actor
    # mode produced the slots
    envs = make_host_envs(cfg.args.env_id, cfg.envs_per_actor, seed=cfg.seed,
                          env_backend=cfg.args.env_backend,
                          **({"atari": True} if cfg.atari else {}))
    try:
        B = cfg.envs_per_actor
        T = cfg.args.rollout_length
        obs, _ = envs.reset(seed=cfg.seed)
        last_action = np.zeros(B, np.int32)
        reward = np.zeros(B, np.float32)
        done = np.ones(B, bool)
        core_state = agent.initial_state(B)
        version = -1
        # read by the weight service before it answers the first request
        conn.send({"kind": "report", "actor_id": cfg.actor_id, **process_report(),
                   "torch_threads": torch.get_num_threads()})
        ep_ret = np.zeros(B, np.float64)
        returns: List[float] = []
        timings = Timings()  # pull / acquire / write_row / model / step / commit

        def on_step(rew: np.ndarray, dn: np.ndarray) -> None:
            nonlocal ep_ret
            ep_ret += rew
            for b in np.nonzero(dn)[0]:
                returns.append(float(ep_ret[b]))
                ep_ret[b] = 0.0

        while not ring.closed:
            timings.reset()
            reply = send_recv(conn, {"kind": "params", "have": version},
                              timeout=cfg.pull_timeout_s)
            if reply is not None:
                version = int(reply["version"])
                agent.set_weights({k: torch.from_numpy(v) for k, v in reply["weights"].items()})
            timings.time("pull")
            idx = ring.acquire(timeout=1.0)
            if idx is None:
                continue
            timings.time("acquire")
            try:
                slot = ring.slot(idx)
                returns.clear()
                obs, last_action, reward, done, core_state = fill_rollout_slot(
                    slot, agent, envs, obs, last_action, reward, done, core_state, T,
                    on_step=on_step, timings=timings,
                )
                slot["meta"][0] = cfg.actor_id
                slot["meta"][1] = version
            except BaseException:
                # a failure mid-fill hands the slot back before it
                # propagates, or each elastic restart strands one slot
                slot = None  # drop the views first so detach() can close
                ring.release(idx)
                raise
            slot = None  # a live view at loop exit keeps the mapping exported
            ring.commit(idx)
            timings.time("commit")
            # returns (maybe none) and the running phase means, each slot
            conn.send({"kind": "stats", "actor_id": cfg.actor_id, "returns": list(returns),
                       "timings": timings.means()})
    finally:
        try:
            envs.close()
        except Exception:  # noqa: BLE001 - teardown goes on
            pass


def slot_fields(agent, unroll_length: int, envs_per_actor: int
                ) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """The ring's slot layout for ``agent``: one actor's ``[T+1, B]``
    trajectory (``data/trajectory.py``'s rows; uint8 pixels, float32 flat
    observations), its entering core state, and ``meta`` (actor id, weight
    version), as the JAX trainer lays it out."""
    T1, B = unroll_length + 1, envs_per_actor
    obs_dtype = "uint8" if len(agent.obs_shape) == 3 else "float32"
    fields: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
        "obs": ((T1, B) + tuple(agent.obs_shape), np.dtype(obs_dtype)),
        "action": ((T1, B), np.dtype(np.int32)),
        "reward": ((T1, B), np.dtype(np.float32)),
        "done": ((T1, B), np.dtype(bool)),
        "logits": ((T1, B, agent.num_actions), np.dtype(np.float32)),
        "meta": ((2,), np.dtype(np.float64)),
    }
    for i, (c, h) in enumerate(agent.initial_state(B)):
        fields[f"core_{i}_c"] = (tuple(c.shape), np.dtype(np.float32))
        fields[f"core_{i}_h"] = (tuple(h.shape), np.dtype(np.float32))
    return fields


class ProcessActorLearnerTrainer(ProcessPlaneMixin, HostPlaneMixin, BaseTrainer):
    """IMPALA with actor processes (the reference's topology, shm ring)."""

    def __init__(
        self,
        args: ImpalaArguments,
        agent,
        envs_per_actor: Optional[int] = None,
        run_name: Optional[str] = None,
        max_actor_restarts: int = 0,
    ) -> None:
        """``max_actor_restarts``: elastic actors.  An actor that fails is
        respawned (same id, seed and config, a fresh pipe) up to this many
        times across the run instead of failing the learner.

        Contract: recovery is guaranteed only for *funneled* failures (the
        actor caught its exception and sent ``{"kind": "error"}``: env
        crashes, errors in the actor's Python); the actor releases its
        acquired-but-uncommitted slot before the error propagates, so the
        ring stays whole.  A hard-killed actor (SIGKILL) is respawned
        best-effort, but one that died between claiming and publishing a
        ring cell wedges the lock-free ring for every later consumer at
        that position; no user-space recovery exists for that.  0 (the
        default) fails fast."""
        super().__init__(args, run_name=run_name)
        self.agent = agent
        # args.num_envs is the TOTAL lane count; each actor drives its share
        self.envs_per_actor = envs_per_actor or max(args.num_envs // args.num_actors, 1)
        # slot-aware ring floor: a learn step pops batch_size/envs_per_actor
        # full slots; a shallower ring starves it
        check_queue_depth(args, self.envs_per_actor)
        self.param_server = ParameterServer()
        self.returns: List[float] = []
        self.learn_timings = Timings()
        self.env_frames = 0
        self.learn_steps = 0
        self.stop_event = threading.Event()
        self.max_actor_restarts = max_actor_restarts
        self.actor_restarts = 0
        self._restart_lock = threading.Lock()

        fields = slot_fields(agent, args.rollout_length, self.envs_per_actor)
        # built here, before any child spawns: children load the same library
        self.ring = ShmRolloutRing(SlotSpec(fields), num_slots=args.num_buffers)
        self._init_process_plane(_proc_actor_main)

    def _may_respawn(self, actor_id: int, exc: BaseException) -> bool:
        return self.grant_actor_restart(actor_id, exc)

    def _actor_configs(self) -> List[_ProcActorConfig]:
        env_id = self.args.env_id
        atari = env_id.startswith("ALE/") or "NoFrameskip" in env_id
        return [
            _ProcActorConfig(
                actor_id=i, args=self.args, obs_shape=tuple(self.agent.obs_shape),
                num_actions=self.agent.num_actions, envs_per_actor=self.envs_per_actor,
                seed=self.args.seed + 7919 * i, pull_timeout_s=self.pull_timeout_s, atari=atari,
            )
            for i in range(self.args.num_actors)
        ]

    # -- learner -------------------------------------------------------
    def _pop_batch(self, n_slots: int) -> Optional[List[int]]:
        idxs: List[int] = []
        while len(idxs) < n_slots:
            if self._actor_error:
                for i in idxs:
                    self.ring.release(i)
                self.raise_actor_error()
            # verified pop: a torn or corrupt slot is detected, released, skipped
            idx = self.ring.pop_full_verified(timeout=1.0)
            if idx is None:
                if self.ring.closed or self.stop_event.is_set():
                    for i in idxs:
                        self.ring.release(i)
                    return None
                continue
            idxs.append(idx)
        return idxs

    def _batch_to_host(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        """The popped slots as one host batch: lanes concatenated (time-major
        fields on axis 1, core states on axis 0), copied out of the ring."""
        views = [self.ring.slot(i) for i in idxs]
        batch: Dict[str, np.ndarray] = {}
        for name in views[0]:
            if name == "meta":
                continue
            axis = 0 if name.startswith("core_") else 1
            batch[name] = np.concatenate([v[name] for v in views], axis=axis)
        self._lag = float(np.mean([self.param_server.version - v["meta"][1] for v in views]))
        return batch

    def train(self, total_frames: Optional[int] = None) -> Dict[str, float]:
        from scalerl_torch.data.trajectory import batch_to_trajectory
        from scalerl_torch.runtime.dispatch import get_metrics

        args = self.args
        total_frames = total_frames or args.total_steps
        frames_per_slot = args.rollout_length * self.envs_per_actor
        n_slots = max(args.batch_size // self.envs_per_actor, 1)
        if self.resuming:
            self.try_resume()
        self.param_server.push(self.agent.get_weights(), to_host=False)
        if not self.procs:
            self.start_actors()
        # a preemption saves at the next slot boundary; the watchdog dumps
        # stacks and ring occupancy when frames stop advancing
        guard = PreemptionGuard().install() if args.handle_preemption else None
        watchdog: Optional[StallWatchdog] = None
        if args.watchdog_timeout_s > 0:
            watchdog = StallWatchdog(args.watchdog_timeout_s, name="process-actor-learner")
            watchdog.watch("env_frames", lambda: self.env_frames)
            watchdog.add_probe("shm_ring", self.ring.stats)
            watchdog.add_probe("actor_restarts", lambda: self.actor_restarts)
            watchdog.add_probe("actors_alive", lambda: sum(p.is_alive() for p in self.procs))
            watchdog.start()
        start = time.time()
        start_frames = self.env_frames  # nonzero after a resume
        last_log = start_frames
        cadence = CheckpointCadence(args.save_frequency, args.checkpoint_interval_s, start_frames)
        saving = args.save_model and not args.disable_checkpoint
        metrics: Dict = {}
        self._lag = float("nan")
        try:
            while self.env_frames < total_frames and not self.stop_event.is_set():
                if watchdog is not None:
                    watchdog.check()
                if guard is not None and guard.triggered:
                    if saving:
                        self.save_resume()
                    break
                self.learn_timings.reset()
                idxs = self._pop_batch(n_slots)
                if idxs is None:
                    break
                self.learn_timings.time("dequeue")
                batch = self._batch_to_host(idxs)  # copies out of the slots
                for i in idxs:
                    self.ring.release(i)
                traj = batch_to_trajectory(batch, self.agent.device)
                self.learn_timings.time("host_batch")
                metrics = self.agent.learn_device(traj)
                self.learn_timings.time("learn")
                self.learn_steps += 1
                self.param_server.push(self.agent.get_weights(), to_host=False)
                self.learn_timings.time("push")
                self.env_frames += n_slots * frames_per_slot

                if saving and cadence.due(self.env_frames):
                    cadence.mark_saved(self.env_frames)
                    self.save_resume()

                if self.env_frames - last_log >= args.logger_frequency:
                    last_log = self.env_frames
                    sps = (self.env_frames - start_frames) / max(time.time() - start, 1e-8)
                    ret = float(np.mean(self.returns[-50:])) if self.returns else float("nan")
                    host_metrics = get_metrics(metrics)  # one batched copy
                    self.log(self.env_frames, "train", {**host_metrics, "sps": sps,
                                                        "return_mean": ret,
                                                        "weights_lag": self._lag})
                    if self._instrument:
                        telemetry.observe_train_metrics(host_metrics)
                        telemetry.get_registry().set_gauges(
                            {**host_metrics, "sps": sps, "return_mean": ret,
                             "weights_lag": self._lag}, prefix="train.")
                        self.logger.log_registry(self.env_frames, step_type="train",
                                                 include_prefixes=("train.", "ring."))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"frames {self.env_frames} | sps {sps:.0f} | return {ret:.1f} | "
                            f"lag {self._lag:.1f}")
        finally:
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.restore()
            self.stop()
        if saving:
            self.save_resume()
        sps = (self.env_frames - start_frames) / max(time.time() - start, 1e-8)
        return {
            **get_metrics(metrics),
            "env_frames": float(self.env_frames),
            "sps": float(sps),
            "return_mean": float(np.mean(self.returns[-100:])) if self.returns else float("nan"),
            "episodes": float(len(self.returns)),
        }
