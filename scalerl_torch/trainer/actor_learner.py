"""Actor-learner trainers: the host actor plane (SEED-style) and the fused
device loop, each with its run directory, logger, telemetry, resume
checkpoints, preemption guard and stall watchdog.

Port of ``scalerl_tpu/trainer/actor_learner.py``:

- :class:`HostActorLearnerTrainer` (``actor_mode="threads"``): actor
  threads step host envs only; every policy forward is the agent's central
  batched ``act`` on the device.  Each actor owns a vector env, fills
  numpy trajectory slots (:func:`fill_rollout_slot`) from a free/full
  ``RolloutQueue``; the learner thread drains ``batch_size`` lanes of slots,
  ships them (``batch_to_trajectory``) and takes one learn step.  Actors act
  on the learner's newest parameters (the agent swaps its state whole, see
  ``agents/policy_value.py``), and a ``ParameterServer`` snapshot is pushed
  each step for off-host consumers.  A crashed actor rebuilds its env from
  its factory within the ``max_actor_restarts`` budget; past it the error
  re-raises in the learner.  ``num_learner_threads >= 2`` assembles batches
  in prefetch threads.  ``actor_mode="serving"``: the one policy lives in
  an ``InferenceServer`` (``serving/server.py``) on the agent's device and
  each actor thread acts through its own ``RemotePolicyClient`` over an
  in-process codec link (``local_pair``), the wire a remote env shell
  speaks over a socket; the learner pushes its parameters to the server
  after each learn step, reports the staleness of the oldest client's last
  served generation at each log, and closes the clients before the server
  at teardown.  The agent is each client's local fallback
  (``serving_client.fallbacks`` counts its use).  ``"process"`` is
  ``trainer/process_actor_learner.py``'s and refused here.
- :class:`DeviceActorLearnerTrainer`: IMPALA over the port's tensor envs
  through ``DeviceActorLearnerLoop.run``; a preemption stops dispatch at the
  next chunk boundary and the checkpoint records the chunks done.

Checkpoint saves, logger writes and telemetry marks happen at cadence or
log boundaries only, never inside a warm fused chunk.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.config import ImpalaArguments
from scalerl_torch.data.trajectory import TrajectorySpec, batch_to_trajectory
from scalerl_torch.parallel.sharding import gather_tree
from scalerl_torch.parallel.train_step import (
    RankAgreement,
    maybe_enable_mesh_from_args,
    place_agent_state,
)
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.rollout_queue import RolloutQueue
from scalerl_torch.runtime.supervisor import CheckpointCadence, PreemptionGuard, StallWatchdog
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics
from scalerl_torch.utils.profiling import maybe_trace
from scalerl_torch.utils.timers import Timings


def fill_rollout_slot(
    slot,
    agent,
    envs,
    obs,
    last_action,
    reward,
    done,
    core_state,
    unroll_length: int,
    on_step=None,
    timings: Optional[Timings] = None,
):
    """Write one ``[T+1, B]`` trajectory slot (``data/trajectory.py``'s row
    convention: each row holds the model's inputs at that step; row T is
    input-only, its logits zero, so the core never advances over ``obs_T``
    twice).  Returns the carried ``(obs, last_action, reward, done,
    core_state)``.  ``on_step(reward, done)`` fires after every env step;
    ``timings`` records the ``write_row`` / ``model`` / ``step`` split."""
    for i, (c, h) in enumerate(core_state):
        slot[f"core_{i}_c"][:] = _host(c)
        slot[f"core_{i}_h"][:] = _host(h)
    for t in range(unroll_length + 1):
        slot["obs"][t] = obs
        slot["action"][t] = last_action
        slot["reward"][t] = reward
        slot["done"][t] = done
        if timings is not None:
            timings.time("write_row")
        if t == unroll_length:
            slot["logits"][t] = 0.0
            break
        action, logits, core_state = agent.act(obs, last_action, reward, done, core_state)
        slot["logits"][t] = logits
        if timings is not None:
            timings.time("model")
        obs, reward, term, trunc, _ = envs.step(np.asarray(action))
        done = np.logical_or(term, trunc)
        reward = np.asarray(reward, np.float32)
        last_action = np.asarray(action, np.int32)
        if on_step is not None:
            on_step(reward, done)
        if timings is not None:
            timings.time("step")
    return obs, last_action, reward, done, core_state


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _ActorThread(threading.Thread):
    """One actor: owns a vector env, fills trajectory slots."""

    def __init__(self, actor_id: int, trainer, envs, policy=None) -> None:
        """``policy``: the acting facade (``act`` + ``initial_state``);
        the trainer's agent by default (R2D2 passes an epsilon-greedy
        view)."""
        super().__init__(name=f"actor-{actor_id}", daemon=True)
        self.actor_id = actor_id
        self.trainer = trainer
        self.envs = envs
        self.policy = policy if policy is not None else trainer.agent
        self.timings = Timings()

    def run(self) -> None:
        tr = self.trainer
        q = tr.queue
        while True:
            try:
                self._act_loop()
                return
            except Exception as e:  # noqa: BLE001 - restart or funnel
                if not tr.grant_actor_restart(self.actor_id, e):
                    q.report_error(e)
                    return
                # a crashed env stack is suspect (a dead worker cannot step
                # again): rebuild it from its factory
                try:
                    self.envs.close()
                except Exception:  # noqa: BLE001 - already broken
                    pass
                try:
                    self.envs = tr.env_fns[self.actor_id]()
                except Exception as rebuild_err:  # noqa: BLE001
                    q.report_error(rebuild_err)
                    return

    def _act_loop(self) -> None:
        tr = self.trainer
        agent = self.policy
        q = tr.queue
        T = tr.args.rollout_length
        B = self.envs.num_envs
        obs, _ = self.envs.reset(seed=tr.args.seed + 1000 * self.actor_id)
        last_action = np.zeros(B, np.int32)
        reward = np.zeros(B, np.float32)
        done = np.ones(B, bool)
        core_state = agent.initial_state(B)
        metrics = tr.episode_metrics[self.actor_id]
        while not tr.stop_event.is_set():
            idx = q.acquire(timeout=1.0)
            if idx is None:
                continue
            self.timings.reset()
            committed = False
            try:
                obs, last_action, reward, done, core_state = fill_rollout_slot(
                    q.slots[idx], agent, self.envs, obs, last_action, reward, done,
                    core_state, T, on_step=metrics.step, timings=self.timings,
                )
                q.commit(idx)
                committed = True
            except BaseException:
                # a crash mid-fill must hand the slot back, or the pool
                # shrinks one slot per restart until acquire starves
                if not committed:
                    q.recycle([idx])
                raise
            self.timings.time("write")
            with tr.frame_lock:
                tr.env_frames += T * B


class HostPlaneMixin:
    """Host-plane scaffolding: the elastic-actor restart budget and the
    agent-state resume trio.  Expects ``agent``, ``env_frames``,
    ``param_server``, ``max_actor_restarts``, ``actor_restarts`` and
    ``_restart_lock`` beside ``BaseTrainer``'s resume plumbing."""

    def grant_actor_restart(self, actor_id: int, exc: BaseException) -> bool:
        """Take one unit of the elastic-actor budget; False = fail fast."""
        with self._restart_lock:
            if self.actor_restarts >= self.max_actor_restarts:
                return False
            self.actor_restarts += 1
            used = self.actor_restarts
        if self.is_main_process:
            self.text_logger.warning(
                f"actor {actor_id} crashed ({type(exc).__name__}: {exc}); "
                f"rebuilding its envs (restart {used}/{self.max_actor_restarts})"
            )
        return True

    def _resume_pytree(self) -> Dict:
        # a meshed state is saved whole (every rank gathers, the main one writes)
        return {"agent": gather_tree(self.agent.state),
                "env_frames": np.asarray(self.env_frames, np.int64)}

    def save_resume(self) -> None:
        self.save_resume_checkpoint(self._resume_pytree(), self.env_frames,
                                    int(self.agent.state.step))

    def try_resume(self) -> bool:
        """Restore the learner's state and the frame counter."""
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = place_agent_state(self.agent, state["agent"])
        self.env_frames = int(state["env_frames"])
        self.param_server.push(self.agent.get_weights(), to_host=False)
        if self.is_main_process:
            self.text_logger.info(f"resumed from {self.resume_ckpt_path}: frames {self.env_frames}")
        return True


def check_queue_depth(args, envs_per_actor: int) -> None:
    """The slot-aware queue floor, which needs the env fleet's shape: one
    learn step drains ``batch_size / envs_per_actor`` slots, and every
    actor must be able to hold a slot while the learner drains a batch."""
    n_slots = max(args.batch_size // envs_per_actor, 1)
    floor = max(2 * n_slots, args.num_actors)
    if args.num_buffers < floor:
        raise ValueError(
            f"num_buffers ({args.num_buffers} slots of {envs_per_actor} "
            f"lanes) must be at least max(2 * batch_size/envs_per_actor, "
            f"num_actors) = {floor} so the learner can drain a full batch "
            "while every actor holds a slot"
        )


def _refuse_process_mode(args) -> None:
    if args.actor_mode == "process":
        raise ValueError(
            "actor_mode='process' is ProcessActorLearnerTrainer's "
            "(trainer/process_actor_learner.py), not this trainer's"
        )


class HostActorLearnerTrainer(HostPlaneMixin, BaseTrainer):
    def __init__(
        self,
        args: ImpalaArguments,
        agent: ImpalaAgent,
        env_fns,  # one callable per actor, each building a vector env
        run_name: Optional[str] = None,
        max_actor_restarts: int = 0,
    ) -> None:
        """``max_actor_restarts``: how many times, across all actors, a
        crashed actor may rebuild its env and go on (0: the crash re-raises
        in the learner)."""
        _refuse_process_mode(args)
        super().__init__(args, run_name=run_name)
        self.agent = agent
        # RLArguments' mesh_shape / dp_size / mp_size, before any actor starts
        maybe_enable_mesh_from_args(agent, args)
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
        obs_space = probe_env.single_observation_space
        num_actions = probe_env.single_action_space.n
        self._probe_env = probe_env

        core = agent.initial_state(self.envs_per_actor)
        self.spec = TrajectorySpec(
            unroll_length=args.rollout_length,
            batch_size=self.envs_per_actor,
            obs_shape=tuple(obs_space.shape),
            num_actions=num_actions,
            obs_dtype=np.float32 if len(obs_space.shape) == 1 else np.uint8,
            core_state_shapes=tuple(tuple(c.shape) for c, _ in core),
        )
        check_queue_depth(args, self.envs_per_actor)
        self.queue = RolloutQueue(self.spec, num_slots=args.num_buffers)
        self.episode_metrics = [EpisodeMetrics(self.envs_per_actor) for _ in env_fns]
        self.learn_timings = Timings()
        self.learn_steps = 0

        # actor_mode="serving": the inference plane.  A server that cannot
        # start raises here; the agent is only each client's fallback.
        self.inference_server = None
        self._serving_clients: list = []
        if args.actor_mode == "serving":
            from scalerl_torch.serving import (
                InferenceServer,
                RemotePolicyClient,
                ServingConfig,
                local_pair,
            )

            self.inference_server = InferenceServer(agent, ServingConfig.from_args(args))
            self.inference_server.start()
            for _ in env_fns:
                client_end, server_end = local_pair()
                self.inference_server.add_connection(server_end)
                self._serving_clients.append(RemotePolicyClient(conn=client_end, fallback=agent))

    def _stop_serving(self) -> None:
        """Clients first: closing one wakes its blocked actor, which ends
        its slot on the local fallback without a degraded-mode flip; then
        the server.  Idempotent."""
        for c in self._serving_clients:
            c.close()
        if self.inference_server is not None:
            self.inference_server.stop()

    def close(self) -> None:
        self._stop_serving()
        super().close()

    def _assemble_batch(self, n_slots: int, timings: Optional[Timings] = None):
        """Drain ``n_slots`` full slots into one device trajectory (the one
        assembly path of the inline loop and the prefetch threads)."""
        batch, idxs = self.queue.get_batch(n_slots)
        if timings is not None:
            timings.time("dequeue")
        traj = batch_to_trajectory(batch, self.agent.device)
        self.queue.recycle(idxs)
        if timings is not None:
            timings.time("device")
        return traj

    def train(self, total_frames: Optional[int] = None) -> Dict[str, float]:
        args = self.args
        total_frames = total_frames or args.total_steps
        if self.resuming:
            self.try_resume()
        actors = [_ActorThread(i, self, self._probe_env if i == 0 else fn(),
                               policy=self._serving_clients[i] if self._serving_clients else None)
                  for i, fn in enumerate(self.env_fns)]
        self.actors = actors
        # installed after the envs are built, so a failing factory cannot
        # leak signal handlers (the finally below owns the teardown)
        guard = PreemptionGuard().install() if args.handle_preemption else None
        watchdog: Optional[StallWatchdog] = None
        learn_progress = None
        if args.watchdog_timeout_s > 0:
            watchdog = StallWatchdog(args.watchdog_timeout_s, name="host-actor-learner")
            watchdog.watch("env_frames", lambda: self.env_frames)
            learn_progress = watchdog.counter("learn_steps")
            watchdog.add_probe("rollout_queue", self.queue.stats)
            watchdog.add_probe("actor_restarts", lambda: self.actor_restarts)
            watchdog.start()
        for a in actors:
            a.start()

        start = time.time()
        start_frames = self.env_frames  # nonzero after a resume
        last_log_frames = start_frames
        fps_meter = learn_meter = None
        if self._instrument:
            reg = telemetry.get_registry()
            fps_meter = reg.meter("rates.fps")
            learn_meter = reg.meter("rates.learn_steps_per_s")
        meter_frames, meter_steps = start_frames, 0
        cadence = CheckpointCadence(args.save_frequency, args.checkpoint_interval_s,
                                    start_frames)
        saving = args.save_model and not args.disable_checkpoint
        n_slots = max(args.batch_size // self.envs_per_actor, 1)
        metrics: Dict = {}
        learn_steps_done = 0

        prefetch_q: Optional[queue_mod.Queue] = None
        assemble_threads: list = []
        if args.num_learner_threads >= 2:
            prefetch_q = queue_mod.Queue(maxsize=2)

            def _put(item) -> bool:
                # a bounded put that gives up at shutdown
                while True:
                    try:
                        prefetch_q.put(item, timeout=0.5)
                        return True
                    except queue_mod.Full:
                        if self.stop_event.is_set():
                            return False

            def _assemble() -> None:
                try:
                    while not self.stop_event.is_set():
                        if not _put(self._assemble_batch(n_slots)):
                            return
                except BaseException as e:  # noqa: BLE001 — re-raised by next_traj
                    _put(e)

            for i in range(args.num_learner_threads - 1):
                t = threading.Thread(target=_assemble, name=f"learner-assemble-{i}",
                                     daemon=True)
                t.start()
                assemble_threads.append(t)

        def next_traj():
            self.learn_timings.reset()
            if prefetch_q is None:
                return self._assemble_batch(n_slots, timings=self.learn_timings)
            while True:
                try:
                    item = prefetch_q.get(timeout=0.5)
                    break
                except queue_mod.Empty:
                    if self.stop_event.is_set():
                        raise RuntimeError("rollout queue closed")
            self.learn_timings.time("dequeue")
            if isinstance(item, BaseException):
                raise item
            return item

        # under a mesh of several ranks, total_frames counts the frames of
        # every rank, and each decision that gates a learn step is taken
        # alike on all of them
        agree = RankAgreement(getattr(self.agent, "mesh", None))
        try:
            while True:
                frames, halted, preempted = agree(
                    self.env_frames, self.stop_event.is_set(),
                    guard is not None and guard.triggered)
                if frames >= total_frames or halted:
                    break
                if watchdog is not None:
                    watchdog.check()
                if preempted:
                    # a safe point: the last learn step is complete and
                    # no slot is half consumed
                    if saving:
                        self.save_resume()
                    break
                traj = next_traj()
                # metrics stay on the device until a log boundary
                metrics = self.agent.learn_device(traj)
                self.learn_timings.time("learn")
                learn_steps_done += 1
                self.learn_steps += 1
                if learn_progress is not None:
                    learn_progress.bump()
                self.param_server.push(self.agent.get_weights(), to_host=False)
                if self.inference_server is not None:
                    # a new generation: every reply from here on is tagged
                    # with it (a flush in flight keeps its old tag)
                    self.inference_server.push_params(self.agent.get_weights(),
                                                      learner_step=learn_steps_done)

                (frames,) = agree(self.env_frames)
                _, save_due = agree(0, saving and cadence.due(frames))
                if save_due:
                    cadence.mark_saved(frames)
                    self.save_resume()

                if frames - last_log_frames >= args.logger_frequency:
                    last_log_frames = frames
                    sps = (frames - start_frames) / max(time.time() - start, 1e-8)
                    rets = [r for m in self.episode_metrics for r in m.episode_returns[-20:]]
                    ret_mean = float(np.mean(rets)) if rets else float("nan")
                    host_metrics = get_metrics(metrics)  # one batched copy
                    if self.inference_server is not None:
                        # the lag between the newest push and the oldest
                        # client's last served generation: the staleness
                        # V-trace corrects
                        self.inference_server.observe_staleness(
                            min(c.generation for c in self._serving_clients))
                    self.log(self.env_frames, "train", {**host_metrics, "sps": sps,
                                                        "return_mean": ret_mean,
                                                        "learn_steps": learn_steps_done})
                    if self._instrument:
                        fps_meter.mark(self.env_frames - meter_frames)
                        meter_frames = self.env_frames
                        learn_meter.mark(learn_steps_done - meter_steps)
                        meter_steps = learn_steps_done
                        telemetry.observe_train_metrics(host_metrics)
                        telemetry.get_registry().set_gauges(
                            {**host_metrics, "sps": sps, "return_mean": ret_mean},
                            prefix="train.")
                        self.logger.log_registry(self.env_frames, step_type="train",
                                                 include_prefixes=("train.", "queue."))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"frames {self.env_frames} | sps {sps:.0f} | return "
                            f"{ret_mean:.1f} | loss "
                            f"{host_metrics.get('total_loss', float('nan')):.3f}"
                        )
        finally:
            self.stop_event.set()
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.restore()
            self.queue.close()
            self._stop_serving()
            # joins share one wall-clock budget a group (a wedged env must
            # not multiply the teardown), shorter after a diagnosed stall
            stalled = watchdog is not None and watchdog.stalled is not None
            deadline = time.monotonic() + (0.5 if stalled else 3.0)
            for t in assemble_threads:
                t.join(timeout=max(0.05, deadline - time.monotonic()))
            if prefetch_q is not None:
                while True:  # release device trajectories still queued
                    try:
                        prefetch_q.get_nowait()
                    except queue_mod.Empty:
                        break
            deadline = time.monotonic() + (0.5 if stalled else 5.0)
            for a in actors:
                a.join(timeout=max(0.05, deadline - time.monotonic()))
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
            "return_mean": float(np.mean(rets[-100:])) if rets else float("nan"),
            "episodes": float(len(rets)),
        }


class DeviceActorLearnerTrainer(BaseTrainer):
    """IMPALA over the port's tensor envs through the fused loop."""

    def __init__(
        self,
        args: ImpalaArguments,
        agent: ImpalaAgent,
        venv,
        iters_per_call: int = 10,
        run_name: Optional[str] = None,
        chunks_in_flight: int = 2,
    ) -> None:
        """``chunks_in_flight``: fused chunks dispatched ahead of the host's
        batched metric read (1 reads after every chunk)."""
        super().__init__(args, run_name=run_name)
        from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

        self.agent = agent
        self.venv = venv
        self.iters_per_call = iters_per_call
        self.chunks_in_flight = chunks_in_flight
        # the agent owns the loss hyperparameters
        self.learn_fn = agent.make_learn_fn()
        self.loop: Optional[DeviceActorLearnerLoop] = None

    def _resume_pytree(self) -> Dict:
        return {"agent": self.agent.state, "env_frames": np.asarray(0, np.int64)}

    def train(self, total_frames: Optional[int] = None) -> Dict[str, float]:
        from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

        args = self.args
        total_frames = total_frames or args.total_steps
        frames_per_call = args.rollout_length * self.venv.num_envs * self.iters_per_call
        done_frames = 0
        if self.resuming:
            prev = self.load_resume_checkpoint(self._resume_pytree())
            if prev is not None:
                self.agent.state = prev["agent"]
                done_frames = int(prev["env_frames"])
                if self.is_main_process:
                    self.text_logger.info(
                        f"resumed from {self.resume_ckpt_path}: frames {done_frames}")
        remaining = total_frames - done_frames
        if remaining <= 0:
            # a finished run: nothing to do
            if self.is_main_process:
                self.text_logger.info(
                    f"resume frames {done_frames} >= budget {total_frames}; no-op")
            return {"env_frames": float(done_frames), "sps": 0.0}
        num_calls = max(remaining // frames_per_call, 1)
        # a resumed run draws a new stream, as the reference keys its loop
        self.loop = loop = DeviceActorLearnerLoop(
            self.agent.model, self.venv, self.learn_fn, args.rollout_length,
            iters_per_call=self.iters_per_call, seed=args.seed + done_frames % 65537,
            device=self.agent.device,
        )
        carry = loop.init_carry()
        start = time.time()

        def on_metrics(i: int, m: Dict[str, float]) -> None:
            # offset by done_frames: a resumed run's timeline continues
            frames = done_frames + (i + 1) * frames_per_call
            sps = (frames - done_frames) / max(time.time() - start, 1e-8)
            self.log(frames, "train", {**m, "sps": sps})
            if self._instrument:
                telemetry.get_registry().set_gauges({**m, "sps": sps}, prefix="train.")
                self.logger.log_registry(frames, step_type="train", include_prefixes=("train.",))
            if self.is_main_process and (i % 10 == 0 or i == num_calls - 1):
                self.text_logger.info(
                    f"frames {frames} | sps {sps:.0f} | return "
                    f"{m.get('return_mean', float('nan')):.2f}")

        guard = PreemptionGuard().install() if args.handle_preemption else None
        watchdog: Optional[StallWatchdog] = None
        progress = None
        if args.watchdog_timeout_s > 0:
            watchdog = StallWatchdog(args.watchdog_timeout_s, name="device-actor-learner")
            progress = watchdog.counter("fused_chunks")
            watchdog.start()
        try:
            with maybe_trace(args.profile_dir or None):
                state, carry, metrics = loop.run(
                    self.agent.state, carry, num_calls, on_metrics=on_metrics,
                    chunks_in_flight=self.chunks_in_flight, progress=progress,
                    should_stop=(lambda: guard.triggered) if guard is not None else None,
                    instrument=self._instrument,
                )
        finally:
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.restore()
        self.agent.state = state
        # after a preemption chunks_done < num_calls: record the frames
        # trained, not the budget
        chunks_done = int(metrics.pop("chunks_done", num_calls))
        frames = done_frames + chunks_done * frames_per_call
        if args.save_model and not args.disable_checkpoint:
            self.save_resume_checkpoint(
                {"agent": state, "env_frames": np.asarray(frames, np.int64)},
                frames, int(state.step))
        metrics["env_frames"] = float(frames)
        metrics["sps"] = (frames - done_frames) / max(time.time() - start, 1e-8)
        metrics["chunks_done"] = float(chunks_done)
        return metrics
