"""Ape-X: distributed prioritized experience replay (Horgan et al. 2018).

Port of ``scalerl_tpu/trainer/apex.py``:

- **Actors** are threads, each driving its own vector env with its own
  epsilon ``eps_i = base^(1 + i/(N-1) * alpha)`` and its own device
  generator.  They act by central inference on the card through their own
  copy of the Q-network (``functional_call`` swaps a module's parameters in
  place, so two threads must not run one module), fold each rollout chunk
  into n-step transitions on the host (:func:`fold_n_step`), compute the
  transitions' initial priorities (|TD| under one read of the agent's
  state, so ``params`` and ``target_params`` stay paired) and enqueue the
  slab, already on the device.
- **The learner** (the caller's thread) owns the replay: it drains slabs
  into it (``add_with_priorities``), samples with importance weights, runs
  the double-DQN update and writes the new priorities back.  With
  ``use_pallas`` the sample and the write-back are the CUDA kernels of
  ``ops/cuda_per.py``.  The learn step builds a new state and the agent
  swaps it in one assignment; nothing writes a tensor the actors read.
- **Weights**: actors read the learner's newest parameters directly; a
  ``ParameterServer`` snapshot is pushed every ``actor_update_frequency``
  learn steps for consumers off the process.

Resume checkpoints hold the agent's state, the whole replay and the
counters.  C51 raises, as the JAX trainer does.

Under a meshed agent (``DQNAgent.enable_mesh``, or the args' ``mesh_shape``
/ ``dp_size`` / ``mp_size``; one process a device) the
replay is a ``ShardedPrioritizedReplay`` (``data/sharded_replay.py``) over
the learner's ``dp`` x ``fsdp`` ranks.  Each rank runs its own actors, and
one global add is every rank's slab side by side: the buffer is
``world x slab`` lanes wide, a replay shard's block holds the slabs of
its ranks (those that differ only in mp are gathered over mp, the one
insert traffic: each such rank receives the others' slabs), and the ranks
add in lockstep, agreeing on the count each drain with one all-reduce
(min).  So the state is the unsharded buffer's under that sequence of
adds, with ``buffer_size`` transitions of capacity.  Each rank samples its
shard's ``batch_size / S`` rows, learns on them (the agent's step in its
``"replay_shard"`` batch mode) and writes their priorities back to its own block.
Actors act on the learner's acting copies of ``params`` and
``target_params``, which the learner thread publishes after each step, so
no actor issues a collective.  Stopping, saving and the frame count are
agreed across ranks (``RankAgreement``), and a checkpoint holds the replay
gathered whole.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from scalerl_torch.agents.dqn import DQNAgent, make_dqn_priority_fn
from scalerl_torch.config import ApexArguments
from scalerl_torch.data.prioritized import PrioritizedReplayBuffer
from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
from scalerl_torch.parallel.sharding import gather_batch, gather_tree, pool_axes, pool_batch
from scalerl_torch.parallel.train_step import (
    RankAgreement,
    maybe_enable_mesh_from_args,
    multi_rank,
    place_agent_state,
)
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.runtime.param_server import ParameterServer
from scalerl_torch.runtime.supervisor import CheckpointCadence, PreemptionGuard, StallWatchdog
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics
from scalerl_torch.utils.schedulers import LinearDecayScheduler
from scalerl_torch.utils.timers import Timings


def fold_n_step(
    obs: np.ndarray,  # [T, W, ...]
    action: np.ndarray,  # [T, W]
    reward: np.ndarray,  # [T, W]
    next_obs: np.ndarray,  # [T, W, ...]
    term: np.ndarray,  # [T, W] bool: episode terminated (no bootstrap)
    trunc: np.ndarray,  # [T, W] bool: episode truncated (bootstrap, no reward leak)
    gamma: float,
    n: int,
) -> Dict[str, np.ndarray]:
    """Fold a rollout chunk into ``[(T-n+1) * W]`` n-step transitions, on
    the host.

    Rewards accumulate up to and including the first episode boundary
    (termination or truncation, never across an autoreset); ``next_obs``
    bootstraps from that boundary step (for a truncation, the stashed final
    observation); ``done`` holds only for a termination; ``n_steps`` is the
    realised window length for the ``gamma**n`` discount."""
    T, W = reward.shape[:2]
    m = T - n + 1
    if m <= 0:
        raise ValueError(f"rollout of {T} steps cannot fold n_step={n} windows")
    stop = term | trunc  # any episode boundary cuts the window
    stopf = stop.astype(np.float32)
    out_r = np.zeros((m, W), np.float32)
    alive = np.ones((m, W), np.float32)
    last = np.full((m, W), n - 1, np.int64)
    stop_found = np.zeros((m, W), bool)
    for k in range(n):
        out_r += (gamma**k) * alive * reward[k:k + m]
        s_k = stop[k:k + m]
        newly = s_k & ~stop_found
        last[newly] = k
        stop_found |= s_k
        alive *= 1.0 - stopf[k:k + m]
    rows = np.arange(m)[:, None] + last  # [m, W] absolute step index
    cols = np.broadcast_to(np.arange(W), (m, W))
    done = term[rows, cols]
    return {
        "obs": obs[:m].reshape((m * W,) + obs.shape[2:]),
        "action": action[:m].reshape(m * W),
        "reward": out_r.reshape(m * W),
        "next_obs": next_obs[rows, cols].reshape((m * W,) + next_obs.shape[2:]),
        "done": done.reshape(m * W),
        "n_steps": (last + 1).astype(np.int32).reshape(m * W),
    }


class ApexActorThread(threading.Thread):
    """One actor: its own env, epsilon, generator and model copy; enqueues
    prioritised slabs."""

    def __init__(self, actor_id: int, trainer: "ApexTrainer", envs) -> None:
        super().__init__(name=f"apex-actor-{actor_id}", daemon=True)
        self.actor_id = actor_id
        self.trainer = trainer
        self.envs = envs
        args = trainer.args
        frac = actor_id / max(max(args.num_actors, 1) - 1, 1)
        self.eps = float(args.eps_greedy_base ** (1 + frac * args.eps_greedy_alpha))
        agent = trainer.agent
        self.network = copy.deepcopy(trainer.act_template)
        self.priority = make_dqn_priority_fn(self.network, args.gamma, args.double_dqn)
        self.generator = torch.Generator(device=agent.device).manual_seed(
            args.seed * 1000 + actor_id)
        self.timings = Timings()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - funnelled to the learner
            self.error = e
            self.trainer._actor_error(self.actor_id, e)

    def _run(self) -> None:
        tr = self.trainer
        args, agent = tr.args, tr.agent
        T = args.rollout_length
        W = getattr(self.envs, "num_envs", 1)
        obs, _ = self.envs.reset(seed=args.seed + 7919 * self.actor_id)
        obs = np.asarray(obs)
        while not tr._stop.is_set():
            obs_buf = np.zeros((T, W) + obs.shape[1:], obs.dtype)
            act_buf = np.zeros((T, W), np.int32)
            rew_buf = np.zeros((T, W), np.float32)
            next_buf = np.zeros((T, W) + obs.shape[1:], obs.dtype)
            term_buf = np.zeros((T, W), bool)
            trunc_buf = np.zeros((T, W), bool)
            self.timings.reset()
            for t in range(T):
                obs_dev = torch.as_tensor(obs, device=agent.device).to(torch.float32)
                q = agent.q_values(tr.acting[0], obs_dev, network=self.network)
                actions = agent.epsilon_greedy(q, self.eps, self.generator).cpu().numpy()
                next_obs, reward, term, trunc, infos = self.envs.step(actions)
                real_next = np.array(next_obs, copy=True)
                final_obs = infos.get("final_obs") if isinstance(infos, dict) else None
                if final_obs is not None:
                    for i in np.nonzero(infos.get("_final_obs"))[0]:
                        real_next[i] = final_obs[i]
                obs_buf[t] = obs
                act_buf[t] = actions
                rew_buf[t] = reward
                next_buf[t] = real_next
                term_buf[t] = term
                trunc_buf[t] = trunc
                tr.metrics.step(reward, np.logical_or(term, trunc), lane0=self.actor_id * W)
                obs = np.asarray(next_obs)
            self.timings.time("rollout")
            slab = fold_n_step(obs_buf, act_buf, rew_buf, next_buf, term_buf, trunc_buf,
                               args.gamma, args.n_steps)
            self.timings.time("fold")
            # one upload: the device slab feeds both the priorities and,
            # through the queue, the learner's insert
            dev_slab = {k: torch.as_tensor(v, device=agent.device) for k, v in slab.items()}
            for k in ("obs", "next_obs"):
                dev_slab[k] = dev_slab[k].to(torch.float32)
            params, target = tr.acting  # one read: the two stay paired
            prio = self.priority(params, target, dev_slab["obs"],
                                 dev_slab["action"], dev_slab["reward"], dev_slab["next_obs"],
                                 dev_slab["done"], dev_slab["n_steps"])
            self.timings.time("priority")
            # a put that gives up at shutdown: a bare put() on a full queue
            # would outlive the learner
            while not tr._stop.is_set():
                try:
                    tr._slab_queue.put((dev_slab, prio), timeout=1.0)
                    break
                except queue.Full:
                    continue
            self.timings.time("enqueue")
            with tr._step_lock:
                tr.global_step += T * W


class ApexTrainer(BaseTrainer):
    """N prioritised actor threads and one PER learner."""

    def __init__(
        self,
        args: ApexArguments,
        agent: DQNAgent,
        make_envs,  # callable (actor_id) -> that actor's vector env
        eval_envs=None,
        run_name: Optional[str] = None,
    ) -> None:
        if args.categorical_dqn:
            raise ValueError(
                "categorical_dqn (C51) is not supported by ApexTrainer: its priority and "
                "learn paths are scalar-Q (make_dqn_priority_fn, make_dqn_learn_fn); use "
                "DQNAgent with OffPolicyTrainer for C51")
        super().__init__(args, run_name=run_name)
        self.agent = agent
        # RLArguments' mesh_shape / dp_size / mp_size, before any actor
        # starts; a meshed step learns on the rows of this rank's replay shard
        maybe_enable_mesh_from_args(agent, args, batch_mode="replay_shard")
        self.eval_envs = eval_envs
        self._actor_envs = [make_envs(i) for i in range(args.num_actors)]
        env0 = self._actor_envs[0]
        self.envs_per_actor = getattr(env0, "num_envs", 1)
        obs_shape = tuple(env0.single_observation_space.shape)
        # the actors' model copies come from this module, which nobody runs
        self.act_template = copy.deepcopy(agent.network)

        # a buffer row is one slab of pre-folded transitions (each storing
        # its realised window length), so the capacity in transitions
        # converts to rows, and n_step=1: no window spans two slabs
        slab_width = (args.rollout_length - args.n_steps + 1) * self.envs_per_actor
        buffer_kw = dict(
            obs_shape=obs_shape, alpha=args.per_alpha, n_step=1, gamma=args.gamma,
            sample_method="pallas" if args.use_pallas else "hierarchical",
            update_method="pallas" if args.use_pallas else "xla",
            extra_fields={"n_steps": ((), torch.int32)}, device=agent.device,
        )
        self.mesh = getattr(agent, "mesh", None)
        self._agree = RankAgreement(self.mesh)
        if self.mesh is not None:
            # one global add is every rank's slab side by side (module docstring)
            width = slab_width * self.mesh.size
            self.buffer = ShardedPrioritizedReplay(
                capacity=max(args.buffer_size // width, 2), mesh=self.mesh, num_envs=width,
                seed=args.seed + 0x53A1, **buffer_kw)
            self.generator = self.buffer.generator
            self._pool = pool_axes(self.mesh)  # the ranks that share a replay shard
            self._pending: list = []
        else:
            self.buffer = PrioritizedReplayBuffer(
                capacity=max(args.buffer_size // slab_width, 2), num_envs=slab_width,
                **buffer_kw)
            self.generator = torch.Generator(device=agent.device).manual_seed(
                args.seed + 0x53A1)
        self.per_beta = LinearDecayScheduler(args.per_beta, args.per_beta_final,
                                             args.max_timesteps)
        self._publish_acting()
        self.param_server = ParameterServer()
        self.param_server.push(agent.get_weights(), to_host=False)

        self._slab_queue: "queue.Queue" = queue.Queue(maxsize=4 * args.num_actors)
        self._stop = threading.Event()
        self._step_lock = threading.Lock()
        self._errors: "queue.Queue" = queue.Queue()
        self.global_step = 0
        self.learn_steps = 0
        self.metrics = EpisodeMetrics(args.num_actors * self.envs_per_actor)
        self.timings = Timings()
        self.actors: list = []

    # ------------------------------------------------------------------
    def _actor_error(self, actor_id: int, err: BaseException) -> None:
        self._errors.put((actor_id, err))

    def _publish_acting(self) -> None:
        """The ``(params, target_params)`` the actors read, in one
        assignment: the state's own without a mesh, else the acting copy
        and the target gathered once, here on the learner's thread."""
        st = self.agent.state
        target = st.target_params if self.mesh is None else gather_tree(st.target_params)
        self.acting = (self.agent.acting_params(), target)

    def _drain_slabs(self, block: bool) -> int:
        """Move the pending actor slabs into the replay (the one writer)."""
        if self.mesh is not None:
            return self._drain_in_lockstep(block)
        drained = 0
        while True:
            try:
                slab, prio = self._slab_queue.get(block=block and drained == 0, timeout=1.0)
            except queue.Empty:
                break
            self.buffer.add_with_priorities(slab, prio)
            self.timings.time("insert")
            drained += 1
        return drained

    def _drain_in_lockstep(self, block: bool) -> int:
        """The meshed drain: take what this rank's actors queued (up to the
        queue's depth), agree on the count every rank has, and add that
        many global steps, each rank its own slab (pooled over the ranks of
        its replay shard)."""
        limit = self._slab_queue.maxsize
        while len(self._pending) < limit:
            try:
                self._pending.append(self._slab_queue.get(
                    block=block and not self._pending, timeout=1.0))
            except queue.Empty:
                break
        count = self._agree.least(len(self._pending))
        for slab, prio in self._pending[:count]:
            if self._pool:
                slab = pool_batch(slab, self.mesh, self._pool)
                prio = gather_batch(prio, self.mesh, 0, self._pool)
            self.buffer.add_shard_with_priorities(slab, prio)
            self.timings.time("insert")
        del self._pending[:count]
        return count

    def train_step(self, frames: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Sample, learn, write the new priorities back; the metrics stay on
        the device.  ``frames``: the step count the beta schedule reads (the
        ranks' agreed count under a mesh), default ``global_step``."""
        beta = self.per_beta.value(self.global_step if frames is None else frames)
        self.timings.reset()
        batch = self.buffer.sample(self.args.batch_size, beta=beta, generator=self.generator)
        self.timings.time("sample")
        metrics, td_abs = self.agent.learn_device(batch)
        self._publish_acting()
        self.timings.time("learn")
        if self.mesh is None:
            self.buffer.update_priorities(batch["indices"], td_abs + 1e-6)
        else:  # this shard's own rows
            self.buffer.update_shard_priorities(batch["indices"], td_abs + 1e-6)
        self.timings.time("update_prio")
        self.learn_steps += 1
        if self.learn_steps % self.args.actor_update_frequency == 0:
            self.param_server.push(self.agent.get_weights(), to_host=False)
        return metrics

    # -- resume --------------------------------------------------------
    def _resume_pytree(self) -> Dict:
        # a meshed state and replay are saved whole (every rank gathers)
        return {
            "agent": gather_tree(self.agent.state),
            "replay": self.buffer.state if self.mesh is None else self.buffer.full_state(),
            "global_step": np.asarray(self.global_step, np.int64),
            "learn_steps": np.asarray(self.learn_steps, np.int64),
        }

    def save_resume(self) -> None:
        self.save_resume_checkpoint(self._resume_pytree(), self.global_step, self.learn_steps)

    def try_resume(self) -> bool:
        """Restore the learner's state, the whole prioritised replay and the
        counters; True when restored."""
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = place_agent_state(self.agent, state["agent"])
        if self.mesh is None:
            self.buffer.state = state["replay"]
        else:
            self.buffer.load_full_state(state["replay"])
        self._publish_acting()
        self.global_step = int(state["global_step"])
        self.learn_steps = int(state["learn_steps"])
        self.param_server.push(self.agent.get_weights(), to_host=False)
        if self.is_main_process:
            self.text_logger.info(f"resumed from {self.resume_ckpt_path}: step "
                                  f"{self.global_step}")
        return True

    def run_evaluate_episodes(self, n_episodes: Optional[int] = None) -> Dict[str, float]:
        """Greedy rollouts on the eval envs until ``n_episodes`` finish."""
        envs = self.eval_envs
        if envs is None:
            return {}
        n_episodes = n_episodes or self.args.eval_episodes
        num_envs = getattr(envs, "num_envs", 1)
        obs, _ = envs.reset(seed=self.args.seed + 100)
        returns: list = []
        ep_ret = np.zeros(num_envs)
        while len(returns) < n_episodes:
            actions = self.agent.predict(np.asarray(obs)).cpu().numpy()
            obs, reward, term, trunc, _ = envs.step(actions)
            ep_ret += reward
            for i in np.nonzero(np.logical_or(term, trunc))[0]:
                returns.append(ep_ret[i])
                ep_ret[i] = 0.0
        rets = np.array(returns[:n_episodes])
        return {"reward_mean": float(rets.mean()), "reward_std": float(rets.std())}

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        args = self.args
        saving = args.save_model and not args.disable_checkpoint
        if self.resuming:
            self.try_resume()
        guard = PreemptionGuard().install() if args.handle_preemption else None
        watchdog: Optional[StallWatchdog] = None
        if args.watchdog_timeout_s > 0:
            watchdog = StallWatchdog(args.watchdog_timeout_s, name="apex")
            watchdog.watch("global_step", lambda: self.global_step)
            watchdog.watch("learn_steps", lambda: self.learn_steps)
            watchdog.add_probe("slab_queue_depth", self._slab_queue.qsize)
            watchdog.add_probe("replay_size", lambda: len(self.buffer))
            watchdog.add_probe("actor_errors_pending", self._errors.qsize)
            watchdog.start()
        self.actors = [ApexActorThread(i, self, env) for i, env in enumerate(self._actor_envs)]
        for a in self.actors:
            a.start()

        start = time.time()
        # under a mesh of several ranks max_timesteps counts the steps of
        # every rank, and each decision that gates a collective is agreed
        agree = self._agree
        (start_step,) = agree(self.global_step)
        # seeded from the (possibly resumed) step, or the first iteration
        # logs and evaluates at once
        last_log = last_eval = start_step
        cadence = CheckpointCadence(args.save_frequency, args.checkpoint_interval_s, start_step)
        train_info: Dict = {}
        try:
            while True:
                frames, preempted, crashed = agree(
                    self.global_step, guard is not None and guard.triggered,
                    not self._errors.empty())
                if frames >= args.max_timesteps:
                    break
                if watchdog is not None:
                    watchdog.check()
                if preempted:
                    if saving:
                        self.save_resume()
                    break
                if crashed:
                    if self._errors.empty():
                        raise RuntimeError("an apex actor crashed on another rank")
                    actor_id, err = self._errors.get()
                    raise RuntimeError(f"apex actor {actor_id} crashed") from err
                self._drain_slabs(block=True)
                if len(self.buffer) >= args.warmup_learn_steps:
                    train_info = self.train_step(frames)

                if frames - last_log >= args.logger_frequency:
                    last_log = frames
                    fps = (frames - start_step) / max(time.time() - start, 1e-8)
                    summary = self.metrics.summary()
                    host = get_metrics(train_info)  # one batched device->host copy
                    counters = {"rpm_size": float(len(self.buffer)), "fps": fps,
                                "learn_steps": float(self.learn_steps),
                                "weight_version": float(self.param_server.version)}
                    self.log(frames, "train", {**host, **summary, **counters})
                    if self._instrument:
                        telemetry.observe_train_metrics(host)
                        reg = telemetry.get_registry()
                        reg.set_gauges({**host, **summary, **counters}, prefix="train.")
                        self.logger.log_registry(frames, step_type="train",
                                                 include_prefixes=("train.",))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"step {frames} | fps {fps:.0f} | return "
                            f"{summary.get('return_mean', float('nan')):.1f} | loss "
                            f"{host.get('loss', float('nan')):.4f} | learn {self.learn_steps}")

                if (self.eval_envs is not None
                        and frames - last_eval >= args.eval_frequency):
                    last_eval = frames
                    eval_info = self.run_evaluate_episodes()
                    self.log(frames, "eval", eval_info)
                    self.logger.log_test_data(eval_info, frames)

                _, save_due = agree(0, saving and cadence.due(frames))
                if save_due:
                    cadence.mark_saved(frames)
                    self.save_resume()
        finally:
            self._stop.set()
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.restore()
            for a in self.actors:
                a.join(timeout=10.0)
            # a meshed state is gathered by every rank and written by rank 0
            if saving and (self.is_main_process or multi_rank(self.mesh)):
                self.agent.save_checkpoint(f"{self.model_save_dir}/ckpt_final")
        return self.metrics.summary()

    def close(self) -> None:
        self._stop.set()
        for envs in self._actor_envs:
            try:
                envs.close()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass
        super().close()
