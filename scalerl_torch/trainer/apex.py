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
counters.  A meshed agent needs ``data/sharded_replay.py``, which is not
ported, and raises; C51 raises, as the JAX trainer does.
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
                q = agent.q_values(agent.state.params, obs_dev, network=self.network)
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
            st = agent.state  # one read: params and target_params stay paired
            prio = self.priority(st.params, st.target_params, dev_slab["obs"],
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
        if getattr(agent, "mesh", None) is not None:
            raise NotImplementedError(
                "Ape-X with a meshed agent needs data/sharded_replay.py, which is not "
                "ported yet")
        if args.categorical_dqn:
            raise ValueError(
                "categorical_dqn (C51) is not supported by ApexTrainer: its priority and "
                "learn paths are scalar-Q (make_dqn_priority_fn, make_dqn_learn_fn); use "
                "DQNAgent with OffPolicyTrainer for C51")
        super().__init__(args, run_name=run_name)
        self.agent = agent
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
        self.buffer = PrioritizedReplayBuffer(
            obs_shape, capacity=max(args.buffer_size // slab_width, 2), num_envs=slab_width,
            alpha=args.per_alpha, n_step=1, gamma=args.gamma,
            sample_method="pallas" if args.use_pallas else "hierarchical",
            update_method="pallas" if args.use_pallas else "xla",
            extra_fields={"n_steps": ((), torch.int32)}, device=agent.device,
        )
        self.per_beta = LinearDecayScheduler(args.per_beta, args.per_beta_final,
                                             args.max_timesteps)
        self.generator = torch.Generator(device=agent.device).manual_seed(args.seed + 0x53A1)
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

    def _drain_slabs(self, block: bool) -> int:
        """Move the pending actor slabs into the replay (the one writer)."""
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

    def train_step(self) -> Dict[str, torch.Tensor]:
        """Sample, learn, write the new priorities back; the metrics stay on
        the device."""
        beta = self.per_beta.value(self.global_step)
        self.timings.reset()
        batch = self.buffer.sample(self.args.batch_size, beta=beta, generator=self.generator)
        self.timings.time("sample")
        metrics, td_abs = self.agent.learn_device(batch)
        self.timings.time("learn")
        self.buffer.update_priorities(batch["indices"], td_abs + 1e-6)
        self.timings.time("update_prio")
        self.learn_steps += 1
        if self.learn_steps % self.args.actor_update_frequency == 0:
            self.param_server.push(self.agent.get_weights(), to_host=False)
        return metrics

    # -- resume --------------------------------------------------------
    def _resume_pytree(self) -> Dict:
        return {
            "agent": self.agent.state,
            "replay": self.buffer.state,
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
        self.agent.state = state["agent"]
        self.buffer.state = state["replay"]
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
        start_step = self.global_step
        # seeded from the (possibly resumed) step, or the first iteration
        # logs and evaluates at once
        last_log = last_eval = self.global_step
        cadence = CheckpointCadence(args.save_frequency, args.checkpoint_interval_s,
                                    self.global_step)
        train_info: Dict = {}
        try:
            while self.global_step < args.max_timesteps:
                if watchdog is not None:
                    watchdog.check()
                if guard is not None and guard.triggered:
                    if saving:
                        self.save_resume()
                    break
                if not self._errors.empty():
                    actor_id, err = self._errors.get()
                    raise RuntimeError(f"apex actor {actor_id} crashed") from err
                self._drain_slabs(block=True)
                if len(self.buffer) >= args.warmup_learn_steps:
                    train_info = self.train_step()

                if self.global_step - last_log >= args.logger_frequency:
                    last_log = self.global_step
                    fps = (self.global_step - start_step) / max(time.time() - start, 1e-8)
                    summary = self.metrics.summary()
                    host = get_metrics(train_info)  # one batched device->host copy
                    counters = {"rpm_size": float(len(self.buffer)), "fps": fps,
                                "learn_steps": float(self.learn_steps),
                                "weight_version": float(self.param_server.version)}
                    self.log(self.global_step, "train", {**host, **summary, **counters})
                    if self._instrument:
                        telemetry.observe_train_metrics(host)
                        reg = telemetry.get_registry()
                        reg.set_gauges({**host, **summary, **counters}, prefix="train.")
                        self.logger.log_registry(self.global_step, step_type="train",
                                                 include_prefixes=("train.",))
                    if self.is_main_process:
                        self.text_logger.info(
                            f"step {self.global_step} | fps {fps:.0f} | return "
                            f"{summary.get('return_mean', float('nan')):.1f} | loss "
                            f"{host.get('loss', float('nan')):.4f} | learn {self.learn_steps}")

                if (self.eval_envs is not None
                        and self.global_step - last_eval >= args.eval_frequency):
                    last_eval = self.global_step
                    eval_info = self.run_evaluate_episodes()
                    self.log(self.global_step, "eval", eval_info)
                    self.logger.log_test_data(eval_info, self.global_step)

                if saving and cadence.due(self.global_step):
                    cadence.mark_saved(self.global_step)
                    self.save_resume()
        finally:
            self._stop.set()
            if watchdog is not None:
                watchdog.stop()
            if guard is not None:
                guard.restore()
            for a in self.actors:
                a.join(timeout=10.0)
            if saving and self.is_main_process:
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
