"""Off-policy trainer: vector-env steps feeding a device replay and a learner.

Port of ``scalerl_tpu/trainer/off_policy.py`` for discrete actions (DQN)
and continuous ones (SAC, TD3: a ``Box`` action space gives a float32
action plane of its shape): the buffer and sampler wiring (uniform or PER, one-step or n-step), the
warm-up and ``train_frequency`` gating, the PER beta schedule, episode
accounting, periodic logging and greedy evaluation.

The env may be a gym vector env on the host (numpy in and out) or a view
over a device env that takes and returns tensors on the card.  Actions go
back to the env in the form its observations came in; everything else
moves to the agent's device at the replay's door.  Each vector step reads
its rewards and done flags to the host once, for the episode accounting;
the learn step's metrics stay on the device until a log interval reads
them in one batched copy.

Resume checkpoints hold the agent's state, the replay (plane, priorities
and cursors) and the step counters (``save_resume`` / ``try_resume``);
``ckpt_{step}`` and ``ckpt_final`` hold the agent's state.  The divergence
tripwire (``divergence_rollback_steps`` > 0) restores the agent from the
last good resume checkpoint after that many consecutive skipped learn
steps; only then does each learn step read its ``skipped_steps`` to the
host.  Telemetry goes to the registry at log boundaries.  Under a chaos
plan with ``grad_nan``/``grad_inf`` (``runtime/chaos.py``) a sampled batch
(not the buffer) is poisoned on its device, for the guard and the tripwire
to absorb.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.agents.dqn import DQNAgent
from scalerl_torch.config import DQNArguments
from scalerl_torch.data.sampler import Sampler
from scalerl_torch.parallel.train_step import tensor_leaves
from scalerl_torch.runtime import chaos, telemetry
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.runtime.supervisor import DivergenceTripwire
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics
from scalerl_torch.utils.schedulers import LinearDecayScheduler


def _logical_or(a, b):
    return a | b if isinstance(a, torch.Tensor) else np.logical_or(a, b)


def _host_step(reward, done) -> Tuple[np.ndarray, np.ndarray]:
    """One step's rewards and done flags as host arrays: a single
    device->host copy when they are device tensors."""
    if isinstance(reward, torch.Tensor):
        both = torch.stack([reward.to(torch.float32), done.to(torch.float32)]).cpu().numpy()
        return both[0], both[1] > 0.5
    return np.asarray(reward), np.asarray(done, dtype=bool)


def _env_actions(actions: torch.Tensor, obs: Any):
    """Actions in the form the env's observations came in."""
    return actions.cpu().numpy() if isinstance(obs, np.ndarray) else actions


class OffPolicyTrainer(BaseTrainer):
    def __init__(
        self,
        args: DQNArguments,
        agent: DQNAgent,
        train_envs,
        eval_envs=None,
        run_name: Optional[str] = None,
    ) -> None:
        super().__init__(args, run_name=run_name)
        self.agent = agent
        self.train_envs = train_envs
        self.eval_envs = eval_envs
        self.num_envs = getattr(train_envs, "num_envs", 1)
        act_space = train_envs.single_action_space
        if hasattr(act_space, "n"):  # Discrete
            action_shape, action_dtype = (), torch.int64
        else:  # Box (continuous control: SAC, TD3)
            action_shape, action_dtype = tuple(act_space.shape), torch.float32
        self.sampler = Sampler(
            obs_shape=train_envs.single_observation_space.shape,
            capacity=args.buffer_size,
            num_envs=self.num_envs,
            use_per=args.use_per,
            per_alpha=args.per_alpha,
            n_step=args.n_steps,
            gamma=args.gamma,
            use_pallas=args.use_pallas,
            action_shape=action_shape,
            action_dtype=action_dtype,
            device=agent.device,
        )
        self.per_beta = LinearDecayScheduler(args.per_beta, args.per_beta_final, args.max_timesteps)
        self.global_step = 0
        self.learn_steps = 0
        self.metrics = EpisodeMetrics(self.num_envs)
        # replay sampling draws from its own seeded stream on the device
        self.generator = torch.Generator(device=agent.device).manual_seed(args.seed + 0x53A1)
        # learn steps the all-finite guard skipped, summed on the device
        self.skipped_steps = torch.zeros((), dtype=torch.float32, device=agent.device)
        # meters are fed once a log interval (telemetry_interval_s <= 0: none)
        self._learn_marked = 0
        if self._instrument:
            reg = telemetry.get_registry()
            self._fps_meter = reg.meter("rates.fps")
            self._learn_meter = reg.meter("rates.learn_steps_per_s")
            reg.bind("replay.size", lambda: len(self.sampler))
        self.tripwire = DivergenceTripwire(args.divergence_rollback_steps,
                                           self._divergence_rollback)

    def store_experience(
        self, obs, next_obs, action, reward, terminated, infos, truncated=None
    ) -> None:
        """Store one vector step; where an episode ended, ``next_obs`` is
        the true last observation from ``infos["final_obs"]`` when the env
        gives one (gym's SAME_STEP autoreset).

        ``terminated`` alone is the bootstrap mask; ``terminated |
        truncated`` bounds the n-step fold at time-limit resets."""
        final_obs = infos.get("final_obs") if isinstance(infos, dict) else None
        if final_obs is not None:
            next_obs = np.asarray(next_obs).copy()
            for i in np.nonzero(infos.get("_final_obs"))[0]:
                next_obs[i] = final_obs[i]
        boundary = _logical_or(terminated, truncated) if truncated is not None else None
        self.sampler.add(obs, next_obs, action, reward, terminated, boundary=boundary)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """Sample, learn, and write the new priorities back; the metrics
        come back on the device."""
        beta = self.per_beta.value(self.global_step)
        batch = self.sampler.sample(self.args.batch_size, beta=beta, generator=self.generator)
        inj = chaos.active()
        if inj is not None:
            # seeded NaN/Inf bursts land in the sampled batch, not the
            # buffer, so the guarded learn step and the tripwire absorb them
            batch = dict(batch)
            inj.poison_batch(batch, site="offpolicy.batch")
        metrics, td_abs = self.agent.learn_device(batch)
        if self.args.use_per:
            self.sampler.update_priorities(batch["indices"], td_abs + 1e-6)
        if "skipped_steps" in metrics:
            self.skipped_steps = self.skipped_steps + metrics["skipped_steps"]
        self.learn_steps += 1
        if self.tripwire.enabled:
            # the one per-step host read, only with the tripwire on
            self.tripwire.observe(get_metrics({"skipped_steps": metrics.get(
                "skipped_steps", torch.zeros(()))}))
        return metrics

    def _divergence_rollback(self) -> None:
        """Restore the agent from the last good resume checkpoint after the
        tripwire's K consecutive skipped learn steps, and check once that the
        restored parameters are finite.  Env steps and the replay stay: the
        divergence spoiled the parameters, not the experience."""
        try:
            state = self.load_resume_checkpoint(self._resume_pytree())
        except FileNotFoundError:
            state = None
        if state is None:
            self.text_logger.warning(
                "divergence tripwire fired but no resume checkpoint exists; "
                "continuing with the current (guard-protected) state")
            return
        self.agent.state = state["agent"]
        self.learn_steps = int(state["learn_steps"])
        finite = all(bool(torch.isfinite(x).all())
                     for x in tensor_leaves(self.agent.state) if x.is_floating_point())
        self.text_logger.warning(
            "divergence tripwire: restored agent state from %s (learn_steps=%d, params "
            "finite=%s, rollback #%d)", self.resume_ckpt_path, self.learn_steps, finite,
            self.tripwire.trips)

    # ------------------------------------------------------------------
    def _resume_pytree(self) -> Dict:
        return {
            "agent": self.agent.state,
            "replay": self.sampler.buffer.state,
            "global_step": np.asarray(self.global_step, np.int64),
            "learn_steps": np.asarray(self.learn_steps, np.int64),
        }

    def save_resume(self) -> None:
        self.save_resume_checkpoint(self._resume_pytree(), self.global_step, self.learn_steps)

    def try_resume(self) -> bool:
        """Restore the agent, the replay, the counters and the exploration
        schedule's position from ``args.resume``; True when restored."""
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = state["agent"]
        self.sampler.buffer.state = state["replay"]
        self.global_step = int(state["global_step"])
        self.learn_steps = int(state["learn_steps"])
        if hasattr(self.agent, "eps_scheduler"):  # epsilon-greedy agents only
            self.agent.eps_scheduler.cur_step = self.global_step
            self.agent.eps = self.agent.eps_scheduler.value(self.global_step)
        if self.is_main_process:
            self.text_logger.info(f"resumed from {self.resume_ckpt_path}: step "
                                  f"{self.global_step}, learn_steps {self.learn_steps}")
        return True

    def run_evaluate_episodes(self, n_episodes: Optional[int] = None) -> Dict[str, float]:
        """Greedy rollouts on the eval envs (else the train envs) until
        ``n_episodes`` finish."""
        envs = self.eval_envs or self.train_envs
        n_episodes = n_episodes or self.args.eval_episodes
        num_envs = getattr(envs, "num_envs", 1)
        obs, _ = envs.reset(seed=self.args.seed + 100)
        returns: list = []
        ep_ret = np.zeros(num_envs)
        ep_len = np.zeros(num_envs, int)
        prev_done = np.ones(num_envs, bool)
        while len(returns) < n_episodes:
            actions = self.agent.predict(obs, done=prev_done)
            obs_next, reward, term, trunc, _ = envs.step(_env_actions(actions, obs))
            reward, done = _host_step(reward, _logical_or(term, trunc))
            obs = obs_next
            ep_ret += reward
            ep_len += 1
            prev_done = done
            for i in np.nonzero(done)[0]:
                returns.append((ep_ret[i], ep_len[i]))
                ep_ret[i] = 0.0
                ep_len[i] = 0
        rets = np.array([r for r, _ in returns[:n_episodes]])
        lens = np.array([n for _, n in returns[:n_episodes]])
        return {
            "reward_mean": float(rets.mean()),
            "reward_std": float(rets.std()),
            "length_mean": float(lens.mean()),
        }

    def run(self) -> Dict[str, float]:
        args = self.args
        saving = args.save_model and not args.disable_checkpoint
        if self.resuming:
            self.try_resume()
        if (self.tripwire.enabled and self.is_main_process and saving
                and not os.path.exists(self.resume_ckpt_path)):
            # a rollback needs a last good state from step 0 on
            self.save_resume()
        obs, _ = self.train_envs.reset(seed=args.seed)
        start = time.time()
        start_step = self.global_step
        last_log = self.global_step
        last_eval = self.global_step
        last_save = self.global_step
        train_info: Dict[str, Any] = {}

        prev_done = np.ones(self.num_envs, bool)
        while self.global_step < args.max_timesteps:
            actions = self.agent.get_action(obs, done=prev_done)
            next_obs, reward, term, trunc, infos = self.train_envs.step(_env_actions(actions, obs))
            self.store_experience(obs, next_obs, actions, reward, term, infos, trunc)
            reward_h, prev_done = _host_step(reward, _logical_or(term, trunc))
            self.metrics.step(reward_h, prev_done)
            obs = next_obs
            self.global_step += self.num_envs
            if hasattr(self.agent, "update_exploration"):
                self.agent.update_exploration(self.num_envs)

            if (
                len(self.sampler) >= args.warmup_learn_steps
                and self.global_step % args.train_frequency < self.num_envs
            ):
                train_info = self.train_step()

            if self.global_step - last_log >= args.logger_frequency:
                frames_delta = self.global_step - last_log
                last_log = self.global_step
                fps = int((self.global_step - start_step) / max(time.time() - start, 1e-8))
                summary = self.metrics.summary()
                train_info = get_metrics(train_info)  # one batched device->host copy
                counters = {"fps": float(fps), "learn_steps": float(self.learn_steps),
                            "rpm_size": float(len(self.sampler))}
                self.log(self.global_step, "train", {**train_info, **summary, **counters})
                if self._instrument:
                    telemetry.observe_train_metrics(train_info)
                    reg = telemetry.get_registry()
                    reg.set_gauges({**train_info, **summary, **counters}, prefix="train.")
                    self._fps_meter.mark(frames_delta)
                    self._learn_meter.mark(self.learn_steps - self._learn_marked)
                    self._learn_marked = self.learn_steps
                    self.logger.log_registry(self.global_step, step_type="train",
                                             include_prefixes=("train.",))
                self.text_logger.info(
                    f"step {self.global_step} | fps {fps} | return "
                    f"{summary.get('return_mean', float('nan')):.1f} "
                    f"| eps {getattr(self.agent, 'eps', float('nan')):.3f} "
                    f"| loss {train_info.get('loss', float('nan')):.4f}"
                )

            if self.eval_envs is not None and self.global_step - last_eval >= args.eval_frequency:
                last_eval = self.global_step
                eval_info = self.run_evaluate_episodes()
                self.log(self.global_step, "eval", eval_info)
                self.logger.log_test_data(eval_info, self.global_step)
                self.text_logger.info(
                    f"eval @ {self.global_step}: return "
                    f"{eval_info['reward_mean']:.1f} +- {eval_info['reward_std']:.1f}"
                )

            if saving and self.global_step - last_save >= args.save_frequency:
                last_save = self.global_step
                if self.is_main_process:
                    self.agent.save_checkpoint(f"{self.model_save_dir}/ckpt_{self.global_step}")
                    self.save_resume()

        if saving and self.is_main_process:
            self.agent.save_checkpoint(f"{self.model_save_dir}/ckpt_final")
            self.save_resume()
        return self.metrics.summary()
