"""Off-policy trainer: vector-env steps feeding a device replay and a learner.

Port of ``scalerl_tpu/trainer/off_policy.py`` for discrete actions (DQN):
the buffer and sampler wiring (uniform or PER, one-step or n-step), the
warm-up and ``train_frequency`` gating, the PER beta schedule, episode
accounting, periodic logging and greedy evaluation.

The env may be a gym vector env on the host (numpy in and out) or a view
over a device env that takes and returns tensors on the card.  Actions go
back to the env in the form its observations came in; everything else
moves to the agent's device at the replay's door.  Each vector step reads
its rewards and done flags to the host once, for the episode accounting;
the learn step's metrics stay on the device until a log interval reads
them in one batched copy.

Not ported yet: telemetry, chaos injection, the divergence tripwire and
checkpoint/resume.  Their arguments are absent from ``scalerl_torch.
config`` or refused by its ``validate``, so a run cannot ask for them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.agents.dqn import DQNAgent
from scalerl_torch.config import DQNArguments
from scalerl_torch.data.sampler import Sampler
from scalerl_torch.runtime.dispatch import get_metrics
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
    ) -> None:
        super().__init__(args)
        self.agent = agent
        self.train_envs = train_envs
        self.eval_envs = eval_envs
        self.num_envs = getattr(train_envs, "num_envs", 1)
        act_space = train_envs.single_action_space
        if not hasattr(act_space, "n"):
            raise NotImplementedError("continuous actions (SAC, TD3) are not ported yet")
        self.sampler = Sampler(
            obs_shape=train_envs.single_observation_space.shape,
            capacity=args.buffer_size,
            num_envs=self.num_envs,
            use_per=args.use_per,
            per_alpha=args.per_alpha,
            n_step=args.n_steps,
            gamma=args.gamma,
            use_pallas=args.use_pallas,
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
        metrics, td_abs = self.agent.learn_device(batch)
        if self.args.use_per:
            self.sampler.update_priorities(batch["indices"], td_abs + 1e-6)
        if "skipped_steps" in metrics:
            self.skipped_steps = self.skipped_steps + metrics["skipped_steps"]
        self.learn_steps += 1
        return metrics

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
        obs, _ = self.train_envs.reset(seed=args.seed)
        start = time.time()
        start_step = self.global_step
        last_log = self.global_step
        last_eval = self.global_step
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
            self.agent.update_exploration(self.num_envs)

            if (
                len(self.sampler) >= args.warmup_learn_steps
                and self.global_step % args.train_frequency < self.num_envs
            ):
                train_info = self.train_step()

            if self.global_step - last_log >= args.logger_frequency:
                last_log = self.global_step
                fps = int((self.global_step - start_step) / max(time.time() - start, 1e-8))
                summary = self.metrics.summary()
                train_info = get_metrics(train_info)  # one batched device->host copy
                self.log(self.global_step, "train", {
                    **train_info, **summary, "fps": float(fps),
                    "learn_steps": float(self.learn_steps), "rpm_size": float(len(self.sampler)),
                })
                self.text_logger.info(
                    f"step {self.global_step} | fps {fps} | return "
                    f"{summary.get('return_mean', float('nan')):.1f} | eps {self.agent.eps:.3f} "
                    f"| loss {train_info.get('loss', float('nan')):.4f}"
                )

            if self.eval_envs is not None and self.global_step - last_eval >= args.eval_frequency:
                last_eval = self.global_step
                eval_info = self.run_evaluate_episodes()
                self.log(self.global_step, "eval", eval_info)
                self.text_logger.info(
                    f"eval @ {self.global_step}: return "
                    f"{eval_info['reward_mean']:.1f} +- {eval_info['reward_std']:.1f}"
                )
        return self.metrics.summary()
