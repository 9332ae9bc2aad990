"""On-policy trainer: the A3C/A2C and PPO runtime over a vector-env fleet.

Port of ``scalerl_tpu/trainer/on_policy.py``.  The env lanes are one vector
env stepped on the host; each step's policy forward is one central batched
``agent.act`` (one packed host-to-device copy of the step's inputs, one
copy back of the actions and logits); each chunk of ``rollout_length``
steps goes to the learner's device in one packed copy
(``data/trajectory.py::host_chunk_to_trajectory``) for one ``learn`` call.

The rollout keeps the ``[T+1, B]`` trajectory layout (row t holds obs[t]
and the last action, reward and done leading into it), and the recurrent
core is carried across chunk boundaries on the device, as on the IMPALA
path.  Resume checkpoints hold the agent's state and the two counters (an
on-policy run has no replay to carry: the next chunk comes from the
restored policy); ``ckpt_{step}`` and ``ckpt_final`` hold the agent's
state.  Train metrics stay on the device until a log interval reads them in
one batched copy.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from scalerl_torch.config import A3CArguments
from scalerl_torch.data.trajectory import host_chunk_to_trajectory
from scalerl_torch.parallel.sharding import gather_tree
from scalerl_torch.parallel.train_step import (
    RankAgreement,
    maybe_enable_mesh_from_args,
    multi_rank,
    place_agent_state,
)
from scalerl_torch.runtime import telemetry
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.trainer.base import BaseTrainer
from scalerl_torch.utils.metrics import EpisodeMetrics


class OnPolicyTrainer(BaseTrainer):
    def __init__(
        self,
        args: A3CArguments,
        agent,
        train_envs,
        eval_envs=None,
        run_name: Optional[str] = None,
    ) -> None:
        super().__init__(args, run_name=run_name)
        self.agent = agent
        # RLArguments' mesh_shape / dp_size / mp_size, before any actor starts
        maybe_enable_mesh_from_args(agent, args)
        self.train_envs = train_envs
        self.eval_envs = eval_envs
        self.num_envs = getattr(train_envs, "num_envs", 1)
        self.global_step = 0
        self.learn_steps = 0
        self.metrics = EpisodeMetrics(self.num_envs)

    # ------------------------------------------------------------------
    def collect_rollout(self, obs, last_action, last_reward, last_done, core_state):
        """Advance the fleet ``rollout_length`` steps; returns the chunk on
        the agent's device and the carry for the next chunk."""
        T = self.args.rollout_length
        B = self.num_envs
        obs = np.asarray(obs)
        buf = {
            "obs": np.zeros((T + 1, B) + obs.shape[1:], dtype=obs.dtype),
            "action": np.zeros((T + 1, B), np.int32),
            "reward": np.zeros((T + 1, B), np.float32),
            "done": np.zeros((T + 1, B), bool),
            "logits": np.zeros((T + 1, B, self.agent.num_actions), np.float32),
        }
        buf["obs"][0] = obs
        buf["action"][0] = last_action
        buf["reward"][0] = last_reward
        buf["done"][0] = last_done
        entering_core = core_state

        for t in range(T):
            action, logits, core_state = self.agent.act(
                obs, buf["action"][t], buf["reward"][t], buf["done"][t], core_state)
            buf["logits"][t] = logits
            next_obs, reward, term, trunc, _ = self.train_envs.step(action)
            done = np.logical_or(term, trunc)
            buf["obs"][t + 1] = next_obs
            buf["action"][t + 1] = action
            buf["reward"][t + 1] = reward
            buf["done"][t + 1] = done
            self.metrics.step(reward, done)
            obs = np.asarray(next_obs)
            self.global_step += B

        # row T's logits stay zero: the losses read behaviour rows [:-1]
        traj = host_chunk_to_trajectory(buf, entering_core, self.agent.device)
        carry = (obs, buf["action"][T], buf["reward"][T], buf["done"][T], core_state)
        return traj, carry

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
            obs, reward, term, trunc, _ = envs.step(np.asarray(actions))
            ep_ret += reward
            ep_len += 1
            done = np.logical_or(term, trunc)
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

    # ------------------------------------------------------------------
    def _resume_pytree(self) -> Dict:
        return {
            # a meshed state is saved whole (every rank gathers, the main one writes)
            "agent": gather_tree(self.agent.state),
            "global_step": np.asarray(self.global_step, np.int64),
            "learn_steps": np.asarray(self.learn_steps, np.int64),
        }

    def save_resume(self) -> None:
        self.save_resume_checkpoint(self._resume_pytree(), self.global_step, self.learn_steps)

    def try_resume(self) -> bool:
        """Restore the train state and the counters from ``args.resume``;
        True when restored."""
        state = self.load_resume_checkpoint(self._resume_pytree())
        if state is None:
            return False
        self.agent.state = place_agent_state(self.agent, state["agent"])
        self.global_step = int(state["global_step"])
        self.learn_steps = int(state["learn_steps"])
        if self.is_main_process:
            self.text_logger.info(f"resumed from {self.resume_ckpt_path}: step {self.global_step}")
        return True

    def run(self) -> Dict[str, float]:
        args = self.args
        saving = args.save_model and not args.disable_checkpoint
        if self.resuming:
            self.try_resume()
        B = self.num_envs
        obs, _ = self.train_envs.reset(seed=args.seed)
        carry = (obs, np.zeros(B, np.int32), np.zeros(B, np.float32), np.zeros(B, bool),
                 self.agent.initial_state(B))
        start = time.time()
        start_step = self.global_step
        last_log = self.global_step
        last_eval = self.global_step
        # under a mesh of several ranks, max_timesteps counts the steps of
        # every rank, and the gates of collectives (saves) are taken alike
        # on all of them; a meshed save gathers on every rank
        agree = RankAgreement(getattr(self.agent, "mesh", None))
        saver = self.is_main_process or multi_rank(getattr(self.agent, "mesh", None))
        (last_save,) = agree(self.global_step)
        train_info: Dict[str, float] = {}

        while agree(self.global_step)[0] < args.max_timesteps:
            traj, carry = self.collect_rollout(*carry)
            train_info = self.agent.learn_device(traj)
            self.learn_steps += 1
            (steps,) = agree(self.global_step)

            if self.global_step - last_log >= args.logger_frequency:
                last_log = self.global_step
                fps = int((self.global_step - start_step) / max(time.time() - start, 1e-8))
                summary = self.metrics.summary()
                train_info = get_metrics(train_info)  # one batched device->host copy
                counters = {"fps": float(fps), "learn_steps": float(self.learn_steps)}
                self.log(self.global_step, "train", {**train_info, **summary, **counters})
                if self._instrument:
                    telemetry.observe_train_metrics(train_info)
                    reg = telemetry.get_registry()
                    reg.set_gauges({**train_info, **summary, **counters}, prefix="train.")
                    self.logger.log_registry(self.global_step, step_type="train",
                                             include_prefixes=("train.",))
                if self.is_main_process:
                    ret = summary.get("return_mean", float("nan"))
                    self.text_logger.info(
                        f"step {self.global_step} | fps {fps} | return {ret:.1f} "
                        f"| loss {train_info.get('total_loss', float('nan')):.4f}"
                    )

            if self.eval_envs is not None and self.global_step - last_eval >= args.eval_frequency:
                last_eval = self.global_step
                eval_info = self.run_evaluate_episodes()
                self.log(self.global_step, "eval", eval_info)
                self.logger.log_test_data(eval_info, self.global_step)
                if self.is_main_process:
                    self.text_logger.info(
                        f"eval @ {self.global_step}: return "
                        f"{eval_info['reward_mean']:.1f} +- {eval_info['reward_std']:.1f}"
                    )

            if saving and steps - last_save >= args.save_frequency:
                last_save = steps
                if saver:
                    self.agent.save_checkpoint(f"{self.model_save_dir}/ckpt_{self.global_step}")
                    self.save_resume()

        if saving and saver:
            self.agent.save_checkpoint(f"{self.model_save_dir}/ckpt_final")
            self.save_resume()
        self.last_train_info = get_metrics(train_info)
        return self.metrics.summary()
