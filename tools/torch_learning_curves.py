#!/usr/bin/env python3
"""The port's learners trained to the reference's learning thresholds.

    python3 tools/torch_learning_curves.py [--tasks synthetic,catch,recall,breakout]
        [--seeds 0,1,2] [--device cuda]

Each task is a recipe of the JAX package's learning curves
(``examples/curves/impala.py``, scaffold ``examples/curves/common.py:43-109``)
run on ``scalerl_torch``: ``DeviceActorLearnerLoop.run_until`` over a
device env, with the reference's hyperparameters (16 envs, T=20, 5
iterations a chunk, hidden 256, lr 6e-4 or 1e-3, unless the recipe says
otherwise), float32, and V-trace through the CUDA kernel
(``use_pallas=True``).  The thresholds and frame budgets are the
reference's (``docs/LEARNING_CURVES.md``):

- ``synthetic``: ``SyntheticPixelEnv`` 24x24x4, 4 states, 4 actions,
  episodes of 64: 54.4 (0.85 of optimal) within 500,000 frames;
- ``catch``: ``TensorCatch(24)``: 0.85 within 600,000 frames;
- ``recall``: ``TensorRecall(16, delay 6, 4 cues)`` with the LSTM, hidden
  64, 32 envs, T=8, entropy 0.02: 0.8 within 400,000 frames; then the
  feed-forward control for the LSTM run's frames must end below 0;
- ``breakout``: ``TensorBreakout(10)``: 20.0 within 2,000,000 frames;
- ``cartpole_host``: the host actor plane (``HostActorLearnerTrainer``, 2
  actors x 8 ``TensorCartPole`` envs stepped on the CPU, the learner on
  ``--device``), T=16, batch 16, feed-forward hidden 64, lr 2e-3: 400.0
  within 400,000 frames (``examples/curves/impala.py:125-171``); the run
  stops at the first logged crossing;
- ``dqn_cartpole``: double + dueling 3-step DQN through ``OffPolicyTrainer``
  on 4 ``TensorCartPole`` envs stepped on the CPU, 300,000 frames; passes
  when the final greedy evaluation over 10 episodes reaches 450
  (``examples/curves/dqn.py``);
- ``r2d2_recall``: R2D2 on the host plane (2 actors x 8 ``RecallGymEnv``
  12x12, delay 3, 2 cues), 60,000 frames with the LSTM and the same with the
  feed-forward control: the LSTM arm's mean return must reach 0.6 and the
  control's stay below 0.3 (``examples/curves/r2d2.py:11-59``);
- ``r2d2_recall_device``: the same task as ``TensorRecall`` on the device
  under ``DeviceR2D2Trainer`` (16 envs), 50,000 frames an arm, held to the
  windowed return of the run's last quarter (``examples/curves/r2d2.py:
  69-144``);
- ``a3c_cartpole`` / ``ppo_cartpole``: ``OnPolicyTrainer`` on 8
  ``TensorCartPole`` lanes stepped on the CPU, 300,000 frames; the final
  greedy evaluation over 10 episodes must reach 400
  (``examples/curves/onpolicy.py``);
- ``ppo_recall_lstm``: the PPO learn step inside the fused loop with the
  LSTM on ``TensorRecall(16, delay 6, 4 cues)``: 0.8 within 200,000 frames;
- ``a3c_fleet_cartpole``: ``examples/train_a3c_fleet_torch.py``, the
  async-gradient A3C over the actor fleet (2 workers, each 4
  ``TensorCartPole`` lanes on the CPU computing A2C gradients, T=32; the
  learner applies each on ``--device``): the windowed return (every 20
  applied gradients) must reach 150 within 250,000 frames
  (``examples/curves/onpolicy.py:208-255``);
- ``marl_pursuit_iql``: ``examples/train_marl_dqn_torch.py``, independent
  DQN for both agents of ``PursuitToyEnv`` over ``AsyncMultiAgentVecEnv``
  (8 env processes, 4,000 steps: 32,000 frames); passes when the trained
  runner is caught under 0.5x as often as a random one and the trained
  chaser catches in under 0.6x a random chaser's time
  (``examples/curves/marl.py:17-90``);
- ``sac_pendulum`` / ``td3_pendulum``: ``OffPolicyTrainer`` on gymnasium's
  ``Pendulum-v1`` (needs gymnasium; the card's machine has none, so these
  run with ``--device cpu`` on a host that has it), 24,000 steps, the
  greedy evaluation over 6 episodes against -400
  (``examples/curves/continuous.py``).

``seed`` seeds the loop's generator (env draws and actions), as the
reference's ``seed`` keys its loop; the weights come from
``ImpalaArguments.seed`` (42 by default) in both.  One JSON row a task
and seed on stdout, misses included; ``passed`` says whether it crossed.
Needs a card unless ``--device cpu``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch
from torch.func import functional_call

from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.config import ImpalaArguments
from scalerl_torch.envs.tensor_envs import (
    SyntheticPixelEnv,
    TensorBreakout,
    TensorCatch,
    TensorEnv,
    TensorRecall,
)
from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop


def run_fused_to_threshold(
    make_env: Callable[[int], TensorEnv],
    threshold: float,
    max_frames: int,
    learning_rate: float,
    num_envs: int = 16,
    unroll: int = 20,
    iters_per_call: int = 5,
    seed: int = 0,
    use_lstm: bool = False,
    hidden_size: int = 256,
    entropy_cost: float = 0.01,
    device: str = "cuda",
    on_chunk: Optional[Callable[[int, float, Dict[str, float]], None]] = None,
    probe: Optional[Callable[[torch.nn.Module, Dict[str, torch.Tensor], TensorEnv],
                             Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """``examples/curves/common.py::_run_fused_to_threshold`` on the port:
    an ``ImpalaAgent`` and the fused loop over ``make_env(num_envs)``,
    driven by ``run_until`` until the windowed return reaches
    ``threshold`` or ``max_frames`` frames have run.  ``on_chunk(frames,
    windowed, metrics)`` sees every chunk's metrics; ``probe(model,
    params, env)`` reads the trained policy into the row.  Returns the
    summary row, with the loop's V-trace learner steps
    (``learner_steps``)."""
    args = ImpalaArguments(
        use_lstm=use_lstm, hidden_size=hidden_size, rollout_length=unroll,
        batch_size=num_envs, max_timesteps=0, learning_rate=learning_rate,
        entropy_cost=entropy_cost, use_pallas=True,
    )
    env = make_env(num_envs)
    agent = ImpalaAgent(args, env.observation_shape, env.num_actions, device=device)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), unroll,
                                  iters_per_call=iters_per_call, seed=seed, device=device)
    frames_per_call = unroll * num_envs * iters_per_call
    curve = []

    def on_metrics(frames: int, windowed: float, m: Dict[str, float]) -> None:
        curve.append((frames, windowed))
        if on_chunk is not None:
            on_chunk(frames, windowed, m)

    t0 = time.perf_counter()
    state, _, summary = loop.run_until(agent.state, loop.init_carry(), threshold=threshold,
                                       max_calls=max_frames // frames_per_call,
                                       on_metrics=on_metrics)
    if state.step.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    crossing = next((f for f, w in curve if w >= threshold), None)
    probed = probe(agent.model, state.params, env) if probe is not None else {}
    return {**probed, 
        "threshold": threshold,
        "final_return": summary["windowed_return"],
        "frames": int(summary["frames"]),
        "frames_to_threshold": crossing,
        "seconds": wall,
        "frames_per_s": summary["frames"] / wall,
        "learner_steps": int(state.step),
        "nonfinite_chunks": summary["nonfinite_chunks"],
        "passed": bool(summary["hit"]),
        "seed": seed,
    }


# task -> (reference frames to threshold, docs/LEARNING_CURVES.md)
# (the R2D2 rows record both arms' frames and no crossing)
REFERENCE_FRAMES = {"synthetic": 36_800, "catch": 227_200, "recall": 120_320,
                    "breakout": 996_800, "cartpole_host": 292_096, "dqn_cartpole": 238_000,
                    "r2d2_recall": 120_576, "r2d2_recall_device": 100_224,
                    "a3c_cartpole": 251_904, "ppo_cartpole": 139_264, "ppo_recall_lstm": 18_944,
                    "sac_pendulum": None, "td3_pendulum": None,
                    "a3c_fleet_cartpole": 94_720, "marl_pursuit_iql": None}
# the Pendulum rows run a fixed 24,000 steps: the reference's final eval return;
# the pursuit row's is its two ratios against random
REFERENCE_RETURN = {"sac_pendulum": -182.2, "td3_pendulum": -256.8,
                    "marl_pursuit_iql": "caught 0.06x, catch-time 0.41x"}


@torch.no_grad()
def synthetic_action_probs(model, params, env: SyntheticPixelEnv) -> Dict[str, Any]:
    """The trained policy in each cell of the synthetic env (``[cell][action]``)
    and its dead actions: those below 1e-3 in every cell.  One dead action
    holds the return near 0.6 x 64 = 38.4 (one cell of 4 always wrong
    teleports the walk), two near 27.4."""
    cells = torch.arange(env.num_states, device=env.device)
    zeros = torch.zeros((1, env.num_states), dtype=torch.long, device=env.device)
    out, _ = functional_call(model, params, (env._render(cells)[None], zeros,
                                             zeros.to(torch.float32), zeros.to(torch.bool), ()))
    probs = torch.softmax(out.policy_logits[0], dim=-1)
    dead = (probs.max(dim=0).values < 1e-3).nonzero().flatten()
    return {"action_probs": probs.tolist(), "dead_actions": dead.tolist()}


def impala_synthetic(seed: int = 0, device: str = "cuda", max_frames: int = 500_000,
                     **kw) -> Dict[str, Any]:
    """``examples/curves/impala.py:13-47``."""
    return run_fused_to_threshold(
        lambda n: SyntheticPixelEnv(n, size=24, num_states=4, num_actions=4, episode_length=64,
                                    device=device),
        threshold=0.85 * 64, max_frames=max_frames, learning_rate=6e-4, seed=seed,
        device=device, probe=synthetic_action_probs, **kw)


def impala_catch(seed: int = 0, device: str = "cuda", **kw) -> Dict[str, Any]:
    """``examples/curves/impala.py:97-123``."""
    return run_fused_to_threshold(
        lambda n: TensorCatch(n, size=24, device=device),
        threshold=0.85, max_frames=600_000, learning_rate=1e-3, seed=seed, device=device, **kw)


RECALL = dict(threshold=0.8, learning_rate=1e-3, num_envs=32, unroll=8, iters_per_call=5,
              hidden_size=64, entropy_cost=0.02)


def impala_recall_lstm(seed: int = 0, device: str = "cuda", **kw) -> Dict[str, Any]:
    """``examples/curves/impala.py:328-373``: the LSTM run, then the
    feed-forward control for the LSTM run's frames, which must end below 0
    (a memoryless policy expects 2/4 - 1 = -0.5)."""
    def make_env(n: int) -> TensorRecall:
        return TensorRecall(n, size=16, delay=6, num_cues=4, device=device)

    row = run_fused_to_threshold(make_env, max_frames=400_000, use_lstm=True, seed=seed,
                                 device=device, **RECALL, **kw)
    ff = run_fused_to_threshold(make_env, max_frames=row["frames"], use_lstm=False, seed=seed,
                                device=device, **RECALL)
    row["ff_control_return"] = ff["final_return"]
    row["ff_control_frames"] = ff["frames"]
    row["ff_control_seconds"] = ff["seconds"]
    row["ff_control_learner_steps"] = ff["learner_steps"]
    row["lstm_passed"] = row["passed"]
    row["passed"] = bool(row["passed"] and ff["final_return"] < 0.0)
    return row


def impala_breakout(seed: int = 0, device: str = "cuda", **kw) -> Dict[str, Any]:
    """``examples/curves/impala.py:376-401``."""
    return run_fused_to_threshold(
        lambda n: TensorBreakout(n, size=10, device=device),
        threshold=20.0, max_frames=2_000_000, learning_rate=1e-3, seed=seed, device=device, **kw)


def impala_cartpole_host(seed: int = 0, device: str = "cuda", num_actors: int = 2,
                         envs_per_actor: int = 8, max_frames: int = 400_000,
                         threshold: float = 400.0, work_dir: str = "work_dirs",
                         **kw) -> Dict[str, Any]:
    """``examples/curves/impala.py:125-171`` on the port's host plane: the
    envs are ``TensorCartPole`` on the CPU behind ``TensorVectorView``, the
    learner and the central inference on ``device``.  The crossing is the
    first logged ``return_mean`` (the last 20 episodes of each actor, every
    5,000 frames, as the reference reads it from its event file) at or
    above ``threshold``; the run stops there.  ``kw`` overrides arguments
    (``logger_backend``, ``telemetry_interval_s``, ...)."""
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    fields = dict(env_id="CartPole-v1", rollout_length=16, batch_size=16,
                  num_actors=num_actors, num_buffers=32, use_lstm=False, hidden_size=64,
                  learning_rate=2e-3, entropy_cost=0.01, gamma=0.99, seed=seed,
                  logger_backend="none", logger_frequency=5_000, work_dir=work_dir,
                  save_model=False, max_timesteps=max_frames, use_pallas=True)
    args = ImpalaArguments(**{**fields, **kw})
    agent = ImpalaAgent(args, (4,), 2, device=device)
    env_fns = [lambda: TensorVectorView(TensorCartPole(envs_per_actor, device="cpu"))
               for _ in range(num_actors)]
    trainer = HostActorLearnerTrainer(args, agent, env_fns, run_name=f"impala_cartpole_{seed}")
    log = trainer.log

    def log_and_stop(step: int, kind: str, m: Dict[str, float]) -> None:
        log(step, kind, m)
        if kind == "train" and m.get("return_mean", float("nan")) >= threshold:
            trainer.stop_event.set()

    trainer.log = log_and_stop
    t0 = time.perf_counter()
    try:
        result = trainer.train(total_frames=max_frames)
    finally:
        trainer.close()
    wall = time.perf_counter() - t0
    curve = [(f, m["return_mean"]) for f, kind, m in trainer.log_history if kind == "train"]
    crossing = next((f for f, r in curve if r >= threshold), None)
    return {
        "threshold": threshold,
        "final_return": curve[-1][1] if curve else float("nan"),
        "frames": int(result["env_frames"]),
        "frames_to_threshold": crossing,
        "seconds": wall,
        "frames_per_s": result["env_frames"] / wall,
        "learner_steps": trainer.learn_steps,
        "skipped_steps": result.get("skipped_steps"),
        "passed": crossing is not None and crossing <= max_frames,
        "seed": seed,
    }


def dqn_cartpole(seed: int = 3, device: str = "cuda", num_envs: int = 4,
                 max_frames: int = 300_000, threshold: float = 450.0,
                 work_dir: str = "work_dirs", **kw) -> Dict[str, Any]:
    """``examples/curves/dqn.py``: double + dueling 3-step DQN, hard target
    updates every 500 learn steps, lr decaying 5e-4 -> 5e-5, on
    ``TensorCartPole`` envs stepped on the CPU (the reference's gymnasium
    CartPole-v1: same dynamics; a time limit ends an episode as a
    termination here).  ``passed``: the final greedy evaluation over 10
    episodes reaches ``threshold``; ``frames_to_threshold``: the first logged
    ``return_mean`` (every 2,000 frames) at or above it."""
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    fields = dict(env_id="CartPole-v1", num_envs=num_envs, buffer_size=50_000, batch_size=128,
                  max_timesteps=max_frames, warmup_learn_steps=1_000, train_frequency=4,
                  learning_rate=5e-4, double_dqn=True, dueling_dqn=True, n_steps=3,
                  use_soft_update=False, target_update_frequency=500, lr_scheduler="linear",
                  min_learning_rate=5e-5, exploration_fraction=0.25, eps_greedy_end=0.02,
                  eval_frequency=25_000, eval_episodes=5, logger_frequency=2_000,
                  save_frequency=10**9, seed=seed, work_dir=work_dir, logger_backend="none",
                  telemetry_interval_s=0.0, save_model=False)
    args = DQNArguments(**{**fields, **kw})
    train_envs = TensorVectorView(TensorCartPole(num_envs, device="cpu"))
    eval_envs = TensorVectorView(TensorCartPole(4, device="cpu"))
    agent = DQNAgent(args, (4,), 2, device=device)
    trainer = OffPolicyTrainer(args, agent, train_envs, eval_envs, run_name=f"dqn_cartpole_{seed}")
    t0 = time.perf_counter()
    try:
        trainer.run()
        ev = trainer.run_evaluate_episodes(n_episodes=10)
    finally:
        trainer.close()
    wall = time.perf_counter() - t0
    curve = [(f, m["return_mean"]) for f, kind, m in trainer.log_history
             if kind == "train" and "return_mean" in m]
    return {
        "threshold": threshold,
        "final_return": ev["reward_mean"],
        "frames": trainer.global_step,
        "frames_to_threshold": next((f for f, r in curve if r >= threshold), None),
        "seconds": wall,
        "frames_per_s": trainer.global_step / wall,
        "learner_steps": trainer.learn_steps,
        "skipped_steps": float(trainer.skipped_steps),
        "passed": ev["reward_mean"] >= threshold,
        "seed": seed,
    }


R2D2_RECALL = dict(rollout_length=12, burn_in=2, n_steps=1, batch_size=16, replay_capacity=512,
                   warmup_sequences=32, target_update_frequency=200, hidden_size=64,
                   lstm_layers=1, learning_rate=1e-3, logger_backend="none",
                   logger_frequency=10**9, save_model=False, telemetry_interval_s=0.0,
                   use_pallas=True)
RECALL_TASK = dict(size=12, delay=3, num_cues=2)


def run_r2d2_recall(use_lstm: bool, frames: int = 60_000, seed: int = 0, device: str = "cuda",
                    work_dir: str = "work_dirs") -> Dict[str, Any]:
    """One arm of ``examples/curves/r2d2.py::run_r2d2_recall`` on the port's
    host plane: 2 actors x 8 ``RecallGymEnv`` (numpy, behind
    ``SyncVectorView``), ``train_intensity`` 2, the Ape-X ladder from
    ``eps_base`` 0.3; returns the trainer's summary."""
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import R2D2Arguments
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.r2d2 import R2D2Trainer

    args = R2D2Arguments(env_id="RecallGym-v0", num_actors=2, num_buffers=16, train_intensity=2,
                         use_lstm=use_lstm, eps_base=0.3, eps_alpha=7.0, seed=seed,
                         work_dir=work_dir, **R2D2_RECALL)
    agent = R2D2Agent(args, (12, 12, 1), 2, device=device)
    env_fns = [(lambda i=i: make_host_envs("RecallGym-v0", 8, seed + i, **RECALL_TASK))
               for i in range(2)]
    trainer = R2D2Trainer(args, agent, env_fns, run_name=f"r2d2_recall_{int(use_lstm)}_{seed}")
    try:
        return trainer.train(total_frames=frames)
    finally:
        trainer.close()


def run_r2d2_recall_device(use_lstm: bool, frames: int = 50_000, seed: int = 0,
                           device: str = "cuda", work_dir: str = "work_dirs") -> Dict[str, Any]:
    """One arm of ``examples/curves/r2d2.py::run_r2d2_recall_device`` on the
    port: ``DeviceR2D2Trainer`` over 16 ``TensorRecall`` lanes on
    ``device``, ``eps_base`` 0.05; returns the trainer's summary."""
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import R2D2Arguments
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

    args = R2D2Arguments(env_id="Recall-v0", train_intensity=1, use_lstm=use_lstm,
                         eps_base=0.05, seed=seed, work_dir=work_dir, **R2D2_RECALL)
    env = TensorRecall(16, device=device, **RECALL_TASK)
    agent = R2D2Agent(args, env.observation_shape, env.num_actions, device=device)
    trainer = DeviceR2D2Trainer(args, agent, env, run_name=f"r2d2_recall_device_{int(use_lstm)}")
    try:
        return trainer.train(total_frames=frames)
    finally:
        trainer.close()


def _r2d2_pair(run: Callable[..., Dict[str, Any]], key: str, frames: int, seed: int,
               device: str, **kw) -> Dict[str, Any]:
    """The LSTM arm, then the feed-forward control on the same budget; the
    LSTM arm's ``key`` return must reach 0.6, the control's stay below 0.3."""
    t0 = time.perf_counter()
    lstm = run(True, frames, seed, device, **kw)
    ff = run(False, frames, seed, device, **kw)
    wall = time.perf_counter() - t0
    threshold = 0.6
    total = lstm["env_frames"] + ff["env_frames"]
    return {
        "threshold": threshold,
        "final_return": lstm[key],
        "ff_control_return": ff[key],
        "frames": int(total),
        "frames_to_threshold": None,
        "seconds": wall,
        "frames_per_s": total / wall,
        "learner_steps": lstm["learn_steps"],
        "ff_control_learner_steps": ff["learn_steps"],
        "nonfinite": {"lstm": lstm.get("skipped_steps"), "ff": ff.get("skipped_steps")},
        "passed": bool(lstm[key] >= threshold and ff[key] < threshold / 2),
        "seed": seed,
    }


def r2d2_recall(seed: int = 0, device: str = "cuda", frames: int = 60_000,
                **kw) -> Dict[str, Any]:
    """``examples/curves/r2d2.py::r2d2_recall``: held to the mean return of
    each arm's last 100 episodes."""
    return _r2d2_pair(run_r2d2_recall, "return_mean", frames, seed, device, **kw)


def r2d2_recall_device(seed: int = 0, device: str = "cuda", frames: int = 50_000,
                       **kw) -> Dict[str, Any]:
    """``examples/curves/r2d2.py::r2d2_recall_device``: held to the
    windowed return of each arm's last quarter."""
    return _r2d2_pair(run_r2d2_recall_device, "return_windowed", frames, seed, device, **kw)


def _onpolicy_cartpole(agent_cls, args, seed: int, device: str, threshold: float,
                       name: str) -> Dict[str, Any]:
    """``examples/curves/onpolicy.py``'s CartPole harness on the port:
    ``OnPolicyTrainer`` over ``num_workers`` ``TensorCartPole`` lanes
    stepped on the CPU (the reference's gymnasium CartPole-v1: same
    dynamics; a time limit ends an episode as a termination here), the
    learner and the central inference on ``device``.  ``passed``: the
    final greedy evaluation over 10 episodes (4 eval envs) reaches
    ``threshold``; ``frames_to_threshold``: the first logged ``return_mean``
    (every 2,000 frames) at or above it."""
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.on_policy import OnPolicyTrainer

    train_envs = TensorVectorView(TensorCartPole(args.num_workers, device="cpu"))
    eval_envs = TensorVectorView(TensorCartPole(4, device="cpu"))
    agent = agent_cls(args, (4,), 2, device=device)
    trainer = OnPolicyTrainer(args, agent, train_envs, eval_envs, run_name=f"{name}_{seed}")
    t0 = time.perf_counter()
    try:
        trainer.run()
        ev = trainer.run_evaluate_episodes(n_episodes=10)
    finally:
        trainer.close()
    wall = time.perf_counter() - t0
    curve = [(f, m["return_mean"]) for f, kind, m in trainer.log_history
             if kind == "train" and "return_mean" in m]
    return {
        "threshold": threshold,
        "final_return": ev["reward_mean"],
        "frames": trainer.global_step,
        "frames_to_threshold": next((f for f, r in curve if r >= threshold), None),
        "seconds": wall,
        "frames_per_s": trainer.global_step / wall,
        "learner_steps": trainer.learn_steps,
        "skipped_steps": trainer.last_train_info.get("skipped_steps"),
        "passed": ev["reward_mean"] >= threshold,
        "seed": seed,
    }


ONPOLICY_CARTPOLE = dict(env_id="CartPole-v1", num_workers=8, hidden_sizes="64,64",
                         entropy_coef=0.01, gae_lambda=0.95, gamma=0.99, max_timesteps=300_000,
                         eval_frequency=10**9, logger_frequency=2_000, logger_backend="none",
                         telemetry_interval_s=0.0, save_model=False, normalize_obs=False)


def a3c_cartpole(seed: int = 0, device: str = "cuda", work_dir: str = "work_dirs",
                 **kw) -> Dict[str, Any]:
    """``examples/curves/onpolicy.py::a3c_cartpole``: the synchronous A2C
    runtime, 8 lanes, T=16, hidden 64,64, lr 1e-3, 300,000 frames, to 400."""
    from scalerl_torch.agents.a3c import A3CAgent
    from scalerl_torch.config import A3CArguments

    args = A3CArguments(**{**ONPOLICY_CARTPOLE, "rollout_length": 16, "learning_rate": 1e-3,
                           "seed": seed, "work_dir": work_dir, **kw})
    return _onpolicy_cartpole(A3CAgent, args, seed, device, 400.0, "a3c_cartpole")


def ppo_cartpole(seed: int = 0, device: str = "cuda", work_dir: str = "work_dirs",
                 **kw) -> Dict[str, Any]:
    """``examples/curves/onpolicy.py::ppo_cartpole``: 8 lanes, T=32, 4
    epochs of 4 minibatches, hidden 64,64, lr 3e-4, 300,000 frames, to 400."""
    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.config import PPOArguments

    args = PPOArguments(**{**ONPOLICY_CARTPOLE, "rollout_length": 32, "num_minibatches": 4,
                           "ppo_epochs": 4, "learning_rate": 3e-4, "seed": seed,
                           "work_dir": work_dir, **kw})
    return _onpolicy_cartpole(PPOAgent, args, seed, device, 400.0, "ppo_cartpole")


def ppo_recall_lstm(seed: int = 0, device: str = "cuda", max_frames: int = 200_000,
                    threshold: float = 0.8) -> Dict[str, Any]:
    """``examples/curves/onpolicy.py::ppo_recall_lstm``: the PPO learn step
    inside ``DeviceActorLearnerLoop`` with the LSTM (hidden 64) on
    ``TensorRecall(16, delay 6, 4 cues)``, 32 lanes, T=8, 2 iterations a
    chunk, 2 epochs of 2 minibatches, lr 1e-3, entropy 0.02: the windowed
    return reaches 0.8 within 200,000 frames."""
    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.config import PPOArguments

    B, T, iters = 32, 8, 2
    env = TensorRecall(B, size=16, delay=6, num_cues=4, device=device)
    args = PPOArguments(use_lstm=True, hidden_size=64, rollout_length=T, num_workers=B,
                        num_minibatches=2, ppo_epochs=2, max_timesteps=0, learning_rate=1e-3,
                        entropy_coef=0.02, gae_lambda=0.95)
    agent = PPOAgent(args, env.observation_shape, env.num_actions, device=device)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), T,
                                  iters_per_call=iters, seed=seed, device=device)
    curve = []
    t0 = time.perf_counter()
    state, _, summary = loop.run_until(
        agent.state, loop.init_carry(), threshold=threshold,
        max_calls=max_frames // (B * T * iters),
        on_metrics=lambda frames, windowed, m: curve.append((frames, windowed)))
    if state.step.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {
        "threshold": threshold,
        "final_return": summary["windowed_return"],
        "frames": int(summary["frames"]),
        "frames_to_threshold": next((f for f, w in curve if w >= threshold), None),
        "seconds": wall,
        "frames_per_s": summary["frames"] / wall,
        "learner_steps": int(state.step),
        "nonfinite_chunks": summary["nonfinite_chunks"],
        "passed": bool(summary["hit"]),
        "seed": seed,
    }


def _pendulum(agent_cls, args, seed: int, device: str) -> Dict[str, Any]:
    """``examples/curves/continuous.py``'s Pendulum harness on the port:
    ``OffPolicyTrainer`` over 4 gymnasium ``Pendulum-v1`` envs (needs
    gymnasium), 24,000 env steps, then the greedy evaluation over 6
    episodes (2 eval envs) against -400."""
    from scalerl_torch.envs.gym_env import make_vect_envs
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    envs = make_vect_envs("Pendulum-v1", num_envs=4, seed=seed, async_envs=False)
    eval_envs = make_vect_envs("Pendulum-v1", num_envs=2, seed=seed + 1, async_envs=False)
    space = envs.single_action_space
    agent = agent_cls(args, (3,), space.low, space.high, device=device)
    trainer = OffPolicyTrainer(args, agent, envs, eval_envs,
                               run_name=f"{args.algo_name}_pendulum_{seed}")
    t0 = time.perf_counter()
    try:
        trainer.run()
        ev = trainer.run_evaluate_episodes(n_episodes=6)
    finally:
        trainer.close()
        envs.close()
        eval_envs.close()
    wall = time.perf_counter() - t0
    threshold = -400.0
    return {
        "threshold": threshold,
        "final_return": ev["reward_mean"],
        "frames": trainer.global_step,
        "frames_to_threshold": None,
        "seconds": wall,
        "frames_per_s": trainer.global_step / wall,
        "learner_steps": trainer.learn_steps,
        "skipped_steps": float(trainer.skipped_steps),
        "passed": ev["reward_mean"] >= threshold,
        "seed": seed,
    }


PENDULUM = dict(env_id="Pendulum-v1", num_envs=4, buffer_size=100_000, batch_size=128,
                warmup_learn_steps=1000, train_frequency=2, max_timesteps=24_000,
                logger_backend="none", logger_frequency=10**9, save_model=False,
                eval_frequency=10**9, telemetry_interval_s=0.0)


def sac_pendulum(seed: int = 0, device: str = "cuda", work_dir: str = "work_dirs",
                 **kw) -> Dict[str, Any]:
    """``examples/curves/continuous.py::sac_pendulum``."""
    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.config import SACArguments

    args = SACArguments(**{**PENDULUM, "seed": seed, "work_dir": work_dir, **kw})
    return _pendulum(SACAgent, args, seed, device)


def td3_pendulum(seed: int = 0, device: str = "cuda", work_dir: str = "work_dirs",
                 **kw) -> Dict[str, Any]:
    """``examples/curves/continuous.py::td3_pendulum``."""
    from scalerl_torch.agents.td3 import TD3Agent
    from scalerl_torch.config import TD3Arguments

    args = TD3Arguments(**{**PENDULUM, "seed": seed, "work_dir": work_dir, **kw})
    return _pendulum(TD3Agent, args, seed, device)


def _example(name: str):
    """An entry-point twin under ``examples/``, imported by name so that its
    fleet runners unpickle in spawned workers."""
    import importlib

    examples = str(Path(__file__).resolve().parent.parent / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(name)


def a3c_fleet_cartpole(seed: int = 0, device: str = "cuda", num_workers: int = 2,
                       max_frames: int = 250_000, threshold: float = 150.0) -> Dict[str, Any]:
    """``examples/curves/onpolicy.py::a3c_fleet_cartpole``: passes at the
    first window at or above ``threshold``."""
    from scalerl_torch.utils.platform import resolve_device

    resolve_device(device)
    crossing: Dict[str, Any] = {"frames": None, "best": float("-inf")}

    def on_window(frames, windowed):
        crossing["best"] = max(crossing["best"], windowed)
        if crossing["frames"] is None and windowed >= threshold:
            crossing["frames"] = frames

    s = _example("train_a3c_fleet_torch").train_a3c_fleet(
        num_workers=num_workers, total_frames=max_frames, seed=seed, on_window=on_window,
        device=device)
    return {
        "threshold": threshold,
        "final_return": s["windowed_return"],
        "best_window": crossing["best"],
        "frames": s["env_frames"],
        "frames_to_threshold": crossing["frames"],
        "seconds": s["wall_s"],
        "frames_per_s": s["fps"],
        "applied_updates": s["applied_updates"],
        "applied_per_s": s["applied_per_s"],
        "passed": crossing["frames"] is not None,
        "seed": seed,
    }


def marl_pursuit_iql(seed: int = 0, device: str = "cuda", max_steps: int = 4000,
                     num_envs: int = 8) -> Dict[str, Any]:
    """``examples/curves/marl.py::marl_pursuit_iql``: both learned policies
    against random opponents, held to the two ratios."""
    from scalerl_torch.utils.platform import resolve_device

    resolve_device(device)
    s = _example("train_marl_dqn_torch").run_marl(max_steps=max_steps, num_envs=num_envs,
                                                  seed=seed, device=device)
    rr = s["random_vs_random"]
    caught = s["random_vs_trained_runner"]["catch_rate"] / max(rr["catch_rate"], 1e-9)
    catch_time = s["trained_chaser_vs_random"]["mean_len"] / max(rr["mean_len"], 1e-9)
    return {
        "threshold": "caught<0.5x AND catch-time<0.6x random",
        "final_return": f"caught {caught:.2f}x, catch-time {catch_time:.2f}x",
        "caught_ratio": caught,
        "catch_time_ratio": catch_time,
        "frames": s["env_frames"],
        "frames_to_threshold": None,
        "seconds": s["wall_s"],
        "frames_per_s": s["fps"],
        "learn_steps": s["learn_steps"],
        "matchups": {k: s[k] for k in ("trained_chaser_vs_random", "random_vs_random",
                                       "random_vs_trained_runner")},
        "passed": bool(caught < 0.5 and catch_time < 0.6),
        "seed": seed,
    }


TASKS = {"synthetic": impala_synthetic, "catch": impala_catch, "recall": impala_recall_lstm,
         "breakout": impala_breakout, "cartpole_host": impala_cartpole_host,
         "dqn_cartpole": dqn_cartpole, "r2d2_recall": r2d2_recall,
         "r2d2_recall_device": r2d2_recall_device, "a3c_cartpole": a3c_cartpole,
         "ppo_cartpole": ppo_cartpole, "ppo_recall_lstm": ppo_recall_lstm,
         "sac_pendulum": sac_pendulum, "td3_pendulum": td3_pendulum,
         "a3c_fleet_cartpole": a3c_fleet_cartpole, "marl_pursuit_iql": marl_pursuit_iql}


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tasks", default=",".join(TASKS))
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(argv)
    tasks = opts.tasks.split(",")
    unknown = sorted(set(tasks) - set(TASKS))
    if unknown:
        parser.error(f"unknown tasks {unknown}; choose from {sorted(TASKS)}")
    if opts.device == "cuda":
        if not torch.cuda.is_available():
            print("no GPU: torch.cuda.is_available() is False", file=sys.stderr)
            return 1
        where = {"card": card(), "kind": torch.cuda.get_device_name(0)}
    else:
        where = {"card": None, "kind": "cpu"}
    print(json.dumps(where), flush=True)
    for seed in (int(s) for s in opts.seeds.split(",")):
        for task in tasks:
            row = TASKS[task](seed=seed, device=opts.device)
            ref = {"reference_frames": REFERENCE_FRAMES[task]}
            if task in REFERENCE_RETURN:
                ref["reference_return"] = REFERENCE_RETURN[task]
            print(json.dumps({"task": task, **row, **ref, **where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
