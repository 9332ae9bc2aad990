"""Distributed DQN over the actor fleet on PyTorch: the twin of ``examples/train_fleet_dqn.py``.

The Gorila/HandyRL topology: a central learner hands out rollout tasks, a
worker fleet (gathers spawned as local processes; ``RemoteCluster`` from
other hosts) runs epsilon-greedy CartPole episodes with numpy inference
(``models/np_forward.py::mlp_qnet_forward``) on versioned weight snapshots,
and the episodes' transitions stream back, batched and compressed, into the
uniform ``ReplayBuffer`` on the card that the ``DQNAgent`` samples, as in
the reference.  Weights republish every ``publish_every`` learn steps.

Episodes run on the port's ``TensorCartPole`` on the CPU through
``envs/gym_env.py::make_host_envs(..., env_backend="jax")`` (the card's
machine has no gymnasium); that view resets a finished lane in the same
step and reports every end as terminated, so an episode's last transition
is stored as terminal, which masks its bootstrap.

The learner runs on the card and raises without one (``--device cpu`` runs
it on the host).  Guard ``if __name__ == "__main__":`` in scripts that call
:func:`train_fleet_dqn`: the gathers start by spawn.

Usage::

    python examples/train_fleet_dqn_torch.py --episodes 200 --num-workers 4
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Any, Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ENV_ID = "CartPole-v1"
OBS_DIM, NUM_ACTIONS = 4, 2
MAX_EPISODE_STEPS = 500
# host staging: the replay takes fixed-size chunks, one copy a field
CHUNK = 64
TRANSITION_KEYS = ("obs", "action", "reward", "next_obs", "done")


def episode_runner(task: Dict[str, Any], weights: Any, worker_id: int) -> Dict[str, Any]:
    """One epsilon-greedy CartPole episode on the fleet worker's CPU."""
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.models.np_forward import mlp_qnet_forward

    seed = int(task["seed"])
    env = make_host_envs(ENV_ID, 1, seed, env_backend="jax")
    rng = np.random.default_rng(seed)
    eps = float(task.get("eps", 0.1))
    obs, _ = env.reset(seed=seed)
    obs = obs[0]
    obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
    done = False
    while not done and len(act_l) < MAX_EPISODE_STEPS:
        if weights is None or rng.random() < eps:
            a = int(rng.integers(NUM_ACTIONS))
        else:
            a = int(np.argmax(mlp_qnet_forward(weights, obs[None])[0]))
        nxt, r, term, trunc, _ = env.step(np.array([a]))
        obs_l.append(obs)
        act_l.append(a)
        rew_l.append(float(r[0]))
        next_l.append(nxt[0])
        done_l.append(bool(term[0]))
        obs = nxt[0]
        done = bool(term[0] or trunc[0])
    env.close()
    return {
        "obs": np.asarray(obs_l, np.float32),
        "action": np.asarray(act_l, np.int32),
        "reward": np.asarray(rew_l, np.float32),
        "next_obs": np.asarray(next_l, np.float32),
        "done": np.asarray(done_l, np.bool_),
        "episode_return": float(np.sum(rew_l)),
        "seed": seed,
    }


def train_fleet_dqn(
    episodes: int = 200,
    num_workers: int = 4,
    batch_size: int = 64,
    publish_every: int = 10,
    eps: float = 0.2,
    device: str = "cuda",
    log_every: int = 20,
) -> Dict[str, Any]:
    """Run ``episodes`` fleet episodes; returns the counts, rates and
    returns, and the agent."""
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.data.replay import ReplayBuffer
    from scalerl_torch.fleet import FleetConfig, LocalCluster, WorkerServer

    args = DQNArguments(hidden_sizes="128,128", learning_rate=1e-3)
    agent = DQNAgent(args, obs_shape=(OBS_DIM,), action_dim=NUM_ACTIONS, device=device)
    replay = ReplayBuffer(obs_shape=(OBS_DIM,), capacity=50_000, num_envs=1,
                          device=agent.device)
    sample_gen = torch.Generator(device=agent.device).manual_seed(args.seed)

    lock = threading.Lock()
    counter = {"i": 0}
    stop = threading.Event()
    server_box: Dict[str, Any] = {}

    def task_source():
        with lock:
            if stop.is_set() or counter["i"] >= episodes:
                return None
            counter["i"] += 1
            return {"role": "rollout", "seed": counter["i"], "eps": eps,
                    "param_version": server_box["s"].params.version}

    config = FleetConfig(num_workers=num_workers, workers_per_gather=4, upload_batch=2)
    server = WorkerServer(config, task_source)
    server_box["s"] = server
    server.publish(agent.get_weights())
    server.start()
    cluster = LocalCluster(server, config, episode_runner, mp_context="spawn")
    cluster.start()

    done_episodes = learn_steps = transitions = 0
    returns: list = []
    seeds: list = []
    metrics: Dict[str, Any] = {}
    pending: Dict[str, list] = {k: [] for k in TRANSITION_KEYS}

    def flush_pending() -> None:
        while len(pending["action"]) >= CHUNK:
            chunk = {k: np.asarray(v[:CHUNK]) for k, v in pending.items()}
            for k in pending:
                del pending[k][:CHUNK]
            # [T, num_envs=1, ...]
            replay.save_chunk(**{k: v[:, None] for k, v in chunk.items()})

    t0 = time.time()
    try:
        while done_episodes < episodes:
            result = server.get_result(timeout=1.0)
            if result is None:
                if not server.worker_errors.empty():
                    err = server.worker_errors.get()
                    raise RuntimeError(f"fleet worker failed: {err.get('error')}")
                continue
            done_episodes += 1
            returns.append(result["episode_return"])
            seeds.append(int(result["seed"]))
            transitions += len(result["action"])
            for k in pending:
                pending[k].extend(list(result[k]))
            flush_pending()
            if len(replay) >= batch_size:
                for _ in range(2):
                    metrics = agent.learn(replay.sample(batch_size, sample_gen))
                    learn_steps += 1
                if learn_steps % publish_every < 2:
                    server.publish(agent.get_weights())
            if log_every and done_episodes % log_every == 0:
                print(f"episodes {done_episodes} | return(20) {np.mean(returns[-20:]):.1f} | "
                      f"learn_steps {learn_steps} | weight v{server.params.version} | "
                      f"loss {float(metrics.get('loss', float('nan'))):.4f}", flush=True)
    finally:
        stop.set()
        cluster.join()
        server.stop()
    wall = time.time() - t0
    return {
        "episodes": done_episodes,
        "transitions": transitions,
        "learn_steps": learn_steps,
        "wall_s": wall,
        "env_steps_per_s": transitions / max(wall, 1e-9),
        "learn_steps_per_s": learn_steps / max(wall, 1e-9),
        "return_first20": float(np.mean(returns[:20])) if returns else float("nan"),
        "return_last20": float(np.mean(returns[-20:])) if returns else float("nan"),
        "unique_episodes": len(set(seeds)),
        "weight_version": server.params.version,
        "metrics": {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0},
        "agent": agent,
    }


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--episodes", type=int, default=200)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--publish-every", type=int, default=10)
    parser.add_argument("--eps", type=float, default=0.2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = parser.parse_args(argv)
    out = train_fleet_dqn(episodes=a.episodes, num_workers=a.num_workers,
                          batch_size=a.batch_size, publish_every=a.publish_every, eps=a.eps,
                          device=a.device)
    print(f"done: {out['episodes']} episodes in {out['wall_s']:.1f}s | final return(20) "
          f"{out['return_last20']:.1f} | first return(20) {out['return_first20']:.1f}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
