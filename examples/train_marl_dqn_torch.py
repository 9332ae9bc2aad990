"""Independent DQN over the async multi-agent plane on PyTorch: the twin of ``examples/train_marl_dqn.py``.

Two independent DQN learners, one per agent id, train against each other on
the built-in 2-agent pursuit game (``envs/multi_agent.py::PursuitToyEnv``),
every env instance running in a subprocess that writes its observations into
the shared-memory plane (``envs/vector::AsyncMultiAgentVecEnv``).

Independent Q-learning (IQL, Tan 1993): each agent treats the other as part
of the environment, with its own replay, its own epsilon-greedy schedule and
one batched ``get_action`` an agent a step (central inference on the card
over the env batch).  At an episode's end the async workers reset and keep
the true terminal observation in ``infos[i]["final_observation"]``; the
replay stores that as ``next_obs``.

Evidence (``tools/torch_learning_curves.py`` row ``marl_pursuit_iql``):
each learned policy against a *random* opponent.  The trained chaser must
catch much faster than a random chaser does (random walks on a small ring
collide eventually, so the catch rate alone cannot tell), and the trained
runner must be caught much less often than a random runner.

The learners run on the card and raise without one (``--device cpu`` runs
them on the host).  Guard ``if __name__ == "__main__":`` in scripts that
call :func:`run_marl`: the env workers start by spawn.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def _policy_random(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 3, n).astype(np.int64)


def evaluate_matchup(
    chaser_policy: Optional[Callable[[np.ndarray], np.ndarray]],
    runner_policy: Optional[Callable[[np.ndarray], np.ndarray]],
    episodes: int = 200,
    seed: int = 0,
) -> Tuple[float, float]:
    """One pursuit matchup (``None``: a random policy): ``(catch_rate,
    mean_episode_length)``.  Time to catch tells chasers apart, the catch
    rate runners."""
    from scalerl_torch.envs.multi_agent import PursuitToyEnv

    env = PursuitToyEnv()
    rng = np.random.default_rng(seed)
    caught = 0
    lengths = []
    for ep in range(episodes):
        obs, _ = env.reset(seed=seed + ep)
        for t in range(env.episode_limit):
            acts = {}
            for name, policy in (("chaser", chaser_policy), ("runner", runner_policy)):
                if policy is None:
                    acts[name] = int(_policy_random(rng, 1)[0])
                else:
                    acts[name] = int(policy(obs[name][None])[0])
            obs, rew, term, trunc, _ = env.step(acts)
            if term["chaser"]:
                caught += 1
                lengths.append(t + 1)
                break
            if trunc["chaser"]:
                lengths.append(env.episode_limit)
                break
    env.close()
    return caught / episodes, float(np.mean(lengths))


def terminal_next_obs(next_obs: Dict[str, np.ndarray], infos, names) -> Dict[str, np.ndarray]:
    """``next_obs`` with each finished env's row replaced by its true terminal
    observation (``infos[i]["final_observation"]``); an agent missing from
    that dict (a PettingZoo agent that left early) keeps its row."""
    store = dict(next_obs)
    for i, info in enumerate(infos):
        fin = info.get("final_observation") if info else None
        if fin is None:
            continue
        for a in names:
            fin_a = fin.get(a)
            if fin_a is None:
                continue
            if store[a] is next_obs[a]:
                store[a] = np.array(next_obs[a])
            store[a][i] = fin_a
    return store


def train_iql(
    venv,
    make_agent_args,  # (index, name) -> DQNArguments
    obs_shape: Tuple[int, ...],
    n_actions: int,
    max_steps: int,
    batch_size: int = 64,
    warmup: int = 500,
    train_frequency: int = 4,
    seed: int = 0,
    on_window=None,
    device: str = "cuda",
) -> Dict:
    """The independent-Q-learning loop over the async multi-agent plane.

    ``on_window(frames, per_agent_returns, team_return)`` fires every 500
    steps.  Returns the trained ``agents``, the per-agent and team return
    windows, and the rates."""
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.sampler import Sampler

    names = list(venv.agents)
    num_envs = venv.num_envs
    agents: Dict[str, DQNAgent] = {}
    samplers: Dict[str, Sampler] = {}
    gens: Dict[str, torch.Generator] = {}
    for i, name in enumerate(names):
        args = make_agent_args(i, name)
        agents[name] = DQNAgent(args, obs_shape=obs_shape, action_dim=n_actions, device=device)
        samplers[name] = Sampler(obs_shape=obs_shape, capacity=args.buffer_size,
                                 num_envs=num_envs, n_step=1, gamma=args.gamma,
                                 device=agents[name].device)
        gens[name] = torch.Generator(device=agents[name].device).manual_seed(args.seed)

    obs, _ = venv.reset(seed=seed)
    ep_ret = {a: np.zeros(num_envs) for a in names}
    window: Dict[str, list] = {a: [] for a in names}
    team_ep = np.zeros(num_envs)
    team_window: list = []
    learn_steps = 0
    t0 = time.time()
    for step in range(max_steps):
        actions = {a: agents[a].get_action(obs[a]).cpu().numpy() for a in names}
        next_obs, rew, term, trunc, infos = venv.step(actions)
        done = {a: np.logical_or(term[a], trunc[a]) for a in names}
        # the replay bootstraps from the true terminal obs at episode ends
        store_next = terminal_next_obs(next_obs, infos, names)
        team_step = np.zeros(num_envs)
        for a in names:
            samplers[a].add(obs[a], store_next[a], actions[a], rew[a], term[a],
                            boundary=done[a])
            agents[a].update_exploration(num_envs)
            ep_ret[a] += rew[a]
            team_step += rew[a]
            for i in np.nonzero(done[a])[0]:
                window[a].append(ep_ret[a][i])
                ep_ret[a][i] = 0.0
        team_ep += team_step
        all_done = np.all([done[a] for a in names], axis=0)
        for i in np.nonzero(all_done)[0]:
            team_window.append(team_ep[i])
            team_ep[i] = 0.0
        obs = next_obs
        if step >= warmup and step % train_frequency == 0:
            for a in names:
                agents[a].learn(samplers[a].sample(batch_size, generator=gens[a]))
            learn_steps += 1
        if on_window is not None and step and step % 500 == 0:
            returns = {a: float(np.mean(window[a][-200:])) if window[a] else 0.0 for a in names}
            team = float(np.mean(team_window[-50:])) if team_window else 0.0
            on_window(step * num_envs, returns, team)

    wall = time.time() - t0
    return {
        "agents": agents,
        "samplers": samplers,
        "window": window,
        "team_window": team_window,
        "learn_steps": learn_steps,
        "wall_s": wall,
        "env_frames": max_steps * num_envs,
        "fps": round(max_steps * num_envs / max(wall, 1e-9), 1),
    }


def marl_agent_args(i: int, name: str, max_timesteps: int, batch_size: int, seed: int):
    """Each agent's ``DQNArguments``, as the JAX example sets them."""
    from scalerl_torch.config import DQNArguments

    return DQNArguments(
        env_id="PursuitToy-v0", hidden_sizes="64,64", buffer_size=50_000,
        batch_size=batch_size, learning_rate=1e-3, gamma=0.97, max_timesteps=max_timesteps,
        eps_greedy_end=0.05, double_dqn=True, logger_backend="none", save_model=False,
        seed=seed + 17 * i)


def run_marl(
    num_envs: int = 8,
    max_steps: int = 4000,  # env steps a lane: num_envs * this transitions
    batch_size: int = 64,
    warmup: int = 500,
    train_frequency: int = 4,
    seed: int = 0,
    on_window=None,
    device: str = "cuda",
    eval_episodes: int = 200,
) -> Dict:
    """Train independent DQNs for both pursuit agents; return the summary
    (``on_window(frames, returns)`` every 500 steps)."""
    from scalerl_torch.envs.multi_agent import PursuitToyEnv, make_multi_agent_vec_env
    from scalerl_torch.utils.platform import resolve_device

    resolve_device(device)  # refuse a missing card before any env process starts
    # spawn: the learners' process holds CUDA (or a test's JAX) threads
    venv = make_multi_agent_vec_env(PursuitToyEnv, num_envs=num_envs, context="spawn")
    try:
        t = train_iql(
            venv,
            lambda i, name: marl_agent_args(i, name, max_steps * num_envs, batch_size, seed),
            obs_shape=(4,), n_actions=3, max_steps=max_steps, batch_size=batch_size,
            warmup=warmup, train_frequency=train_frequency, seed=seed,
            on_window=(None if on_window is None
                       else lambda f, returns, team: on_window(f, returns)),
            device=device,
        )
    finally:
        venv.close()
    agents, window, wall = t["agents"], t["window"], t["wall_s"]
    chaser, runner = agents["chaser"], agents["runner"]
    rate_cr, len_cr = evaluate_matchup(chaser.predict, None, eval_episodes, seed=seed + 1)
    rate_rr, len_rr = evaluate_matchup(None, None, eval_episodes, seed=seed + 2)
    rate_rc, len_rc = evaluate_matchup(None, runner.predict, eval_episodes, seed=seed + 3)
    return {
        "env_frames": max_steps * num_envs,
        "wall_s": round(wall, 1),
        "fps": round(max_steps * num_envs / max(wall, 1e-9), 1),
        "learn_steps": t["learn_steps"],
        "final_returns": {a: float(np.mean(window[a][-200:])) if window[a] else 0.0
                          for a in agents},
        # the trained chaser catches much faster than a random one; the
        # trained runner is caught much less often
        "trained_chaser_vs_random": {"catch_rate": rate_cr, "mean_len": len_cr},
        "random_vs_random": {"catch_rate": rate_rr, "mean_len": len_rr},
        "random_vs_trained_runner": {"catch_rate": rate_rc, "mean_len": len_rc},
    }


def main(argv=None) -> Dict:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-envs", type=int, default=8)
    parser.add_argument("--max-steps", type=int, default=4000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    summary = run_marl(
        num_envs=args.num_envs, max_steps=args.max_steps, seed=args.seed, device=args.device,
        on_window=lambda f, r: print(f"frames {f} | returns {r}", flush=True),
    )
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
