"""Multi-agent parallel-env protocol, adapters and wrappers.

Port of ``scalerl_tpu/envs/multi_agent.py`` (plain numpy there too).  The
protocol is PettingZoo's *parallel* API (``possible_agents``, dict-keyed
``reset``/``step``, per-agent spaces): real PettingZoo envs plug into
``AsyncMultiAgentVecEnv`` unchanged, and this package does not import
pettingzoo.

Parity targets: ``PettingZooAutoResetParallelWrapper``
(``scalerl/envs/pettingzoo_wrappers.py:9-64``), and the single-agent use of
the shared-memory vec env (``make_shared_vec_envs``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


class AutoResetParallelWrapper:
    """Auto-reset a parallel multi-agent env when every agent is done."""

    def __init__(self, env: Any) -> None:
        self.env = env

    @property
    def possible_agents(self) -> Sequence[str]:
        return self.env.possible_agents

    def observation_space(self, agent: str):
        return self.env.observation_space(agent)

    def action_space(self, agent: str):
        return self.env.action_space(agent)

    def reset(self, seed: Optional[int] = None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, actions: Dict[str, Any]):
        obs, rew, term, trunc, infos = self.env.step(actions)
        agents = self.possible_agents
        if all(term.get(a, True) or trunc.get(a, False) for a in agents):
            obs, _reset_infos = self.env.reset()
        return obs, rew, term, trunc, infos

    def close(self) -> None:
        close = getattr(self.env, "close", None)
        if close:
            close()

    def __getattr__(self, name: str):
        return getattr(self.env, name)


class SingleAgentAdapter:
    """Expose a gymnasium env through the parallel multi-agent protocol.

    Makes ``AsyncMultiAgentVecEnv`` double as a shared-memory single-agent
    vector env: one agent named ``agent_0``.
    """

    AGENT = "agent_0"

    def __init__(self, env: Any) -> None:
        self.env = env
        self.possible_agents = [self.AGENT]

    def observation_space(self, agent: str):
        return self.env.observation_space

    def action_space(self, agent: str):
        return self.env.action_space

    def reset(self, seed: Optional[int] = None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return {self.AGENT: obs}, {self.AGENT: info}

    def step(self, actions: Dict[str, Any]):
        obs, reward, terminated, truncated, info = self.env.step(
            actions[self.AGENT]
        )
        a = self.AGENT
        return (
            {a: obs},
            {a: float(reward)},
            {a: bool(terminated)},
            {a: bool(truncated)},
            {a: info},
        )

    def close(self) -> None:
        self.env.close()


class _Box:
    """Minimal space descriptor (shape + dtype), gymnasium-free."""

    def __init__(self, shape: Tuple[int, ...], dtype) -> None:
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


class _Discrete:
    def __init__(self, n: int) -> None:
        self.n = n
        self.shape = ()
        self.dtype = np.dtype(np.int64)


class PursuitToyEnv:
    """Tiny built-in 2-agent pursuit on a 1-D ring: the chaser scores when
    it lands on the runner.  Used by tests, examples, and the env
    throughput benchmark — no external deps, fully deterministic."""

    SIZE = 8

    def __init__(self, episode_limit: int = 32) -> None:
        self.possible_agents = ["chaser", "runner"]
        self.episode_limit = episode_limit
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._pos = np.zeros(2, np.int64)

    def observation_space(self, agent: str):
        return _Box((4,), np.float32)

    def action_space(self, agent: str):
        return _Discrete(3)  # left / stay / right

    def _obs(self) -> Dict[str, np.ndarray]:
        c, r = self._pos
        base = np.array(
            [c / self.SIZE, r / self.SIZE, (r - c) % self.SIZE / self.SIZE,
             self._t / self.episode_limit],
            np.float32,
        )
        return {"chaser": base, "runner": -base}

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = self._rng.integers(0, self.SIZE, size=2)
        self._t = 0
        return self._obs(), {a: {} for a in self.possible_agents}

    def step(self, actions: Dict[str, int]):
        self._t += 1
        for i, agent in enumerate(self.possible_agents):
            self._pos[i] = (self._pos[i] + int(actions[agent]) - 1) % self.SIZE
        caught = self._pos[0] == self._pos[1]
        reward = {"chaser": 1.0 if caught else -0.01,
                  "runner": -1.0 if caught else 0.01}
        done = bool(caught)
        trunc = self._t >= self.episode_limit
        term = {a: done for a in self.possible_agents}
        truncs = {a: trunc and not done for a in self.possible_agents}
        return self._obs(), reward, term, truncs, {a: {} for a in
                                                   self.possible_agents}

    def close(self) -> None:
        pass


def make_multi_agent_vec_env(
    env_fn, num_envs: int, autoreset: bool = True, **kwargs
):
    """Vectorize a parallel multi-agent env over subprocesses with the
    shared-memory plane (parity: ``make_multi_agent_vect_envs``,
    ``scalerl/envs/env_utils.py:97-120``)."""
    from scalerl_torch.envs.vector import AsyncMultiAgentVecEnv

    return AsyncMultiAgentVecEnv(
        [env_fn for _ in range(num_envs)], autoreset=autoreset, **kwargs
    )


class _SingleAgentFactory:
    """Picklable env factory, so spawn and forkserver contexts work
    (lambdas would restrict the vec env to fork, which is unsafe once the
    parent holds a CUDA context)."""

    def __init__(self, env_fn) -> None:
        self.env_fn = env_fn

    def __call__(self):
        return SingleAgentAdapter(self.env_fn())


def make_shared_vec_envs(env_fn, num_envs: int, **kwargs):
    """Single-agent gym envs over the shared-memory vec env."""
    from scalerl_torch.envs.vector import AsyncMultiAgentVecEnv

    return AsyncMultiAgentVecEnv(
        [_SingleAgentFactory(env_fn) for _ in range(num_envs)], **kwargs
    )
