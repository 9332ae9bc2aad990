"""Episode accounting for vector envs (port of ``EpisodeMetrics``,
``calculate_vectorized_scores`` and ``calculate_mean`` of
``scalerl_tpu/utils/metrics.py``).  Plain numpy on the host: episode
boundaries are data-dependent."""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np


class EpisodeMetrics:
    """Track each env's running return and length; record finished episodes."""

    def __init__(self, num_envs: int) -> None:
        self.num_envs = num_envs
        self._returns = np.zeros(num_envs, dtype=np.float64)
        self._lengths = np.zeros(num_envs, dtype=np.int64)
        self.episode_returns: List[float] = []
        self.episode_lengths: List[int] = []

    def step(self, rewards: np.ndarray, dones: np.ndarray, lane0: int = 0) -> int:
        """Accumulate one vector step; returns the number of episodes that
        finished.  ``lane0``: the first of the lanes this step updates (an
        Ape-X actor's own block; actors touch disjoint lanes)."""
        rewards = np.asarray(rewards, dtype=np.float64).ravel()
        width = rewards.shape[0]
        dones = np.asarray(dones).reshape(width).astype(bool)
        lanes = slice(lane0, lane0 + width)
        self._returns[lanes] += rewards
        self._lengths[lanes] += 1
        for i in np.nonzero(dones)[0]:
            self.episode_returns.append(float(self._returns[lane0 + i]))
            self.episode_lengths.append(int(self._lengths[lane0 + i]))
        self._returns[lanes][dones] = 0.0
        self._lengths[lanes][dones] = 0
        return int(dones.sum())

    @property
    def num_episodes(self) -> int:
        return len(self.episode_returns)

    def summary(self, window: int = 100) -> Dict[str, float]:
        rets = self.episode_returns[-window:]
        lens = self.episode_lengths[-window:]
        if not rets:
            return {"episodes": 0}
        return {
            "episodes": float(len(self.episode_returns)),
            "return_mean": float(np.mean(rets)),
            "return_std": float(np.std(rets)),
            "return_max": float(np.max(rets)),
            "return_min": float(np.min(rets)),
            "length_mean": float(np.mean(lens)),
        }


def calculate_vectorized_scores(rewards: np.ndarray, dones: np.ndarray,
                                include_unterminated: bool = False) -> List[float]:
    """Split ``[T, N]`` reward/done arrays into completed-episode returns,
    env by env; ``include_unterminated`` adds each env's open episode."""
    rewards = np.asarray(rewards, dtype=np.float64)
    dones = np.asarray(dones).astype(bool)
    if rewards.ndim == 1:
        rewards, dones = rewards[:, None], dones[:, None]
    scores: List[float] = []
    for env in range(rewards.shape[1]):
        acc, steps = 0.0, 0
        for r, d in zip(rewards[:, env], dones[:, env]):
            acc += r
            steps += 1
            if d:
                scores.append(acc)
                acc, steps = 0.0, 0
        if include_unterminated and steps > 0:
            scores.append(acc)
    return scores


def calculate_mean(dicts: Sequence[Mapping[str, float]]) -> Dict[str, float]:
    """Average a list of metric dicts key by key (keys may be ragged)."""
    out: Dict[str, List[float]] = {}
    for d in dicts:
        for k, v in d.items():
            out.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in out.items()}
