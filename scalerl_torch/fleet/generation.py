"""Episode generation for fleet workers.

Port of ``scalerl_tpu/fleet/generation.py`` (plain numpy there too).
Parity target: ``Generator`` (``scalerl/hpc/generation.py:16-183``): turn-
based multi-player rollouts with legal-action masking, per-player discounted
returns, and episodes shipped as fixed-size chunks.

Steps accumulate into *fixed-shape* numpy chunks (padded, with an explicit
``length``), so the learner's host stacks them straight into ``[T, B]``
batches; masking adds a ``-inf`` mask before a stable softmax rather than
the reference's ``+1e32`` legal-logit trick.  Compression happens in the
transport (``FleetConfig.compress_uplink``), not per episode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np


class TurnBasedEnv(Protocol):
    """Minimal turn-based multi-player env protocol (HandyRL-style)."""

    def reset(self, seed: Optional[int] = None) -> None: ...
    def players(self) -> Sequence[int]: ...
    def turn(self) -> int: ...
    def terminal(self) -> bool: ...
    def observation(self, player: int) -> np.ndarray: ...
    def legal_actions(self, player: int) -> Sequence[int]: ...
    def play(self, action: int) -> None: ...
    def outcome(self) -> Dict[int, float]: ...


# PolicyFn: (weights, observation, player) -> action logits [num_actions]
PolicyFn = Callable[[Any, np.ndarray, int], np.ndarray]


def masked_softmax(logits: np.ndarray, legal: Sequence[int]) -> np.ndarray:
    """Probabilities over all actions with illegal ones exactly zero."""
    mask = np.full(logits.shape, -np.inf, dtype=np.float32)
    mask[list(legal)] = 0.0
    z = logits.astype(np.float32) + mask
    z -= z[list(legal)].max()
    e = np.where(np.isneginf(z), 0.0, np.exp(z))
    return e / e.sum()


def discounted_returns(
    rewards: np.ndarray, gamma: float, block: int = 64
) -> np.ndarray:
    """Per-step discounted return (reference ``generation.py:143-147``),
    vectorized.

    The reverse recursion ``acc = r_t + gamma * acc`` is a scaled prefix
    sum: within a window, ``out_t = (sum_{u>=t} r_u * gamma^u) / gamma^t``.
    Dividing by ``gamma^t`` underflows float64 for long horizons at small
    gamma, so the episode is processed in blocks of ``block`` steps from
    the end — each block is one vectorized reverse cumsum in float64 (with
    the carry from later blocks folded in as ``gamma^(n-t) * acc``), and
    ``gamma^block`` stays comfortably inside the float64 range for any
    realistic discount.  Exact (modulo float64 rounding) match to the old
    Python loop, without the per-step host loop a worker pays on every
    episode.
    """
    r = np.asarray(rewards, dtype=np.float64)
    T = len(r)
    if T == 0:
        return np.zeros(0, dtype=np.float32)
    if gamma == 0.0:
        return r.astype(np.float32)
    if gamma == 1.0:
        return np.cumsum(r[::-1])[::-1].astype(np.float32)
    out = np.empty(T, dtype=np.float64)
    acc = 0.0
    for end in range(T, 0, -block):
        start = max(end - block, 0)
        x = r[start:end]
        n = len(x)
        w = np.power(float(gamma), np.arange(n))  # gamma^t within the block
        s = np.cumsum((x * w)[::-1])[::-1]  # sum_{u>=t} x_u * gamma^u
        out[start:end] = s / w + acc * np.power(
            float(gamma), np.arange(n, 0, -1)
        )
        acc = out[start]
    return out.astype(np.float32)


class EpisodeGenerator:
    """Runs one turn-based episode and emits fixed-shape padded chunks."""

    def __init__(
        self,
        env: TurnBasedEnv,
        policy_fn: PolicyFn,
        num_actions: int,
        gamma: float = 1.0,
        chunk_len: int = 64,
        temperature: float = 1.0,
    ) -> None:
        self.env = env
        self.policy_fn = policy_fn
        self.num_actions = num_actions
        self.gamma = gamma
        self.chunk_len = chunk_len
        self.temperature = temperature

    def generate(
        self, weights: Any, seed: Optional[int] = None, greedy: bool = False
    ) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        env = self.env
        env.reset(seed=seed)
        obs_l: List[np.ndarray] = []
        act_l: List[int] = []
        probs_l: List[np.ndarray] = []
        player_l: List[int] = []
        while not env.terminal():
            player = env.turn()
            obs = np.asarray(env.observation(player))
            legal = env.legal_actions(player)
            logits = self.policy_fn(weights, obs, player)
            probs = masked_softmax(logits / max(self.temperature, 1e-6), legal)
            if greedy:
                action = int(np.argmax(probs))
            else:
                action = int(rng.choice(self.num_actions, p=probs))
            env.play(action)
            obs_l.append(obs)
            act_l.append(action)
            probs_l.append(probs)
            player_l.append(player)
        outcome = env.outcome()
        T = len(act_l)
        players = np.asarray(player_l, dtype=np.int32)
        # per-player reward stream: outcome at that player's last move,
        # discounted back through *their own* moves
        returns = np.zeros(T, dtype=np.float32)
        for p, score in outcome.items():
            idx = np.nonzero(players == p)[0]
            if len(idx) == 0:
                continue
            r = np.zeros(len(idx), dtype=np.float32)
            r[-1] = float(score)
            returns[idx] = discounted_returns(r, self.gamma)
        episode = {
            "obs": np.stack(obs_l) if obs_l else np.zeros((0,), np.float32),
            "action": np.asarray(act_l, dtype=np.int32),
            "probs": np.stack(probs_l) if probs_l else np.zeros((0,), np.float32),
            "player": players,
            "returns": returns,
            "length": T,
            "outcome": {int(k): float(v) for k, v in outcome.items()},
        }
        return {"chunks": self._chunk(episode), "length": T,
                "outcome": episode["outcome"]}

    def _chunk(self, episode: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Split into fixed-shape, zero-padded chunks of ``chunk_len``."""
        T = episode["length"]
        chunks = []
        for start in range(0, max(T, 1), self.chunk_len):
            end = min(start + self.chunk_len, T)
            n = end - start
            chunk: Dict[str, Any] = {"start": start, "length": n}
            for key in ("obs", "action", "probs", "player", "returns"):
                arr = episode[key][start:end]
                if n < self.chunk_len:
                    pad = [(0, self.chunk_len - n)] + [(0, 0)] * (arr.ndim - 1)
                    arr = np.pad(arr, pad)
                chunk[key] = arr
            chunks.append(chunk)
        return chunks


class GenerationRunner:
    """Fleet ``EpisodeRunner`` running turn-based generation
    (``role='rollout'``) or greedy evaluation (``role='eval'``), mirroring
    the reference's ``role=='g'``/``'e'`` split (``hpc/worker.py:108-116``).

    A class (not a closure) so it pickles across ``spawn`` process
    boundaries when ``env_fn``/``policy_fn`` are module-level callables;
    the lazily-built :class:`EpisodeGenerator` is excluded from the pickle.
    """

    def __init__(
        self,
        env_fn: Callable[[], TurnBasedEnv],
        policy_fn: PolicyFn,
        num_actions: int,
        gamma: float = 1.0,
        chunk_len: int = 64,
    ) -> None:
        self.env_fn = env_fn
        self.policy_fn = policy_fn
        self.num_actions = num_actions
        self.gamma = gamma
        self.chunk_len = chunk_len
        self._gen: Any = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_gen"] = None
        return state

    def __call__(
        self, task: Dict[str, Any], weights: Any, worker_id: int
    ) -> Dict[str, Any]:
        if self._gen is None:
            self._gen = EpisodeGenerator(
                self.env_fn(),
                self.policy_fn,
                self.num_actions,
                gamma=self.gamma,
                chunk_len=self.chunk_len,
            )
        greedy = task.get("role") == "eval"
        out = self._gen.generate(weights, seed=task.get("seed"), greedy=greedy)
        out["role"] = task.get("role", "rollout")
        return out


def make_generation_runner(
    env_fn: Callable[[], TurnBasedEnv],
    policy_fn: PolicyFn,
    num_actions: int,
    gamma: float = 1.0,
    chunk_len: int = 64,
) -> GenerationRunner:
    """Factory kept for API stability; see :class:`GenerationRunner`."""
    return GenerationRunner(env_fn, policy_fn, num_actions, gamma, chunk_len)
