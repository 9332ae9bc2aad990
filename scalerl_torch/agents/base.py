"""Agent interface (port of ``scalerl_tpu/agents/base.py``): ``BaseAgent``,
the surface the trainers call, and ``RecurrentEvalState``, the carried core
behind the per-call ``get_action``/``predict`` of a recurrent agent."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Mapping

import numpy as np

from scalerl_torch.parallel.sharding import MeshedAgentState


class RecurrentEvalState:
    """Per-mode recurrent memory for the per-call host API (one slot per
    mode, so exploration and greedy evaluation keep their own cores).

    Rows reset where the caller's ``done`` flag is True; a batch-size change
    rebuilds everything; ``done=None`` on a fresh slot resets the whole
    batch.  The reward input is zero (the host API carries no reward)."""

    def __init__(self, initial_state_fn: Callable[[int], Any]) -> None:
        self._initial_state_fn = initial_state_fn
        self._modes: Dict[str, Dict[str, Any]] = {}

    def step_inputs(self, mode: str, batch_size: int, done):
        st = self._modes.get(mode)
        if st is None or st["batch"] != batch_size:
            st = {
                "batch": batch_size,
                "core": self._initial_state_fn(batch_size),
                "prev_action": np.zeros(batch_size, np.int32),
            }
            self._modes[mode] = st
            done_in = np.ones(batch_size, bool)
        elif done is None:
            done_in = np.zeros(batch_size, bool)
        else:
            done_in = np.asarray(done, bool)
        # fresh episodes start with a zero last action, as the model's core
        # resets on done rows
        prev_action = np.where(done_in, 0, st["prev_action"]).astype(np.int32)
        reward = np.zeros(batch_size, np.float32)
        return st["core"], prev_action, reward, done_in

    def update(self, mode: str, action, core) -> None:
        st = self._modes[mode]
        st["prev_action"] = np.asarray(action, np.int32)
        st["core"] = core

    def reset(self) -> None:
        """Drop every carried core (after new weights are loaded)."""
        self._modes.clear()


class BaseAgent(MeshedAgentState, ABC):
    """Algorithm-agnostic agent API consumed by the trainers."""

    @abstractmethod
    def get_action(self, obs: Any, *, done: Any = None) -> Any:
        """Actions with exploration.  ``done`` is the previous step's
        episode-boundary flag per env lane; stateless agents ignore it."""

    @abstractmethod
    def predict(self, obs: Any, *, done: Any = None) -> Any:
        """Greedy actions (evaluation); ``done`` as in :meth:`get_action`."""

    @abstractmethod
    def learn(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One gradient step on a batch; returns its metrics."""

    def get_weights(self) -> Any:
        raise NotImplementedError

    def set_weights(self, weights: Any) -> None:
        raise NotImplementedError

    def save_checkpoint(self, path: str) -> str:
        """Save ``self.state`` to the checkpoint directory ``path``; a meshed
        agent's state is gathered to full tensors first
        (``parallel/train_step.py::save_sharded``)."""
        if getattr(self, "mesh", None) is not None:
            from scalerl_torch.parallel.train_step import save_sharded

            return save_sharded(self, path)
        from scalerl_torch.utils.checkpoint import save_checkpoint

        return save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        """Restore ``self.state`` from ``path`` (its tree, dtypes and
        devices), falling back through the retained ``.prev`` chain; a
        meshed agent re-places the restored tensors in its layout."""
        if getattr(self, "mesh", None) is not None:
            from scalerl_torch.parallel.train_step import load_sharded

            self.state = load_sharded(self, path)
            return
        from scalerl_torch.utils.checkpoint import load_checkpoint

        self.state = load_checkpoint(path, self.state)
