"""Agent interface (port of ``scalerl_tpu/agents/base.py``'s ``BaseAgent``,
the surface the off-policy trainer calls).  Checkpoint save/load is not
ported yet."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Mapping


class BaseAgent(ABC):
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
