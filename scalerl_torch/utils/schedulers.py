"""Host-side hyperparameter schedules (port of
``scalerl_tpu/utils/schedulers.py``): the exploration epsilon and the PER
beta, fed to the device calls as Python floats, and the piecewise-constant
and multi-step schedules."""

from __future__ import annotations

from typing import List, Sequence, Tuple


class PiecewiseScheduler:
    """Piecewise-constant schedule over step boundaries."""

    def __init__(self, endpoints: Sequence[Tuple[int, float]]) -> None:
        if not endpoints:
            raise ValueError("endpoints must be non-empty")
        steps = [s for s, _ in endpoints]
        if steps != sorted(steps):
            raise ValueError(f"endpoints must be sorted by step, got {steps}")
        self.endpoints = list(endpoints)
        self.cur_step = 0

    def value(self, step: int) -> float:
        out = self.endpoints[0][1]
        for boundary, v in self.endpoints:
            if step < boundary:
                break
            out = v
        return out

    def step(self, num: int = 1) -> float:
        self.cur_step += num
        return self.value(self.cur_step)


class LinearDecayScheduler:
    """Linear interpolation from start to end over ``total_steps``."""

    def __init__(self, start_value: float, end_value: float, total_steps: int) -> None:
        if total_steps <= 0:
            raise ValueError(f"total_steps must be positive, got {total_steps}")
        self.start_value = float(start_value)
        self.end_value = float(end_value)
        self.total_steps = int(total_steps)
        self.cur_step = 0

    def value(self, step: int) -> float:
        frac = min(max(step / self.total_steps, 0.0), 1.0)
        return self.start_value + frac * (self.end_value - self.start_value)

    def step(self, num: int = 1) -> float:
        self.cur_step += num
        return self.value(self.cur_step)


class MultiStepScheduler:
    """Multiply the value by ``gamma`` at each milestone."""

    def __init__(self, start_value: float, milestones: Sequence[int], gamma: float = 0.1) -> None:
        ms: List[int] = list(milestones)
        if ms != sorted(ms):
            raise ValueError(f"milestones must be sorted, got {ms}")
        self.start_value = float(start_value)
        self.milestones = ms
        self.gamma = float(gamma)
        self.cur_step = 0

    def value(self, step: int) -> float:
        v = self.start_value
        for m in self.milestones:
            if step >= m:
                v *= self.gamma
        return v

    def step(self, num: int = 1) -> float:
        self.cur_step += num
        return self.value(self.cur_step)
