"""Host-side hyperparameter schedules (port of ``LinearDecayScheduler`` of
``scalerl_tpu/utils/schedulers.py``): the exploration epsilon and the PER
beta, fed to the device calls as Python floats."""

from __future__ import annotations


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
