"""Interval-gated scalar loggers: TensorBoard, W&B, or silent.

The port's own copy of ``scalerl_tpu/utils/loggers.py``: ``BaseLogger``
with per-namespace interval gating and the registry-backed
``log_registry``, ``LazyLogger``, ``TensorboardLogger`` over
``tensorboardX`` (resume by replaying the event files, which stay readable
by either package) and ``WandbLogger``.  ``tensorboardX`` and ``wandb`` are
imported where a logger is built; a missing one raises an ``ImportError``
naming it.  ``make_logger`` builds what ``logger_backend`` names and
nothing else.
"""

from __future__ import annotations

import itertools
import os
from abc import ABC, abstractmethod
from numbers import Number
from typing import Callable, Dict, Optional, Tuple

WRITE_TYPE = Tuple[str, int, Dict[str, float]]

# tensorboardX names event files events.out.tfevents.<second>.<hostname>:
# two writers on one dir within the same second SILENTLY OVERWRITE each
# other — exactly the resume path (restore_data constructs a fresh writer
# over the old run dir).  A per-process sequence + pid suffix makes every
# writer's file unique; the "port" tag keeps it apart from the JAX package's
# writers, whose sequence restarts at 0 in a process that loads both.
_WRITER_SEQ = itertools.count()


class BaseLogger(ABC):
    """Scalar logger with per-namespace interval gating."""

    def __init__(
        self,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
    ) -> None:
        self.train_interval = train_interval
        self.test_interval = test_interval
        self.update_interval = update_interval
        self.last_log_train_step = -1
        self.last_log_test_step = -1
        self.last_log_update_step = -1

    @abstractmethod
    def write(self, step_type: str, step: int, data: Dict[str, float]) -> None:
        ...

    def log_train_data(self, data: Dict[str, float], step: int) -> None:
        if step - self.last_log_train_step >= self.train_interval:
            self.write("train/env_step", step, {f"train/{k}": v for k, v in data.items()})
            self.last_log_train_step = step

    def log_test_data(self, data: Dict[str, float], step: int) -> None:
        if step - self.last_log_test_step >= self.test_interval:
            self.write("test/env_step", step, {f"test/{k}": v for k, v in data.items()})
            self.last_log_test_step = step

    def log_update_data(self, data: Dict[str, float], step: int) -> None:
        if step - self.last_log_update_step >= self.update_interval:
            self.write("update/gradient_step", step, {f"update/{k}": v for k, v in data.items()})
            self.last_log_update_step = step

    def log_registry(
        self,
        step: int,
        step_type: str = "train",
        registry=None,
        include_prefixes: Optional[Tuple[str, ...]] = None,
        extra: Optional[Dict[str, float]] = None,
    ) -> None:
        """Registry-backed write path: flatten the telemetry registry's
        scalars and route them through the existing interval gating.

        Trainers populate the process registry (gauges/meters/counters) and
        call this instead of hand-assembling a metric dict; every backend
        (TensorBoard/W&B/none) then reads from the same plane.  Dots become
        slashes so instruments group in TensorBoard (``train.fps`` →
        ``train/fps``).  ``include_prefixes`` narrows the write to matching
        instrument names; ``extra`` rides along (already-host floats only).
        """
        from scalerl_torch.runtime.telemetry import get_registry

        reg = registry if registry is not None else get_registry()
        scalars = reg.scalars()
        if include_prefixes is not None:
            scalars = {
                k: v
                for k, v in scalars.items()
                if k.startswith(include_prefixes)
            }
        # the gating methods prefix with their namespace; drop a redundant
        # leading instrument namespace (train.fps → train/fps, not
        # train/train/fps)
        ns = step_type + "."
        data = {
            (k[len(ns):] if k.startswith(ns) else k).replace(".", "/"): v
            for k, v in scalars.items()
        }
        if extra:
            data.update(extra)
        if step_type == "train":
            self.log_train_data(data, step)
        elif step_type == "test":
            self.log_test_data(data, step)
        elif step_type == "update":
            self.log_update_data(data, step)
        else:
            raise ValueError(
                f"unknown step_type {step_type!r}; expected train|test|update"
            )

    def save_data(
        self,
        epoch: int,
        env_step: int,
        gradient_step: int,
        checkpoint_fn: Optional[Callable[[int, int, int], str]] = None,
    ) -> None:
        pass

    def restore_data(self) -> Tuple[int, int, int]:
        return 0, 0, 0

    def close(self) -> None:
        pass


class LazyLogger(BaseLogger):
    """A no-op logger (``scalerl/utils/logger/base.py:133-146``)."""

    def __init__(self) -> None:
        super().__init__()

    def write(self, step_type: str, step: int, data: Dict[str, float]) -> None:
        pass


class TensorboardLogger(BaseLogger):
    """TensorBoard scalar logger with resume via event-file replay."""

    SAVE_KEYS = ("save/epoch", "save/env_step", "save/gradient_step")

    def __init__(
        self,
        log_dir: str,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
    ) -> None:
        super().__init__(train_interval, test_interval, update_interval)
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorboardLogger requires `tensorboardX`; install it or use "
                "logger_backend='none'"
            ) from e

        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.writer = SummaryWriter(
            log_dir, filename_suffix=f".{os.getpid()}.port{next(_WRITER_SEQ)}"
        )

    def write(self, step_type: str, step: int, data: Dict[str, float]) -> None:
        for k, v in data.items():
            if isinstance(v, Number) or getattr(v, "ndim", None) == 0:
                self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()

    def save_data(
        self,
        epoch: int,
        env_step: int,
        gradient_step: int,
        checkpoint_fn: Optional[Callable[[int, int, int], str]] = None,
    ) -> None:
        if checkpoint_fn is not None:
            checkpoint_fn(epoch, env_step, gradient_step)
        self.write("save/epoch", epoch, {"save/epoch": epoch})
        self.write("save/env_step", env_step, {"save/env_step": env_step})
        self.write(
            "save/gradient_step", gradient_step, {"save/gradient_step": gradient_step}
        )

    def restore_data(self) -> Tuple[int, int, int]:
        """Replay event files to recover save/{epoch,env_step,gradient_step}."""
        try:
            from tensorboard.backend.event_processing import event_accumulator
        except ImportError as e:
            raise ImportError(
                "TensorboardLogger.restore_data reads the event files with "
                "`tensorboard`; install it or use logger_backend='none'"
            ) from e

        ea = event_accumulator.EventAccumulator(self.log_dir)
        ea.Reload()
        out = []
        for key in self.SAVE_KEYS:
            try:
                out.append(int(ea.Scalars(key)[-1].step))
            except KeyError:
                out.append(0)
        epoch, env_step, gradient_step = out
        self.last_log_train_step = env_step
        self.last_log_update_step = gradient_step
        return epoch, env_step, gradient_step

    def close(self) -> None:
        self.writer.close()


class WandbLogger(BaseLogger):
    """Weights & Biases logger (requires ``wandb``; raises a clear error if absent)."""

    def __init__(
        self,
        project: str,
        name: Optional[str] = None,
        config: Optional[dict] = None,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
    ) -> None:
        super().__init__(train_interval, test_interval, update_interval)
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandbLogger requires `wandb`; install it or use "
                "logger_backend='tensorboard'"
            ) from e
        self.wandb = wandb
        self.run = wandb.init(project=project, name=name, config=config, resume="allow")

    def write(self, step_type: str, step: int, data: Dict[str, float]) -> None:
        # Record the gating step as a field instead of wandb's monotonic
        # ``step=`` axis: train logs are gated on env_step while update logs
        # are gated on gradient_step, and interleaving those on one axis makes
        # wandb drop out-of-order rows.
        self.wandb.log({**data, step_type: step})

    def save_data(
        self,
        epoch: int,
        env_step: int,
        gradient_step: int,
        checkpoint_fn: Optional[Callable[[int, int, int], str]] = None,
    ) -> None:
        if checkpoint_fn is not None:
            path = checkpoint_fn(epoch, env_step, gradient_step)
            artifact = self.wandb.Artifact("run_checkpoint", type="model")
            if path and os.path.exists(path):
                artifact.add_dir(path) if os.path.isdir(path) else artifact.add_file(path)
            self.run.log_artifact(artifact)
        self.wandb.log(
            {
                "save/epoch": epoch,
                "save/env_step": env_step,
                "save/gradient_step": gradient_step,
            },
            step=env_step,
        )

    def close(self) -> None:
        self.run.finish()


def make_logger(
    backend: str,
    log_dir: str,
    project: str = "scalerl_torch",
    name: Optional[str] = None,
    config: Optional[dict] = None,
    **intervals: int,
) -> BaseLogger:
    if backend == "tensorboard":
        return TensorboardLogger(log_dir, **intervals)
    if backend == "wandb":
        return WandbLogger(project=project, name=name, config=config, **intervals)
    if backend in ("none", "lazy"):
        return LazyLogger()
    raise ValueError(
        f"unknown logger backend {backend!r}; expected "
        "'tensorboard' | 'wandb' | 'none'"
    )
