"""Trainer base: the arguments, the text log and the record of what was logged.

Port of the parts of ``scalerl_tpu/trainer/base.py`` that the off-policy
trainer needs.  It writes no files: the run directory, the TensorBoard and
W&B loggers, resume checkpoints and the telemetry export are not ported
yet (their arguments are absent from ``scalerl_torch.config``, or refused
by its ``validate``).  What the JAX trainer sends to its logger goes to the
``scalerl_torch`` Python logger and into :attr:`BaseTrainer.log_history`.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from scalerl_torch.config import RLArguments


class BaseTrainer:
    def __init__(self, args: RLArguments) -> None:
        args.validate()
        self.args = args
        self.text_logger = logging.getLogger("scalerl_torch")
        # (env step, "train" | "eval", host metrics), in the order logged
        self.log_history: List[Tuple[int, str, Dict[str, float]]] = []

    def log(self, step: int, kind: str, metrics: Dict[str, float]) -> None:
        self.log_history.append((step, kind, dict(metrics)))

    def close(self) -> None:
        """Nothing to release yet (no logger backends or export loops)."""
