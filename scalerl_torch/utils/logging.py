"""Process-rank-aware colored logging.

Port of ``scalerl_tpu/utils/logging.py``: colored stream output, a file
handler on process 0 only, and every other process raised to ERROR so a
multi-process run logs once.  The process index is the port's own:
``SCALERL_PROCESS_INDEX`` when set, else the ``torch.distributed`` rank of
an initialized process group, else 0.  Reading it never initializes CUDA
nor a process group.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

_initialized_loggers: Dict[str, logging.Logger] = {}

_COLORS = {
    logging.DEBUG: "\x1b[36m",  # cyan
    logging.INFO: "\x1b[32m",  # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True) -> None:
        super().__init__("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


def process_index() -> int:
    """This process's index in a multi-process run (0 when alone)."""
    env = os.environ.get("SCALERL_PROCESS_INDEX")
    if env is not None:
        return int(env)
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def get_logger(
    name: str = "scalerl_torch",
    log_file: Optional[str] = None,
    log_level: int = logging.INFO,
) -> logging.Logger:
    """A logger writing colored stream output; file output on process 0
    only; every other process at ERROR."""
    logger = logging.getLogger(name)
    if name in _initialized_loggers:
        return logger
    logger.propagate = False

    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(_ColorFormatter(use_color=sys.stderr.isatty()))
    handlers: list[logging.Handler] = [stream]

    rank = process_index()
    if rank == 0 and log_file is not None:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(_ColorFormatter(use_color=False))
        handlers.append(fh)

    level = log_level if rank == 0 else logging.ERROR
    for h in handlers:
        h.setLevel(level)
        logger.addHandler(h)
    logger.setLevel(level)
    _initialized_loggers[name] = logger
    return logger
