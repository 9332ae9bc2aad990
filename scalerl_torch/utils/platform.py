"""Device resolution for the port's entry points, and the start method for
worker processes."""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device]

# intra-op threads of a spawned actor process: one each, so that actors x
# threads stay within the host's cores (8 actors on the card's 8-core host)
ACTOR_TORCH_THREADS = 1


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card.

    The entry points default to ``"cuda"``; on a machine without a card that
    default raises here instead of quietly running on the host.  A caller
    that wants the host asks for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    return dev


def safe_mp_context(requested: Optional[str] = None) -> Optional[str]:
    """A ``multiprocessing`` start-method name (port of
    ``scalerl_tpu/utils/platform.py::safe_mp_context``).

    An explicit ``requested`` wins.  Otherwise ``"spawn"`` when CUDA is
    initialized in this process (a forked child must not inherit a CUDA
    context), else ``None``: the platform default, fork on Linux, the
    cheapest when no runtime is at risk.  Call sites keep worker targets
    and their arguments picklable, so the spawn path works when it
    triggers."""
    if requested is not None:
        return requested
    return "spawn" if torch.cuda.is_initialized() else None


def process_report() -> Dict[str, Any]:
    """What this process loaded: whether CUDA is initialized in it and its
    top-level modules (spawned actors send it to their learner)."""
    return {
        "cuda_initialized": torch.cuda.is_initialized(),
        "modules": sorted({m.split(".")[0] for m in list(sys.modules)}),
    }
