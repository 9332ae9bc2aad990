"""Parameter-dict helpers (port of ``scalerl_tpu/utils/tree.py``)."""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def soft_target_update(online: Params, target: Params, tau: float) -> Params:
    """Polyak update: target <- tau * online + (1 - tau) * target."""
    return {k: tau * online[k] + (1.0 - tau) * t for k, t in target.items()}
