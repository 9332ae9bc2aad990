"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


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
