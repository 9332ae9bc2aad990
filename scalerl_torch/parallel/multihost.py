"""Multi-node bring-up: join the default process group.  Port of
``scalerl_tpu/parallel/multihost.py``.

Where the JAX package calls ``jax.distributed.initialize`` against a
coordinator, a PyTorch rank joins ``torch.distributed``'s default process
group, from explicit arguments or from the launcher's environment:
torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` (the JAX function reads ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``).  Every later mesh
(``parallel/mesh.py::make_mesh``) spans the ranks of that group.  A plain
single-host run with no arguments and no such environment is a no-op, so a
trainer can call this unconditionally.

The backend is nccl with ``device="cuda"`` (the default; the rank's card is
``local_device_ids[0]``, else ``LOCAL_RANK``, else 0) and gloo with
``device="cpu"``, the twin of the JAX function's CPU gloo collectives.  A
bad rendezvous raises; nothing falls back quietly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from scalerl_torch.utils.logging import get_logger
from scalerl_torch.utils.platform import DeviceLike, resolve_device

logger = get_logger(__name__)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None,
                         device: DeviceLike = "cuda") -> bool:
    """Join the default process group; returns True when it ran.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (every
    rank passes the same), ``num_processes`` the world size and
    ``process_id`` this rank.  Arguments left None come from the torchrun
    environment; with neither, returns False and does nothing."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    device = resolve_device(device)
    missing = [name for name, v in (("coordinator_address", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"multihost rendezvous needs {missing} (or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE and RANK in the environment)")
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialized")
    kw = {}
    if device.type == "cuda":
        local = (local_device_ids[0] if local_device_ids else _env_int("LOCAL_RANK")) or 0
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), **kw)
    logger.info("multihost: process %d/%d on %s (%s)", dist.get_rank(),
                dist.get_world_size(), device, dist.get_backend())
    return True
