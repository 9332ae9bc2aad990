"""Spawned producers of the port's shared-memory ring tests
(``tests/test_torch_shm_ring.py``).  This module imports neither JAX nor the
JAX package, so a spawned child that unpickles one of these targets starts
in a second or two."""

import numpy as np

from scalerl_torch.runtime import chaos


def produce(ring, actor_id: int, episodes: int) -> None:
    for e in range(episodes):
        idx = ring.acquire(timeout=10.0)
        if idx is None:
            raise RuntimeError("acquire timed out")
        views = ring.slot(idx)
        views["obs"][:] = actor_id * 100 + e
        views["action"][:] = actor_id
        views = None  # drop the zero-copy views so detach() can close the mapping
        ring.commit(idx)
    ring.detach()


def produce_torn(ring, n: int, spec: str) -> None:
    """Producer under a seeded chaos plan (``slot_tear`` tears some commits
    after their CRC stamp)."""
    chaos.install(chaos.FaultInjector(chaos.ChaosPlan.parse(spec)))
    for i in range(n):
        idx = ring.acquire(timeout=10.0)
        if idx is None:
            raise RuntimeError("acquire timed out")
        views = ring.slot(idx)
        views["obs"][:] = float(i)
        views["action"][:] = i
        views = None
        ring.commit(idx)
    ring.detach()


def tear_schedule(spec: str, n: int, slot_bytes: int):
    """Which of ``n`` commits the plan tears (the producer's own draws)."""
    inj = chaos.FaultInjector(chaos.ChaosPlan.parse(spec))
    return [inj.tear_slot(bytearray(slot_bytes)) for _ in range(n)]


def fill_value(ring, i: int) -> None:
    views = ring.slot(i)
    for name, arr in views.items():
        arr[...] = np.arange(arr.size).reshape(arr.shape) % 7 + i
