"""IMPACT's circular surrogate buffer (arxiv 1912.00167, §3.1).

Port of ``scalerl_tpu/data/circular.py``: a small ring of whole trajectory
chunks between the actor plane and the learner.  Each inserted chunk
carries ``replay_times`` use credits, ``add`` overwrites the oldest slot once
the ring is full, and ``sample`` goes round-robin over the slots that still
hold credits, so a chunk takes part in up to K learner updates and the
updates mix chunks of different ages.

Chunks are held by reference: the learner's trajectories, torch tensors on
its device, stay where they are.  The bookkeeping is plain host counters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class CircularTrajectoryBuffer:
    """Ring of trajectory chunks with per-chunk replay credits.

    ``capacity``: slots (chunks) retained; ``replay_times``: the credits a
    chunk is born with.  ``sample`` takes one credit from the next slot in
    cursor order, skipping spent slots; when every retained chunk is spent
    (the learner outran the actors) it returns the freshest chunk anyway and
    counts an ``overdraw``, as IMPACT's learner does not wait."""

    def __init__(self, capacity: int, replay_times: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if replay_times < 1:
            raise ValueError(f"replay_times must be >= 1, got {replay_times}")
        self.capacity = capacity
        self.replay_times = replay_times
        self._chunks: List[Any] = []
        self._credits: List[int] = []
        self._write = 0  # next slot to overwrite
        self._read = 0  # round-robin sample cursor
        self._latest: Optional[int] = None
        self.inserted = 0
        self.sampled = 0
        self.overdraws = 0

    def __len__(self) -> int:
        return len(self._chunks)

    def add(self, chunk: Any) -> None:
        """Insert a chunk with fresh credits; once the ring is full it
        overwrites the oldest slot, whose unspent credits are forfeited."""
        if len(self._chunks) < self.capacity:
            self._latest = len(self._chunks)
            self._chunks.append(chunk)
            self._credits.append(self.replay_times)
        else:
            self._latest = self._write
            self._chunks[self._write] = chunk
            self._credits[self._write] = self.replay_times
            self._write = (self._write + 1) % self.capacity
        self.inserted += 1

    def sample(self) -> Any:
        """The next chunk with credits left (round-robin), else the
        freshest chunk."""
        if not self._chunks:
            raise ValueError("sample() on an empty CircularTrajectoryBuffer")
        n = len(self._chunks)
        for _ in range(n):
            idx = self._read
            self._read = (self._read + 1) % n
            if self._credits[idx] > 0:
                self._credits[idx] -= 1
                self.sampled += 1
                return self._chunks[idx]
        self.overdraws += 1
        self.sampled += 1
        assert self._latest is not None
        return self._chunks[self._latest]

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._chunks),
            "credits": sum(self._credits),
            "inserted": self.inserted,
            "sampled": self.sampled,
            "overdraws": self.overdraws,
        }
