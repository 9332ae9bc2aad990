"""Pipelined host reads: one batched metric copy per chunk, K chunks in flight.

Port of ``scalerl_tpu/runtime/dispatch.py``.

- :func:`get_metrics` materialises a whole metric dict with ONE device->host
  copy: the tensor leaves are flattened into a single float32 device vector
  first.
- :class:`MetricsPipeline` keeps ``depth`` chunks' metrics pending, so the
  host reads chunk ``i`` only after dispatching chunk ``i + depth - 1`` and
  never stalls the device on a fresh result; :func:`pipelined_drive` drives
  a dispatch function through one.
- :func:`steady_state_guard` is the counterpart of the JAX package's
  transfer guard: ``torch.cuda.set_sync_debug_mode("error")`` around warm
  chunks, so any operation that synchronises with the host raises at its
  line.  :func:`get_metrics`' one explicit copy relaxes it for that copy
  only.
"""

from __future__ import annotations

from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch


@contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextmanager
def steady_state_guard() -> Iterator[None]:
    """Raise on any host synchronisation inside the block (CUDA only: the
    host has nothing to synchronise with, so without a card this is a
    no-op).  Loops skip it for their first chunk, whose one-time setup
    (cuDNN's algorithm search, first allocations) may synchronise."""
    if not torch.cuda.is_available():
        yield
        return
    with _sync_debug_mode("error"):
        yield


def _device_get(flat: torch.Tensor) -> np.ndarray:
    """The one sanctioned device->host copy (tests count calls here)."""
    if flat.device.type != "cuda":
        return flat.numpy()
    with _sync_debug_mode("default"):
        return flat.cpu().numpy()


def get_metrics(metrics: Mapping[str, Any]) -> Dict[str, Any]:
    """A flat metric dict -> host values with ONE device->host copy.

    0-dim (or one-element) tensors come back as Python floats, larger ones
    as float32 numpy arrays; host numbers pass through as floats.
    """
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out: Dict[str, Any] = {
        k: float(v) for k, v in metrics.items() if not isinstance(v, torch.Tensor)
    }
    if keys:
        tensors = [metrics[k].detach() for k in keys]
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        host = _device_get(flat)
        offset = 0
        for k, t in zip(keys, tensors):
            n = t.numel()
            chunk = host[offset:offset + n]
            out[k] = float(chunk[0]) if n == 1 else chunk.reshape(t.shape).copy()
            offset += n
    return {k: out[k] for k in metrics}


class MetricsPipeline:
    """Bounded deque of in-flight metric payloads (one per dispatched chunk).

    :meth:`push` enqueues a chunk's device metrics and materialises (one
    batched copy each) only once ``depth`` payloads are pending; ``depth=1``
    reads back synchronously.  :attr:`transfers` counts batched copies.
    """

    def __init__(self, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.transfers = 0
        self._pending: Deque[Tuple[Any, Any]] = deque()

    def _materialize(self, item: Tuple[Any, Any]) -> Tuple[Any, Any]:
        tag, payload = item
        self.transfers += 1
        return tag, get_metrics(payload)

    def push(self, tag: Any, payload: Any) -> List[Tuple[Any, Any]]:
        """Enqueue a chunk's device metrics; return newly ready host ones
        (oldest first), empty while the pipeline is still filling."""
        self._pending.append((tag, payload))
        ready: List[Tuple[Any, Any]] = []
        while len(self._pending) >= self.depth:
            ready.append(self._materialize(self._pending.popleft()))
        return ready

    def drain(self) -> List[Tuple[Any, Any]]:
        """Materialise every pending payload (oldest first) and empty the
        pipeline: the end-of-run synchronisation point."""
        ready = [self._materialize(item) for item in self._pending]
        self._pending.clear()
        return ready


def pipelined_drive(
    dispatch: Callable[[int], Any],
    num_calls: int,
    on_ready: Optional[Callable[[int, Any], None]] = None,
    depth: int = 2,
    stop: Optional[Callable[[], bool]] = None,
) -> int:
    """Drive ``dispatch(i) -> device metrics`` for up to ``num_calls``
    chunks with ``depth`` in flight; ``on_ready(i, host_metrics)`` fires in
    chunk order, ``depth - 1`` chunks behind the dispatch.  ``stop()`` is
    polled after each materialisation batch: once it is True no further
    chunk is dispatched, and the chunks in flight are still drained.
    Returns the number of chunks dispatched."""
    pipe = MetricsPipeline(depth=depth)

    def consume(ready) -> bool:
        for tag, host in ready:
            if on_ready is not None:
                on_ready(tag, host)
        return bool(stop is not None and stop())

    dispatched = 0
    for i in range(num_calls):
        payload = dispatch(i)
        dispatched += 1
        if consume(pipe.push(i, payload)):
            break
    consume(pipe.drain())
    return dispatched
