"""Device and host tracing over ``torch.profiler``.

Port of ``scalerl_tpu/utils/profiling.py``, whose ``trace`` wraps
``jax.profiler.trace``.  Here :func:`trace` records the host and, with a
card, the device under ``torch.profiler`` and writes one Chrome trace
(``trace_<pid>_<n>.json``, readable by Perfetto or ``chrome://tracing``)
into ``log_dir``; :func:`annotate` names a host region (a
``record_function`` range, and an NVTX range on a card) so queue waits and
env steps line up against the device streams; :func:`step_marker` marks
one train step.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

import torch

_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a host (and, with a card, device) profile into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a host region in the captured trace::

        with annotate("drain_rollout_queue"):
            batch, idxs = queue.get_batch(...)
    """
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_marker(step: int):
    """Mark one train step (one fused chunk) in the trace."""
    return annotate(f"train_step#{step}")


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``trace`` when a directory is given, nothing otherwise: trainers take
    a ``profile_dir`` argument unconditionally."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
