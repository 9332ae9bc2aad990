"""Host-side interval timers.

The port's own copy of ``scalerl_tpu/utils/timers.py``: ``Timings``, a
per-event online mean/variance profiler (Welford), and ``Timer``, a
stopwatch with a check interval.  They time the host runtime (env
stepping, queue waits, batch assembly); ``utils/profiling.py`` traces the
device.  Every clock is ``time.monotonic()``: a wall-clock jump would feed
a negative or hours-long sample into the accumulators.
"""

from __future__ import annotations

import collections
import time
from typing import Dict


class Timings:
    """Per-event online mean/variance timers (Welford update).

    Usage::

        t = Timings()
        ... step env ...
        t.time("step")
        ... write buffer ...
        t.time("write")
    """

    def __init__(self) -> None:
        # plain dicts: reads must never insert keys (the old defaultdicts
        # grew phantom zero-entries on every speculative lookup)
        self._means: Dict[str, float] = {}
        self._vars: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.reset()

    def reset(self) -> None:
        self.last_time = time.monotonic()

    def time(self, name: str) -> None:
        """Record the elapsed time since the last ``time``/``reset`` call."""
        now = time.monotonic()
        x = now - self.last_time
        self.last_time = now
        n = self._counts.get(name, 0) + 1
        mean = self._means.get(name, 0.0)
        delta = x - mean
        mean += delta / n
        delta2 = x - mean
        self._means[name] = mean
        self._vars[name] = self._vars.get(name, 0.0) + delta * delta2
        self._counts[name] = n

    def means(self) -> Dict[str, float]:
        return dict(self._means)

    def stds(self) -> Dict[str, float]:
        """Per-event std-devs; lookups of never-recorded keys return 0.0
        (a defaultdict view) instead of raising — summary consumers probe
        speculative keys like ``dequeue`` that only some topologies emit."""
        return collections.defaultdict(
            float,
            {
                k: (self._vars.get(k, 0.0) / max(self._counts.get(k, 1), 1)) ** 0.5
                for k in self._counts
            },
        )

    def summary(self, prefix: str = "") -> str:
        means = self.means()
        stds = self.stds()
        total = sum(means.values()) or 1.0
        rows = [
            f"  {k}: {1000.0 * means[k]:.2f}ms +- {1000.0 * stds[k]:.2f}ms "
            f"({100.0 * means[k] / total:.1f}%)"
            for k in sorted(means, key=means.get, reverse=True)  # type: ignore[arg-type]
        ]
        return f"{prefix}total: {1000.0 * total:.2f}ms\n" + "\n".join(rows)


class Timer:
    """Context-manager stopwatch with a running check interval."""

    def __init__(self) -> None:
        self._start = time.monotonic()
        self._last_check = self._start
        self._running = True

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self._running = False

    def start(self) -> None:
        self._start = time.monotonic()
        self._last_check = self._start
        self._running = True

    def since_start(self) -> float:
        return time.monotonic() - self._start

    def since_last_check(self) -> float:
        now = time.monotonic()
        dur = now - self._last_check
        self._last_check = now
        return dur

    def check_time(self, interval: float) -> bool:
        """True (and reset the check clock) if ``interval`` seconds elapsed."""
        now = time.monotonic()
        if now - self._last_check >= interval:
            self._last_check = now
            return True
        return False
