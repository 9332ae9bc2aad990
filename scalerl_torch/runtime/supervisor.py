"""Runtime supervision: stall watchdog, preemption guard, checkpoint cadence,
divergence tripwire, and the liveness and backoff primitives.

The port's own copy of the parts of ``scalerl_tpu/runtime/supervisor.py``
that the trainers use (jax-free there too):

- ``StallWatchdog``: a monitor thread over named progress sources (counters
  the loops bump, or getters).  When none advances for ``deadline_s`` it
  writes a report of the sources, the registered probes (queue depths) and
  a ``faulthandler`` dump of every thread's stack, then calls a recovery
  callback or interrupts the main thread, so a hung run fails with a
  diagnosis.
- ``PreemptionGuard``: SIGTERM/SIGINT become a flag the training loop reads
  at its next safe point (a learn step's or a chunk's boundary), where it
  writes its resume checkpoint and exits cleanly; a second signal falls
  through to the previous handler.
- ``CheckpointCadence``: a save is due every ``save_frequency`` frames or
  every ``checkpoint_interval_s`` seconds, whichever comes first.
- ``DivergenceTripwire``: after ``k`` consecutive skipped learn steps it
  calls the trainer's rollback to the last good checkpoint.
- ``exp_backoff`` / ``LivenessTracker``: capped exponential delays and a
  last-seen table.
- The heartbeat and drain vocabulary of the wire (``make_ping``,
  ``make_pong``, ``is_heartbeat``, ``make_drain``, ``is_drain``): the hub
  answers pings in its receive pump and feeds each pong's stamps to the
  tracer's clock-skew estimator (``runtime/tracing.py::observe_pong``).

``PreemptionGuard.poll_chaos`` is the chaos ``preempt`` hook
(``runtime/chaos.py``): a seeded draw at a safe point that delivers a real
SIGTERM.  A stall, a caught signal and a divergence trip each record a
flight-recorder event and dump the recorder's tail as JSON
(``telemetry.flight_dump_path``), and the stall report carries that tail
as text.
"""

from __future__ import annotations

import faulthandler
import os
import random as _random
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from scalerl_torch.runtime import telemetry
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Heartbeat frame kinds of the wire: transport-level filters and protocol
# handlers agree on one vocabulary.
PING = "ping"
PONG = "pong"

# Drain control frames: the server tells a peer to stop starting work,
# return what it has not started, flush what it holds and close cleanly
# (the deliberate scale-down path; kill-and-respawn is the crash path).
DRAIN = "drain"
DRAIN_DONE = "drain_done"


def make_ping() -> Dict[str, Any]:
    return {"kind": PING, "t": time.time()}


def make_pong(ping_msg: Dict[str, Any]) -> Dict[str, Any]:
    """Echo the ping's send time and add the responder's wall clock and
    host id: the pinger gets ``(t_send, t_peer, t_recv)`` a heartbeat, the
    sample ``tracing.ClockSkewEstimator`` needs."""
    return {
        "kind": PONG,
        "t": ping_msg.get("t", 0.0),
        "rt": time.time(),
        "host": telemetry.host_id(),
    }


def is_heartbeat(msg: Any) -> bool:
    return isinstance(msg, dict) and msg.get("kind") in (PING, PONG)


def make_drain() -> Dict[str, Any]:
    return {"kind": DRAIN, "t": time.time()}


def is_drain(msg: Any) -> bool:
    return isinstance(msg, dict) and msg.get("kind") == DRAIN


def exp_backoff(
    attempt: int,
    base: float = 0.5,
    cap: float = 10.0,
    jitter: bool = False,
    rng: Optional[Any] = None,
) -> float:
    """Capped exponential delay for reconnect attempt ``attempt`` (0-based).

    Default is deterministic (no jitter): fleet tests assert the schedule,
    and the handful of gathers per host cannot thundering-herd a learner.

    ``jitter=True`` opts into DECORRELATED jitter for paths where many
    peers share one failure clock — a dead serving replica puts every
    router probe and every fallen-back client on the same schedule, and
    synchronized redials arrive as a reconnect storm.  The draw is uniform
    in ``[base, min(cap, 3 * prev)]`` where ``prev`` is the deterministic
    delay of the previous attempt (the stateless rendering of the classic
    decorrelated-jitter recurrence ``sleep = rand(base, 3 * sleep_prev)``),
    so delays stay capped and attempt-ordered in expectation while peers
    spread out.  ``rng`` (anything with ``.uniform``) pins the stream for
    deterministic tests; default is the process-global ``random``.
    """
    if base <= 0:
        return 0.0
    if not jitter:
        return min(cap, base * (2.0 ** max(attempt, 0)))
    prev = min(cap, base * (2.0 ** max(attempt - 1, 0)))
    hi = max(min(cap, 3.0 * prev), base)
    return (rng if rng is not None else _random).uniform(base, hi)


class LivenessTracker:
    """Thread-safe last-seen table: ``beat(key)`` on any traffic,
    ``stale(timeout)`` lists keys silent for longer than ``timeout``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: Dict[Hashable, float] = {}

    def beat(self, key: Hashable) -> None:
        with self._lock:
            self._seen[key] = time.monotonic()

    def forget(self, key: Hashable) -> None:
        with self._lock:
            self._seen.pop(key, None)

    def last_seen(self, key: Hashable) -> Optional[float]:
        with self._lock:
            return self._seen.get(key)

    def stale(self, timeout: float) -> List[Hashable]:
        now = time.monotonic()
        with self._lock:
            return [k for k, t in self._seen.items() if now - t > timeout]


# ---------------------------------------------------------------------------
# stall watchdog


class StallError(RuntimeError):
    """No registered progress source advanced within the deadline."""


class ProgressCounter:
    """Monotonic counter a hot loop bumps; reads are lock-free snapshots.

    A torn read costs at most one extra watchdog poll — never a false
    stall — so ``bump`` stays cheap enough for per-chunk call sites.
    """

    __slots__ = ("name", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0

    def bump(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class StallWatchdog:
    """Monitor thread that dumps all-thread stacks when progress stops.

    Progress sources are ``counter(name)`` objects the supervised loops bump
    and/or ``watch(name, fn)`` getters (e.g. ``lambda: trainer.env_frames``).
    Any source changing value between polls counts as progress.  After
    ``deadline_s`` with no change the watchdog fires ONCE per stall:

    1. writes a report — source values, probe outputs (queue depths, ring
       occupancy), and a ``faulthandler`` dump of every thread — to
       ``dump_path`` (default: a temp file) and the module logger;
    2. records it as ``self.stalled`` (``check()`` re-raises it in the
       supervised loop);
    3. invokes ``on_stall(StallError)`` when given — the recovery hook that
       can feed an elastic-restart budget — otherwise interrupts the main
       thread so a wedged-but-interruptible loop dies fast with a diagnosis.

    A loop blocked in an uninterruptible C call (a wedged device dispatch)
    cannot be unwound from Python; the dump still lands, which is the point:
    the run fails *diagnosed*.  If sources advance again after a fire the
    watchdog re-arms.
    """

    def __init__(
        self,
        deadline_s: float,
        poll_s: Optional[float] = None,
        on_stall: Optional[Callable[[StallError], None]] = None,
        dump_path: Optional[str] = None,
        interrupt_main: bool = True,
        name: str = "watchdog",
    ) -> None:
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = poll_s if poll_s is not None else max(
            min(deadline_s / 4.0, 1.0), 0.01
        )
        self.on_stall = on_stall
        self.dump_path = dump_path
        self.flight_dump_path: Optional[str] = None  # set when the watchdog fires
        self.interrupt_main = interrupt_main
        self.name = name
        self.stalled: Optional[StallError] = None
        self.fire_count = 0
        self._counters: List[ProgressCounter] = []
        self._watches: List[Tuple[str, Callable[[], Any]]] = []
        self._probes: List[Tuple[str, Callable[[], Any]]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration --------------------------------------------------
    def counter(self, name: str) -> ProgressCounter:
        c = ProgressCounter(name)
        with self._lock:
            self._counters.append(c)
        return c

    def watch(self, name: str, fn: Callable[[], Any]) -> None:
        """Register an external progress getter (read every poll)."""
        with self._lock:
            self._watches.append((name, fn))

    def add_probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Extra state for the stall report only (never drives liveness):
        queue depths, ring occupancy, in-flight task counts."""
        with self._lock:
            self._probes.append((name, fn))

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        # telemetry plane: the watchdog's verdict state is part of the
        # merged snapshot (supervisor.<name>.fire_count/stalled)
        telemetry.get_registry().bind(
            f"supervisor.{self.name}",
            lambda: {
                "fire_count": self.fire_count,
                "stalled": int(self.stalled is not None),
                "deadline_s": self.deadline_s,
            },
        )
        self._thread = threading.Thread(
            target=self._monitor, name=f"stall-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def check(self) -> None:
        """Raise the recorded ``StallError`` (call from the supervised loop)."""
        if self.stalled is not None:
            raise self.stalled

    # -- internals -----------------------------------------------------
    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = list(self._counters)
            watches = list(self._watches)
        snap: Dict[str, Any] = {c.name: c.value for c in counters}
        for name, fn in watches:
            try:
                snap[name] = fn()
            except Exception as e:  # noqa: BLE001 — a dying getter is itself a stall symptom
                snap[name] = f"<error: {e!r}>"
        return snap

    def _monitor(self) -> None:
        last = self._snapshot()
        last_progress = time.monotonic()
        fired = False
        while not self._stop.wait(self.poll_s):
            snap = self._snapshot()
            if snap != last or not snap:
                last = snap
                last_progress = time.monotonic()
                fired = False  # progress resumed: re-arm
                continue
            stalled_for = time.monotonic() - last_progress
            if stalled_for >= self.deadline_s and not fired:
                fired = True
                self._fire(snap, stalled_for)

    def _fire(self, snap: Dict[str, Any], stalled_for: float) -> None:
        self.fire_count += 1
        telemetry.record_event("watchdog_stall", watchdog=self.name,
                               stalled_for_s=round(stalled_for, 1))
        report = self._build_report(snap, stalled_for)
        # the flight recorder's tail also lands as JSON beside the stack dump
        self.flight_dump_path = telemetry.get_recorder().dump_json(
            telemetry.flight_dump_path(f"stall_{self.name}"))
        logger.error("%s", report)
        err = StallError(report)
        self.stalled = err
        if self.on_stall is not None:
            try:
                self.on_stall(err)
            except Exception:  # noqa: BLE001 — recovery must not kill the monitor
                logger.exception("watchdog %s: on_stall callback failed", self.name)
        elif self.interrupt_main:
            import _thread

            _thread.interrupt_main()

    def _build_report(self, snap: Dict[str, Any], stalled_for: float) -> str:
        with self._lock:
            probes = list(self._probes)
        lines = [
            f"=== StallWatchdog[{self.name}]: no progress for "
            f"{stalled_for:.1f}s (deadline {self.deadline_s:.1f}s) ===",
            f"progress sources (frozen): {snap}",
        ]
        for name, fn in probes:
            try:
                value = fn()
                lines.append(f"probe {name}: {value}")
                telemetry.record_event("watchdog_probe", watchdog=self.name, probe=name,
                                       value=str(value))
            except Exception as e:  # noqa: BLE001 — report what we can
                lines.append(f"probe {name}: <error: {e!r}>")
        lines.append("--- flight recorder (recent events) ---")
        lines.append(telemetry.get_recorder().dump_text())
        lines.append("--- all-thread stacks (faulthandler) ---")
        lines.append(self._dump_stacks())
        return "\n".join(lines)

    def _dump_stacks(self) -> str:
        """faulthandler writes to a real fd; round-trip through a file so the
        stacks also land in the report string (and thus the logger/callback)."""
        path = self.dump_path
        try:
            if path is None:
                fd, path = tempfile.mkstemp(prefix="scalerl_stall_", suffix=".txt")
                os.close(fd)
                self.dump_path = path
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            with open(path, "r") as f:
                return f.read()
        except Exception as e:  # noqa: BLE001 — a dump failure must not mask the stall
            return f"<faulthandler dump failed: {e!r}>"


# ---------------------------------------------------------------------------
# preemption-safe checkpointing


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a "save at the next safe point" flag.

    Training loops poll ``triggered`` at slot/chunk boundaries and run the
    existing ``save_resume`` path before exiting cleanly — a preemption
    (SIGTERM from the scheduler) or Ctrl-C becomes a resumable checkpoint,
    not a lost run.  The SECOND occurrence of a signal falls through to the
    previously-installed handler (default: kill), so a wedged loop can still
    be force-quit.

    Signal handlers only install from the main thread; elsewhere
    ``install()`` is a no-op and ``triggered`` stays False (trainer loops
    embedded in worker threads keep their old behavior).  Use as a context
    manager so handlers are restored on exit.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)) -> None:
        self.signals = signals
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False
        self.received: Optional[int] = None
        self.flight_dump_path: Optional[str] = None  # set on the first signal

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame) -> None:
        if self._event.is_set():
            # second signal: the user/scheduler means it — fall through
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            if prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        self.received = signum
        self._event.set()
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        telemetry.get_registry().counter("supervisor.preemption_signals").inc()
        # the preemption is itself an event, and the tail of what led up to
        # it lands as JSON at once: the save at the next safe point may never
        # run if the loop is wedged
        telemetry.record_event("preemption_signal", signal=name)
        self.flight_dump_path = telemetry.get_recorder().dump_json(
            telemetry.flight_dump_path(f"signal_{name.lower()}"))
        # signal-safe enough: one write, no allocation-heavy formatting
        sys.stderr.write(
            f"[scalerl] caught {name}: checkpointing at next safe point "
            f"(repeat to force-quit; flight recorder -> {self.flight_dump_path})\n"
        )

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self  # signal API is main-thread-only; stay inert
        if self._installed:
            return self
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # non-main interpreter oddities
                self._prev.pop(s, None)
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def simulate(self, signum: int = signal.SIGTERM) -> None:
        """Trip the guard as if ``signum`` arrived: the chaos ``preempt``
        hook and the threads that cannot own signal handlers use this, so
        every consumer sees one shape of preemption, the flag."""
        self._handler(signum, None)

    def poll_chaos(self, site: str) -> bool:
        """One seeded ``preempt`` draw at a safe point.  When the stream
        fires, the preemption arrives as a REAL ``SIGTERM`` to this process
        when the handler is installed (the seeded fault walks the genuine
        signal path), else through :meth:`simulate`.  Returns ``triggered``
        either way: ``if guard.poll_chaos("learner"): save_and_exit()``."""
        if not self._event.is_set():
            from scalerl_torch.runtime import chaos

            inj = chaos.active()
            if inj is not None and inj.preempt_victim(1, site=site) is not None:
                if self._installed:
                    signal.raise_signal(signal.SIGTERM)
                else:
                    self.simulate()
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()


class DivergenceTripwire:
    """Host-side divergence breaker over the guarded train step's metrics.

    The all-finite guard (``parallel/train_step.py``) already skips
    individual non-finite updates; this tripwire watches the
    ``skipped_steps`` counter it emits and, after ``k`` CONSECUTIVE bad
    steps (a diverged run, not a single poisoned batch), invokes the
    rollback callback — typically "restore agent state from the last good
    checkpoint" (``OffPolicyTrainer._divergence_rollback``).  It
    consumes the already-materialized host metrics dict, adding zero device
    traffic.
    """

    def __init__(self, k: int, on_trip: Optional[Callable[[], None]]) -> None:
        self.k = int(k)
        self.on_trip = on_trip
        self.consecutive = 0
        self.trips = 0

    @property
    def enabled(self) -> bool:
        return self.k > 0 and self.on_trip is not None

    def observe(self, metrics: Optional[Dict[str, Any]]) -> bool:
        """Feed one step's host metrics; True when the rollback fired."""
        bad = 0.0
        if metrics:
            try:
                bad = float(metrics.get("skipped_steps", 0.0) or 0.0)
            except (TypeError, ValueError):
                bad = 0.0
        if bad > 0.0:
            self.consecutive += 1
        else:
            self.consecutive = 0
        if self.enabled and self.consecutive >= self.k:
            self.consecutive = 0
            self.trips += 1
            telemetry.get_registry().counter("supervisor.divergence_trips").inc()
            telemetry.record_event("divergence_trip", trips=self.trips, k=self.k)
            # the events leading into a divergence, beside the rollback
            telemetry.get_recorder().dump_json(telemetry.flight_dump_path("divergence"))
            self.on_trip()
            return True
        return False


class CheckpointCadence:
    """When is a resume save due?  Frame interval OR wall-clock interval.

    One implementation for every trainer loop: ``save_frequency`` (frames)
    is the reference-parity gate; ``checkpoint_interval_s`` (seconds) is the
    preemption-era gate that bounds lost work on slow-frame runs.  Either
    firing makes the save due; ``mark_saved`` resets both.  ``interval_s``
    (or ``frames``) <= 0 disables that gate.
    """

    def __init__(self, frames: int, interval_s: float, start_frames: int = 0) -> None:
        self.frames = int(frames)
        self.interval_s = float(interval_s)
        self._last_frames = int(start_frames)
        self._last_t = time.monotonic()

    def due(self, current_frames: int) -> bool:
        if self.frames > 0 and current_frames - self._last_frames >= self.frames:
            return True
        if self.interval_s > 0 and time.monotonic() - self._last_t >= self.interval_s:
            return True
        return False

    def mark_saved(self, current_frames: int) -> None:
        self._last_frames = int(current_frames)
        self._last_t = time.monotonic()
