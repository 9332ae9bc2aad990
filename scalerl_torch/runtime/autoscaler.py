"""Telemetry-driven fleet autoscaler: the control loop over the elastic fleet.

Port of ``scalerl_tpu/runtime/autoscaler.py`` (jax-free there too).
IMPALA (arxiv 1802.01561) and the Podracer report (arxiv 2104.06272) frame
actor-learner throughput as a balance of three signals: actor production
vs learner consumption vs queue occupancy.  The telemetry plane exposes
them and the bounded-admission sheds; this module reads them and issues
scale-up, scale-down and drain actions through a pluggable executor.

- **Decisions are a pure table** over :class:`FleetSignals`
  (``Autoscaler.evaluate``: testable with synthetic vectors, no fleet).
- **Hysteresis**: a pressure verdict must persist for ``up_hysteresis`` /
  ``down_hysteresis`` consecutive evaluations before it becomes an action.
- **Cooldown**: after any action the engine holds for ``cooldown_s``.
- **Floor**: ``live_workers < min_workers`` (a preemption wave just landed)
  bypasses both.
- Every decision that is not a steady hold lands in the flight recorder
  (``autoscale_decision``) and the registry (``autoscaler.*``).

The loop runs on the learner's host beside the ``WorkerServer`` and never
touches the card.  The fleet's executor is ``fleet.cluster.ClusterExecutor``
and the serving tier's ``serving.router.RouterTierExecutor``; anything with
``worker_count``/``scale_up``/``scale_down`` works.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Deque, Dict, Optional

from scalerl_torch.runtime import telemetry
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# decision vocabulary
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
HOLD = "hold"


@dataclass
class FleetSignals:
    """One evaluation's input vector — the Podracer tuning triad plus the
    bounded-admission and serving-SLO pressure signals."""

    fps: float = 0.0                 # actor-plane production rate (results/s or frames/s)
    learn_steps_per_s: float = 0.0   # learner consumption rate
    queue_occupancy: float = 0.0     # 0..1 fill of the results/rollout queue
    shed_delta: float = 0.0          # bounded-admission sheds since last eval
    serving_p95_ms: float = 0.0      # inference-plane latency SLO quantile
    # generation-tier signal (disaggregated sequence RL): the unified
    # staleness gauge — learner steps behind the newest param generation in
    # the consumed data.  High staleness means the generation tier is
    # underproducing relative to the learner (replay serving old
    # generations), the scale-up pressure of the sequence-RL triad.
    snapshot_staleness: float = 0.0
    live_workers: int = 0            # capacity the executor currently runs


@dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs for the decision table and its anti-flap guards."""

    min_workers: int = 1             # hard floor: breached -> immediate backfill
    max_workers: int = 32            # hard ceiling for scale-up
    interval_s: float = 5.0          # evaluation cadence of the background loop
    scale_step: int = 1              # workers added/drained per action
    # decision-table thresholds
    low_occupancy: float = 0.2       # queue this empty = learner starved -> up
    high_occupancy: float = 0.9      # queue this full = actors flooding -> down
    # optional production target: actors should produce at least this many
    # fps per learner step/s before the starved verdict is suppressed
    # (0 disables the ratio rule; occupancy alone then drives scale-up)
    fps_per_learn_step: float = 0.0
    # optional serving-plane guard: p95 act latency above this sheds load by
    # draining workers (0 disables the rule)
    serving_p95_slo_ms: float = 0.0
    # serving-TIER capacity rule (the router's replica fleet, where
    # live_workers are replicas, not actors — opposite semantics from the
    # guard above): aggregate p95 past the up threshold means the tier is
    # out of capacity -> add a replica; p95 under the down threshold means
    # it is over-provisioned -> drain one.  0 disables either side.
    serving_scale_up_p95_ms: float = 0.0
    serving_scale_down_p95_ms: float = 0.0
    # optional generation-tier guard (disaggregated sequence RL): consumed
    # data staler than this many learner steps means the generation fleet
    # is underproducing — scale it up (0 disables the rule)
    max_staleness: float = 0.0
    # anti-flap guards
    up_hysteresis: int = 2           # consecutive starved verdicts before up
    down_hysteresis: int = 3         # consecutive flooded verdicts before down
    cooldown_s: float = 30.0         # hold window after any action

    def __post_init__(self) -> None:
        if self.min_workers < 0:
            raise ValueError(f"min_workers must be >= 0, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})"
            )
        if self.scale_step < 1:
            raise ValueError(f"scale_step must be >= 1, got {self.scale_step}")
        if self.up_hysteresis < 1 or self.down_hysteresis < 1:
            raise ValueError("hysteresis thresholds must be >= 1")
        if (
            self.serving_scale_up_p95_ms > 0
            and self.serving_scale_down_p95_ms >= self.serving_scale_up_p95_ms
        ):
            raise ValueError(
                "serving_scale_down_p95_ms "
                f"({self.serving_scale_down_p95_ms}) must be < "
                f"serving_scale_up_p95_ms ({self.serving_scale_up_p95_ms}) "
                "or the tier flaps between the two verdicts"
            )
        if self.serving_scale_up_p95_ms > 0 and self.serving_p95_slo_ms > 0:
            raise ValueError(
                "serving_scale_up_p95_ms (serving-tier capacity: p95 adds "
                "replicas) and serving_p95_slo_ms (actor-fleet guard: p95 "
                "drains actors) are opposite semantics for one signal — "
                "configure one per autoscaler instance"
            )

    @classmethod
    def from_args(cls, args: Any) -> "AutoscalerConfig":
        """Build from the ``RLArguments.autoscale_*`` fields (config.py)."""
        cfg = cls(
            min_workers=getattr(args, "autoscale_min_workers", cls.min_workers),
            max_workers=getattr(args, "autoscale_max_workers", cls.max_workers),
            interval_s=getattr(args, "autoscale_interval_s", cls.interval_s),
            cooldown_s=getattr(args, "autoscale_cooldown_s", cls.cooldown_s),
            max_staleness=getattr(
                args, "autoscale_max_staleness", cls.max_staleness
            ),
            serving_scale_up_p95_ms=getattr(
                args, "autoscale_serving_up_p95_ms", cls.serving_scale_up_p95_ms
            ),
            serving_scale_down_p95_ms=getattr(
                args,
                "autoscale_serving_down_p95_ms",
                cls.serving_scale_down_p95_ms,
            ),
        )
        hyst = int(getattr(args, "autoscale_hysteresis", cfg.up_hysteresis))
        # down is deliberately one verdict slower than up: adding capacity
        # during a starve is cheap to undo, draining during a flood is not
        return replace(cfg, up_hysteresis=hyst, down_hysteresis=hyst + 1)


@dataclass
class Decision:
    """One evaluation's verdict: what to do, how much, and why."""

    action: str                      # scale_up | scale_down | hold
    delta: int                       # workers to add/drain (0 for hold)
    reason: str
    signals: FleetSignals
    t: float = 0.0


class Autoscaler:
    """The decision engine plus an optional background control loop.

    ``executor`` (duck-typed): ``worker_count() -> int``,
    ``scale_up(n: int)``, ``scale_down(n: int)``.  ``signal_source`` is a
    zero-arg callable returning :class:`FleetSignals`
    (:func:`fleet_signal_source` builds one over a ``WorkerServer``).
    Both are optional so the table can be unit-tested bare.
    """

    def __init__(
        self,
        config: AutoscalerConfig,
        executor: Any = None,
        signal_source: Optional[Callable[[], FleetSignals]] = None,
        name: str = "autoscaler",
    ) -> None:
        self.config = config
        self.executor = executor
        self.signal_source = signal_source
        self.name = name
        self.scale_ups = 0
        self.scale_downs = 0
        self.holds = 0
        self.decisions = 0
        self.last_decision: Optional[Decision] = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = -float("inf")
        self._action_times: Deque[float] = deque(maxlen=256)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        telemetry.get_registry().bind(
            self.name,
            lambda: {
                "decisions": self.decisions,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "holds": self.holds,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "actions_per_min": round(self.actions_per_min(), 3),
                "min_workers": self.config.min_workers,
                "max_workers": self.config.max_workers,
            },
        )

    # -- flap accounting -----------------------------------------------
    def actions_per_min(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        """Actions issued over the trailing window, per minute: the flap
        rate."""
        now = time.monotonic() if now is None else now
        recent = sum(1 for t in self._action_times if now - t <= window_s)
        return recent * 60.0 / window_s

    # -- the decision table --------------------------------------------
    def _pressure(self, s: FleetSignals) -> Optional[str]:
        """Raw directional verdict from one signal vector, pre-hysteresis."""
        cfg = self.config
        if cfg.serving_scale_up_p95_ms > 0 or cfg.serving_scale_down_p95_ms > 0:
            # serving-tier capacity semantics (the router's replica fleet):
            # latency pressure ADDS capacity — checked before the actor
            # rules because replica sheds are a scale-UP signal here
            if (
                cfg.serving_scale_up_p95_ms > 0
                and s.serving_p95_ms > cfg.serving_scale_up_p95_ms
            ):
                return SCALE_UP  # tier out of capacity: add a replica
            if s.shed_delta > 0:
                return SCALE_UP  # replicas shedding = demand over capacity
            if (
                cfg.serving_scale_down_p95_ms > 0
                and 0.0 < s.serving_p95_ms <= cfg.serving_scale_down_p95_ms
            ):
                return SCALE_DOWN  # comfortably under SLO: drain a replica
            return None
        if s.shed_delta > 0:
            return SCALE_DOWN  # bounded admission is actively dropping data
        if s.queue_occupancy >= cfg.high_occupancy:
            return SCALE_DOWN  # queue depth IS policy lag; don't add to it
        if cfg.serving_p95_slo_ms > 0 and s.serving_p95_ms > cfg.serving_p95_slo_ms:
            return SCALE_DOWN  # inference plane past its SLO
        if cfg.max_staleness > 0 and s.snapshot_staleness > cfg.max_staleness:
            # generation tier underproducing: the learner is consuming
            # sequences from old param generations — add decode capacity
            return SCALE_UP
        if s.queue_occupancy <= cfg.low_occupancy:
            target = cfg.fps_per_learn_step * s.learn_steps_per_s
            if cfg.fps_per_learn_step <= 0 or s.fps < target:
                return SCALE_UP  # learner starved: queue empty, production short
        return None

    def evaluate(self, signals: FleetSignals, now: Optional[float] = None) -> Decision:
        """One decision from one signal vector.  Pure apart from the streak/
        cooldown state this engine exists to keep — inject ``now`` in tests."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        live = int(signals.live_workers)
        self.decisions += 1

        # hard floor: a preemption wave dropped us below the operator's
        # minimum — backfill immediately, no hysteresis, no cooldown
        if live < cfg.min_workers:
            return self._act(
                SCALE_UP, cfg.min_workers - live, "below_min_workers",
                signals, now,
            )

        pressure = self._pressure(signals)
        if pressure is None:
            self._up_streak = 0
            self._down_streak = 0
            return self._hold("steady", signals, now, record=False)
        if pressure == SCALE_UP:
            self._up_streak += 1
            self._down_streak = 0
            streak, needed = self._up_streak, cfg.up_hysteresis
        else:
            self._down_streak += 1
            self._up_streak = 0
            streak, needed = self._down_streak, cfg.down_hysteresis
        if streak < needed:
            return self._hold(
                f"hysteresis:{pressure} ({streak}/{needed})", signals, now
            )
        if now - self._last_action_t < cfg.cooldown_s:
            return self._hold(f"cooldown:{pressure}", signals, now)
        serving_tier = (
            cfg.serving_scale_up_p95_ms > 0 or cfg.serving_scale_down_p95_ms > 0
        )
        if pressure == SCALE_UP:
            delta = min(cfg.scale_step, cfg.max_workers - live)
            if delta <= 0:
                return self._hold("at_max_workers", signals, now)
            why = "tier_over_capacity" if serving_tier else "learner_starved"
            return self._act(SCALE_UP, delta, why, signals, now)
        delta = min(cfg.scale_step, live - cfg.min_workers)
        if delta <= 0:
            return self._hold("at_min_workers", signals, now)
        why = "tier_over_provisioned" if serving_tier else "overload"
        return self._act(SCALE_DOWN, delta, why, signals, now)

    def _hold(self, reason: str, signals: FleetSignals, now: float,
              record: bool = True) -> Decision:
        self.holds += 1
        d = Decision(HOLD, 0, reason, signals, now)
        self.last_decision = d
        if record:
            # a suppressed pressure verdict is itself diagnostic: the flight
            # tail shows WHY the fleet did not move (steady holds are noise
            # and stay out of the bounded ring)
            telemetry.record_event(
                "autoscale_decision", action=HOLD, reason=reason,
                workers=signals.live_workers,
            )
        return d

    def _act(self, action: str, delta: int, reason: str,
             signals: FleetSignals, now: float) -> Decision:
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = now
        self._action_times.append(now)
        if action == SCALE_UP:
            self.scale_ups += 1
            telemetry.get_registry().counter("autoscaler.scale_ups").inc()
        else:
            self.scale_downs += 1
            telemetry.get_registry().counter("autoscaler.scale_downs").inc()
        telemetry.record_event(
            "autoscale_decision", action=action, delta=delta, reason=reason,
            workers=signals.live_workers,
        )
        logger.info(
            "autoscaler: %s %+d workers (%s; live=%d occ=%.2f fps=%.1f "
            "learn/s=%.1f shed=%.0f)",
            action, delta if action == SCALE_UP else -delta, reason,
            signals.live_workers, signals.queue_occupancy, signals.fps,
            signals.learn_steps_per_s, signals.shed_delta,
        )
        d = Decision(action, delta, reason, signals, now)
        self.last_decision = d
        return d

    # -- wiring ---------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Decision:
        """Read signals, decide, and apply through the executor."""
        signals = self.signal_source() if self.signal_source is not None else FleetSignals()
        if self.executor is not None:
            # capacity truth comes from the executor (spawned procs, booting
            # gathers included) — roster-registered counts lag spawn by the
            # child's boot time and would re-fire the floor rule every poll
            signals = replace(signals, live_workers=int(self.executor.worker_count()))
        decision = self.evaluate(signals, now)
        if self.executor is not None and decision.delta > 0:
            try:
                if decision.action == SCALE_UP:
                    self.executor.scale_up(decision.delta)
                elif decision.action == SCALE_DOWN:
                    self.executor.scale_down(decision.delta)
            except Exception as e:  # noqa: BLE001 — the loop must outlive one bad action
                logger.exception("autoscaler: executor %s failed", decision.action)
                telemetry.record_event(
                    "autoscale_error", action=decision.action, error=repr(e)
                )
        return decision

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — a bad signal read must not kill the loop
                logger.exception("autoscaler: step failed")

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=self.name, daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def fleet_signal_source(
    server: Any,
    registry: Optional[Any] = None,
    slo: Optional[Callable[[], Dict[str, float]]] = None,
) -> Callable[[], FleetSignals]:
    """Signal reader over a ``WorkerServer`` + the telemetry registry.

    - ``fps``: the server's ``server.results_per_s`` ingest meter;
    - ``learn_steps_per_s``: the trainers' ``rates.learn_steps_per_s`` meter
      (0 until a learner marks it);
    - ``queue_occupancy``: the server results queue fill fraction;
    - ``shed_delta``: hub + results-queue sheds since the previous read;
    - ``serving_p95_ms``: from an optional ``slo()`` callable
      (``InferenceServer.slo``);
    - ``live_workers``: the server's gather roster (the executor's spawned
      count overrides this inside ``Autoscaler.step``).
    """
    last = {"shed": 0.0}

    def read() -> FleetSignals:
        reg = registry if registry is not None else telemetry.get_registry()
        shed = float(server.hub.shed_total + server.dropped_results)
        delta, last["shed"] = shed - last["shed"], shed
        maxsize = server.results.maxsize or 1
        p95 = 0.0
        if slo is not None:
            try:
                p95 = float((slo() or {}).get("p95_ms", 0.0))
            except Exception:  # noqa: BLE001 — a dead serving plane is not a signal
                p95 = 0.0
        return FleetSignals(
            fps=reg.meter("server.results_per_s").rate(),
            learn_steps_per_s=reg.meter("rates.learn_steps_per_s").rate(),
            queue_occupancy=server.results.qsize() / maxsize,
            shed_delta=delta,
            serving_p95_ms=p95,
            live_workers=server.live_worker_count(),
        )

    return read


def router_signal_source(router: Any) -> Callable[[], FleetSignals]:
    """Signal reader over a ``ServingRouter`` — the serving-TIER loop,
    where capacity units are replicas and the decision table runs the
    ``serving_scale_up/down_p95_ms`` rules.

    - ``serving_p95_ms``: the router's aggregate end-to-end p95 (admit ->
      client reply, retries and failover included — per-replica p95s
      structurally miss both);
    - ``shed_delta``: router sheds since the previous read (requests no
      routable replica could serve — demand past the tier's capacity, a
      scale-UP signal under tier semantics);
    - ``fps``: the router's request rate meter;
    - ``queue_occupancy`` is pinned mid-band: the occupancy rules encode
      actor-fleet semantics and must stay silent for this tier;
    - ``live_workers``: live replicas (``RouterTierExecutor``'s spawned
      count overrides this inside ``Autoscaler.step``).
    """
    last = {"shed": 0.0}

    def read() -> FleetSignals:
        reg = telemetry.get_registry()
        shed = float(router.shed)
        delta, last["shed"] = shed - last["shed"], shed
        return FleetSignals(
            fps=reg.meter("router.requests_per_s").rate(),
            queue_occupancy=0.5,
            shed_delta=delta,
            serving_p95_ms=float(router.aggregate_p95_ms()),
            live_workers=int(router.replica_count()),
        )

    return read
