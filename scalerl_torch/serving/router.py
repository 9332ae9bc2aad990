"""SLO-aware serving front door: health-checked routing over N replicas.

Port of ``scalerl_tpu/serving/router.py`` (jax-free there too).
:class:`ServingRouter` speaks the ``RemotePolicyClient`` wire on the
client side (``act``/``core_init`` in, ``act_result``/``core_init`` out)
and fans requests over N replica links, adding two frame kinds of its own
(``router_hello`` membership and ``health``/``health_result``):

- **a circuit breaker a replica** (:class:`ReplicaHealth`, a pure state
  machine): ``eject_after`` consecutive errors or sheds eject a replica;
  capped ``exp_backoff`` probes (decorrelated jitter) let ONE live request
  through a window, and a served probe re-admits.  Heartbeat silence past
  the health timeout and a lost link are death verdicts;
- **prefix affinity first**: the request's ``affinity`` field, else the
  leading ``affinity_bytes`` of its obs slab, is rendezvous-hashed over the
  routable replicas; when that target is overloaded (beyond
  ``spill_load_factor`` × the mean in-flight) or unroutable, **power of two
  choices** on in-flight load decides, from ``random.Random(seed)``;
- **at-least-once re-dispatch under first-reply-wins dedup**: every
  request in flight on a dead replica is re-sent to a healthy one; the pop
  of the pending table is the dedup point, so a late duplicate is counted
  (``router.duplicate_replies``), never delivered twice.  A request past
  its ``hedge_budget`` of retries gets an explicit shed, so every admitted
  request ends exactly once: answered, shed, or orphaned when its client
  went away (``admitted == answered + shed + orphaned`` once quiet);
- **rolling weight rollout** (:meth:`ServingRouter.rollout`): one replica
  at a time is drained, pushed (``ParamSnapshotPlane.push_params``) and
  re-admitted; a generation-skew guard holds laggards out of rotation until
  a catch-up push, and a rollout from an older learner epoch is refused;
- **capacity control**: :class:`RouterTierExecutor` adds and drains
  replicas for an autoscaler (``worker_count``/``scale_up``/``scale_down``).
"""

from __future__ import annotations

import itertools
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from scalerl_torch.fleet.hub import QueueHub
from scalerl_torch.fleet.transport import (
    Connection,
    SocketConnection,
    accept_connection,
    listen_socket,
)
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.supervisor import (
    LivenessTracker,
    exp_backoff,
    is_heartbeat,
    make_pong,
)
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# chaos site prefix for router<->client links (sites=route scopes faults to
# the front door; replica links keep the serving plane's serve_* sites)
ROUTE_CHAOS_SITE = "route_sock"

# replica health states (the breaker's vocabulary)
HEALTHY = "healthy"
DRAINING = "draining"
EJECTED = "ejected"

# breaker state -> gauge code (``router.breaker.<replica>``): a replay
# verdict correlates a p99 spike against this timeline numerically.
# 0 = closed (healthy, in rotation), 1 = open (ejected), 2 = probing
# (one trial in flight), 3 = draining (rollout/scale-down)
BREAKER_CODES = {HEALTHY: 0.0, EJECTED: 1.0, DRAINING: 3.0}
BREAKER_PROBING = 2.0


@dataclass
class RouterConfig:
    """Knobs for the front door's breaker, routing, and rollout."""

    # circuit breaker: consecutive errors/sheds on one replica before it is
    # ejected from rotation (successes reset the streak)
    eject_after: int = 3
    # capped-exp_backoff probe schedule for ejected replicas; jitter is ON
    # here by default — probing is exactly the synchronized-storm path the
    # decorrelated draw exists for (determinism-pinned tests inject rng)
    probe_backoff_s: float = 0.05
    probe_backoff_cap_s: float = 2.0
    probe_jitter: bool = True
    # retries per request beyond the first dispatch (shed/error/death all
    # consume one); exhausted -> explicit shed to the client
    hedge_budget: int = 2
    # leading obs bytes hashed into the prefix-affinity key when the act
    # frame carries no explicit "affinity" field
    affinity_bytes: int = 64
    # the affinity target spills to power-of-two-choices when its in-flight
    # load exceeds this multiple of the mean across routable replicas
    spill_load_factor: float = 2.0
    # a replica whose generation lags the fleet max by more than this is
    # held out of rotation until a catch-up push (mid-rollout guard)
    max_gen_skew: int = 1
    # health poll cadence over replica links (0 = off; request outcomes
    # still feed the breaker).  A replica silent past health_timeout_s
    # (default 4x interval) is declared dead.
    health_interval_s: float = 0.0
    health_timeout_s: float = 0.0
    # graceful-drain bound for rollout()/remove_replica(): in-flight
    # stragglers past this are re-dispatched instead of wedging the drain
    drain_timeout_s: float = 5.0
    # client-side hub plumbing (same vocabulary as ServingConfig)
    hub_maxsize: int = 1024
    max_pending: int = 0
    client_heartbeat_s: float = 0.0
    seed: int = 0

    def resolved_health_timeout(self) -> float:
        return self.health_timeout_s or 4.0 * self.health_interval_s


class ReplicaHealth:
    """The per-replica circuit breaker: a pure state machine over request
    outcomes, unit-testable with an injected clock.

    States: HEALTHY (in rotation) -> EJECTED (``eject_after`` consecutive
    failures, or a death verdict via :meth:`force_eject`) -> probe window
    (one live request allowed once ``probe_at`` passes) -> HEALTHY on a
    served probe, or re-ejected with a longer capped backoff on a failed
    one.  DRAINING (rollout/scale-down) is routable never, re-admitted
    explicitly.  Not thread-safe by itself — the router serializes
    transitions under its lock.
    """

    def __init__(
        self,
        eject_after: int = 3,
        probe_backoff_s: float = 0.05,
        probe_backoff_cap_s: float = 2.0,
        jitter: bool = True,
        rng: Any = None,
    ) -> None:
        self.eject_after = max(int(eject_after), 1)
        self.probe_backoff_s = probe_backoff_s
        self.probe_backoff_cap_s = probe_backoff_cap_s
        self.jitter = jitter
        self.rng = rng
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.ejections = 0       # lifetime count; also the backoff attempt
        self.probe_at = 0.0
        self.probing = False     # one trial request in flight

    def record_ok(self) -> bool:
        """A served request: resets the failure streak; a served *probe*
        re-admits.  Returns True exactly on the EJECTED->HEALTHY edge."""
        self.consecutive_failures = 0
        if self.state == EJECTED:
            self.state = HEALTHY
            self.probing = False
            self.ejections = 0  # a recovered replica earns a fresh schedule
            return True
        return False

    def record_failure(self, now: Optional[float] = None) -> bool:
        """A shed/error outcome.  Returns True exactly when this failure
        ejects (or re-ejects, for a failed probe) the replica."""
        now = time.monotonic() if now is None else now
        if self.state == EJECTED:
            if self.probing:  # the probe request itself failed: back off more
                self._eject(now)
                return True
            return False
        self.consecutive_failures += 1
        if self.state == HEALTHY and self.consecutive_failures >= self.eject_after:
            self._eject(now)
            return True
        return False

    def force_eject(self, now: Optional[float] = None) -> None:
        """Death verdict (link lost / liveness timeout): eject immediately
        regardless of streak."""
        self._eject(time.monotonic() if now is None else now)

    def _eject(self, now: float) -> None:
        self.state = EJECTED
        self.probing = False
        self.consecutive_failures = 0
        delay = exp_backoff(
            self.ejections,
            self.probe_backoff_s,
            self.probe_backoff_cap_s,
            jitter=self.jitter,
            rng=self.rng,
        )
        self.ejections += 1
        self.probe_at = now + delay

    def mark_draining(self) -> None:
        self.state = DRAINING
        self.probing = False

    def readmit(self) -> None:
        """Explicit re-admission (rollout push done / operator action)."""
        self.state = HEALTHY
        self.probing = False
        self.consecutive_failures = 0

    def routable(self, now: Optional[float] = None) -> bool:
        """In rotation?  An EJECTED replica becomes routable for exactly
        ONE request per probe window (the trial the breaker re-admits on)."""
        if self.state == HEALTHY:
            return True
        if self.state == DRAINING:
            return False
        now = time.monotonic() if now is None else now
        if not self.probing and now >= self.probe_at:
            self.probing = True
            return True
        return False


class ReplicaHandle:
    """One replica as the router sees it: the wire link, the optional
    in-process control handle (``server`` — anything with ``push_params``,
    the rollout path), and the in-flight ledger."""

    def __init__(self, name: str, conn: Connection, server: Any = None) -> None:
        self.name = name
        self.conn = conn
        self.server = server
        self.alive = True
        self.generation = 0
        # the learner incarnation whose params this replica serves (set by
        # the router's own pushes): generations only compare within the
        # epoch-qualified order (epoch, generation)
        self.epoch = 0
        self.p95_ms = 0.0
        self.shed_total = 0
        self.pending = 0
        self.host = ""
        self._send_lock = threading.Lock()
        self._inflight: Set[int] = set()
        self._inflight_lock = threading.Lock()

    def send(self, msg: Dict[str, Any]) -> None:
        with self._send_lock:
            self.conn.send(msg)

    def begin(self, rid: int) -> None:
        with self._inflight_lock:
            self._inflight.add(rid)

    def end(self, rid: int) -> None:
        with self._inflight_lock:
            self._inflight.discard(rid)

    def inflight_count(self) -> int:
        with self._inflight_lock:
            return len(self._inflight)

    def take_inflight(self) -> List[int]:
        """Snapshot-and-clear the ledger (the re-dispatch sweep)."""
        with self._inflight_lock:
            rids, self._inflight = list(self._inflight), set()
        return rids


def connect_replica(server: Any, name: str) -> ReplicaHandle:
    """Wire an in-process ``InferenceServer`` behind the router: a codec
    pipe pair, the server end registered on its hub, the client end held
    by the router — the bench/chaos topology (socket replicas hand the
    router a pre-dialed :class:`ReplicaHandle` instead)."""
    from scalerl_torch.serving import local_pair

    router_end, server_end = local_pair()
    server.add_connection(server_end)
    return ReplicaHandle(name, router_end, server=server)


class _Pending:
    """One admitted request: the reply route back to the client plus the
    retry ledger.  ``rid`` (the router's monotonic id) is the wire ``req``
    on replica links; ``client_req`` is restored on the way back."""

    __slots__ = (
        "rid", "client", "client_req", "msg", "kind", "affinity",
        "attempts", "t_admit", "trace", "replica",
    )

    def __init__(self, rid, client, client_req, msg, kind, affinity, trace):
        self.rid = rid
        self.client = client
        self.client_req = client_req
        self.msg = msg
        self.kind = kind
        self.affinity = affinity
        self.attempts = 0
        self.t_admit = time.monotonic()
        self.trace = trace
        self.replica: Optional[str] = None


class ServingRouter:
    """The front door: client hub in, N health-tracked replica links out.

    Host-only — the router runs wherever the clients are (the learner
    host, an edge pop, a test) and never touches a device.  See the module
    docstring for the full contract.
    """

    def __init__(
        self,
        replicas: Optional[List[ReplicaHandle]] = None,
        config: Optional[RouterConfig] = None,
    ) -> None:
        self.config = config or RouterConfig()
        self._rng = random.Random(self.config.seed)
        self._rids = itertools.count(1)
        self._pending: Dict[int, _Pending] = {}
        self._lock = threading.RLock()
        self.replicas: List[ReplicaHandle] = []
        self._health: Dict[str, ReplicaHealth] = {}
        self._liveness = LivenessTracker()
        self._reader_threads: Dict[str, threading.Thread] = {}
        self._last_push: Optional[
            Tuple[Any, Optional[int], int]
        ] = None
        # newest learner epoch ever rolled out through this router: a
        # rollout from an OLDER epoch (a zombie pre-restart learner racing
        # its restarted successor) is refused, so rolling restarts can
        # never re-serve a stale generation
        self.learner_epoch = 0
        self.stale_rollouts = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listen_sock = None
        # exact-accounting ledger: admitted == answered + shed + orphaned
        # once quiesced — the chaos e2e's acceptance equation
        self.admitted = 0
        self.answered = 0
        self.shed = 0
        self.retries = 0
        self.redispatches = 0
        self.duplicate_replies = 0
        self.orphaned = 0
        self.ejections = 0
        self.readmissions = 0
        self.rollouts = 0
        reg = telemetry.get_registry()
        # digest backend: aggregate_p95_ms() is the autoscaler's capacity
        # signal — it must hold its relative-error bound at front-door
        # request counts, which the reservoir backend cannot
        self._lat_hist = reg.histogram("router.latency_s", backend="digest")
        self._req_meter = reg.meter("router.requests_per_s")
        self._req_counter = reg.counter("router.requests")
        self._retry_counter = reg.counter("router.retries")
        self._redispatch_counter = reg.counter("router.redispatches")
        self._shed_counter = reg.counter("router.sheds")
        self._dup_counter = reg.counter("router.duplicate_replies")
        self._eject_counter = reg.counter("router.ejections")
        self._readmit_counter = reg.counter("router.readmissions")
        reg.bind("router", self.stats)
        self.hub = QueueHub(
            maxsize=self.config.hub_maxsize,
            heartbeat_interval=self.config.client_heartbeat_s,
            max_pending=self.config.max_pending,
            on_disconnect=self._on_client_gone,
        )
        for r in replicas or ():
            self.add_replica(r)

    # -- membership -----------------------------------------------------
    def add_replica(self, replica: ReplicaHandle) -> None:
        """Admit a replica: announce membership (``router_hello``), start
        its reader, put it in rotation."""
        with self._lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(f"duplicate replica name {replica.name!r}")
            self.replicas.append(replica)
            self._health[replica.name] = ReplicaHealth(
                eject_after=self.config.eject_after,
                probe_backoff_s=self.config.probe_backoff_s,
                probe_backoff_cap_s=self.config.probe_backoff_cap_s,
                jitter=self.config.probe_jitter,
                rng=self._rng,
            )
        self._export_breaker(replica.name)
        self._liveness.beat(replica.name)
        t = threading.Thread(
            target=self._replica_loop, args=(replica,),
            name=f"router-replica-{replica.name}", daemon=True,
        )
        self._reader_threads[replica.name] = t
        t.start()
        try:
            replica.send({"kind": "router_hello", "req": f"hello:{replica.name}"})
        except (ConnectionError, OSError, ValueError):
            self._on_replica_down(replica, "hello failed")
        # a late-joining replica adopts the newest rolled-out snapshot
        # (epoch-qualified) BEFORE taking traffic — otherwise the skew /
        # epoch guards would hold it out of rotation forever anyway
        self._catch_up(replica)
        telemetry.record_event("router_replica_added", replica=replica.name)

    def remove_replica(
        self, name: str, drain: bool = True
    ) -> Optional[ReplicaHandle]:
        """Drain a replica out of rotation and drop its link; returns the
        handle so the owner (the tier executor) can stop the process."""
        with self._lock:
            replica = next((r for r in self.replicas if r.name == name), None)
        if replica is None:
            return None
        health = self._health[name]
        health.mark_draining()
        self._export_breaker(name)
        if drain:
            self._await_drain(replica)
        with self._lock:
            replica.alive = False
            self.replicas = [r for r in self.replicas if r.name != name]
        self._redispatch_inflight(replica)
        try:
            replica.conn.close()
        except Exception:  # noqa: BLE001 — teardown
            pass
        self._liveness.forget(name)
        telemetry.record_event("router_replica_removed", replica=name)
        return replica

    # -- bring-up -------------------------------------------------------
    def start(self, listen_port: Optional[int] = None) -> None:
        self._threads = [
            threading.Thread(target=self._client_loop, name="router-admit",
                             daemon=True),
        ]
        if self.config.health_interval_s > 0:
            self._threads.append(
                threading.Thread(target=self._health_loop,
                                 name="router-health", daemon=True)
            )
        if listen_port is not None:
            self._listen_sock = listen_socket(listen_port)
            self._threads.append(
                threading.Thread(
                    target=self._accept_loop, args=(self._listen_sock,),
                    name="router-accept", daemon=True,
                )
            )
        for t in self._threads:
            t.start()

    def add_client(self, conn: Connection) -> None:
        """Register an in-process or pre-accepted client link."""
        self.hub.add_connection(conn)

    def stop(self) -> None:
        self._stop.set()
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
        self.hub.close()
        for replica in list(self.replicas):
            try:
                replica.conn.close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        for t in list(self._threads) + list(self._reader_threads.values()):
            t.join(timeout=3.0)

    def _accept_loop(self, sock) -> None:
        while not self._stop.is_set():
            try:
                conn = accept_connection(sock, timeout=0.5)
            except (TimeoutError, OSError):
                continue
            if isinstance(conn, SocketConnection):
                conn.chaos_site = ROUTE_CHAOS_SITE
            self.hub.add_connection(conn)

    def _on_client_gone(self, conn: Connection) -> None:
        """A client link dropped: orphan its pendings so late replies are
        counted instead of sent down a dead pipe."""
        with self._lock:
            for p in self._pending.values():
                if p.client is conn:
                    p.client = None

    # -- admission + routing --------------------------------------------
    def _client_loop(self) -> None:
        import queue as queue_mod

        while not self._stop.is_set():
            try:
                conn, msg = self.hub.recv(timeout=0.2)
            except queue_mod.Empty:
                continue
            try:
                self._admit(conn, msg)
            except Exception:  # noqa: BLE001 — a bad request must not kill the front door
                logger.exception(
                    "router: failed handling %r",
                    msg.get("kind") if isinstance(msg, dict) else msg,
                )

    def _admit(self, conn: Connection, msg: Dict[str, Any]) -> None:
        kind = msg.get("kind")
        if kind not in ("act", "core_init"):
            logger.warning("router: unknown message kind %r", kind)
            return
        rid = next(self._rids)
        p = _Pending(
            rid=rid,
            client=conn,
            client_req=msg.get("req"),
            msg=msg,
            kind=kind,
            affinity=self._affinity_key(msg),
            trace=tracing.extract(msg),
        )
        with self._lock:
            self.admitted += 1
            self._pending[rid] = p
        self._req_counter.inc()
        self._req_meter.mark()
        self._dispatch(p)

    def _affinity_key(self, msg: Dict[str, Any]) -> Optional[int]:
        """The placement key: an explicit ``affinity`` field wins (agentic
        callers tag a conversation); else the leading bytes of the obs slab
        — the prompt's first blocks, so identical prefixes hash together."""
        if "affinity" in msg:
            return zlib.crc32(str(msg["affinity"]).encode())
        obs = msg.get("obs")
        if obs is None:
            return None
        arr = np.ascontiguousarray(np.asarray(obs))
        head = arr.tobytes()[: self.config.affinity_bytes]
        return zlib.crc32(head) if head else None

    def _route(
        self, p: _Pending, exclude: Set[str] = frozenset()
    ) -> Optional[ReplicaHandle]:
        now = time.monotonic()
        with self._lock:
            fleet_max = max((r.generation for r in self.replicas), default=0)
            eligible = [
                r for r in self.replicas
                if r.name not in exclude and r.alive
                # mid-rollout laggards are held out until caught up
                and fleet_max - r.generation <= self.config.max_gen_skew
                # a pushable replica still on a pre-restart learner epoch
                # serves stale weights by definition — held out until
                # _catch_up rolls it forward (wire-only replicas track
                # generations through their own reports instead)
                and (r.server is None or r.epoch >= self.learner_epoch)
            ]
            # probe-due ejected replicas take the next request as their ONE
            # trial per window — the flag is consumed here, exactly when the
            # request is actually routed to them
            for r in eligible:
                h = self._health[r.name]
                if h.state == EJECTED and not h.probing and now >= h.probe_at:
                    h.probing = True
                    # the open->probing edge of the breaker timeline: a
                    # gauge write + flight event, both host-side and cheap
                    self._export_breaker(r.name)
                    telemetry.record_event("router_probe", replica=r.name)
                    return r
            candidates = [
                r for r in eligible
                if self._health[r.name].state == HEALTHY
            ]
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]
        loads = [r.inflight_count() for r in candidates]
        if p.affinity is not None:
            # rendezvous (highest-random-weight) hash: stable under replica
            # churn — adding/removing one replica only remaps the keys that
            # belonged to it, so prefix pages stay where they were
            best_i = max(
                range(len(candidates)),
                key=lambda i: zlib.crc32(
                    f"{p.affinity}|{candidates[i].name}".encode()
                ),
            )
            mean = sum(loads) / len(loads)
            if loads[best_i] <= self.config.spill_load_factor * max(mean, 1.0):
                return candidates[best_i]
        # power-of-two-choices on in-flight load (affinity target overloaded
        # or no affinity key): two random candidates, take the idler one
        i, j = self._rng.sample(range(len(candidates)), 2)
        return candidates[i] if loads[i] <= loads[j] else candidates[j]

    def _dispatch(self, p: _Pending, exclude: Set[str] = frozenset()) -> None:
        replica = self._route(p, exclude)
        if replica is None:
            self._give_up(p, "no routable replica")
            return
        p.replica = replica.name
        replica.begin(p.rid)
        fwd = dict(p.msg)
        fwd["req"] = p.rid
        try:
            replica.send(fwd)
        except (ConnectionError, OSError, ValueError):
            self._on_replica_down(replica, "send failed")

    def _give_up(self, p: _Pending, why: str) -> None:
        """Explicit shed back to the client — the exactly-once terminal for
        a request no replica could serve."""
        reply_kind = "act_result" if p.kind == "act" else p.kind
        with self._lock:
            self._pending.pop(p.rid, None)
            # exactly one terminal bucket per admitted request: a shed is
            # DELIVERED; a client that vanished first counts as orphaned
            if p.client is not None:
                self.shed += 1
            else:
                self.orphaned += 1
        if p.client is not None:
            self._shed_counter.inc()
            self.hub.send(
                p.client,
                {"kind": reply_kind, "req": p.client_req, "shed": True},
            )
        # the request's kind rides as req_kind: the event's own "kind" is
        # record_event's first argument (the JAX copy passes kind= and
        # raises TypeError here, after the shed went out)
        telemetry.record_event("router_shed", why=why, req_kind=p.kind)

    def _retry(self, p: _Pending, from_name: str, why: str) -> None:
        """Re-dispatch an un-answered request (its pending entry is already
        popped); exhausting the hedge budget sheds explicitly instead."""
        if p.attempts >= self.config.hedge_budget:
            self._give_up(p, f"hedge budget exhausted ({why})")
            return
        p.attempts += 1
        self.retries += 1
        self._retry_counter.inc()
        with self._lock:
            self._pending[p.rid] = p
        self._dispatch(p, exclude={from_name})

    # -- the replica side -----------------------------------------------
    def _replica_loop(self, replica: ReplicaHandle) -> None:
        while not self._stop.is_set() and replica.alive:
            try:
                msg = replica.conn.recv(timeout=0.2)
            except TimeoutError:
                continue
            except (ConnectionError, EOFError, OSError, ValueError):
                if self._stop.is_set():
                    return  # router teardown, not a replica death
                # includes ProtocolError: desynchronized stream = dead link
                self._on_replica_down(replica, "link lost")
                return
            self._liveness.beat(replica.name)
            if is_heartbeat(msg):
                # the replica hub's liveness plane: answer pings so silence
                # verdicts never fire against a healthy router
                if isinstance(msg, dict) and msg.get("kind") == "ping":
                    try:
                        replica.send(make_pong(msg))
                    except (ConnectionError, OSError):
                        self._on_replica_down(replica, "pong failed")
                        return
                continue
            if not isinstance(msg, dict):
                continue
            kind = msg.get("kind")
            if kind == "health_result":
                self._on_health(replica, msg)
            elif kind == "router_hello":
                replica.host = str(msg.get("host", ""))
                replica.generation = max(
                    replica.generation, int(msg.get("gen", 0))
                )
            else:
                self._on_reply(replica, msg)

    def _on_reply(self, replica: ReplicaHandle, msg: Dict[str, Any]) -> None:
        rid = msg.get("req")
        replica.end(rid)
        with self._lock:
            p = self._pending.pop(rid, None)
        if p is None:
            # first-reply-wins dedup: a re-dispatched request was already
            # answered elsewhere (or shed) — count, never double-deliver
            with self._lock:
                self.duplicate_replies += 1
            self._dup_counter.inc()
            return
        health = self._health[replica.name]
        if msg.get("shed"):
            if health.record_failure():
                self._note_ejection(replica, "shed streak")
            self._retry(p, replica.name, "shed")
            return
        if "error" in msg:
            if health.record_failure():
                self._note_ejection(replica, "error streak")
            self._retry(p, replica.name, "error")
            return
        if health.record_ok():
            self._note_readmission(replica)
        replica.generation = max(
            replica.generation, int(msg.get("gen", replica.generation))
        )
        now = time.monotonic()
        self._lat_hist.observe(max(now - p.t_admit, 0.0))
        with self._lock:
            if p.client is None:
                self.orphaned += 1
                return
            self.answered += 1
        if p.trace is not None:
            tracing.record_span(
                "router.route", parent=p.trace, t_start=p.t_admit,
                t_end=now, kind="serving", replica=replica.name,
                attempts=p.attempts,
            )
        out = dict(msg)
        out["req"] = p.client_req
        self.hub.send(p.client, out)

    def _note_ejection(self, replica: ReplicaHandle, why: str) -> None:
        self.ejections += 1
        self._eject_counter.inc()
        self._export_breaker(replica.name)
        telemetry.record_event("router_eject", replica=replica.name, why=why)
        logger.warning("router: ejected replica %s (%s)", replica.name, why)

    def _note_readmission(self, replica: ReplicaHandle) -> None:
        self.readmissions += 1
        self._readmit_counter.inc()
        self._export_breaker(replica.name)
        telemetry.record_event("router_readmit", replica=replica.name)
        logger.info("router: re-admitted replica %s", replica.name)
        self._catch_up(replica)

    def _export_breaker(self, name: str) -> None:
        """Export one replica's breaker state as a gauge
        (``router.breaker.<replica>``; see :data:`BREAKER_CODES`).  Called
        on every transition — a replay verdict lines p99 spikes up against
        this timeline plus the eject/readmit/probe/rollout flight events."""
        h = self._health.get(name)
        if h is None:
            return
        code = (
            BREAKER_PROBING if (h.state == EJECTED and h.probing)
            else BREAKER_CODES.get(h.state, 0.0)
        )
        telemetry.get_registry().gauge(f"router.breaker.{name}").set(code)

    def breaker_states(self) -> Dict[str, str]:
        """The per-replica breaker state, human vocabulary (``probing``
        refines ``ejected`` while the trial request is in flight)."""
        with self._lock:
            return {
                name: ("probing" if (h.state == EJECTED and h.probing)
                       else h.state)
                for name, h in self._health.items()
                if any(r.name == name for r in self.replicas)
            }

    def _on_replica_down(self, replica: ReplicaHandle, why: str) -> None:
        """Death verdict: eject, close, and re-dispatch every in-flight
        request — at-least-once, the dedup pop above keeps it exactly-once
        at the client."""
        with self._lock:
            if not replica.alive:
                return
            replica.alive = False
        self._health[replica.name].force_eject()
        self._note_ejection(replica, why)
        try:
            replica.conn.close()
        except Exception:  # noqa: BLE001 — link already broken
            pass
        telemetry.record_event(
            "router_replica_down", replica=replica.name, why=why
        )
        self._redispatch_inflight(replica)

    def _redispatch_inflight(self, replica: ReplicaHandle) -> None:
        for rid in replica.take_inflight():
            with self._lock:
                p = self._pending.pop(rid, None)
            if p is None:
                continue
            self.redispatches += 1
            self._redispatch_counter.inc()
            self._retry(p, replica.name, "replica down")

    # -- health plane ---------------------------------------------------
    def _health_loop(self) -> None:
        timeout = self.config.resolved_health_timeout()
        while not self._stop.wait(self.config.health_interval_s):
            now = time.monotonic()
            for replica in list(self.replicas):
                if not replica.alive:
                    continue
                last = self._liveness.last_seen(replica.name)
                if last is not None and now - last > timeout:
                    self._on_replica_down(replica, "health timeout")
                    continue
                try:
                    replica.send(
                        {"kind": "health", "req": f"health:{replica.name}"}
                    )
                except (ConnectionError, OSError, ValueError):
                    self._on_replica_down(replica, "health send failed")

    def _on_health(self, replica: ReplicaHandle, msg: Dict[str, Any]) -> None:
        replica.p95_ms = float(msg.get("p95_ms", replica.p95_ms))
        replica.shed_total = int(msg.get("shed_total", replica.shed_total))
        replica.pending = int(msg.get("pending", replica.pending))
        replica.host = str(msg.get("host", replica.host))
        replica.generation = max(
            replica.generation, int(msg.get("gen", replica.generation))
        )

    # -- rolling weight rollout -----------------------------------------
    def _await_drain(self, replica: ReplicaHandle) -> None:
        deadline = time.monotonic() + self.config.drain_timeout_s
        while replica.inflight_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.002)

    def rollout(
        self,
        params: Any,
        learner_step: Optional[int] = None,
        learner_epoch: Optional[int] = None,
    ) -> int:
        """Rolling weight rollout: one replica at a time, drain -> push ->
        re-admit — in-flight traffic keeps flowing through the others, and
        the ``max_gen_skew`` guard bounds how far the fleet can diverge
        mid-roll.  Returns the fleet's max generation after the roll.

        ``learner_epoch`` (when the caller rides the preemption-tolerant
        plane) orders rollouts ACROSS learner restarts: a push from an
        older epoch than the newest ever seen is a zombie pre-restart
        learner racing its successor and is refused outright — the
        epoch-qualified order (epoch, generation) is what "never serve a
        stale generation through a rolling restart" means."""
        if learner_epoch is not None:
            epoch = int(learner_epoch)
            if epoch < self.learner_epoch:
                self.stale_rollouts += 1
                telemetry.record_event(
                    "router_stale_rollout",
                    epoch=epoch,
                    current=self.learner_epoch,
                )
                logger.warning(
                    "router: refused rollout from stale learner epoch %d "
                    "(current %d)", epoch, self.learner_epoch,
                )
                return max(
                    (r.generation for r in self.replicas if r.alive),
                    default=0,
                )
            self.learner_epoch = epoch
        self._last_push = (params, learner_step, self.learner_epoch)
        self.rollouts += 1
        for replica in list(self.replicas):
            if not replica.alive or replica.server is None:
                continue
            health = self._health[replica.name]
            in_rotation = health.state == HEALTHY
            if in_rotation:
                health.mark_draining()
                self._export_breaker(replica.name)
                # the rollout phase timeline: drain -> push -> readmit per
                # replica, so a replay verdict can correlate a latency
                # spike with exactly which phase the fleet was in
                telemetry.record_event(
                    "router_rollout_phase", replica=replica.name,
                    phase="drain", rollout=self.rollouts,
                )
                self._await_drain(replica)
                # stragglers past the drain bound re-dispatch (the replica
                # may be wedged; at-least-once covers the race where it
                # still answers)
                self._redispatch_inflight(replica)
            telemetry.record_event(
                "router_rollout_phase", replica=replica.name, phase="push",
                rollout=self.rollouts,
            )
            gen = replica.server.push_params(params, learner_step=learner_step)
            replica.generation = max(replica.generation, int(gen))
            replica.epoch = max(replica.epoch, self.learner_epoch)
            if in_rotation:
                # an EJECTED replica gets the push (generations stay
                # aligned) but NOT a free pass back into rotation — only
                # its probe can re-admit it
                health.readmit()
                self._export_breaker(replica.name)
                telemetry.record_event(
                    "router_rollout_phase", replica=replica.name,
                    phase="readmit", rollout=self.rollouts,
                )
            telemetry.record_event(
                "router_rollout", replica=replica.name, gen=replica.generation
            )
        fleet_max = max(
            (r.generation for r in self.replicas if r.alive), default=0
        )
        return fleet_max

    def _catch_up(self, replica: ReplicaHandle) -> None:
        """A re-admitted (or late-joining) laggard gets the newest
        rolled-out params: pushes repeat until its epoch-qualified
        (epoch, generation) reaches the fleet max, so the skew guard
        releases it back into rotation — a replica that slept through a
        learner restart cannot re-enter serving pre-restart weights."""
        if replica.server is None or self._last_push is None:
            return
        params, step, epoch = self._last_push
        with self._lock:
            fleet_max = max((r.generation for r in self.replicas), default=0)
        while (replica.epoch, replica.generation) < (epoch, fleet_max):
            gen = replica.server.push_params(params, learner_step=step)
            replica.generation = max(replica.generation, int(gen))
            replica.epoch = max(replica.epoch, epoch)

    # -- observability ---------------------------------------------------
    def replica_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.alive)

    def healthy_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self.replicas
                if r.alive and self._health[r.name].state == HEALTHY
            )

    def aggregate_p95_ms(self) -> float:
        """The tier's end-to-end p95 (router admit -> client reply), the
        autoscaler's capacity signal — retries and failover included, which
        per-replica p95s structurally cannot see."""
        return self._lat_hist.quantile(0.95) * 1e3

    def slo(self) -> Dict[str, float]:
        h = self._lat_hist
        return {
            "p50_ms": h.quantile(0.50) * 1e3,
            "p95_ms": h.quantile(0.95) * 1e3,
            "p99_ms": h.quantile(0.99) * 1e3,
            "requests": self.admitted,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            inflight = len(self._pending)
            gens = [r.generation for r in self.replicas if r.alive]
            epochs = [r.epoch for r in self.replicas if r.alive]
        return {
            "admitted": self.admitted,
            "answered": self.answered,
            "shed": self.shed,
            "retries": self.retries,
            "redispatches": self.redispatches,
            "duplicate_replies": self.duplicate_replies,
            "orphaned": self.orphaned,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "rollouts": self.rollouts,
            "inflight": inflight,
            "replicas": len(gens),
            "healthy": self.healthy_count(),
            "generation_max": max(gens, default=0),
            "generation_min": min(gens, default=0),
            "learner_epoch": self.learner_epoch,
            "epoch_min": min(epochs, default=0),
            "stale_rollouts": self.stale_rollouts,
            "breaker": self.breaker_states(),
        }


class RouterTierExecutor:
    """The autoscaler executor over the router's replica fleet: scale-up
    spawns a replica through ``replica_factory`` (returning a wired
    :class:`ReplicaHandle`), scale-down drains the newest one — same
    duck-typed surface (``worker_count``/``scale_up``/``scale_down``) as
    the actor fleet's ``ClusterExecutor``."""

    def __init__(
        self,
        router: ServingRouter,
        replica_factory: Callable[[int], ReplicaHandle],
        stop_replica: Optional[Callable[[ReplicaHandle], None]] = None,
    ) -> None:
        self.router = router
        self._factory = replica_factory
        self._stop_replica = stop_replica
        self._spawned = itertools.count(len(router.replicas))

    def worker_count(self) -> int:
        return self.router.replica_count()

    def scale_up(self, n: int) -> None:
        for _ in range(n):
            self.router.add_replica(self._factory(next(self._spawned)))

    def scale_down(self, n: int) -> None:
        # newest-first drain: the longest-lived replicas hold the warmest
        # prefix caches, so churn costs the least affinity
        for _ in range(n):
            with self.router._lock:
                live = [r for r in self.router.replicas if r.alive]
            if not live:
                return
            handle = self.router.remove_replica(live[-1].name)
            if handle is not None and self._stop_replica is not None:
                self._stop_replica(handle)
