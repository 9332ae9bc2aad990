"""Parity of the port's serving front door (``scalerl_torch/serving/router.py``)
with the JAX package's, decision by decision.

Thread timing makes a whole run's routing sequence nondeterministic, so the
two routers are compared as decision functions on the same inputs:

- replica choice: 300 requests over 4 replicas with scripted in-flight
  loads, affinity keys (explicit, obs bytes, none) and ejections, from one
  seed (rendezvous hashing, the spill rule, power of two choices from
  ``random.Random(seed)``, the breaker's jittered backoff on that stream);
- the breaker (``ReplicaHealth``) on an injected clock and rng;
- the hedge budget and first-reply-wins dedup: the same scripted replies
  (sheds, errors, answers, duplicates, a replica's death) give the same
  forwards, client replies and counters;
- the generation-skew and epoch guards through a rolling rollout.

A live run (two port servers behind the router, one stopped mid-traffic)
is held only to the exact identity ``admitted == answered + shed +
orphaned``.
"""

import queue
import random
import threading
import time

import numpy as np
import pytest
import torch

from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.config import ImpalaArguments
from scalerl_torch.runtime import telemetry
from scalerl_torch.serving import InferenceServer, RemotePolicyClient, ServingConfig, local_pair
from scalerl_torch.serving import router as trouter
from scalerl_tpu.serving import router as jrouter

torch.set_num_threads(1)
WAIT_S = 20.0
PACKAGES = (jrouter, trouter)


class _FakeConn:
    """A replica or client link that records what the router sends and
    never delivers anything (each receive waits out its timeout)."""

    def __init__(self) -> None:
        self.sent: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()

    def send(self, msg, compress=False):
        self.sent.put(msg)

    def recv(self, timeout=None):
        if self._closed.wait(timeout if timeout is not None else 0.2):
            raise EOFError("closed")
        raise TimeoutError

    def poll(self, timeout=0.0):
        return False

    def close(self):
        self._closed.set()

    def fileno(self):
        return -1

    def drain(self, n=None, timeout=WAIT_S):
        """Everything sent so far, or wait for ``n`` messages."""
        out = []
        deadline = time.monotonic() + timeout
        while n is None or len(out) < n:
            try:
                out.append(self.sent.get(timeout=0.0 if n is None else
                                         max(deadline - time.monotonic(), 0.01)))
            except queue.Empty:
                if n is None or time.monotonic() >= deadline:
                    break
        return out


class _Pushable:
    def __init__(self) -> None:
        self.generation = 0

    def push_params(self, params, learner_step=None, quantize=None):
        self.generation += 1
        return self.generation


def _router(mod, n, pushable=False, **cfg):
    base = dict(probe_backoff_s=1e6, probe_backoff_cap_s=1e6, seed=7)
    base.update(cfg)
    router = mod.ServingRouter(config=mod.RouterConfig(**base))
    for i in range(n):
        router.add_replica(mod.ReplicaHandle(f"r{i}", _FakeConn(),
                                             server=_Pushable() if pushable else None))
    return router


def _route_trace(mod):
    router = _router(mod, 4)
    rng = np.random.default_rng(0)
    picks = []
    try:
        for step in range(300):
            kind = step % 3
            msg = {"kind": "act", "req": step}
            if kind == 0:
                msg["affinity"] = f"conv-{rng.integers(0, 12)}"
            elif kind == 1:
                msg["obs"] = rng.integers(0, 4, (2, 40)).astype(np.uint8)
            p = mod._Pending(step, None, step, msg, "act", router._affinity_key(msg), None)
            chosen = router._route(p)
            picks.append(None if chosen is None else chosen.name)
            if chosen is not None and rng.uniform() < 0.6:
                chosen.begin(step)  # the load stays in flight
            for r in router.replicas:
                if rng.uniform() < 0.05:
                    r.take_inflight()  # its load drains
            if step in (50, 120):  # a failure streak ejects a replica
                h = router._health[f"r{step % 4}"]
                for _ in range(3):
                    h.record_failure(now=float(step))
            if step == 200:
                router._health["r2"].readmit()
        return picks, [round(router._health[f"r{i}"].probe_at, 9) for i in range(4)]
    finally:
        router.stop()


def test_replica_choices_match_jax_under_one_seed():
    jax_picks, jax_probe = _route_trace(jrouter)
    port_picks, port_probe = _route_trace(trouter)
    assert port_picks == jax_picks and port_probe == jax_probe
    assert len(set(port_picks)) == 4  # every replica took traffic


def _breaker_trace(mod):
    h = mod.ReplicaHealth(eject_after=2, probe_backoff_s=0.05, probe_backoff_cap_s=0.4,
                          jitter=True, rng=random.Random(11))
    out = []
    t = 0.0
    script = ["fail", "ok", "fail", "fail", "route", "fail", "route", "route", "ok", "fail",
              "force", "route", "fail", "route", "drain", "route", "readmit", "route", "fail",
              "fail", "fail", "route", "ok"]
    for op in script:
        t += 0.1
        if op == "fail":
            r = h.record_failure(now=t)
        elif op == "ok":
            r = h.record_ok()
        elif op == "force":
            r = h.force_eject(now=t)
        elif op == "route":
            r = h.routable(now=t)
        elif op == "drain":
            r = h.mark_draining()
        else:
            r = h.readmit()
        out.append((op, r, h.state, h.consecutive_failures, h.ejections,
                    round(h.probe_at, 12), h.probing))
    return out


def test_breaker_transitions_match_jax():
    assert _breaker_trace(trouter) == _breaker_trace(jrouter)


def _hedge_trace(mod):
    """Scripted replica replies into a router over two fake replicas."""
    router = _router(mod, 2, hedge_budget=2, eject_after=10)
    client = _FakeConn()
    reps = {r.name: r for r in router.replicas}
    for r in reps.values():
        r.conn.drain()  # the router_hello
    forwards = []

    def forwarded():
        for name in sorted(reps):
            for m in reps[name].conn.drain():
                forwards.append((name, m["req"]))

    def reply(rid, **fields):
        name = next(n for n, r in reps.items() if rid in r._inflight)
        router._on_reply(reps[name], {"kind": "act_result", "req": rid, "gen": 1, **fields})
        forwarded()

    try:
        for i in range(4):
            router._admit(client, {"kind": "act", "req": 100 + i, "affinity": i,
                                   "obs": np.zeros((1, 2), np.float32)})
        forwarded()
        reply(1, shed=True)     # retry 1 on the other replica
        reply(1, error="boom")  # retry 2
        reply(1, shed=True)     # past the hedge budget: shed to the client
        reply(2, action=np.zeros(1, np.int32))
        router._on_reply(reps["r0"], {"kind": "act_result", "req": 2, "gen": 1})  # duplicate
        victim = next(n for n, r in reps.items() if 3 in r._inflight)
        router._on_replica_down(reps[victim], "link lost")  # re-dispatch 3 (and 4 if there)
        forwarded()
        for rid in (3, 4):
            reply(rid, action=np.zeros(1, np.int32))
        got = [(m["req"], bool(m.get("shed")), m.get("gen")) for m in client.drain(n=4)]
        stats = {k: v for k, v in router.stats().items() if k != "breaker"}
        return forwards, sorted(got), stats, router.breaker_states()
    finally:
        router.stop()


class _TelemetryShim:
    """The JAX router's telemetry module with ``record_event`` taking a
    ``kind`` field, so its give-up path runs to its end (see
    :func:`test_give_up_records_its_event_where_the_jax_router_raises`)."""

    def __init__(self, module) -> None:
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)

    def record_event(self, event, **fields):
        if "kind" in fields:
            fields["req_kind"] = fields.pop("kind")
        self._module.record_event(event, **fields)


def test_give_up_records_its_event_where_the_jax_router_raises():
    """The JAX router's ``_give_up`` passes ``kind=`` to ``record_event``,
    whose first parameter is ``kind``: it raises TypeError after the shed
    went out, which kills a replica reader on the hedge-budget path.  The
    port records the request's kind as ``req_kind``."""
    for mod in PACKAGES:
        router = _router(mod, 0)
        client = _FakeConn()
        p = mod._Pending(1, client, 9, {"kind": "act"}, "act", None, None)
        router._pending[1] = p
        try:
            if mod is jrouter:
                with pytest.raises(TypeError, match="kind"):
                    router._give_up(p, "no routable replica")
            else:
                router._give_up(p, "no routable replica")
                evt = telemetry.get_recorder().events("router_shed")[-1]
                assert evt["req_kind"] == "act" and evt["why"] == "no routable replica"
            assert client.drain(n=1) == [{"kind": "act_result", "req": 9, "shed": True}]
            assert router.shed == 1
        finally:
            router.stop()


def test_hedge_budget_and_dedup_match_jax(monkeypatch):
    monkeypatch.setattr(jrouter, "telemetry", _TelemetryShim(jrouter.telemetry))
    jax_trace, port_trace = _hedge_trace(jrouter), _hedge_trace(trouter)
    assert port_trace == jax_trace
    _, got, stats, _ = port_trace
    assert got == [(100, True, None), (101, False, 1), (102, False, 1), (103, False, 1)]
    assert stats["admitted"] == stats["answered"] + stats["shed"] + stats["orphaned"] == 4
    assert stats["duplicate_replies"] == 1 and stats["retries"] >= 3


def _rollout_trace(mod):
    router = _router(mod, 3, pushable=True, max_gen_skew=0)
    try:
        out = [router.rollout({"w": 1}, learner_step=5, learner_epoch=1)]
        out.append(router.rollout({"w": 2}, learner_step=6, learner_epoch=0))  # stale: refused
        router.replicas[1].generation = 0  # a laggard is held out of rotation
        p = mod._Pending(1, None, 1, {"kind": "act"}, "act", None, None)
        out.append(sorted({router._route(p).name for _ in range(20)}))
        router._catch_up(router.replicas[1])
        out.append([(r.name, r.generation, r.epoch) for r in router.replicas])
        stats = router.stats()
        out.append((stats["rollouts"], stats["stale_rollouts"], stats["learner_epoch"]))
        return out
    finally:
        router.stop()


def test_rollout_and_generation_guards_match_jax():
    assert _rollout_trace(trouter) == _rollout_trace(jrouter)


def test_router_latency_uses_the_digest_backend():
    router = trouter.ServingRouter()
    try:
        assert router._lat_hist.backend == "digest"
    finally:
        router.stop()


def test_live_router_accounting_is_exact_through_a_replica_stop():
    args = ImpalaArguments(use_lstm=False, hidden_size=32, max_timesteps=0)
    agent = ImpalaAgent(args, (8,), 4, device="cpu")
    servers = [InferenceServer(agent, ServingConfig(max_batch=8, max_wait_s=0.002))
               for _ in range(2)]
    for s in servers:
        s.start()
    router = trouter.ServingRouter(
        [trouter.connect_replica(s, f"replica{i}") for i, s in enumerate(servers)],
        trouter.RouterConfig(hedge_budget=2, seed=0))
    router.start()
    clients = []
    for _ in range(3):
        c_end, r_end = local_pair()
        router.add_client(r_end)
        clients.append(RemotePolicyClient(conn=c_end, request_timeout_s=WAIT_S))
    errors = []

    def traffic(c, n, seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(n):
                obs = rng.normal(size=(2, 8)).astype(np.float32)
                a, logits, _ = c.act(obs, np.zeros(2, np.int32), np.zeros(2, np.float32),
                                     np.zeros(2, bool), ())
                assert a.shape == (2,) and logits.shape == (2, 4)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=traffic, args=(c, 30, i), daemon=True)
               for i, c in enumerate(clients)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        servers[1].stop()  # a replica dies mid-traffic: its in-flight work re-dispatches
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads) and not errors
        deadline = time.monotonic() + WAIT_S
        while router.stats()["inflight"] > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = router.stats()
        assert stats["admitted"] == stats["answered"] + stats["shed"] + stats["orphaned"]
        assert stats["admitted"] >= 90 and stats["inflight"] == 0
        assert telemetry.get_registry().counter("router.requests").value >= 90
    finally:
        for c in clients:
            c.close()
        router.stop()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("n_up", [1, 2])
def test_tier_executor_scales_like_jax(n_up):
    def run(mod):
        router = _router(mod, 1)
        ex = mod.RouterTierExecutor(router, lambda i: mod.ReplicaHandle(f"s{i}", _FakeConn()),
                                    stop_replica=lambda h: h.conn.close())
        try:
            ex.scale_up(n_up)
            after_up = (ex.worker_count(), [r.name for r in router.replicas])
            ex.scale_down(1)
            return after_up, ex.worker_count(), [r.name for r in router.replicas]
        finally:
            router.stop()

    assert run(trouter) == run(jrouter)
