"""The port's actor fleet against the JAX package's (``scalerl_tpu/fleet``).

- ``FleetConfig``'s derived values;
- ``WorkerServer`` driven in-process by the same scripted gather messages in
  both packages (hello and roster, task batches, results with dedup keys, a
  duplicate, a respawn interleave, a disconnect with outstanding tasks, a
  task return, a drain, worker errors): the same replies, requeues, dropped
  duplicates and counters;
- ``Gather`` driven in-process by the same scripted worker and server
  frames: the same uplink, replies, acks, drain and task return;
- ``LocalCluster`` and ``RemoteCluster`` (localhost TCP) end to end with a
  deterministic runner in both packages: the same multiset of results;
- heartbeat loss of a silent peer, reconnect after a link cut, and a
  killed gather respawned, on the port;
- ``TelemetryAggregator`` trees, the compact snapshot, generation's
  ``masked_softmax``, discounted returns and chunk packing, the chaos
  victims of ``mass_kill`` and ``preempt``, and the tracing context of a
  task across both codecs.
"""

import copy
import multiprocessing as mp
import socket
import threading
import time

import numpy as np
import pytest
import torch
import torch_fleet_helpers as helpers

from scalerl_torch.fleet import cluster as tcluster
from scalerl_torch.fleet import framing as tframing
from scalerl_torch.fleet import generation as tgen
from scalerl_torch.runtime import chaos as tchaos
from scalerl_torch.runtime import telemetry as ttelemetry
from scalerl_torch.runtime import tracing as ttracing
from scalerl_tpu.fleet import cluster as jcluster
from scalerl_tpu.fleet import framing as jframing
from scalerl_tpu.fleet import generation as jgen
from scalerl_tpu.runtime import chaos as jchaos
from scalerl_tpu.runtime import telemetry as jtelemetry
from scalerl_tpu.runtime import tracing as jtracing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    ttelemetry.reset()
    jtelemetry.reset()
    yield
    ttelemetry.reset()
    jtelemetry.reset()


def _norm(tree):
    """Numpy leaves as lists, so replies compare with ``==``."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree.tolist()
    return tree


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("kw", [
    {}, {"num_workers": 1}, {"num_workers": 17, "workers_per_gather": 16},
    {"num_workers": 33, "workers_per_gather": 4, "task_prefetch": 3},
    {"heartbeat_interval_s": 0.5, "heartbeat_timeout_s": 0.0},
    {"heartbeat_interval_s": 2.0, "heartbeat_timeout_s": 7.0},
])
def test_fleet_config_derived_values_match_jax(kw):
    j, t = jcluster.FleetConfig(**kw), tcluster.FleetConfig(**kw)
    assert t.num_gathers == j.num_gathers
    assert [t.prefetch(w) for w in range(40)] == [j.prefetch(w) for w in range(40)]
    assert t.heartbeat_timeout == j.heartbeat_timeout
    assert {k: v for k, v in vars(t).items()} == {k: v for k, v in vars(j).items()}


# ---------------------------------------------------------------------------
# the server, scripted


def _res(wid, epoch, seq, tid=None, x=0):
    r = {"worker_id": wid, "upload_epoch": epoch, "episode_seq": seq, "x": x}
    if tid is not None:
        r["_task_id"] = tid
    return r


SERVER_SCRIPTS = {
    # at-least-once uploads: a resent batch is acked again and not recounted;
    # a respawned worker's fresh epoch is new data; keyless results pass
    "dedup_keys": [
        ("msg", "A", {"kind": "result_batch", "seq": 1,
                      "v": [_res(0, 99, 0, x=1), _res(0, 99, 1, x=2)]}),
        ("msg", "A", {"kind": "result_batch", "seq": 1,
                      "v": [_res(0, 99, 0, x=1), _res(0, 99, 1, x=2)]}),
        ("msg", "A", {"kind": "result_batch", "seq": 2, "v": [_res(0, 100, 0, x=3)]}),
        ("msg", "A", {"kind": "result_batch", "v": [{"x": 4}, {"x": 4}]}),
    ],
    # a slow duplicate of a dead gather's old epoch after its respawn's
    # fresh epoch stays a duplicate
    "respawn_interleave": [
        ("msg", "A", {"kind": "result_batch", "v": [_res(0, 1, 0), _res(0, 1, 1)]}),
        ("msg", "B", {"kind": "result_batch", "v": [_res(0, 2, 0)]}),
        ("msg", "A", {"kind": "result_batch", "v": [_res(0, 1, 1)]}),
        ("msg", "B", {"kind": "result_batch", "v": [_res(0, 2, 1)]}),
    ],
    # a dead link's outstanding tasks requeue with their ids; a task that
    # completed twice counts once; a drain's task return requeues
    "requeue_on_disconnect": [
        ("msg", "A", {"kind": "task_batch", "n": 2}),
        ("disconnect", "A", None),
        ("msg", "B", {"kind": "task_batch", "n": 2}),
        ("msg", "B", {"kind": "result_batch", "v": [_res(5, 7, 0, tid=0)]}),
        ("msg", "A", {"kind": "result_batch", "v": [_res(9, 8, 0, tid=0)]}),
        ("msg", "B", {"kind": "task_return", "v": "ISSUED_B_1"}),
        ("msg", "B", {"kind": "task_batch", "n": 1}),
        ("msg", "B", {"kind": "result_batch", "v": [_res(5, 7, 1, tid=1)]}),
        ("msg", "B", {"kind": "task_batch", "n": 4}),
    ],
    # the roster: hellos register ranges, drains take the newest first,
    # drain_done retires; weights go out on a params request
    "roster_and_drain": [
        ("msg", "A", {"kind": "gather_hello", "base_worker_id": 0, "num_workers": 2,
                      "gather_epoch": 11}),
        ("sleep", None, 0.01),
        ("msg", "B", {"kind": "gather_hello", "base_worker_id": 2, "num_workers": 2,
                      "gather_epoch": 22}),
        ("drain", None, 2),
        ("msg", "A", {"kind": "params", "have": -1}),
        ("msg", "A", {"kind": "params", "have": 1}),
        ("msg", "B", {"kind": "drain_done", "base_worker_id": 2}),
        ("drain", None, 4),
        ("disconnect", "A", None),
    ],
    # the error funnel is bounded; the total keeps the whole history
    "worker_errors": [
        ("msg", "A", {"kind": "worker_error",
                      "v": {"worker_id": i, "task": None, "error": f"boom-{i}"}})
        for i in range(12)
    ] + [("msg", "A", {"kind": "unknown_kind"})],
}


def _run_server_script(mod, script):
    script = copy.deepcopy(script)  # the server pops _task_id off results
    tasks = iter([{"seed": i} for i in range(1, 6)])
    server = mod.WorkerServer(mod.FleetConfig(num_workers=4), lambda: next(tasks, None),
                              worker_error_maxsize=8)
    server.publish({"w": np.arange(3, dtype=np.float32)})
    sent = []
    server.hub.send = lambda c, m, compress=False: sent.append((c, m))  # type: ignore
    issued = {}
    for op, conn, payload in script:
        if op == "msg":
            if payload.get("v") == "ISSUED_B_1":
                payload = dict(payload, v=[issued["B"][1]])
            server._handle(conn, payload)
            if payload["kind"] == "task_batch":
                issued[conn] = sent[-1][1]["v"]
        elif op == "disconnect":
            server._on_disconnect(conn)
        elif op == "drain":
            sent.append(("drain_covered", server.drain_workers(payload)))
        elif op == "sleep":
            time.sleep(payload)
    results = []
    while not server.results.empty():
        results.append(server.results.get_nowait())
    errors = []
    while not server.worker_errors.empty():
        errors.append(server.worker_errors.get_nowait()["error"])
    for _, m in sent:
        if isinstance(m, dict) and m.get("kind") == "drain":
            m.pop("t")  # the send time
    out = {
        "sent": _norm(sent),
        "results": _norm(results),
        "errors": errors,
        "roster": {c: {k: v for k, v in info.items() if k != "joined_t"}
                   for c, info in server.gather_links.items()},
        "outstanding": sorted(server._outstanding),
        "counters": {k: getattr(server, k) for k in (
            "total_results", "duplicate_results", "duplicate_tasks", "requeued_tasks",
            "dropped_results", "worker_errors_total", "worker_errors_dropped",
            "gathers_joined", "gathers_drained")},
        "live": (server.live_gather_count(), server.live_worker_count()),
    }
    server.stop()
    return out


@pytest.mark.parametrize("name", sorted(SERVER_SCRIPTS))
def test_worker_server_matches_jax_on_scripted_messages(name):
    want = _run_server_script(jcluster, SERVER_SCRIPTS[name])
    got = _run_server_script(tcluster, SERVER_SCRIPTS[name])
    assert got == want
    if name == "requeue_on_disconnect":
        assert got["counters"]["duplicate_tasks"] == 1
        assert got["counters"]["requeued_tasks"] == 3
        assert [r.get("_task_id") for r in got["results"]] == [None, None]
    if name == "respawn_interleave":
        assert got["counters"]["total_results"] == 4
        assert got["counters"]["duplicate_results"] == 1


def test_worker_server_binds_its_counters_and_the_fleet_tree():
    server = tcluster.WorkerServer(tcluster.FleetConfig(num_workers=1), lambda: None)
    server.hub.send = lambda c, m, compress=False: None  # type: ignore
    server._handle("A", {"kind": "result_batch", "seq": 1, "telem": None,
                         "v": [_res(0, 1, 0)]})
    server.telemetry.absorb_payload({"src": "gather:0", "v": {"gather.results": 3.0},
                                     "workers": {"0": {"worker.episodes": 5.0}}})
    snap = server.telemetry_snapshot()
    assert snap["server"]["total_results"] == 1
    assert snap["fleet"]["sources"] == 2
    assert snap["fleet"]["aggregate"] == {"gather.results": 3.0, "worker.episodes": 5.0}
    server.stop()


# ---------------------------------------------------------------------------
# the gather, scripted


class _ScriptedConn:
    """A server or worker link: records what it is sent; ``recv`` and
    ``poll`` serve scripted frames."""

    def __init__(self, frames=()):
        self.sent = []
        self.frames = list(frames)

    def send(self, msg, compress=False):
        self.sent.append(msg)

    def recv(self, timeout=None):
        if not self.frames:
            raise TimeoutError("script exhausted")
        return self.frames.pop(0)

    def poll(self, timeout=0.0):
        return bool(self.frames)

    def close(self):
        pass


def _run_gather_script(mod):
    cfg = mod.FleetConfig(num_workers=2, upload_batch=2, telemetry_piggyback=False)
    t1, t2, t3 = ({"role": "rollout", "seed": s, "_task_id": s} for s in (1, 2, 3))
    server = _ScriptedConn([
        {"kind": "ping", "t": 1.5},  # answered inside the rpc, then the reply
        {"kind": "task_batch", "v": [t1, t2, t3]},
        {"kind": "params", "version": 3, "weights": {"w": np.ones(2, np.float32)}},
        None,  # a worker at the cached version makes the gather ask again: current
    ])
    gather = mod.Gather(server, cfg, helpers.bandit_runner, base_worker_id=4, num_workers=0)
    worker = _ScriptedConn()
    steps = [
        {"kind": "task"},
        {"kind": "params", "have": -1, "want": 3},
        {"kind": "params", "have": 3, "want": 3},  # cached: nothing to send
        {"kind": "task"},
        {"kind": "result", "v": {"worker_id": 4, "episode_seq": 0, "x": 1, "_telem": {"a": 1.0}}},
        {"kind": "result", "v": {"worker_id": 4, "episode_seq": 1, "x": 2}},
        {"kind": "result", "v": {"worker_id": 5, "episode_seq": 0, "x": 3}},
        {"kind": "worker_error", "v": {"worker_id": 5, "error": "boom"}},
    ]
    for msg in steps:
        gather._handle(worker, msg)
    # unsolicited frames: an ack, a ping and a drain, pumped outside any rpc
    server.frames += [{"kind": "result_ack", "seq": 1}, {"kind": "ping", "t": 2.5},
                      {"kind": "drain"}]
    gather._pump_server()
    assert gather._drain_requested
    gather._begin_drain()
    gather._handle(worker, {"kind": "task"})  # a drained gather serves None
    gather._flush_results()
    for m in server.sent:
        if m.get("kind") == "gather_hello":
            m["gather_epoch"] = "nonce"
        if m.get("kind") == "pong":
            m.pop("rt")  # the responder's wall clock
            m.pop("host")
    return {"server": _norm(server.sent), "worker": _norm(worker.sent),
            "unacked": sorted(gather._unacked), "relayed_telemetry": gather._worker_telem,
            "draining": gather.draining}


def test_gather_matches_jax_on_scripted_frames():
    want = _run_gather_script(jcluster)
    got = _run_gather_script(tcluster)
    assert got == want
    kinds = [m["kind"] for m in got["server"]]
    assert kinds == ["gather_hello", "task_batch", "pong", "params", "params",
                     "result_batch", "worker_error", "pong", "task_return", "result_batch"]
    assert got["unacked"] == [2]


# ---------------------------------------------------------------------------
# clusters end to end


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _multiset(results):
    return sorted((r["seed"], round(r["reward"], 6), r["param_version"]) for r in results)


def _local_cluster_results(mod, n=8):
    config = mod.FleetConfig(num_workers=2, workers_per_gather=2, upload_batch=2)
    server = mod.WorkerServer(config, helpers.make_task_source(n, lambda: server.params.version))
    server.publish({"w": np.array([1.0, 2.0], np.float32)})
    server.start(listen=False)
    cluster = mod.LocalCluster(server, config, helpers.report_runner, mp_context="spawn")
    cluster.start()
    try:
        results = helpers.drain(server, n)
    finally:
        cluster.join(timeout=20.0)
        server.stop()
    return results, server


def test_local_cluster_end_to_end_matches_jax():
    got, server = _local_cluster_results(tcluster)
    want, _ = _local_cluster_results(jcluster)
    assert len(got) == 8 and _multiset(got) == _multiset(want)
    assert {r["seed"] for r in got} == set(range(1, 9))
    assert all(r["param_version"] == 1 for r in got)
    assert {r["worker_id"] for r in got} <= {0, 1}
    assert server.total_results == 8 and server.requeued_tasks == 0
    for r in got:  # the port's gathers and workers load no JAX and no CUDA
        assert r["cuda_initialized"] is False and "scalerl_torch" in r["modules"]
        assert not {"jax", "jaxlib", "flax", "optax", "scalerl_tpu"} & set(r["modules"])


def _remote_cluster_results(mod, n=6):
    config = mod.FleetConfig(num_workers=2, workers_per_gather=2, upload_batch=1,
                             entry_port=_free_port(), worker_port=_free_port())
    server = mod.WorkerServer(config, helpers.make_task_source(n, lambda: server.params.version))
    server.publish({"w": np.array([0.5, 0.5], np.float32)})
    server.start(listen=True)
    remote = mod.RemoteCluster(config, helpers.bandit_runner, mp_context="spawn")
    remote.start()
    try:
        results = helpers.drain(server, n)
    finally:
        remote.join(timeout=20.0)
        server.stop()
    return results, server


def test_remote_cluster_over_localhost_tcp_matches_jax():
    got, server = _remote_cluster_results(tcluster)
    want, _ = _remote_cluster_results(jcluster)
    assert len(got) == 6 and _multiset(got) == _multiset(want)
    assert all(abs(r["reward"] - 1.0) < 1e-6 for r in got)
    assert server.total_results == 6


def test_entry_handshake_hands_out_ranges_and_the_learner_policy():
    config = tcluster.FleetConfig(num_workers=3, entry_port=_free_port(),
                                  worker_port=_free_port(), heartbeat_interval_s=0.7,
                                  extra={"k": 1})
    server = tcluster.WorkerServer(config, lambda: None)
    server.start(listen=True)
    try:
        remote = tcluster.RemoteCluster(config, helpers.bandit_runner, num_workers=3)
        assert remote.entry()[0] == 0
        base, cfg = remote.entry()
        assert base == 3 and cfg["heartbeat_interval_s"] == 0.7 and cfg["extra"] == {"k": 1}
        adopted = remote._adopt(cfg)
        assert adopted.workers_per_gather == config.workers_per_gather
    finally:
        server.stop()


def test_killed_gather_is_respawned_and_results_keep_flowing():
    config = tcluster.FleetConfig(num_workers=2, workers_per_gather=2, upload_batch=1)
    server = tcluster.WorkerServer(
        config, helpers.make_task_source(40, lambda: server.params.version))
    server.publish({"w": np.array([1.0, 2.0], np.float32)})
    server.start(listen=False)
    cluster = tcluster.LocalCluster(server, config, helpers.slow_bandit_runner,
                                    mp_context="spawn", max_restarts=2)
    cluster.start()
    try:
        assert len(helpers.drain(server, 3)) == 3
        cluster.procs[0].terminate()
        cluster.procs[0].join(timeout=10.0)
        post = helpers.drain(server, 8)
        assert len(post) == 8, f"only {len(post)} results after the gather was killed"
        assert cluster.restarts >= 1
        assert all(r["param_version"] == 1 for r in post)
    finally:
        cluster.join(timeout=20.0)
        server.stop()


def test_heartbeat_drops_a_silent_peer_and_keeps_a_responsive_one():
    config = tcluster.FleetConfig(num_workers=1, heartbeat_interval_s=0.2)
    server = tcluster.WorkerServer(config, helpers.make_task_source(0))
    server.start(listen=False)
    from scalerl_torch.fleet.transport import PipeConnection

    a_parent, a_child = mp.Pipe(duplex=True)
    silent = PipeConnection(a_child)
    server.add_gather_connection(PipeConnection(a_parent))
    silent.send({"kind": "task_batch", "n": 1})
    assert silent.recv(timeout=10.0)["kind"] == "task_batch"
    b_parent, b_child = mp.Pipe(duplex=True)
    responsive = PipeConnection(b_child)
    server.add_gather_connection(PipeConnection(b_parent))
    responsive.send({"kind": "task_batch", "n": 1})
    assert responsive.recv(timeout=10.0)["kind"] == "task_batch"
    stop = threading.Event()

    def pong_pump():
        while not stop.is_set():
            try:
                if responsive.poll(0.05):
                    msg = responsive.recv()
                    if isinstance(msg, dict) and msg.get("kind") == "ping":
                        responsive.send({"kind": "pong", "t": msg.get("t", 0.0)})
            except (EOFError, OSError):
                return

    pump = threading.Thread(target=pong_pump, daemon=True)
    pump.start()
    try:
        err = server.worker_errors.get(timeout=30.0)
        assert "heartbeat" in err["error"]
        deadline = time.monotonic() + 5.0
        while server.hub.connection_count() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.hub.connection_count() == 1
        assert server.worker_errors.empty()
    finally:
        stop.set()
        pump.join(timeout=2.0)
        server.stop()


def test_remote_gathers_reconnect_after_a_link_cut():
    config = tcluster.FleetConfig(num_workers=2, workers_per_gather=2, upload_batch=1,
                                  entry_port=_free_port(), worker_port=_free_port(),
                                  heartbeat_interval_s=0.2, reconnect_backoff_s=0.05,
                                  reconnect_backoff_cap_s=0.5, max_reconnects=10)
    server = tcluster.WorkerServer(
        config, helpers.make_task_source(40, lambda: server.params.version))
    server.publish({"w": np.array([1.0, 2.0], np.float32)})
    server.start(listen=True)
    remote = tcluster.RemoteCluster(config, helpers.slow_bandit_runner, mp_context="spawn")
    remote.start()
    try:
        assert len(helpers.drain(server, 3)) == 3
        with server.hub._lock:
            conns = list(server.hub._conns)
        assert conns, "no gather link established"
        for c in conns:
            server.hub.disconnect(c)
        post = helpers.drain(server, 8)
        assert len(post) == 8, f"only {len(post)} results after the link cut"
        assert all(r["param_version"] == 1 for r in post)
        assert server.gathers_joined >= 2  # the re-announce after the reconnect
    finally:
        remote.join(timeout=20.0)
        server.stop()


# ---------------------------------------------------------------------------
# telemetry aggregation


def _absorb_all(mod, max_sources):
    agg = mod.TelemetryAggregator(max_sources=max_sources)
    rng = np.random.default_rng(0)
    for i in range(12):
        agg.absorb_payload({
            "src": f"gather:{i % 5}",
            "v": {"gather.results": float(i), "gather.uploads": float(rng.integers(9)),
                  "flag": True, "name": "x"},
            "workers": {str(w): {"worker.episodes": float(rng.integers(20)),
                                 "worker.episodes_per_s.rate": float(rng.random())}
                        for w in range(i % 3)},
        })
    agg.absorb_payload("garbage")
    agg.absorb("worker:7", "not a mapping")
    return agg


@pytest.mark.parametrize("max_sources", [0, 4])
def test_telemetry_aggregator_tree_matches_jax(max_sources):
    j = _absorb_all(jtelemetry, max_sources)
    t = _absorb_all(ttelemetry, max_sources)
    jt, tt = j.tree(), t.tree()
    for tree in (jt, tt):
        for snap in tree["per_worker"].values():
            snap.pop("age_s")
    assert tt == jt
    assert t.sources() == j.sources()
    assert t.aggregate() == j.aggregate()


def test_telemetry_aggregator_evicts_stale_sources_as_jax_does(monkeypatch):
    for mod in (jtelemetry, ttelemetry):
        clock = {"t": 100.0}
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock["t"])
        agg = mod.TelemetryAggregator()
        agg.absorb("gather:0", {"a": 1.0})
        clock["t"] = 105.0
        agg.absorb("gather:1", {"a": 2.0})
        clock["t"] = 107.5
        assert agg.tree()["per_worker"]["gather:0"]["age_s"] == 7.5
        assert agg.evict_stale(5.0) == 1
        assert agg.sources() == ["gather:1"] and agg.evicted == 1


def test_compact_snapshot_matches_jax():
    regs = []
    for mod in (jtelemetry, ttelemetry):
        reg = mod.MetricsRegistry()
        reg.counter("worker.episodes").inc(3)
        reg.gauge("gather.live").set(2.0)
        h = reg.histogram("lat")
        for v in (1.0, 2.0, 5.0):
            h.observe(v)
        reg.bind("server", lambda: {"total_results": 4, "param_version": 2})
        regs.append(reg.compact())
    want, got = regs
    assert got == want
    assert "lat.count" in got and "lat.p95" not in got and "lat.sum" not in got


# ---------------------------------------------------------------------------
# generation


def test_masked_softmax_and_discounted_returns_match_jax_exactly():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        logits = (rng.normal(size=n) * 10).astype(np.float32)
        legal = sorted(rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False))
        np.testing.assert_array_equal(tgen.masked_softmax(logits, legal),
                                      jgen.masked_softmax(logits, legal))
    for gamma in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        for T in (0, 1, 63, 64, 65, 257):
            r = rng.normal(size=T).astype(np.float32)
            np.testing.assert_array_equal(tgen.discounted_returns(r, gamma),
                                          jgen.discounted_returns(r, gamma))
    r = rng.normal(size=100).astype(np.float32)
    np.testing.assert_array_equal(tgen.discounted_returns(r, 0.9, block=7),
                                  jgen.discounted_returns(r, 0.9, block=7))


class _Line3:
    """3-cell line game: players alternate claiming cells; more cells wins."""

    def reset(self, seed=None):
        self.board = np.zeros(3, np.int8)
        self.current = 0
        self.moves = 0

    def players(self):
        return [0, 1]

    def turn(self):
        return self.current

    def terminal(self):
        return self.moves >= 3

    def observation(self, player):
        return self.board.astype(np.float32)

    def legal_actions(self, player):
        return [i for i in range(3) if self.board[i] == 0]

    def play(self, action):
        self.board[action] = self.current + 1
        self.current = 1 - self.current
        self.moves += 1

    def outcome(self):
        c = [(self.board == 1).sum(), (self.board == 2).sum()]
        return {0: float(np.sign(c[0] - c[1])), 1: float(np.sign(c[1] - c[0]))}


def _policy(weights, obs, player):
    return np.asarray([0.3, -0.2, 0.1], np.float32) * (player + 1) + obs


@pytest.mark.parametrize("chunk_len,greedy", [(2, False), (4, False), (1, True)])
def test_episode_generator_matches_jax_exactly(chunk_len, greedy):
    outs = [mod.EpisodeGenerator(_Line3(), _policy, num_actions=3, gamma=0.9,
                                 chunk_len=chunk_len).generate(None, seed=5, greedy=greedy)
            for mod in (jgen, tgen)]
    assert _norm(outs[1]) == _norm(outs[0])
    rng = np.random.default_rng(1)
    episode = {"obs": rng.normal(size=(5, 3)).astype(np.float32),
               "action": rng.integers(0, 3, 5).astype(np.int32),
               "probs": rng.random((5, 3)).astype(np.float32),
               "player": np.array([0, 1, 0, 1, 0], np.int32),
               "returns": rng.normal(size=5).astype(np.float32), "length": 5}
    packed = [mod.EpisodeGenerator(_Line3(), _policy, 3, chunk_len=chunk_len)._chunk(episode)
              for mod in (jgen, tgen)]
    assert _norm(packed[1]) == _norm(packed[0])


# ---------------------------------------------------------------------------
# chaos waves and tracing context


class _FakeProc:
    def __init__(self):
        self.alive = True

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive = False


@pytest.mark.parametrize("plan", ["7:mass_kill=0.5@3,kills=2", "11:mass_kill=0.3",
                                  "3:preempt=0.4@2"])
def test_chaos_waves_pick_the_same_victims_in_both_packages(monkeypatch, plan):
    monkeypatch.setenv("SCALERL_CHAOS", plan)
    picks = []
    for chaos_mod, mod in ((jchaos, jcluster), (tchaos, tcluster)):
        chaos_mod.clear()
        procs = [_FakeProc() for _ in range(8)]
        seq = []
        for _ in range(12):
            seq.append(mod.apply_mass_kill(procs, site="fleet"))
            seq.append(mod.apply_preempt(procs, site="fleet"))
        picks.append(seq)
        chaos_mod.clear()
    assert picks[1] == picks[0]
    assert any(p for p in picks[0])


def test_task_trace_context_survives_both_codecs(monkeypatch):
    monkeypatch.setenv("SCALERL_TRACE_SAMPLE", "1.0")
    ttracing.reset()
    jtracing.reset()
    try:
        for server_mod, own, pack, unpack, extract in (
                (tcluster, ttracing, tframing.pack_message, jframing.unpack_message,
                 jtracing.extract),
                (jcluster, jtracing, jframing.pack_message, tframing.unpack_message,
                 ttracing.extract)):
            server = server_mod.WorkerServer(server_mod.FleetConfig(num_workers=1),
                                             lambda: {"seed": 1})
            sent = []
            server.hub.send = lambda c, m, compress=False: sent.append(m)  # type: ignore
            server._handle("A", {"kind": "task_batch", "n": 1})
            task = sent[-1]["v"][0]
            assert "trace" in task
            wire = unpack(pack({"kind": "task_batch", "v": [task]}, compress=True))
            ctx = extract(wire["v"][0])
            sent_ctx = own.extract(task)
            assert ctx is not None and sent_ctx is not None
            assert (ctx.trace_id, ctx.span_id) == (sent_ctx.trace_id, sent_ctx.span_id)
            server.stop()
    finally:
        monkeypatch.delenv("SCALERL_TRACE_SAMPLE")
        ttracing.reset()
        jtracing.reset()
