"""Parity of the port's connection hub and job executor
(``scalerl_torch/fleet/hub.py``) with the JAX package's.

- Bounded admission: the same burst against ``max_pending`` sheds the same
  count in both hubs and delivers the same freshest messages in order;
- a corrupt frame is rejected and the link dropped (``on_disconnect``) in
  both;
- the liveness plane: the hub pings a peer that answers, swallows the pong
  (no consumer sees a heartbeat) and feeds the tracer's clock-skew
  estimator; a peer that never answers is dropped through ``on_dead``;
  a peer's ping is answered by the hub;
- ``JobExecutor`` squares the same jobs over two pipe workers in both
  packages.

Every wait has its own timeout.
"""

import multiprocessing as mp
import queue
import time

import pytest

from scalerl_torch.fleet import hub as thub
from scalerl_torch.fleet import transport as ttransport
from scalerl_torch.runtime import supervisor as tsup
from scalerl_torch.runtime import telemetry as ttel
from scalerl_torch.runtime import tracing as ttr
from scalerl_tpu.fleet import hub as jhub
from scalerl_tpu.fleet import transport as jtransport

WAIT_S = 20.0
PAIRS = [(jhub, jtransport), (thub, ttransport)]


def _wait(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _pipe(transport):
    a, b = mp.Pipe(duplex=True)
    return transport.PipeConnection(a), transport.PipeConnection(b)


def _shed_run(hub_mod, transport):
    hub = hub_mod.QueueHub(max_pending=3)
    mine, theirs = _pipe(transport)
    hub.add_connection(mine)
    try:
        for i in range(9):
            theirs.send({"kind": "x", "i": i})
        assert _wait(lambda: hub.shed_total >= 6)
        got = [hub.recv(timeout=WAIT_S)[1]["i"] for _ in range(3)]
        with pytest.raises(queue.Empty):
            hub.recv(timeout=0.2)
        return hub.shed_total, got
    finally:
        hub.close()


def test_bounded_admission_sheds_like_jax():
    runs = [_shed_run(*p) for p in PAIRS]
    assert runs[1] == runs[0] == (6, [6, 7, 8])


def _corrupt_run(hub_mod, transport):
    gone = []
    hub = hub_mod.QueueHub(on_disconnect=gone.append)
    mine, theirs = _pipe(transport)
    hub.add_connection(mine)
    try:
        theirs.send({"kind": "ok"})
        first = hub.recv(timeout=WAIT_S)[1]
        theirs.conn.send_bytes(b"\x00garbage-that-is-no-frame")
        assert _wait(lambda: hub.connection_count() == 0)
        return first, hub.protocol_errors, len(gone), gone[0] is mine
    finally:
        hub.close()


def test_a_corrupt_frame_drops_the_link_like_jax():
    runs = [_corrupt_run(*p) for p in PAIRS]
    assert runs[1] == runs[0] == ({"kind": "ok"}, 1, 1, True)


def test_liveness_pings_pongs_and_skew_samples():
    ttr.reset()
    dead = []
    hub = thub.QueueHub(heartbeat_interval=0.05, heartbeat_timeout=0.3,
                        first_contact_grace=0.3, on_dead=lambda c, why: dead.append(why))
    live, live_peer = _pipe(ttransport)
    silent, _silent_peer = _pipe(ttransport)
    hub.add_connection(live)
    hub.add_connection(silent)
    try:
        # the live peer answers every ping the way a client's reader does
        pings = 0
        deadline = time.monotonic() + WAIT_S
        while pings < 3 and time.monotonic() < deadline:
            try:
                msg = live_peer.recv(timeout=0.5)
            except TimeoutError:
                continue
            if tsup.is_heartbeat(msg) and msg["kind"] == "ping":
                live_peer.send(dict(tsup.make_pong(msg), host="peer-host"))
                pings += 1
        assert pings == 3
        assert _wait(lambda: ttr.get_skew().samples("peer-host") >= 2)
        assert _wait(lambda: len(dead) == 1) and "heartbeat timeout" in dead[0]
        assert hub.peers_dropped == 1 and hub.connection_count() == 1
        # a ping from the peer is answered in the pump; the consumer sees
        # only real traffic
        live_peer.send(tsup.make_ping())
        live_peer.send({"kind": "act", "req": 1})
        assert hub.recv(timeout=WAIT_S)[1] == {"kind": "act", "req": 1}
        pong = None
        deadline = time.monotonic() + WAIT_S
        while pong is None and time.monotonic() < deadline:
            msg = live_peer.recv(timeout=WAIT_S)
            if msg.get("kind") == "pong":
                pong = msg
            elif msg.get("kind") == "ping":
                live_peer.send(tsup.make_pong(msg))
        assert pong is not None and pong["host"] == ttel.host_id()
    finally:
        hub.close()


def _square_worker(conn, idx):
    while True:
        job = conn.recv()
        if job is None:
            return
        conn.send({"out": job["x"] ** 2, "worker": idx})


@pytest.mark.parametrize("pair", [0, 1], ids=["jax", "port"])
def test_job_executor_squares_the_jobs(pair, monkeypatch):
    from scalerl_torch.utils import platform

    # JAX is live in this process: its workers spawn, as the JAX package's do
    monkeypatch.setattr(platform, "safe_mp_context", lambda requested=None: "spawn")
    hub_mod, _ = PAIRS[pair]
    ex = hub_mod.JobExecutor(_square_worker, iter([{"x": i} for i in range(8)]), num_workers=2,
                             postprocess=lambda r: r["out"])
    ex.start()
    try:
        got = sorted(ex.results.get(timeout=60.0) for _ in range(8))
    finally:
        ex.shutdown(timeout=5.0)
    assert got == [i * i for i in range(8)]
