"""The disaggregated sequence-RL dataflow (``genrl/disagg.py``) and
``DisaggSequenceRLTrainer`` against the JAX package.

- The learner endpoint and the generation-host shell are driven by the
  same scripted frames in both packages: every reply and every frame sent
  must be equal (leases and their task ids, requeues, dropped duplicates,
  welcome epochs, acks, drains), and so must the counters and the saved
  ledger state.
- Both packages' thread fleets over the same lease source deliver the same
  multiset of payloads, and so does the port's fleet of spawned host
  processes (which load no JAX and never initialise CUDA).
- A seeded ``mass_kill`` wave mid-decode, a learner restart from the
  ledger and a host killed during that restart each close the accounting
  exactly: every lease answered once, payloads bit-exact.
- The trainer: ``_WireCompletion`` packing equals JAX's, three rounds end to
  end on real engines, ``save_resume`` and the preemption guard's safe
  point resume bit-exact under a bumped epoch, and one ``bf16_params``
  learn step against JAX's.

Every join and queue wait carries a timeout.
"""

import copy
import json
import multiprocessing as mp
import os
import sys
import threading
import time
from collections import Counter, deque

import numpy as np
import pytest
import torch

from scalerl_torch.fleet.transport import PipeConnection
from scalerl_torch.genrl import disagg as tdisagg
from scalerl_torch.runtime import chaos, telemetry
from scalerl_torch.runtime.supervisor import PreemptionGuard
from scalerl_tpu.fleet.transport import PipeConnection as JaxPipeConnection
from scalerl_tpu.genrl import disagg as jdisagg
from tests import torch_fleet_helpers as helpers

torch.set_num_threads(1)

PACKAGES = {"port": (tdisagg, PipeConnection), "jax": (jdisagg, JaxPipeConnection)}


def _lease_source(n_leases, start=1):
    counter = {"i": start - 1}
    lock = threading.Lock()

    def source():
        with lock:
            if counter["i"] >= start - 1 + n_leases:
                return None
            counter["i"] += 1
            return {"seed": counter["i"], "length": 4}

    return source


def _weights():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32)}


def _collect(learner_ref, n, deadline_s=60.0):
    seqs = []
    deadline = time.monotonic() + deadline_s
    while len(seqs) < n and time.monotonic() < deadline:
        s = learner_ref().get_sequence(timeout=0.2)
        if s is not None:
            seqs.append(s)
    return seqs


def _norm(x):
    """A comparable form of a frame: arrays as (dtype, shape, values),
    tuples as lists, host-local trace stamps dropped."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k not in ("trace", "_t_q")}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _key(seq):
    return (seq["seed"], seq.get("sample_idx", 0), seq["prompt"].tobytes(),
            seq["response_tokens"].tobytes(), seq["behavior_logp"].tobytes(),
            seq["values"].tobytes(), seq["generation"])


def _assert_scripted(seqs, response_len, vocab=32):
    for s in seqs:
        expect = tdisagg.scripted_sequence_payload(s["seed"], response_len, vocab, s["generation"],
                                                   sample=s.get("sample_idx", 0))
        for key in ("prompt", "response_tokens", "behavior_logp", "values"):
            np.testing.assert_array_equal(s[key], expect[key])


# ---------------------------------------------------------------------------
# the learner endpoint and the host shell, driven by the same scripted frames


def _payload(pkg, seed, tid, host, epoch, seq_id, **kw):
    p = dict(pkg.scripted_sequence_payload(seed, 4, 16, 1))
    p.update(host_id=host, host_epoch=epoch, seq_id=seq_id, _task_id=tid, learner_epoch=1, **kw)
    return p


def _drive_learner(name, tmp_path):
    pkg, Pipe = PACKAGES[name]
    path = str(tmp_path / name / "ledger")
    learner = pkg.SequenceLearner(pkg.DisaggConfig(num_hosts=2, heartbeat_interval_s=0.0),
                                  _lease_source(6), ledger_path=path)
    learner.publish(_weights(), learner_step=0)
    conns = [Pipe(mp.Pipe(duplex=True)[0]) for _ in range(2)]
    sent = []
    learner.hub.send = lambda conn, msg, compress=False: sent.append(
        (conns.index(conn), compress, _norm(msg)))
    for c in conns:
        learner.hub.add_connection(c)
    script = [
        (0, {"kind": "gen_hello", "host_id": 0, "host_epoch": 11, "lanes": 2}),
        (1, {"kind": "gen_hello", "host_id": 1, "host_epoch": 12, "lanes": 3}),
        (0, {"kind": "lease", "n": 2, "have_gen": -1}),
        (1, {"kind": "lease", "n": 2, "have_gen": -1}),
        (0, {"kind": "params", "have": -1}),
        (1, {"kind": "params", "have": 1}),
        (0, {"kind": "seq_batch", "seq": 1, "v": [_payload(pkg, 1, 0, 0, 11, 0)]}),
        (0, {"kind": "seq_batch", "seq": 1, "v": [_payload(pkg, 1, 0, 0, 11, 0)]}),
        (1, {"kind": "seq_batch", "seq": 1,
             "v": [_payload(pkg, 1, 0, 1, 12, 0), _payload(pkg, 3, 2, 1, 12, 1)]}),
        (1, {"kind": "lease_return", "v": [{"seed": 4, "length": 4, "_task_id": 3}]}),
        ("disconnect", 0),
        (1, {"kind": "lease", "n": 4, "have_gen": 1}),
        (1, {"kind": "seq_batch", "seq": 2, "v": [
            _payload(pkg, 2, 1, 1, 12, 2, _sample_idx=0, _samples_total=1)]}),
        (1, {"kind": "bogus"}),
    ]
    for who, msg in script:
        if who == "disconnect":
            learner.hub.disconnect(conns[msg])
        else:
            learner._handle(conns[who], msg)
    queued = []
    while (s := learner.get_sequence(timeout=0.01)) is not None:
        queued.append(_norm(s))
    counters = {k: getattr(learner, k) for k in (
        "total_sequences", "duplicate_sequences", "duplicate_leases", "requeued_leases",
        "hosts_joined", "hosts_drained", "dropped_sequences", "snapshot_wire_bytes",
        "learner_epoch", "generation")}
    counters["live_hosts"] = learner.live_host_count()
    counters["live_lanes"] = learner.live_lane_count()
    counters["outstanding"] = sorted(learner._outstanding)
    learner._handle(conns[1], {"kind": "drain_done", "host_id": 1})
    counters["hosts_drained_after"] = learner.hosts_drained
    learner.stop()
    learner.save_ledger()
    state = _norm(learner.ledger_state())
    resumed = pkg.SequenceLearner(pkg.DisaggConfig(num_hosts=2, heartbeat_interval_s=0.0),
                                  _lease_source(0), ledger_path=path)
    restored = dict(epoch=resumed.learner_epoch, reissued=resumed.resumed_sequences_reissued,
                    returned=_norm(list(resumed._returned)), generation=resumed.generation)
    redelivery = _payload(pkg, 3, 2, 1, 12, 1)
    resumed._ingest([redelivery])
    restored["resume_dups"] = resumed.resumed_duplicates_dropped
    resumed.stop()
    return sent, queued, counters, state, restored


def test_learner_answers_scripted_frames_like_jax(tmp_path):
    got = _drive_learner("port", tmp_path)
    want = _drive_learner("jax", tmp_path)
    for part, g, w in zip(("replies", "queued", "counters", "ledger", "restored"), got, want):
        assert g == w, part
    sent, queued, counters, _, restored = got
    assert counters["duplicate_sequences"] == 1 and counters["duplicate_leases"] == 1
    assert counters["requeued_leases"] == 2 and len(queued) == 3
    assert [m["kind"] for _, _, m in sent][:2] == ["gen_welcome", "gen_welcome"]
    assert restored["epoch"] == 2 and restored["resume_dups"] == 1


class _ScriptedLink:
    """A learner answering a host's frames from a fixed script: a welcome,
    one int8 snapshot, leases from a list (then None), an ack per upload.
    ``drain_after`` leases in, it sends a drain; ``break_upload`` makes
    that upload's first send fail like a dropped link."""

    def __init__(self, pkg, leases, drain_after=None, break_upload=None):
        self.inbox = deque()
        self.sent = []
        self.leases = deque(leases)
        self.wire = pkg.quantize_wire_tree(_weights(), "int8")
        self.drain_after = drain_after
        self.break_upload = break_upload
        self.issued = 0

    def send(self, msg, compress=False):
        kind = msg.get("kind")
        if kind == "seq_batch" and msg["seq"] == self.break_upload:
            self.break_upload = None
            raise ConnectionError("link dropped")
        self.sent.append((compress, _norm(msg)))
        if kind == "gen_hello":
            self.inbox.append({"kind": "gen_welcome", "epoch": 3, "gen": 1})
        elif kind == "params":
            reply = {"kind": "params", "generation": 1, "epoch": 3}
            if msg["have"] != 1:
                reply["weights"] = copy.deepcopy(self.wire)
            self.inbox.append(reply)
        elif kind == "lease":
            out = []
            for _ in range(msg["n"]):
                out.append(copy.deepcopy(self.leases.popleft()) if self.leases else None)
                if out[-1] is None:
                    break
            self.issued += len(out)
            self.inbox.append({"kind": "lease", "v": out, "gen": 1, "epoch": 3})
            if self.drain_after is not None and self.issued >= self.drain_after:
                self.drain_after = None
                self.inbox.append({"kind": "drain"})
        elif kind == "seq_batch":
            self.inbox.append({"kind": "seq_ack", "seq": msg["seq"]})

    def recv(self, timeout=None):
        if not self.inbox:
            raise EOFError("no frame")
        return self.inbox.popleft()

    def poll(self, timeout=0.0):
        return bool(self.inbox)

    def close(self):
        pass


@pytest.mark.parametrize("fault", [None, "drain", "reconnect"])
def test_generation_host_sends_the_frames_jax_sends(monkeypatch, fault):
    monkeypatch.setattr(os, "urandom", lambda n: b"\x00\x00\x00\x07")
    leases = [{"seed": s, "length": 4, "_task_id": 40 + s} for s in range(1, 10)]
    leases[2]["samples"] = 2
    runs = {}
    for name, (pkg, _) in PACKAGES.items():
        link = _ScriptedLink(pkg, leases, drain_after=4 if fault == "drain" else None,
                             break_upload=2 if fault == "reconnect" else None)
        cfg = pkg.DisaggConfig(num_hosts=1, lanes_per_host=3, upload_batch=2, ack_timeout_s=1.0,
                               reconnect_backoff_s=0.0)
        host = pkg.GenerationHost(link, cfg, pkg.ScriptedEngineFactory(lanes=3, response_len=5,
                                                                      tokens_per_step=2),
                                  host_id=4, reconnect=lambda: link)
        done = threading.Event()
        thread = threading.Thread(target=lambda: (host.run(), done.set()), daemon=True)
        thread.start()
        thread.join(timeout=30.0)
        assert done.is_set(), f"{name} host did not finish"
        runs[name] = (link.sent, host.learner_epoch, host._seq_id, host._upload_seq,
                      sorted(host._unacked))
    assert runs["port"] == runs["jax"]
    kinds = [m["kind"] for _, m in runs["port"][0]]
    assert kinds[0] == "gen_hello" and runs["port"][1] == 3
    if fault == "drain":
        assert kinds[-1] == "drain_done"
    if fault == "reconnect":
        assert kinds.count("gen_hello") == 2


# ---------------------------------------------------------------------------
# fleets over the pipe wire


def _run_fleet(pkg, n, use_threads, factory, samples=1, join_s=10.0, **fleet_kw):
    """``n`` leases through a fleet of two hosts; returns the accepted
    sequences.  The JAX thread hosts outlive their fleet (they spend their
    reconnect budget, as daemon threads), so the JAX run joins briefly."""
    source = _lease_source(n)
    if samples > 1:
        base = source

        def source():
            lease = base()
            if lease is not None:
                lease["samples"] = samples
            return lease

    cfg = pkg.DisaggConfig(num_hosts=2, lanes_per_host=3, upload_batch=2, heartbeat_interval_s=0.5)
    learner = pkg.SequenceLearner(cfg, source)
    learner.start()
    assert learner.publish(_weights(), learner_step=0) == 1
    fleet = pkg.LocalGenerationFleet(learner, cfg, factory, use_threads=use_threads,
                                     mp_context="spawn", **fleet_kw)
    fleet.start()
    try:
        seqs = _collect(lambda: learner, n * samples, deadline_s=120.0)
    finally:
        learner.stop()
        fleet.join(timeout=join_s)
    assert len(seqs) == n * samples
    assert learner.duplicate_sequences == learner.duplicate_leases == 0
    return seqs


def test_thread_fleets_deliver_the_jax_multiset_of_payloads():
    n = 24
    port = _run_fleet(tdisagg, n, True, tdisagg.ScriptedEngineFactory(lanes=3, response_len=6))
    jax_ = _run_fleet(jdisagg, n, True, jdisagg.ScriptedEngineFactory(lanes=3, response_len=6),
                      join_s=1.0)
    assert Counter(map(_key, port)) == Counter(map(_key, jax_))
    assert len({s["lease_id"] for s in port}) == n
    assert all(s["generation"] == 1 and s["host_id"] in (0, 1) for s in port)
    _assert_scripted(port, 6)


def test_process_fleet_delivers_the_same_payloads_and_loads_no_jax():
    n = 16
    seqs = _run_fleet(tdisagg, n, False, helpers.ReportingScriptedFactory(lanes=3, response_len=6))
    threads = _run_fleet(tdisagg, n, True, tdisagg.ScriptedEngineFactory(lanes=3, response_len=6))
    assert Counter(map(_key, seqs)) == Counter(map(_key, threads))
    for s in seqs:
        assert s["cuda_initialized"] is False
        assert not set(s["modules"]) & {"jax", "jaxlib", "flax", "optax", "scalerl_tpu"}


def test_group_fanout_accounts_every_sample_once():
    n, spp = 8, 3
    seqs = _run_fleet(tdisagg, n, True, tdisagg.ScriptedEngineFactory(lanes=6, response_len=6),
                      samples=spp)
    groups = {}
    for s in seqs:
        groups.setdefault(s["lease_id"], set()).add(s["sample_idx"])
    assert len(groups) == n and all(v == set(range(spp)) for v in groups.values())
    _assert_scripted(seqs, 6)


def test_drain_protocol_loses_no_sequence():
    n = 24
    cfg = tdisagg.DisaggConfig(num_hosts=2, lanes_per_host=2, upload_batch=1,
                               heartbeat_interval_s=0.5)
    learner = tdisagg.SequenceLearner(cfg, _lease_source(n))
    learner.start()
    learner.publish(_weights(), learner_step=0)
    fleet = tdisagg.LocalGenerationFleet(
        learner, cfg, tdisagg.ScriptedEngineFactory(lanes=2, response_len=8, tokens_per_step=1,
                                                    step_sleep_s=0.01), use_threads=True)
    fleet.start()
    try:
        warm = _collect(lambda: learner, 4)
        assert len(warm) == 4
        assert learner.drain_hosts(1) == 1
        seqs = warm + _collect(lambda: learner, n - 4)
        assert len(seqs) == n and len({s["lease_id"] for s in seqs}) == n
        deadline = time.monotonic() + 20.0
        while learner.hosts_drained < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert learner.hosts_drained == 1 and learner.live_host_count() == 1
    finally:
        learner.stop()
        fleet.join(timeout=10.0)
    assert telemetry.get_recorder().events("drain_request")


def test_mass_kill_wave_mid_decode_closes_the_accounting(monkeypatch):
    """A seeded wave kills half of four spawned hosts mid-decode: their
    leases requeue, the autoscaler's floor rule backfills through
    ``GenerationTierExecutor``, and every lease is answered once with its
    scripted payload."""
    from scalerl_torch.runtime.autoscaler import Autoscaler, AutoscalerConfig

    monkeypatch.setenv(chaos.ENV_VAR, "777:mass_kill=1.0@1")
    chaos.clear()
    n = 40
    cfg = tdisagg.DisaggConfig(num_hosts=4, lanes_per_host=2, upload_batch=1,
                               heartbeat_interval_s=0.5)
    learner = tdisagg.SequenceLearner(cfg, _lease_source(n))
    learner.start()
    fleet = tdisagg.LocalGenerationFleet(
        learner, cfg, tdisagg.ScriptedEngineFactory(lanes=2, response_len=8, tokens_per_step=1,
                                                    step_sleep_s=0.02),
        mp_context="spawn", auto_chaos=False)
    fleet.start()
    # hosts take leases only once a snapshot is out: publishing after every
    # host has joined starts all four decoding together, so the wave cannot
    # land on a host still booting, which would hold nothing to requeue
    deadline = time.monotonic() + 120.0
    while learner.live_host_count() < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert learner.live_host_count() == 4
    learner.publish(_weights(), learner_step=0)
    scaler = Autoscaler(
        AutoscalerConfig(min_workers=4, max_workers=8, interval_s=0.25, cooldown_s=1.0,
                         up_hysteresis=1, low_occupancy=-1.0),
        executor=tdisagg.GenerationTierExecutor(learner, fleet),
        signal_source=tdisagg.disagg_signal_source(learner),
    ).start()
    try:
        warm = _collect(lambda: learner, 8, deadline_s=120.0)
        assert len(warm) == 8
        killed = fleet.chaos_poll()
        assert len(killed) == 2
        seqs = warm + _collect(lambda: learner, n - 8, deadline_s=120.0)
    finally:
        scaler.stop()
        learner.stop()
        fleet.join(timeout=10.0)
        monkeypatch.delenv(chaos.ENV_VAR)
        chaos.clear()
    assert len(seqs) == n
    assert {s["seed"] for s in seqs} == set(range(1, n + 1))
    assert learner.requeued_leases >= 1 and scaler.scale_ups >= 1
    _assert_scripted(seqs, 8)
    assert telemetry.get_recorder().events("mass_kill")


def test_learner_restart_from_the_ledger_closes_the_accounting(tmp_path):
    """The learner saves and exits mid-decode with live thread hosts; its
    successor resumes the ledger under epoch 2, the hosts redial and
    re-handshake, and every lease's sequence arrives once."""
    path = str(tmp_path / "ledger")
    n = 30
    cfg = tdisagg.DisaggConfig(num_hosts=2, lanes_per_host=2, upload_batch=1,
                               heartbeat_interval_s=0.5)
    source = _lease_source(n)
    learner = tdisagg.SequenceLearner(cfg, source, ledger_path=path)
    learner.start()
    learner.publish(_weights(), learner_step=0)
    state = {"learner": learner}
    fleet = tdisagg.LocalGenerationFleet(
        learner, cfg, tdisagg.ScriptedEngineFactory(lanes=2, response_len=6, tokens_per_step=1,
                                                    step_sleep_s=0.02),
        use_threads=True, auto_chaos=False)
    fleet.start()
    restarted = None
    try:
        seqs = _collect(lambda: state["learner"], 8)
        assert len(seqs) == 8
        guard = PreemptionGuard()
        guard.simulate()
        assert guard.triggered and os.path.exists(guard.flight_dump_path)
        learner.stop()
        learner.save_ledger()
        restarted = tdisagg.SequenceLearner(cfg, source, ledger_path=path)
        assert restarted.learner_epoch == 2 and restarted.resumed_sequences_reissued > 0
        restarted.start()
        state["learner"] = restarted
        fleet.adopt_learner(restarted)
        seqs += _collect(lambda: state["learner"], n - len(seqs))
    finally:
        learner.stop()
        if restarted is not None:
            restarted.stop()
        fleet.join(timeout=10.0)
    assert len(seqs) == n and len({s["lease_id"] for s in seqs}) == n
    assert len(restarted._outstanding) == 0
    _assert_scripted(seqs, 6)
    assert telemetry.get_recorder().events("preemption_resume")
    assert telemetry.get_registry().gauge("learner.epoch").value == 2
    assert telemetry.get_registry().counter("disagg_host.reconnects").value > 0


def test_host_killed_during_learner_restart(tmp_path):
    path = str(tmp_path / "ledger")
    n = 20
    cfg = tdisagg.DisaggConfig(num_hosts=2, lanes_per_host=2, upload_batch=1,
                               heartbeat_interval_s=0.5)
    factory = tdisagg.ScriptedEngineFactory(lanes=2, response_len=6, tokens_per_step=1,
                                            step_sleep_s=0.02)
    source = _lease_source(n)
    learner = tdisagg.SequenceLearner(cfg, source, ledger_path=path)
    learner.start()
    learner.publish(_weights(), learner_step=0)
    fleet = tdisagg.LocalGenerationFleet(learner, cfg, factory, mp_context="spawn",
                                         auto_chaos=False)
    fleet.start()
    restarted = fleet2 = None
    try:
        seqs = _collect(lambda: learner, 6, deadline_s=120.0)
        assert len(seqs) == 6
        learner.stop()
        learner.save_ledger()
        fleet.procs[0].terminate()
        fleet.join(timeout=10.0)
        restarted = tdisagg.SequenceLearner(cfg, source, ledger_path=path)
        assert restarted.learner_epoch == 2
        restarted.start()
        fleet2 = tdisagg.LocalGenerationFleet(restarted, cfg, factory, use_threads=True,
                                              auto_chaos=False)
        fleet2.start()
        seqs += _collect(lambda: restarted, n - len(seqs))
    finally:
        learner.stop()
        if restarted is not None:
            restarted.stop()
        fleet.join(timeout=5.0)
        if fleet2 is not None:
            fleet2.join(timeout=10.0)
    assert len(seqs) == n and len({s["lease_id"] for s in seqs}) == n
    assert len(restarted._outstanding) == 0
    assert all(s["generation"] >= 1 for s in seqs)
    _assert_scripted(seqs, 6)


def test_signal_source_and_tier_executor():
    from scalerl_torch.runtime.autoscaler import Autoscaler, AutoscalerConfig, FleetSignals

    cfg = tdisagg.DisaggConfig(num_hosts=1, heartbeat_interval_s=0.0)
    learner = tdisagg.SequenceLearner(cfg, _lease_source(1))
    learner.publish(_weights(), learner_step=10)
    learner.publish(_weights(), learner_step=20)
    assert learner.observe_consumed(1) == 10.0
    signals = tdisagg.disagg_signal_source(learner)()
    assert signals.snapshot_staleness == 10.0 and signals.live_workers == 0
    executor = tdisagg.GenerationTierExecutor(learner, tdisagg.LocalGenerationFleet(
        learner, cfg, tdisagg.ScriptedEngineFactory(), use_threads=True))
    assert executor.worker_count() == 0 and executor.scale_down(1) == 0
    learner.stop()
    scaler = Autoscaler(AutoscalerConfig(min_workers=1, max_workers=4, up_hysteresis=1,
                                         low_occupancy=-1.0, max_staleness=5.0, cooldown_s=0.0))
    d = scaler.evaluate(FleetSignals(snapshot_staleness=10.0, queue_occupancy=0.5,
                                     live_workers=2), now=0.0)
    assert d.action == "scale_up"


def test_config_validation_matches_jax():
    for kw in (dict(num_hosts=0), dict(lanes_per_host=0), dict(snapshot_quantize="fp8"),
               dict(upload_batch=0), dict(reconnect_max_tries=0)):
        with pytest.raises(ValueError):
            tdisagg.DisaggConfig(**kw).validate()
        with pytest.raises(ValueError):
            jdisagg.DisaggConfig(**kw).validate()
    t, j = tdisagg.DisaggConfig(lanes_per_host=3), jdisagg.DisaggConfig(lanes_per_host=3)
    assert (t.prefetch, t.heartbeat_timeout) == (j.prefetch, j.heartbeat_timeout) == (4, 10.0)


# ---------------------------------------------------------------------------
# the trainer


def _args(tmp_path=None, **kw):
    from scalerl_torch.config import GenRLArguments

    base = dict(vocab_size=12, prompt_len=4, max_new_tokens=4, d_model=32, n_layers=1,
                n_heads=2, genrl_batch=4, genrl_sample_batch=4, genrl_buffer_sequences=8,
                disagg_hosts=2, disagg_round_timeout_s=60.0)
    if tmp_path is not None:
        base["disagg_ledger_dir"] = str(tmp_path / "plane")
    return GenRLArguments(**{**base, **kw})


def test_wire_completion_packing_equals_jax():
    from scalerl_torch.genrl.rollout import pack_completions, packed_rows_from_completions
    from scalerl_torch.trainer.sequence_rl import _WireCompletion
    from scalerl_tpu.genrl.rollout import pack_completions as jpack
    from scalerl_tpu.genrl.rollout import packed_rows_from_completions as jrows
    from scalerl_tpu.trainer.sequence_rl import _WireCompletion as JaxWireCompletion

    payloads = [tdisagg.scripted_sequence_payload(s, 6, 16, s % 3) for s in range(1, 12)]
    payloads.append(dict(payloads[0], response_tokens=np.arange(2, 12, dtype=np.int32),
                         behavior_logp=np.zeros(10, np.float32), values=np.zeros(10, np.float32)))
    t = pack_completions([_WireCompletion(p) for p in payloads], 4, 8)
    j = jpack([JaxWireCompletion(p) for p in payloads], 4, 8)
    for field in t._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, field)), np.asarray(getattr(j, field)),
                                      err_msg=field)
    rewards = np.linspace(0, 1, len(t.prompt_len)).astype(np.float32)
    tf, tp = packed_rows_from_completions(t, rewards, 12).fields()
    jf, jp = jrows(j, rewards, 12).fields()
    np.testing.assert_array_equal(tp, jp)
    for k in jf:
        np.testing.assert_array_equal(tf[k], np.asarray(jf[k]), err_msg=k)
    assert telemetry.get_recorder().events("oversize_shed")
    # rows shorter than some sequences: both packers shed the same ones
    tf, tp = packed_rows_from_completions(t, rewards, 7).fields()
    jf, jp = jrows(j, rewards, 7).fields()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tf["tokens"], np.asarray(jf["tokens"]))
    assert telemetry.get_recorder().events("pack_oversize_shed")[-1]["pack_len"] == 7


@pytest.mark.parametrize("packing", [False, True])
def test_trainer_three_rounds_on_real_engines(packing):
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    args = _args(learner_packing=packing, learner_packed_attn="pallas")
    trainer = DisaggSequenceRLTrainer(args, device="cpu")
    summary = trainer.train(3)
    assert summary["rounds"] == 3.0 and summary["learn_steps"] == 3.0
    assert summary["wire_sequences"] >= 3 * args.genrl_batch
    assert trainer.learner.duplicate_sequences == 0
    assert np.isfinite(summary["total_loss"]) and summary["skipped_steps"] == 0.0
    assert trainer.learner.generation == 4  # the initial snapshot and one a round
    assert telemetry.get_registry().gauge("staleness_plane.disagg").value >= 0.0
    assert not any(t.is_alive() for t in trainer.fleet.procs)


def test_trainer_continuous_hosts_with_speculation():
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    args = _args(genrl_engine="continuous", spec_enable=True, spec_k=2, temperature=0.0,
                 genrl_page_size=4)
    trainer = DisaggSequenceRLTrainer(args, device="cpu")
    summary = trainer.train(2)
    assert summary["learn_steps"] == 2.0 and np.isfinite(summary["total_loss"])


def test_trainer_round_starvation_raises():
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    class _Idle:
        def __call__(self, params, generation):
            eng = tdisagg.ScriptedSequenceEngine()
            eng.capacity = lambda: 0
            return eng

    trainer = DisaggSequenceRLTrainer(_args(disagg_round_timeout_s=0.5), engine_factory=_Idle(),
                                      device="cpu")
    with pytest.raises(RuntimeError, match="starved"):
        trainer.train(1)


def _weights_np(trainer):
    return {k: v.detach().float().numpy().copy() for k, v in trainer.agent.get_weights().items()}


def test_trainer_save_resume_roundtrip(tmp_path):
    from scalerl_torch.data.sequence_replay import seq_export
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    args = _args(tmp_path)
    os.makedirs(args.disagg_ledger_dir, exist_ok=True)
    t1 = DisaggSequenceRLTrainer(args, device="cpu")
    assert t1.learner.learner_epoch == 1
    t1.train(2)
    rng_cut = json.dumps(t1._lease_rng.bit_generator.state)
    w_cut, replay_cut = _weights_np(t1), seq_export(t1.replay)
    lease_seq = t1._lease_seq
    assert t1.save_resume() == t1.ledger_path
    t2 = DisaggSequenceRLTrainer(args, device="cpu")
    try:
        assert t2.learner.learner_epoch == 2 and t2.learn_steps == 2
        assert json.dumps(t2._lease_rng.bit_generator.state) == rng_cut
        assert t2._lease_seq >= lease_seq  # the cursor continues, never rewinds
        for k, v in w_cut.items():
            np.testing.assert_array_equal(_weights_np(t2)[k], v, err_msg=k)
        back = seq_export(t2.replay)
        for k, v in replay_cut["storage"].items():
            np.testing.assert_array_equal(back["storage"][k], v, err_msg=k)
        np.testing.assert_array_equal(back["priorities"], replay_cut["priorities"])
        assert (back["pos"], back["size"]) == (replay_cut["pos"], replay_cut["size"])
        assert t2.learner.generation >= 1
        assert t2.train(1)["learn_steps"] == 3.0
    finally:
        t2.close()


def test_trainer_guard_preempt_exit_resumes_same_step(tmp_path, monkeypatch):
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    args = _args(tmp_path)
    os.makedirs(args.disagg_ledger_dir, exist_ok=True)
    t1 = DisaggSequenceRLTrainer(args, device="cpu")
    t1.train(2)
    t1.save_resume()
    monkeypatch.setenv(chaos.ENV_VAR, "5:preempt=1.0@1")
    chaos.clear()
    try:
        guard = PreemptionGuard()
        t2 = DisaggSequenceRLTrainer(args, guard=guard, device="cpu")
        assert t2.learn_steps == 2
        summary = t2.train(3)
        assert guard.triggered and summary["learn_steps"] == 2.0
        assert os.path.exists(guard.flight_dump_path)
        assert telemetry.get_recorder().events("preemption_exit")
        assert telemetry.get_recorder().events("preemption_signal")
    finally:
        monkeypatch.delenv(chaos.ENV_VAR)
        chaos.clear()
    t3 = DisaggSequenceRLTrainer(args, device="cpu")
    try:
        assert t3.learn_steps == 2 and t3.learner.learner_epoch == 3
    finally:
        t3.close()


# bf16_params: both packages compute the blocks in bfloat16 but round in other
# places (tests/test_torch_transformer_policy.py: XLA's CPU dot rounds the
# product before the bias add, PyTorch's addmm once after it), so the losses
# are held at 2^-6 relative.  The gradients carry that rounding noise: after
# one step the Adam moments, float32 in both, differ leaf by leaf by 0.07% to
# 1.4% relative L2 here (the float32 heads too, through the bf16 blocks), and
# the IMPALA learner's bf16 updates by up to 3.5%.  So a learn step holds
# the moments at 2^-5 relative L2, and the optimizer itself is held at 1e-6
# on identical gradients, where no bf16 forward stands between the two.
BF16_LOSS_REL = 2.0 ** -6
BF16_MOMENT_REL_L2 = 2.0 ** -5
BF16_SAME_GRADS_TOL = 1e-6


def _bf16_agents():
    from scalerl_torch import convert
    from scalerl_torch.agents.token_ppo import TokenPPOAgent, TokenPPOTrainState
    from scalerl_torch.trainer.sequence_rl import build_genrl_model
    from scalerl_tpu.agents.token_ppo import TokenPPOAgent as JaxTokenPPOAgent
    from scalerl_tpu.trainer.sequence_rl import build_genrl_model as jax_build_genrl_model
    from tests import torch_port_helpers as H

    jargs, targs = H.genrl_args_pair(bf16_params=True, learner_packing=True,
                                     learner_packed_attn="xla", learning_rate=1e-3)
    jagent = JaxTokenPPOAgent(jargs, jax_build_genrl_model(jargs))
    tagent = TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    want_dtypes = {k: v.dtype for k, v in convert.transformer_to_torch(
        H.to_numpy(jagent.state.params)).items()}
    assert {k: v.dtype for k, v in tagent.state.params.items()} == want_dtypes
    assert tagent.state.params["blocks.0.qkv.weight"].dtype == torch.bfloat16
    assert tagent.state.params["policy_head.weight"].dtype == torch.float32
    tagent.state = TokenPPOTrainState(
        params=convert.transformer_to_torch(H.to_numpy(jagent.state.params)),
        ref_params=convert.transformer_to_torch(H.to_numpy(jagent.state.ref_params)),
        opt_state=convert.adam_state_to_torch(H.to_numpy(jagent.state.opt_state),
                                              convert.transformer_to_torch),
        step=torch.zeros((), dtype=torch.int32), tokens_seen=torch.zeros((), dtype=torch.int32))
    return jagent, tagent, want_dtypes


def test_bf16_learn_step_matches_jax():
    """``bf16_params`` on the token-PPO learner: bfloat16 blocks with
    float32 norms and heads, Adam in ``fp32_optimizer_state``; one packed
    learn step from the JAX agent's state."""
    import jax

    from scalerl_torch import convert
    from tests import torch_port_helpers as H

    jagent, tagent, want_dtypes = _bf16_agents()
    _, packed, _ = H.ragged_token_batches(31, V=12, P=8, R=8)
    jm = jagent.learn(H.to_jax_batch(packed))
    tm = tagent.learn(packed)
    assert tm["skipped_steps"] == 0.0
    for key in ("total_loss", "pg_loss", "value_loss"):
        assert abs(tm[key] - jm[key]) <= BF16_LOSS_REL * max(abs(jm[key]), 1.0), key
    want_opt = convert.adam_state_to_torch(H.to_numpy(jax.device_get(jagent.state.opt_state)),
                                           convert.transformer_to_torch)
    for moment in ("mu", "nu"):
        for k, v in want_opt[moment].items():
            got = tagent.state.opt_state[moment][k]
            assert got.dtype == torch.float32 and v.dtype == torch.float32
            rel = float((got - v).norm() / v.norm().clamp(min=1e-30))
            assert rel <= BF16_MOMENT_REL_L2, (moment, k, rel)
    for k, v in tagent.state.params.items():
        assert v.dtype == want_dtypes[k], k


def test_bf16_optimizer_matches_optax_on_the_same_gradients():
    """The port's ``fp32_optimizer_state(clip + Adam)`` against the JAX
    agent's optax chain, two updates from identical mixed bf16 / float32
    gradients: float32 moments, updates in each param's dtype, equal."""
    import jax
    import jax.numpy as jnp

    from scalerl_torch import convert
    from scalerl_torch.convert import torch_to_transformer
    from tests import torch_port_helpers as H

    jagent, tagent, _ = _bf16_agents()
    rng = np.random.default_rng(4)
    jparams = jagent.state.params
    tstate = tagent.optimizer.init(tagent.state.params)
    jstate = jagent.optimizer.init(jparams)
    for step in range(2):
        tgrads = {k: torch.tensor(rng.normal(0, 1, v.shape).astype(np.float32)).to(v.dtype)
                  for k, v in tagent.state.params.items()}
        jgrads = jax.tree_util.tree_map(
            lambda g, p: jnp.asarray(g).astype(p.dtype),
            {"params": torch_to_transformer({k: v.float() for k, v in tgrads.items()})["params"]},
            jparams)
        tupd, tstate = tagent.optimizer.update(tgrads, tstate)
        jupd, jstate = jagent.optimizer.update(jgrads, jstate, jparams)
        want_upd = convert.transformer_to_torch(H.to_numpy(jupd))
        for k, u in tupd.items():
            assert u.dtype == want_upd[k].dtype, k
            np.testing.assert_allclose(u.float().numpy(), want_upd[k].float().numpy(),
                                       rtol=BF16_SAME_GRADS_TOL, atol=BF16_SAME_GRADS_TOL,
                                       err_msg=f"step {step} {k}")
        want = convert.adam_state_to_torch(H.to_numpy(jstate), convert.transformer_to_torch)
        for moment in ("mu", "nu"):
            for k, v in want[moment].items():
                got = tstate[moment][k]
                assert got.dtype == torch.float32, k
                np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=BF16_SAME_GRADS_TOL,
                                           atol=BF16_SAME_GRADS_TOL, err_msg=f"{moment} {k}")
