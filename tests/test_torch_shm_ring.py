"""The port's shared-memory rollout ring and its native library.

- Both legs (the native C++ ring and the Python queues of
  ``use_native=False``) of the JAX package's ring cases: a slot cycle, a
  timeout and a close that wakes a blocked waiter, spawned producers
  delivering every payload intact, and a torn write across processes that
  the verified pop detects (torn reads = the plan's tears, exactly);
- the same ``SlotSpec`` gives the same offsets, slot stride, control
  section and slot bytes (payload, CRC word and sequence word) as the JAX
  ring, byte for byte;
- the library is built from ``scalerl_torch/csrc/shm_ring.cpp`` (a copy of
  the repo's ``csrc/shm_ring.cpp``), and a failed build raises with the
  compiler's output, for ``use_native=None`` too: no quiet fallback.
"""

import multiprocessing as mp
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ring_helpers as helpers
from scalerl_torch.native import build as native_build
from scalerl_torch.runtime import telemetry as ttel
from scalerl_torch.runtime.shm_ring import ShmRolloutRing, SlotSpec
from scalerl_tpu.runtime import shm_ring as jring

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LEGS = [True, False]  # native, then the Python queues


def _fields():
    return {"obs": ((4, 3), np.float32), "action": ((4,), np.int32),
            "reward": ((4,), np.float32)}


def _spec():
    return SlotSpec(_fields())


@pytest.mark.parametrize("use_native", LEGS)
def test_ring_basic_cycle(use_native):
    ring = ShmRolloutRing(_spec(), num_slots=4, use_native=use_native)
    try:
        assert ring.native is use_native
        idx = ring.acquire(timeout=1.0)
        assert idx is not None
        views = ring.slot(idx)
        views["obs"][:] = 2.5
        views["action"][:] = np.arange(4)
        views = None
        ring.commit(idx)
        got = ring.pop_full(timeout=1.0)
        assert got == idx and ring.verify_slot(got) and ring.slot_seq(got) == 1
        batch = ring.gather_batch([got])
        np.testing.assert_array_equal(batch["obs"][0], 2.5)
        np.testing.assert_array_equal(batch["action"][0], np.arange(4))
        ring.release(got)
        idxs = [ring.acquire(timeout=1.0) for _ in range(4)]
        assert sorted(idxs) == [0, 1, 2, 3]
        assert ring.acquire(timeout=0.05) is None  # exhausted
        stats = ring.stats()
        assert stats["slots"] == 4 and stats["closed"] == 0 and stats["torn_reads"] == 0
    finally:
        ring.unlink()


@pytest.mark.parametrize("use_native", LEGS)
def test_ring_timeout_and_close(use_native):
    ring = ShmRolloutRing(_spec(), num_slots=2, use_native=use_native)
    try:
        assert ring.pop_full(timeout=0.05) is None
        woke = threading.Event()

        def waiter():
            assert ring.pop_full(timeout=None) is None
            woke.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.2)
        ring.close()
        assert woke.wait(timeout=5.0), "close() did not unblock pop_full"
        assert ring.closed
    finally:
        ring.unlink()


@pytest.mark.parametrize("use_native", LEGS)
def test_ring_multiprocess_producers(use_native):
    ring = ShmRolloutRing(_spec(), num_slots=4, use_native=use_native)
    n_actors, episodes = 3, 5
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=helpers.produce, args=(ring, a, episodes))
             for a in range(n_actors)]
    try:
        for p in procs:
            p.start()
        seen = []
        deadline = time.monotonic() + 60
        while len(seen) < n_actors * episodes and time.monotonic() < deadline:
            idx = ring.pop_full_verified(timeout=0.5)
            if idx is None:
                continue
            views = ring.slot(idx)
            seen.append((int(views["action"][0]), float(views["obs"][0, 0])))
            views = None
            ring.release(idx)
        for p in procs:
            p.join(timeout=30.0)
        assert [p.exitcode for p in procs] == [0] * n_actors
        for a in range(n_actors):
            assert sorted(v for aid, v in seen if aid == a) == [a * 100 + e
                                                                for e in range(episodes)]
        assert ring.torn_reads == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        ring.unlink()


TEAR_SPEC = "6:slot_tear=0.4"


@pytest.mark.parametrize("use_native", LEGS)
def test_ring_torn_write_detected_across_processes(use_native):
    """A producer process commits slots under a seeded tear plan; the
    verified pop detects exactly the torn ones by checksum, recycles them,
    and delivers every intact payload in order."""
    ttel.reset()
    n = 8
    ring = ShmRolloutRing(_spec(), num_slots=4, use_native=use_native)
    torn = helpers.tear_schedule(TEAR_SPEC, n, ring.spec.slot_bytes)
    proc = mp.get_context("spawn").Process(target=helpers.produce_torn,
                                           args=(ring, n, TEAR_SPEC))
    try:
        proc.start()
        good = []
        deadline = time.monotonic() + 60
        while ring.torn_reads + len(good) < n and time.monotonic() < deadline:
            idx = ring.pop_full_verified(timeout=0.5)
            if idx is None:
                continue
            good.append(float(ring.slot(idx)["obs"][0, 0]))
            ring.release(idx)
        proc.join(timeout=30.0)
        assert proc.exitcode == 0
        assert 1 <= sum(torn) < n
        assert ring.torn_reads == sum(torn)
        assert good == [float(i) for i in range(n) if not torn[i]]
        assert ttel.get_registry().scalars()["ring.torn_reads"] == sum(torn)
        assert len(ttel.get_recorder().events("torn_read")) == sum(torn)
        assert ring.stats()["torn_reads"] == sum(torn)
    finally:
        if proc.is_alive():
            proc.terminate()
        ring.unlink()
        ttel.reset()


@pytest.mark.parametrize("integrity", [True, False])
def test_layout_and_crc_stamp_equal_the_jax_ring(integrity):
    fields = {"obs": ((3, 5, 7), np.uint8), "logits": ((3, 2, 6), np.float32),
              "done": ((3, 2), np.bool_), "meta": ((2,), np.float64),
              "core_0_c": ((1, 2, 16), np.float32)}
    ours = ShmRolloutRing(SlotSpec(fields), num_slots=3, integrity=integrity)
    theirs = jring.ShmRolloutRing(jring.SlotSpec(fields), num_slots=3, use_native=True,
                                  integrity=integrity)
    try:
        assert ours.spec.offsets == theirs.spec.offsets
        assert ours.spec.slot_bytes == theirs.spec.slot_bytes
        assert ours._slot_stride == theirs._slot_stride
        assert ours._ctrl_bytes == theirs._ctrl_bytes and ours.native and theirs.native
        for ring in (ours, theirs):
            for _ in range(2):  # two commits: the sequence word counts them
                idx = ring.acquire(timeout=1.0)
                helpers.fill_value(ring, idx)
                ring.commit(idx)
                assert ring.pop_full(timeout=1.0) == idx
                ring.release(idx)

        def slot_bytes(ring, i):
            start = ring._slot_start(i)
            return bytes(ring.shm.buf[start:start + ring._slot_stride])

        for i in range(3):
            assert slot_bytes(ours, i) == slot_bytes(theirs, i)
            assert ours.slot_seq(i) == theirs.slot_seq(i)
        assert bytes(ours.shm.buf[:ours._ctrl_bytes]) == bytes(theirs.shm.buf[:theirs._ctrl_bytes])
    finally:
        ours.unlink()
        theirs.unlink()


def test_gather_batch_native_matches_the_python_copy():
    rings = [ShmRolloutRing(_spec(), num_slots=4, use_native=leg) for leg in LEGS]
    try:
        for ring in rings:
            for _ in range(4):
                idx = ring.acquire(timeout=1.0)
                helpers.fill_value(ring, idx)
                ring.commit(idx)
        native, python = (r.gather_batch([3, 1, 2]) for r in rings)
        for name in native:
            np.testing.assert_array_equal(native[name], python[name])
        with pytest.raises(ValueError, match="C-contiguous"):
            rings[0].gather_batch([0, 1], out={"obs": np.empty((2, 3, 4), np.float32)[:, :, :3],
                                               "action": np.empty((2, 4), np.int32),
                                               "reward": np.empty((2, 4), np.float32)})
    finally:
        for ring in rings:
            ring.unlink()


def test_ring_pickles_by_name_and_binds_its_stats():
    import pickle

    ttel.reset()
    ring = ShmRolloutRing(_spec(), num_slots=2)
    try:
        clone = pickle.loads(pickle.dumps(ring))
        assert clone.shm.name == ring.shm.name and not clone._owner and clone.native
        idx = clone.acquire(timeout=1.0)
        clone.commit(idx)
        clone.detach()
        assert ring.pop_full(timeout=1.0) == idx
        assert ttel.get_registry().snapshot()["ring"]["slots"] == 2
    finally:
        ring.unlink()
        ttel.reset()
    assert not Path("/dev/shm", ring.shm.name.lstrip("/")).exists()


def test_the_library_is_built_from_the_port_copy_of_the_ring_source():
    assert native_build.SOURCE == REPO / "scalerl_torch" / "csrc" / "shm_ring.cpp"
    ours = native_build.SOURCE.read_text().splitlines()
    theirs = (REPO / "csrc" / "shm_ring.cpp").read_text().splitlines()
    assert [a for a, b in zip(ours, theirs) if a != b] == [ours[16]]  # the build note only
    assert len(ours) == len(theirs)
    lib = native_build.load_ring_lib()
    assert native_build.library_path().exists() and lib.srl_ring_bytes(4) > 0


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "shm_ring.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_build, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit .*\n.*error"):
        native_build.load_ring_lib()
    for use_native in (None, True):  # no quiet fallback to the queues
        with pytest.raises(RuntimeError, match="building shm_ring.cpp failed"):
            ShmRolloutRing(_spec(), num_slots=2, use_native=use_native)
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))  # no compiler at all
    with pytest.raises(RuntimeError, match="building shm_ring.cpp failed"):
        native_build.load_ring_lib()
