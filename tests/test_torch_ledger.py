"""The port's durable learner ledger (``genrl/ledger.py``) against the JAX one.

The ledger is one codec-v2 frame under a sha256 manifest, written new then
rotated through a ``.prev`` chain.  Both packages must write the same
files for the same state (a ledger saved by one restores in the other,
bit-exact), detect a flipped bit or a missing manifest, and fall back
through the chain past a truncated or corrupted ledger.
"""

import json
import os
import shutil

import numpy as np
import pytest

from scalerl_torch.genrl import ledger as tledger
from scalerl_torch.runtime import chaos, telemetry
from scalerl_tpu.genrl import ledger as jledger


def _state():
    rng = np.random.default_rng(7)
    pcg = np.random.default_rng(3)
    pcg.random(5)
    return {
        "format": 1,
        "learner_epoch": 3,
        "arr_f32": rng.standard_normal((5, 3)).astype(np.float32),
        "arr_i64": rng.integers(0, 2**40, size=7),
        "arr_bool": rng.random(4) > 0.5,
        "int_keyed": {0: 17, 42: {11: np.arange(4, dtype=np.int32)}},
        "leases": [{"seed": 1, "_task_id": 9, "prompt": np.arange(6, dtype=np.int32)}, None],
        "scalars": {"pi": 3.140625, "n": -12, "flag": True, "none": None, "big": 2**62},
        # the lease generator's PCG64 state rides as a JSON string
        "lease_rng": json.dumps(pcg.bit_generator.state),
    }


def _assert_state_equal(back, want):
    assert set(back) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
    assert back["int_keyed"][0] == 17
    np.testing.assert_array_equal(back["int_keyed"][42][11], np.arange(4, dtype=np.int32))
    assert back["leases"][0]["_task_id"] == 9 and back["leases"][1] is None
    np.testing.assert_array_equal(back["leases"][0]["prompt"], np.arange(6, dtype=np.int32))
    assert back["scalars"] == want["scalars"]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = json.loads(back["lease_rng"])
    want_rng = np.random.default_rng(0)
    want_rng.bit_generator.state = json.loads(want["lease_rng"])
    assert rng.random() == want_rng.random()


@pytest.mark.parametrize("writer,reader", [(tledger, jledger), (jledger, tledger),
                                           (tledger, tledger)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_roundtrip_bit_exact_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "ledger")
    state = _state()
    out = writer.save_ledger(path, state)
    assert out == os.path.abspath(path)
    assert os.path.exists(os.path.join(path, tledger.LEDGER_FILE))
    assert os.path.exists(os.path.join(path, tledger.MANIFEST_NAME))
    _assert_state_equal(reader.load_ledger(path), state)


def test_the_same_state_writes_the_same_files(tmp_path):
    state = _state()
    tledger.save_ledger(str(tmp_path / "t"), state)
    jledger.save_ledger(str(tmp_path / "j"), state)
    for name in (tledger.LEDGER_FILE, tledger.MANIFEST_NAME):
        with open(tmp_path / "t" / name, "rb") as a, open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_tamper_and_missing_manifest_detected(tmp_path):
    path = str(tmp_path / "ledger")
    tledger.save_ledger(path, {"x": 1})
    fpath = os.path.join(os.path.abspath(path), tledger.LEDGER_FILE)
    blob = bytearray(open(fpath, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(fpath, "wb") as f:
        f.write(bytes(blob))
    for pkg, err in ((tledger, tledger.LedgerIntegrityError),
                     (jledger, jledger.LedgerIntegrityError)):
        with pytest.raises(err):
            pkg.load_ledger(path, fallback=False)
    tledger.save_ledger(path, {"x": 2})
    os.unlink(os.path.join(os.path.abspath(path), tledger.MANIFEST_NAME))
    with pytest.raises(tledger.LedgerIntegrityError, match="manifest"):
        tledger.load_ledger(path, fallback=False)
    # the chain behind it holds only the tampered save: every candidate
    # fails, and the first error surfaces
    with pytest.raises(tledger.LedgerIntegrityError, match="manifest"):
        tledger.load_ledger(path)


def test_truncated_ledger_falls_back_through_the_prev_chain(tmp_path):
    path = str(tmp_path / "ledger")
    for v in (1, 2, 3):
        tledger.save_ledger(path, {"v": v}, keep_last=2)
    apath = os.path.abspath(path)
    assert tledger.ledger_fallbacks(apath) == [apath + ".prev", apath + ".prev2"]
    assert tledger.ledger_exists(path)
    reg = telemetry.get_registry()
    fallbacks0 = reg.counter("ledger.fallbacks").value
    fpath = os.path.join(apath, tledger.LEDGER_FILE)
    blob = open(fpath, "rb").read()
    with open(fpath, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert tledger.load_ledger(path)["v"] == 2
    assert jledger.load_ledger(path)["v"] == 2
    with open(os.path.join(apath + ".prev", tledger.LEDGER_FILE), "ab") as f:
        f.write(b"\x00garbage")
    assert tledger.load_ledger(path)["v"] == 1
    assert reg.counter("ledger.fallbacks").value >= fallbacks0 + 2
    assert telemetry.get_recorder().events("ledger_fallback")
    for p in (apath + ".prev", apath + ".prev2"):
        shutil.rmtree(p)
    with pytest.raises(tledger.LedgerIntegrityError):
        tledger.load_ledger(path)
    shutil.rmtree(apath)
    assert not tledger.ledger_exists(path)
    with pytest.raises(FileNotFoundError):
        tledger.load_ledger(path)


@pytest.mark.parametrize("keep_last", [0, 1, 3])
def test_rotation_keeps_the_same_chain_as_jax(tmp_path, keep_last):
    for pkg, name in ((tledger, "t"), (jledger, "j")):
        path = str(tmp_path / name / "ledger")
        for v in range(5):
            pkg.save_ledger(path, {"v": v}, keep_last=keep_last)
    tchain = [os.path.basename(p) for p in tledger.ledger_fallbacks(str(tmp_path / "t" / "ledger"))]
    jchain = [os.path.basename(p) for p in jledger.ledger_fallbacks(str(tmp_path / "j" / "ledger"))]
    assert tchain == jchain
    assert len(tchain) == keep_last
    values = [tledger.load_ledger(str(tmp_path / "t" / c), fallback=False)["v"] for c in tchain]
    assert values == list(range(3, 3 - keep_last, -1))


def test_chaos_partial_save_is_restored_from_prev(tmp_path, monkeypatch):
    """The chaos plan's ``ckpt_partial`` fault at the ledger site leaves the
    newest ledger torn, as a preemption mid-flush would: the restore falls
    back to the predecessor and records the fallback."""
    path = str(tmp_path / "ledger")
    tledger.save_ledger(path, {"v": 1})
    monkeypatch.setenv(chaos.ENV_VAR, "3:ckpt_partial=1.0")
    chaos.clear()
    try:
        tledger.save_ledger(path, {"v": 2})
    finally:
        monkeypatch.delenv(chaos.ENV_VAR)
        chaos.clear()
    assert tledger.load_ledger(path)["v"] == 1
    assert telemetry.get_recorder().events("ledger_save")
    assert telemetry.get_recorder().events("ledger_restore")
