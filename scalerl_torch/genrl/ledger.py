"""Durable learner ledger: the disaggregated learner's crash-safe state file.

Port of ``scalerl_tpu/genrl/ledger.py``.  The disaggregated
:class:`~scalerl_torch.genrl.disagg.SequenceLearner` must not lose its
lease table, dedup keys or accepted sequences to a preemption, so it saves
them as ONE codec-v2 frame on disk with the crash-safety idiom of
``utils/checkpoint.py``:

- a save never has a window with no complete ledger on disk: the new state
  lands in ``path.tmp`` first, the previous ledger is rotated to
  ``path.prev`` (... ``path.prevK``) before the atomic
  ``rename(tmp, path)``;
- a sha256 ``integrity_manifest.json`` is written INSIDE the directory
  before the rename, so a ledger is never visible without its manifest;
  restore verifies the frame against it, and a flipped bit or a truncated
  file is detected, never unpacked;
- a restore that finds the newest ledger corrupt or partial falls back
  through the retained ``.prev`` chain.

The payload is one frame of ``fleet/framing.py``: numpy arrays, int-keyed
dicts and nested containers round-trip bit-exact, and the frame's own CRC
is a second corruption tripwire under the manifest's sha256.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List

from scalerl_torch.fleet.framing import ProtocolError, pack_message, unpack_message
from scalerl_torch.utils.logging import get_logger

logger = get_logger(__name__)

# same manifest filename as utils/checkpoint.py: the integrity idiom is one
# idiom, whether the bytes underneath are orbax shards or a codec-v2 frame
MANIFEST_NAME = "integrity_manifest.json"
LEDGER_FILE = "ledger.bin"


class LedgerIntegrityError(RuntimeError):
    """Ledger bytes do not match the manifest digest (torn write, flipped
    bit, truncation — anything between save and restore)."""


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _prev_path(path: str, k: int) -> str:
    """k-th displaced ledger: ``path.prev``, ``path.prev2``, ..."""
    return path + (".prev" if k == 1 else f".prev{k}")


def ledger_fallbacks(path: str) -> List[str]:
    """Existing retained predecessors of ``path``, newest first."""
    out: List[str] = []
    k = 1
    while True:
        p = _prev_path(path, k)
        if not os.path.exists(p):
            break
        out.append(p)
        k += 1
    return out


def save_ledger(path: str, state: Dict[str, Any], keep_last: int = 2) -> str:
    """Write ``state`` to ``path`` (write-new-then-rotate). Returns the path.

    ``state`` is any codec-v2-encodable tree (numpy arrays, dicts with
    str/int keys, lists, scalars).  ``keep_last`` retained predecessors
    survive as ``path.prev`` … ``path.prevN`` for the fallback chain.
    """
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    frame = pack_message(state, compress=True)
    with open(os.path.join(tmp, LEDGER_FILE), "wb") as f:
        f.write(frame)
    manifest = {
        "format": 1,
        "leaves": [{"path": LEDGER_FILE, "sha256": _digest(frame)}],
    }
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    # rotate the retention chain oldest-first so each rename target is free
    if os.path.exists(path):
        oldest = _prev_path(path, max(keep_last, 1))
        if os.path.exists(oldest):
            shutil.rmtree(oldest)
        for k in range(max(keep_last, 1) - 1, 0, -1):
            src = _prev_path(path, k)
            if os.path.exists(src):
                os.rename(src, _prev_path(path, k + 1))
        os.rename(path, _prev_path(path, 1))
    os.rename(tmp, path)
    if keep_last <= 0:
        prev = _prev_path(path, 1)
        if os.path.exists(prev):
            shutil.rmtree(prev)
    inj = _chaos_active()
    if inj is not None:
        # chaos: leave the freshly-landed ledger partial (a preemption
        # mid-flush) — restores must fall back through the .prev chain
        inj.corrupt_checkpoint(path, site="ledger")
    _telemetry().record_event("ledger_save", path=path)
    _telemetry().get_registry().counter("ledger.saves").inc()
    return path


def _restore(path: str) -> Dict[str, Any]:
    fpath = os.path.join(path, LEDGER_FILE)
    with open(fpath, "rb") as f:
        frame = f.read()
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        # a save is never visible without its manifest — a missing one
        # means the rename raced a corruption; the .prev chain has truth
        raise LedgerIntegrityError(f"ledger {path} has no manifest")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        expected = {
            leaf["path"]: leaf["sha256"] for leaf in manifest["leaves"]
        }[LEDGER_FILE]
    except (ValueError, KeyError, TypeError) as e:
        raise LedgerIntegrityError(
            f"unreadable ledger manifest at {mpath}: {e}"
        ) from e
    if _digest(frame) != expected:
        raise LedgerIntegrityError(
            f"ledger {fpath} failed sha256 verification against its "
            "save-time manifest"
        )
    try:
        state = unpack_message(frame)
    except ProtocolError as e:  # CRC/structure — should be unreachable
        raise LedgerIntegrityError(f"undecodable ledger frame: {e}") from e
    if not isinstance(state, dict):
        raise LedgerIntegrityError(
            f"ledger frame decoded to {type(state).__name__}, not dict"
        )
    return state


def load_ledger(path: str, fallback: bool = True) -> Dict[str, Any]:
    """Restore the ledger at ``path``; on corruption fall back through the
    retained ``.prev`` chain (the crash-safety contract of
    :func:`save_ledger`).  The original error is chained if every
    candidate fails; ``FileNotFoundError`` if none ever existed."""
    path = os.path.abspath(path)
    candidates = [path] + (ledger_fallbacks(path) if fallback else [])
    first_err = None
    for cand in candidates:
        try:
            state = _restore(cand)
            _telemetry().record_event(
                "ledger_restore", path=cand, fallback=cand != path
            )
            _telemetry().get_registry().counter("ledger.restores").inc()
            return state
        except (OSError, LedgerIntegrityError) as e:
            if first_err is None:
                first_err = e
            if fallback and cand != candidates[-1]:
                _telemetry().record_event(
                    "ledger_fallback", path=cand, error=repr(e)
                )
                _telemetry().get_registry().counter("ledger.fallbacks").inc()
                logger.warning(
                    "ledger %s failed to restore (%r); falling back to %s",
                    cand, e, candidates[candidates.index(cand) + 1],
                )
    assert first_err is not None
    raise first_err


def ledger_exists(path: str) -> bool:
    """True when ``path`` or any retained predecessor holds a ledger."""
    path = os.path.abspath(path)
    return any(
        os.path.exists(os.path.join(p, LEDGER_FILE))
        for p in [path] + ledger_fallbacks(path)
    )


def _chaos_active():
    from scalerl_torch.runtime import chaos

    return chaos.active()


def _telemetry():
    from scalerl_torch.runtime import telemetry

    return telemetry
