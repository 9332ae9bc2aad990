"""Checkpoints of train-state trees on ``torch.save``.

Port of ``scalerl_tpu/utils/checkpoint.py`` (Orbax there).  A checkpoint is
a directory ``path`` holding ``state.pt`` (the tree's leaves as one flat
``{key path: tensor}`` dict) and ``integrity_manifest.json`` (one sha256
digest per leaf).  The crash-safety contract is the reference's:

- a save never leaves a moment with no complete checkpoint on disk: the new
  state lands in ``path.tmp`` first, and the previous checkpoint is
  *rotated* to ``path.prev`` (``path.prev2`` ... up to ``keep_last``), never
  deleted before the new one has taken its name;
- a restore that finds the latest directory corrupt or partial (a torn
  write, a flipped bit the manifest catches) falls back through the
  retained ``.prev`` chain.

A tree is a tensor, a numpy array, a Python number, ``None``, or a
dataclass, named tuple, tuple, list or dict of trees (``ImpalaTrainState``,
``DQNTrainState``, replay states).  Key paths are written as JAX writes
them (``['agent'].params['fc.weight']``, ``[0]``), and a leaf's digest is
the reference's formula: sha256 over ``str((dtype.str, shape))`` and then
the leaf's bytes, so the same array has the same digest in both packages
(bfloat16 as numpy's two-byte void ``'<V2'``, as ``ml_dtypes`` spells it).
Restores load with ``weights_only=True`` onto the target's device and
return the target's tree with its devices, dtypes and leaf types.

Under a chaos plan with ``ckpt_partial`` (``runtime/chaos.py``), a save
leaves its fresh checkpoint partial, as a preemption mid-flush would, so a
restore must fall back through ``.prev``.  Saves, restores and fallbacks
are counted under ``checkpoint.`` and recorded on the flight recorder.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MANIFEST_NAME = "integrity_manifest.json"
PAYLOAD_NAME = "state.pt"


class CheckpointIntegrityError(RuntimeError):
    """Restored leaves do not match the manifest's digests (silent corruption
    that still unpickles)."""


# ---------------------------------------------------------------------------
# trees


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_tree(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs in JAX's order (dict keys sorted)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in flatten_tree(getattr(tree, f.name), f"{prefix}.{f.name}")]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields
                for pair in flatten_tree(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree) for pair in flatten_tree(v, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in flatten_tree(tree[k], f"{prefix}[{k!r}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _rebuild(target: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``target``'s tree with each leaf replaced by ``leaves[path]``."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _rebuild(getattr(target, f.name), leaves, f"{prefix}.{f.name}")
            for f in dataclasses.fields(target) if f.init
        })
    if _is_namedtuple(target):
        return type(target)(*(_rebuild(getattr(target, n), leaves, f"{prefix}.{n}")
                              for n in target._fields))
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(target))
    if isinstance(target, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in target.items()}
    if target is None:
        return None
    return leaves[prefix]


_TOKEN = re.compile(r"\.(\w+)|\[('(?:[^'\\]|\\.)*'|\"[^\"]*\"|-?\d+)\]")


def _nest(flat: Dict[str, Any]) -> Dict[Any, Any]:
    """A nested dict from key paths (a restore without a target)."""
    out: Dict[Any, Any] = {}
    for path, leaf in flat.items():
        keys = [m.group(1) if m.group(1) is not None else _key(m.group(2))
                for m in _TOKEN.finditer(path)]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1] if keys else ""] = leaf
    return out


def _key(token: str) -> Any:
    return int(token) if token.lstrip("-").isdigit() else token[1:-1]


# ---------------------------------------------------------------------------
# leaves


def _host_array(leaf: Any) -> Tuple[str, np.ndarray]:
    """A leaf's numpy ``dtype.str`` and contiguous host array (bfloat16 as
    its bits, under ``ml_dtypes``' ``'<V2'``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "<V2", np.ascontiguousarray(t.view(torch.int16).numpy())
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    # as the JAX formula: ascontiguousarray lifts a 0-d leaf to shape (1,),
    # for tensors and numpy alike, so a restore without a target verifies
    arr = np.ascontiguousarray(arr)
    return arr.dtype.str, arr


def leaf_digest(leaf: Any) -> str:
    """sha256 over ``str((dtype.str, shape))`` then the bytes (the JAX
    package's formula)."""
    dtype_str, arr = _host_array(leaf)
    h = hashlib.sha256()
    h.update(str((dtype_str, arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _tree_digests(state: Any) -> List[Dict[str, str]]:
    return [{"path": path, "sha256": leaf_digest(leaf)} for path, leaf in flatten_tree(state)]


def _to_saved(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf, copy=True))


def _from_saved(saved: torch.Tensor, like: Any, path: str) -> Any:
    """``saved`` in ``like``'s form: its tensor type, device, dtype and shape."""
    if isinstance(like, torch.Tensor):
        if saved.dtype != like.dtype or tuple(saved.shape) != tuple(like.shape):
            raise ValueError(
                f"leaf {path}: checkpoint holds {saved.dtype}{tuple(saved.shape)}, "
                f"the target {like.dtype}{tuple(like.shape)}"
            )
        return saved.to(like.device)
    arr = saved.cpu().numpy()
    if isinstance(like, np.ndarray):
        if arr.dtype != like.dtype or arr.shape != like.shape:
            raise ValueError(
                f"leaf {path}: checkpoint holds {arr.dtype}{arr.shape}, "
                f"the target {like.dtype}{like.shape}"
            )
        return arr.copy()
    if isinstance(like, np.generic):
        return type(like)(arr)
    return type(like)(arr.item())


# ---------------------------------------------------------------------------
# manifests


def write_manifest(path: str, state: Any) -> str:
    manifest = {"format": 1, "leaves": _tree_digests(state)}
    target = os.path.join(path, MANIFEST_NAME)
    with open(target, "w") as f:
        json.dump(manifest, f, indent=1)
    return target


def verify_manifest(path: str, restored: Any) -> None:
    """Raise :class:`CheckpointIntegrityError` if ``restored`` does not
    reproduce the digests recorded at save time (compared as a multiset,
    as the reference does).  A checkpoint without a manifest passes."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        expected = sorted(leaf["sha256"] for leaf in manifest["leaves"])
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointIntegrityError(f"unreadable integrity manifest at {mpath}: {e}") from e
    actual = sorted(d["sha256"] for d in _tree_digests(restored))
    if expected != actual:
        bad = len(set(expected).symmetric_difference(actual))
        raise CheckpointIntegrityError(
            f"checkpoint {path} failed digest verification: "
            f"{bad} leaf digest(s) differ from the save-time manifest"
        )


# ---------------------------------------------------------------------------
# save / load


def _prev_path(path: str, k: int) -> str:
    """The k-th displaced checkpoint: ``path.prev``, ``path.prev2``, ..."""
    return path + (".prev" if k == 1 else f".prev{k}")


def checkpoint_fallbacks(path: str) -> List[str]:
    """The retained predecessors of ``path`` that exist, newest first."""
    out: List[str] = []
    k = 1
    while os.path.exists(_prev_path(path, k)):
        out.append(_prev_path(path, k))
        k += 1
    return out


def save_checkpoint(path: str, state: Any, keep_last: int = 1) -> str:
    """Save a tree to the directory ``path`` (write new, then rotate).
    Returns the absolute path.

    ``keep_last``: how many displaced checkpoints to keep (``path.prev`` ...
    ``path.prevN``); 0 deletes the predecessor once the new checkpoint has
    its name."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save({p: _to_saved(leaf) for p, leaf in flatten_tree(state)},
               os.path.join(tmp, PAYLOAD_NAME))
    # the manifest lands before the rename: a checkpoint is never visible
    # without it
    write_manifest(tmp, state)
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
    from scalerl_torch.runtime import chaos, telemetry

    inj = chaos.active()
    if inj is not None:
        # chaos: leave the freshly landed checkpoint partial (a preemption
        # mid-flush); restores must fall back through the .prev chain
        inj.corrupt_checkpoint(path)
    telemetry.record_event("checkpoint_save", path=path)
    telemetry.get_registry().counter("checkpoint.saves").inc()
    return path


def load_checkpoint(path: str, target: Optional[Any] = None, fallback: bool = True) -> Any:
    """Restore a tree from ``path``.  ``target`` gives the structure, leaf
    types, dtypes and devices; without one, a nested dict of CPU tensors
    keyed by the saved paths comes back.

    ``fallback``: when the latest checkpoint fails to restore, try the
    retained ``.prev`` chain; the first error is raised if all fail."""
    path = os.path.abspath(path)
    candidates = [path] + (checkpoint_fallbacks(path) if fallback else [])
    first_err: Optional[Exception] = None
    from scalerl_torch.runtime import telemetry

    for i, cand in enumerate(candidates):
        try:
            restored = _restore(cand, target)
            telemetry.record_event("checkpoint_restore", path=cand, fallback=cand != path)
            telemetry.get_registry().counter("checkpoint.restores").inc()
            return restored
        except Exception as e:  # noqa: BLE001 — try the retained predecessor
            if first_err is None:
                first_err = e
            if i + 1 < len(candidates):
                telemetry.record_event("checkpoint_fallback", path=cand, error=repr(e))
                telemetry.get_registry().counter("checkpoint.fallbacks").inc()
                logger.warning("checkpoint %s failed to restore (%r); falling back to %s",
                               cand, e, candidates[i + 1])
    assert first_err is not None
    raise first_err


def _target_device(target: Any) -> torch.device:
    for _, leaf in flatten_tree(target):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _restore(path: str, target: Optional[Any]) -> Any:
    device = _target_device(target) if target is not None else torch.device("cpu")
    saved = torch.load(os.path.join(path, PAYLOAD_NAME), map_location=device,
                       weights_only=True)
    if target is None:
        restored = _nest(saved)
    else:
        wanted = flatten_tree(target)
        missing = [p for p, _ in wanted if p not in saved]
        if missing or len(saved) != len(wanted):
            raise ValueError(
                f"checkpoint {path} holds {len(saved)} leaves, the target {len(wanted)}"
                + (f"; missing {missing[:3]}" if missing else "")
            )
        restored = _rebuild(target, {p: _from_saved(saved[p], like, p) for p, like in wanted})
    verify_manifest(path, restored)
    return restored

