"""Generation-tagged parameter snapshots for the generation engines.

Port of ``scalerl_tpu/runtime/param_server.py::ParamSnapshotPlane`` over
torch parameter dicts (``{name: tensor}``, a module's ``state_dict``
layout).  :meth:`ParamSnapshotPlane.push_params` publishes a device-side
copy of every tensor (the copy detaches the snapshot from the learner's
live parameters, which an optimizer updates in place) on the plane's
device, with a monotonic generation bump and no host transfer;
``_snapshot_params`` hands consumers the current ``(params, generation)``;
:meth:`staleness_steps` reads the bounded generation -> learner-step map.

A quantized push (``quantize="int8" | "bf16"``, ``runtime/quantize.py``)
stores the compressed snapshot instead and dequantizes ON READ, cached
until the next push: a replica holds the small format at rest and pays one
dequantization a publish.  A consumer that holds its rank's shards sets
``_shard_ctx`` (a meshed engine): the quantization runs inside that
computation on shards, so a sharded leaf gets the whole leaf's int8
scale.

:class:`ParameterServer` is the pull endpoint over the same plane: pullers
get numpy weights with a version, fetched to the host once a version.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.runtime.quantize import dequantize_tree, quantize_tree

Params = Dict[str, torch.Tensor]

# seconds a puller over a pipe waits for the weight service's reply before
# it gives up (a learner that died without closing the pipe must not hang
# its actors)
PULL_TIMEOUT_S = 120.0


def _copy_params(params: Mapping[str, torch.Tensor], device: torch.device) -> Params:
    return {k: v.detach().to(device, copy=True) for k, v in params.items()}


class ParamSnapshotPlane:
    """Mixin: a consumer calls ``_init_param_plane(params, device)`` once,
    then ``push_params`` / ``_snapshot_params`` / ``staleness_steps``."""

    _GEN_STEPS_CAP = 64
    _shard_ctx = None

    def _init_param_plane(self, params: Optional[Mapping[str, torch.Tensor]],
                          device: torch.device) -> None:
        self._param_lock = threading.Lock()
        self._param_device = device
        self._params = None if params is None else _copy_params(params, device)
        self._quantized = None
        self.generation = 0
        self._gen_steps: Dict[int, int] = {0: 0}
        self._latest_learner_step = 0

    def push_params(
        self,
        params: Mapping[str, torch.Tensor],
        learner_step: Optional[int] = None,
        quantize: Optional[str] = None,
    ) -> int:
        """Publish fresh params (device-side copy, or the quantized
        snapshot, + monotonic generation bump).  Returns the new
        generation."""
        snapshot, qsnap = _copy_params(params, self._param_device), None
        if quantize is not None:
            from scalerl_torch.parallel.sharding import shard_context

            # quantized from the copy, so the 1-D leaves it passes through
            # never alias the live params
            with shard_context(self._shard_ctx):
                snapshot, qsnap = None, quantize_tree(snapshot, quantize)
        with self._param_lock:
            self.generation += 1
            gen = self.generation
            self._params = snapshot
            self._quantized = qsnap
            self._record_step(gen, learner_step)
            return gen

    def _record_step(self, gen: int, learner_step: Optional[int]) -> None:
        """Under the param lock: extend the bounded generation -> step map."""
        self._latest_learner_step = int(learner_step) if learner_step is not None else gen
        self._gen_steps[gen] = self._latest_learner_step
        while len(self._gen_steps) > self._GEN_STEPS_CAP:
            self._gen_steps.pop(min(self._gen_steps))

    def generation_map(self) -> np.ndarray:
        """``[[generation, newest learner step], [g, step of g], ...]``
        int64: what :meth:`restore_params` takes back from a checkpoint."""
        with self._param_lock:
            head = [(self.generation, self._latest_learner_step)]
            return np.array(head + sorted(self._gen_steps.items()), np.int64)

    def restore_params(self, params: Mapping[str, torch.Tensor], generation_map: np.ndarray) -> None:
        """Publish ``params`` under the generation and generation -> step
        map that :meth:`generation_map` gave (a resumed run)."""
        rows = [tuple(int(v) for v in r) for r in np.asarray(generation_map)]
        snapshot = _copy_params(params, self._param_device)
        with self._param_lock:
            self.generation, self._latest_learner_step = rows[0]
            self._gen_steps = dict(rows[1:])
            self._params, self._quantized = snapshot, None

    def _snapshot_params(self) -> Tuple[Params, int]:
        with self._param_lock:
            if self._params is None and self._quantized is not None:
                # dequantize on read, cached until the next push
                self._params = dequantize_tree(self._quantized)
            return self._params, self.generation

    def staleness_steps(self, served_generation: int) -> float:
        """Learner steps between the newest pushed params and the
        generation that produced a sequence (the generation delta for
        generations older than the bounded map)."""
        with self._param_lock:
            newest = self._latest_learner_step
            served = self._gen_steps.get(int(served_generation), int(served_generation))
        return float(max(newest - served, 0))


def _to_host(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """numpy copies of tensors; numpy leaves (a fleet publishing host
    weights) pass through."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in params.items()}


class ParameterServer(ParamSnapshotPlane):
    """The pull endpoint (``scalerl_tpu/runtime/param_server.py::
    ParameterServer``): ``version`` is the plane's generation, and pullers
    always receive host (numpy) weights."""

    def __init__(self) -> None:
        self._init_param_plane(None, torch.device("cpu"))
        self._is_host = True

    @property
    def version(self) -> int:
        with self._param_lock:
            return self.generation

    def push(self, weights: Mapping[str, torch.Tensor], to_host: bool = True) -> int:
        """Publish new weights; returns the new version.

        ``to_host=True`` fetches them to numpy here, once for every pull.
        A learner whose actors act on the device pushes with
        ``to_host=False``: a device-side copy (detached from the live
        parameters) and a version bump, no host sync; the numpy copy is made
        at the first pull of that version."""
        if to_host:
            snapshot: Any = _to_host(weights)
        else:
            snapshot = {k: v.detach().clone() for k, v in weights.items()}
        with self._param_lock:
            self.generation += 1
            self._params = snapshot
            self._quantized = None
            self._is_host = to_host
            self._record_step(self.generation, None)
            return self.generation

    def pull(self, have_version: int = -1) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """``(numpy weights, version)``, or ``(None, version)`` when the
        caller already has this version.  A device push is fetched outside
        the lock, so a slow pull never holds up the next push."""
        with self._param_lock:
            if self._params is None or have_version == self.generation:
                return None, self.generation
            weights, version, is_host = self._params, self.generation, self._is_host
        if not is_host:
            weights = _to_host(weights)
            with self._param_lock:
                if self.generation == version:
                    self._params = weights
                    self._is_host = True
        return weights, version
