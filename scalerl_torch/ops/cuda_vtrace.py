"""V-trace targets through the hand-written CUDA kernel ``csrc/vtrace.cu``.

Replaces the TPU kernel ``scalerl_tpu/ops/pallas_vtrace.py::
vtrace_from_importance_weights_pallas`` (``_vtrace_kernel``).  One CUDA
thread owns one batch column and walks the time axis backwards once, so the
recursion lives in registers and every access to the ``[T, B]`` planes is
coalesced; the source says more.

What bounds it on an H100: it moves ``6*T*B*4 + 4*B`` bytes (about 0.25 MB
at the fused loop's ``[20, 512]``, well under a microsecond at 3.35 TB/s),
so one launch costs about the launch latency; the fused loop launches it
once per learn step.

The wrapper takes the reference function's signature.  A host tensor runs
the plain PyTorch version (``ops/vtrace.py::vtrace_scan``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalerl_torch.ops.vtrace import VTraceOutput, vtrace_scan
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (a plain count; callers zero it).
launches = 0

_c_float = ctypes.c_float
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


def _launcher():
    lib = cuda_build.load("vtrace")
    fn = lib.vtrace_launch
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr] * 7 + [
            _c_int, _c_int,
            _c_float, _c_int, _c_float, _c_int, _c_float,
            _c_ptr,
        ]
        fn.restype = _c_int
    return fn


def _check_inputs(log_rhos, discounts, rewards, values, bootstrap_value) -> None:
    planes = {"log_rhos": log_rhos, "discounts": discounts,
              "rewards": rewards, "values": values}
    if log_rhos.dim() != 2:
        raise ValueError(f"log_rhos must be [T, B], got {tuple(log_rhos.shape)}")
    T, B = log_rhos.shape
    if T < 1 or B < 1:
        raise ValueError(f"V-trace needs T >= 1 and B >= 1, got [{T}, {B}]")
    for name, x in {**planes, "bootstrap_value": bootstrap_value}.items():
        want = (B,) if name == "bootstrap_value" else (T, B)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != log_rhos.device:
            raise ValueError(
                f"{name} is on {x.device}, log_rhos on {log_rhos.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def vtrace_from_importance_weights_kernel(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: float = 1.0,
) -> VTraceOutput:
    """Same contract as ``ops.vtrace.vtrace_from_importance_weights``.

    Inputs are detached; the outputs are constants.  float32, ``[T, B]``
    planes and a ``[B]`` bootstrap row, contiguous, on one device.
    """
    global launches
    inputs = tuple(
        x.detach() for x in (log_rhos, discounts, rewards, values, bootstrap_value)
    )
    _check_inputs(*inputs)
    clips = dict(
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        clip_c_threshold=clip_c_threshold,
    )
    device = inputs[0].device
    if device.type == "cpu":
        return vtrace_scan(*inputs, **clips)
    if device.type != "cuda":
        raise ValueError(f"no V-trace kernel for device {device}")
    T, B = inputs[0].shape
    vs = torch.empty((T, B), dtype=torch.float32, device=device)
    pg = torch.empty((T, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            *(x.data_ptr() for x in inputs), vs.data_ptr(), pg.data_ptr(),
            T, B,
            float(clip_rho_threshold or 0.0), int(clip_rho_threshold is not None),
            float(clip_pg_rho_threshold or 0.0),
            int(clip_pg_rho_threshold is not None),
            float(clip_c_threshold),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: cudaError {err}")
    launches += 1
    return VTraceOutput(vs=vs, pg_advantages=pg)
