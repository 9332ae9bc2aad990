"""V-trace targets through the hand-written CUDA kernel ``csrc/vtrace.cu``.

Replaces the TPU kernel ``scalerl_tpu/ops/pallas_vtrace.py::
vtrace_from_importance_weights_pallas`` (``_vtrace_kernel``).  A CTA owns a
tile of batch columns and walks the time axis backwards in chunks that
``cp.async`` stages through shared memory, double-buffered; the elementwise
terms are computed over each chunk in parallel, and one thread per column
runs the recursion over it from shared memory.  The source says more.

What bounds it on an H100: it moves ``6*T*B*4 + 4*B`` bytes (about 0.25 MB
at the fused loop's ``[20, 512]``, 0.074 us at 3.35 TB/s), so one launch
costs about the launch latency plus one trip to memory a chunk; the fused
loop launches it once per learn step.

The wrapper takes the reference function's signature.  A host tensor runs
the plain PyTorch version (``ops/vtrace.py::vtrace_scan``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches, and
nothing else.  The eager path is kept short, since the main path calls it
once a learn step: one chain of tests for inputs that pass, the launcher
resolved once, ``empty_like`` for the outputs, the raw stream handle, and
no device switch when the tensors are on the current device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalerl_torch.ops.vtrace import VTraceOutput, vtrace_scan
from scalerl_torch.utils import cuda_build

# Kernel launches since the last reset (a plain count; callers zero it).
launches = 0

_NAMES = ("log_rhos", "discounts", "rewards", "values", "bootstrap_value")
_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p,
]
_launch = None  # vtrace_launch of the built library, resolved at the first launch


def _launcher():
    global _launch
    if _launch is None:
        fn = cuda_build.load("vtrace").vtrace_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check_inputs(*inputs: torch.Tensor):
    """Raises on what the kernel does not take; returns ``(T, B)``.  Inputs
    that pass take one chain of tests; the first failure names its input."""
    log_rhos, discounts, rewards, values, bootstrap_value = inputs
    shape = log_rhos.shape
    device = log_rhos.device
    f32 = torch.float32
    if (len(shape) == 2 and shape[0] >= 1 and shape[1] >= 1
            and discounts.shape == shape and rewards.shape == shape and values.shape == shape
            and bootstrap_value.shape == shape[1:]
            and log_rhos.dtype is f32 and discounts.dtype is f32 and rewards.dtype is f32
            and values.dtype is f32 and bootstrap_value.dtype is f32
            and discounts.device == device and rewards.device == device
            and values.device == device and bootstrap_value.device == device
            and log_rhos.is_contiguous() and discounts.is_contiguous()
            and rewards.is_contiguous() and values.is_contiguous()
            and bootstrap_value.is_contiguous()):
        return shape
    if len(shape) != 2:
        raise ValueError(f"log_rhos must be [T, B], got {tuple(shape)}")
    T, B = shape
    if T < 1 or B < 1:
        raise ValueError(f"V-trace needs T >= 1 and B >= 1, got [{T}, {B}]")
    for i, x in enumerate(inputs):
        name = _NAMES[i]
        want = (B,) if i == 4 else (T, B)
        if x.shape != want:
            raise ValueError(f"{name} must have shape {want}, got {tuple(x.shape)}")
        if x.dtype is not f32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, log_rhos on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return T, B


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

    The outputs are constants (no autograd history).  float32, ``[T, B]``
    planes and a ``[B]`` bootstrap row, contiguous, on one device.
    """
    global launches
    inputs = (log_rhos, discounts, rewards, values, bootstrap_value)
    T, B = _check_inputs(*inputs)
    device = log_rhos.device
    if device.type == "cpu":
        return vtrace_scan(*inputs, clip_rho_threshold, clip_pg_rho_threshold,
                           clip_c_threshold)
    if device.type != "cuda":
        raise ValueError(f"no V-trace kernel for device {device}")
    launch = _launcher()
    vs, pg = torch.empty_like(log_rhos), torch.empty_like(log_rhos)
    args = (
        log_rhos.data_ptr(), discounts.data_ptr(), rewards.data_ptr(), values.data_ptr(),
        bootstrap_value.data_ptr(), vs.data_ptr(), pg.data_ptr(), T, B,
        float(clip_rho_threshold or 0.0), clip_rho_threshold is not None,
        float(clip_pg_rho_threshold or 0.0), clip_pg_rho_threshold is not None,
        float(clip_c_threshold),
    )
    # the raw stream handle (as Triton reads it): torch.cuda.current_stream
    # builds a Stream object and costs ~3 us more a call
    if device.index == torch.cuda.current_device():
        err = launch(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = launch(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: cudaError {err}")
    launches += 1
    return VTraceOutput(vs, pg)
