"""ScaleRL on PyTorch and CUDA: the port of ``scalerl_tpu`` to one NVIDIA H100.

The package keeps the JAX package's module names so each module has an
obvious counterpart (``scalerl_torch/ops/vtrace.py`` <-> ``scalerl_tpu/ops/
vtrace.py`` and so on), and the JAX package's layouts at its public
functions: time-major ``[T, B, ...]`` trajectories and NHWC uint8 frames.

It imports ``torch`` and numpy only.  Entry points default to
``device="cuda"`` and raise when no card is present; pass ``device="cpu"``
to run the plain PyTorch versions of the kernels on the host.
"""
