"""ScaleRL on PyTorch and CUDA: the port of ``scalerl_tpu`` to one NVIDIA H100.

The package keeps the JAX package's module names so each module has an
obvious counterpart (``scalerl_torch/ops/vtrace.py`` <-> ``scalerl_tpu/ops/
vtrace.py`` and so on), and the JAX package's layouts at its public
functions: time-major ``[T, B, ...]`` trajectories and NHWC uint8 frames.

Ported so far: the fused IMPALA loop (V-trace kernel), DQN with prioritized
replay (PER sample and update kernels), token generation over a paged KV
cache (paged decode attention kernel), and token-PPO training over packed
rows (segment flash attention, forward and both backward kernels):
``trainer/sequence_rl.py::SequenceRLTrainer`` closes the loop generate ->
score -> pack -> replay -> learn -> push.  The one TPU kernel still to port is
``flash_attention`` behind ``TransformerPolicy(use_flash=True)``.

It imports ``torch`` and numpy only.  Entry points default to
``device="cuda"`` and raise when no card is present; pass ``device="cpu"``
to run the plain PyTorch versions of the kernels on the host.
"""
