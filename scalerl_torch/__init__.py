"""ScaleRL on PyTorch and CUDA: the port of ``scalerl_tpu`` to one NVIDIA H100.

The package keeps the JAX package's module names so each module has an
obvious counterpart (``scalerl_torch/ops/vtrace.py`` <-> ``scalerl_tpu/ops/
vtrace.py`` and so on), and the JAX package's layouts at its public
functions: time-major ``[T, B, ...]`` trajectories and NHWC uint8 frames.

Ported so far: the fused IMPALA loop (V-trace kernel), DQN with prioritized
replay (PER sample and update kernels), token generation over a paged KV
cache (paged decode attention kernel), token-PPO training over packed rows
(segment flash attention, forward and both backward kernels):
``trainer/sequence_rl.py::SequenceRLTrainer`` closes the loop generate ->
score -> pack -> replay -> learn -> push, and the transformer-policy IMPALA
learner (``policy_arch="transformer"``, optionally with bf16 params) whose
attention runs through the flash attention kernels (forward, dq, dk/dv)
behind ``TransformerPolicy(use_flash=True)``.  Every TPU kernel of the JAX
package now has a hand-written CUDA counterpart.  The JAX package's IMPALA
entry point has its twin, ``examples/train_impala_torch.py``: the fused
trainer and the host actor plane (``trainer/actor_learner.py``) with a run
directory, loggers, telemetry export, resume checkpoints
(``utils/checkpoint.py``) and supervision (``runtime/supervisor.py``).
The fleet (``fleet/cluster.py``, ``runtime/autoscaler.py``) feeds learners
on the card from worker processes on the host, over pipes or TCP.

It imports ``torch`` and numpy only.  Entry points default to
``device="cuda"`` and raise when no card is present; pass ``device="cpu"``
to run the plain PyTorch versions of the kernels on the host.
"""
