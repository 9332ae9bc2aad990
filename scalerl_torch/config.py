"""Argument schemas the IMPALA slice reads.

The port's own copies of the ``scalerl_tpu/config.py`` fields that the fused
IMPALA loop reads, with the same names and defaults, so an argument set
means the same thing to both packages.  Fields that no module of the port
reads yet are left out; they arrive with the modules that read them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RLArguments:
    """Common arguments (``scalerl_tpu.config.RLArguments``)."""

    seed: int = 42
    batch_size: int = 32
    rollout_length: int = 20
    learning_rate: float = 1e-3
    gamma: float = 0.99
    max_grad_norm: float = 40.0
    max_timesteps: int = 100_000
    # All-finite update guard (parallel/train_step.py): a learn step whose
    # result holds NaN/Inf is skipped and counted as skipped_steps.
    nonfinite_guard: bool = True
    # Run the guard's check only on steps where step % K == 0.
    nonfinite_check_every: int = 1
    # Route V-trace through the hand-written CUDA kernel
    # (ops/cuda_vtrace.py); on host tensors its plain version runs.
    use_pallas: bool = False

    def validate(self) -> None:
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.nonfinite_check_every < 1:
            raise ValueError(
                "nonfinite_check_every must be >= 1, got "
                f"{self.nonfinite_check_every}"
            )


@dataclass
class ImpalaArguments(RLArguments):
    """IMPALA options (``scalerl_tpu.config.ImpalaArguments``)."""

    use_lstm: bool = True
    hidden_size: int = 512
    # Compute dtype of the conv/dense torso ("float32" | "bfloat16"); params,
    # heads, V-trace and the optimizer stay float32.
    compute_dtype: str = "float32"
    rollout_length: int = 80
    batch_size: int = 8
    reward_clipping: str = "abs_one"  # abs_one | none
    baseline_cost: float = 0.5
    entropy_cost: float = 0.01
    # Optional linear entropy anneal entropy_cost -> entropy_cost_end over
    # entropy_anneal_frames env frames (None/0 = constant).
    entropy_cost_end: Optional[float] = None
    entropy_anneal_frames: int = 0
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    learning_rate: float = 6e-4
    rmsprop_alpha: float = 0.99
    rmsprop_eps: float = 0.01
    rmsprop_momentum: float = 0.0
    max_grad_norm: float = 40.0
    max_timesteps: int = 30_000_000

    @property
    def discounting(self) -> float:
        return self.gamma

    @property
    def total_steps(self) -> int:
        return self.max_timesteps
