"""Argument schemas the ported slices read.

The port's own copies of the ``scalerl_tpu/config.py`` fields that the fused
IMPALA loop and the DQN off-policy trainer read, with the same names and
defaults, so an argument set means the same thing to both packages.  Fields
that no module of the port reads yet are left out; they arrive with the
modules that read them.  Among them are the checkpoint fields
(``save_model``, ``save_frequency``, ...) and the telemetry fields, whose
JAX defaults switch those features on: until they are ported, asking for
them is a ``TypeError``.  ``resume`` and ``divergence_rollback_steps`` are
kept with their JAX defaults (off), and :meth:`RLArguments.validate` raises
if either is set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RLArguments:
    """Common arguments (``scalerl_tpu.config.RLArguments``)."""

    seed: int = 42
    num_envs: int = 8
    buffer_size: int = 10000
    batch_size: int = 32
    rollout_length: int = 20
    warmup_learn_steps: int = 500
    learning_rate: float = 1e-3
    gamma: float = 0.99
    max_grad_norm: float = 40.0
    max_timesteps: int = 100_000
    train_frequency: int = 10
    eval_episodes: int = 5
    eval_frequency: int = 1000
    logger_frequency: int = 500
    # Not ported yet (trainer/base.py resume checkpoints): must stay "".
    resume: str = ""
    # All-finite update guard (parallel/train_step.py): a learn step whose
    # result holds NaN/Inf is skipped and counted as skipped_steps.
    nonfinite_guard: bool = True
    # Run the guard's check only on steps where step % K == 0.
    nonfinite_check_every: int = 1
    # Not ported yet (the divergence tripwire's rollback): must stay 0.
    divergence_rollback_steps: int = 0
    # Route the hand-written CUDA kernels in: V-trace (ops/cuda_vtrace.py)
    # and both halves of prioritized replay, sampling and the priority
    # update (ops/cuda_per.py).  On host tensors their plain versions run.
    use_pallas: bool = False

    def validate(self) -> None:
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.num_envs <= 0:
            raise ValueError(f"num_envs must be positive, got {self.num_envs}")
        if self.buffer_size < self.batch_size:
            raise ValueError(
                f"buffer_size ({self.buffer_size}) must be >= batch_size "
                f"({self.batch_size})"
            )
        if self.resume:
            raise NotImplementedError("resume checkpoints are not ported yet; leave resume empty")
        if self.divergence_rollback_steps > 0:
            raise NotImplementedError(
                "the divergence tripwire is not ported yet; leave divergence_rollback_steps at 0"
            )
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


@dataclass
class DQNArguments(RLArguments):
    """DQN options (``scalerl_tpu.config.DQNArguments``)."""

    double_dqn: bool = True
    dueling_dqn: bool = False
    noisy_dqn: bool = False  # NoisyDense is not ported yet: QNet raises
    hidden_sizes: str = "128,128"
    # Exploration: epsilon decays linearly over exploration_fraction of
    # max_timesteps.
    eps_greedy_start: float = 1.0
    eps_greedy_end: float = 0.05
    exploration_fraction: float = 0.5
    # Learning-rate schedule: "linear" decays to min_learning_rate over the
    # learn steps of the run; anything else keeps it constant.
    lr_scheduler: str = "none"
    min_learning_rate: float = 1e-5
    # Target network
    target_update_frequency: int = 100
    soft_update_tau: float = 0.005
    use_soft_update: bool = True
    # Replay variants
    use_per: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_beta_final: float = 1.0
    n_steps: int = 1

    def validate(self) -> None:
        super().validate()
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if not (0.0 <= self.per_alpha <= 1.0):
            raise ValueError(f"per_alpha must be in [0, 1], got {self.per_alpha}")
