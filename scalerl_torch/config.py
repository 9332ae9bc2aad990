"""Argument schemas the ported slices read, and a dataclass-driven CLI.

The port's own copies of the ``scalerl_tpu/config.py`` fields that the
fused IMPALA loop, the actor-learner trainers, the DQN, Ape-X and R2D2
trainers, the sequence-RL trainer, and the A3C, PPO, IMPACT, SAC and TD3
learners read, with the same names and defaults, so an
argument set means the same thing to both packages: among them the run
identity and directory, the logging, checkpoint, supervision and telemetry
fields.  Fields that no module of the port reads yet are left out; they
arrive with the modules that read them.  :func:`parse_args` gives each
field an option under the JAX package's spelling (``--max-timesteps``,
``--env-backend``, ``--save-model false``).
"""

from __future__ import annotations

import argparse
import typing
from dataclasses import dataclass, fields
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")


@dataclass
class RLArguments:
    """Common arguments (``scalerl_tpu.config.RLArguments``)."""

    # Run identity: the run directory is
    # work_dir/project/env_id/algo_name/<run name> (trainer/base.py)
    project: str = "scalerl_tpu"
    algo_name: str = "dqn"
    seed: int = 42

    # Environment: env_backend "jax" runs the fused loop over the port's
    # tensor envs (the JAX package's device-native envs), "gym" host envs
    # behind gym's vector API
    env_id: str = "CartPole-v1"
    num_envs: int = 8
    env_backend: str = "gym"
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

    # Actors (the host actor plane, trainer/actor_learner.py)
    num_actors: int = 4

    # Logging and checkpoints (trainer/base.py, utils/loggers.py,
    # utils/checkpoint.py)
    work_dir: str = "work_dirs"
    logger_backend: str = "tensorboard"  # tensorboard | wandb | none
    save_model: bool = True
    save_frequency: int = 10_000
    disable_checkpoint: bool = False
    # A previous run directory (the one holding model_dir and tb_log) to
    # resume from: train state, replay, counters and the logger's gates.
    resume: str = ""

    # Supervision (runtime/supervisor.py)
    # Wall-clock resume-save cadence beside the frame-gated save_frequency:
    # whichever fires first; <= 0 turns the wall-clock gate off.
    checkpoint_interval_s: float = 600.0
    # Displaced resume checkpoints kept (resume.prev, resume.prev2, ...);
    # a load falls back through them when the latest is corrupt.
    checkpoint_keep_last: int = 1
    # Stall watchdog deadline in seconds; <= 0 turns it off.
    watchdog_timeout_s: float = 0.0
    # SIGTERM/SIGINT write the resume checkpoint at the next safe point
    # and end the run cleanly; a second signal force-quits.
    handle_preemption: bool = True

    # Observability (runtime/telemetry.py, utils/profiling.py)
    # A torch.profiler trace of the training run into this directory
    # (empty: none).
    profile_dir: str = ""
    # Where the telemetry export loop writes telemetry.jsonl and
    # metrics.prom; empty means <run dir>/telemetry.
    telemetry_dir: str = ""
    # Export cadence in seconds; <= 0 turns the export loop and every
    # registry write of the trainers off.
    telemetry_interval_s: float = 30.0

    # All-finite update guard (parallel/train_step.py): a learn step whose
    # result holds NaN/Inf is skipped and counted as skipped_steps.
    nonfinite_guard: bool = True
    # Run the guard's check only on steps where step % K == 0.
    nonfinite_check_every: int = 1
    # Divergence tripwire: after this many consecutive skipped learn steps
    # the trainer restores the agent from its last good resume checkpoint;
    # <= 0 turns the rollback off (the guard still skips bad steps).
    divergence_rollback_steps: int = 0

    # Elastic fleet (runtime/autoscaler.py, fleet/cluster.py's admission and
    # drain): the autoscaler reads the fleet's signals (actor production vs
    # learner consumption vs queue occupancy, and the sheds) and scales the
    # fleet up or drains it, with hysteresis and a cooldown.  The fleet entry
    # points wire it when on.
    autoscale: bool = False
    # Hard floor: a fleet below it is backfilled at once (no hysteresis, no
    # cooldown).
    autoscale_min_workers: int = 1
    # Hard ceiling for scale-up.
    autoscale_max_workers: int = 32
    # Evaluation cadence of the control loop, seconds.
    autoscale_interval_s: float = 5.0
    # Hold window after any scale action, seconds.
    autoscale_cooldown_s: float = 30.0
    # Consecutive same-direction verdicts before acting (scale-down needs one
    # more than scale-up).
    autoscale_hysteresis: int = 2
    # Generation-tier guard: consumed data staler than this many learner
    # steps is scale-up pressure; 0 turns the rule off.
    autoscale_max_staleness: float = 0.0
    # Serving-tier capacity rules (serving/router.py's replicas): aggregate
    # p95 past the up threshold adds a replica, under the down threshold
    # drains one; 0 turns either side off.
    autoscale_serving_up_p95_ms: float = 0.0
    autoscale_serving_down_p95_ms: float = 0.0

    # Route the hand-written CUDA kernels in: V-trace (ops/cuda_vtrace.py),
    # both halves of prioritized replay, sampling and the priority update
    # (ops/cuda_per.py), and the transformer policy's attention
    # (ops/cuda_flash_attention.py).  On host tensors their plain versions run.
    use_pallas: bool = False
    # The sharded learner's mesh (parallel/mesh.py): an explicit spec such as
    # "dp=8" or "dp=4,mp=2", or the dp x mp topology from dp_size and mp_size
    # (dp_size 0 takes every remaining rank); the trainers resolve it through
    # parallel/train_step.py::maybe_enable_mesh_from_args.
    mesh_shape: Optional[str] = None
    mp_size: int = 1
    dp_size: int = 0
    # Policy architecture for the actor-learner agents: "transformer" picks
    # models/transformer_policy.py::TransformerPolicyNet, sized by d_model,
    # n_layers and n_heads; "moe" picks models/moe.py::MoEPolicyNet, sized by
    # d_model, moe_experts and moe_hidden; "auto" keeps the agent's own model.
    policy_arch: str = "auto"
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    moe_experts: int = 8
    moe_hidden: int = 256
    # bf16 params and compute with float32 heads and float32 optimizer state
    # (parallel/train_step.py::fp32_optimizer_state).  Only the transformer
    # architecture stores bf16 params; IMPALA wraps its optimizer either way.
    bf16_params: bool = False

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
        if self.nonfinite_check_every < 1:
            raise ValueError(
                "nonfinite_check_every must be >= 1, got "
                f"{self.nonfinite_check_every}"
            )
        if self.mp_size < 1:
            raise ValueError(f"mp_size must be >= 1, got {self.mp_size}")
        if self.dp_size < 0:
            raise ValueError(f"dp_size must be >= 0, got {self.dp_size}")
        if self.policy_arch not in ("auto", "transformer", "moe"):
            raise ValueError(
                f"policy_arch must be auto | transformer | moe, got {self.policy_arch!r}"
            )
        if self.autoscale_min_workers < 0:
            raise ValueError(
                "autoscale_min_workers must be >= 0, got "
                f"{self.autoscale_min_workers}"
            )
        if self.autoscale_max_workers < self.autoscale_min_workers:
            raise ValueError(
                f"autoscale_max_workers ({self.autoscale_max_workers}) must "
                f"be >= autoscale_min_workers ({self.autoscale_min_workers})"
            )
        if self.autoscale and self.autoscale_interval_s <= 0:
            raise ValueError(
                "autoscale_interval_s must be positive with autoscale on, "
                f"got {self.autoscale_interval_s}"
            )
        if self.autoscale_hysteresis < 1:
            raise ValueError(
                "autoscale_hysteresis must be >= 1, got "
                f"{self.autoscale_hysteresis}"
            )


@dataclass
class ImpalaArguments(RLArguments):
    """IMPALA options (``scalerl_tpu.config.ImpalaArguments``)."""

    algo_name: str = "impala"
    use_lstm: bool = True
    hidden_size: int = 512
    # Compute dtype of the conv/dense torso ("float32" | "bfloat16"); params,
    # heads, V-trace and the optimizer stay float32.
    compute_dtype: str = "float32"
    rollout_length: int = 80
    num_actors: int = 8
    # Host actor topology: "threads" = SEED-style central inference through
    # the agent (HostActorLearnerTrainer); "process" = monobeast-style actor
    # processes with their own CPU policy over the shared-memory ring
    # (ProcessActorLearnerTrainer); "serving" = the inference plane of
    # serving/: actors act through RemotePolicyClients against one
    # InferenceServer (dynamic batching, generation tags, latency SLOs)
    actor_mode: str = "threads"
    # Inference-plane knobs (ServingConfig.from_args; read when
    # actor_mode="serving"): flush a serve batch at this many pending lanes
    serve_max_batch: int = 64
    # ... or once the oldest pending request has waited this long
    serve_max_wait_ms: float = 5.0
    # bounded admission: shed act requests beyond this queue depth; 0
    # disables shedding
    serve_max_pending: int = 256
    num_buffers: int = 32  # rollout slots of the host plane's queue
    # >= 2 adds num_learner_threads - 1 batch-assembly threads
    num_learner_threads: int = 1
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

    def validate(self) -> None:
        super().validate()
        # num_buffers counts slots (one actor's vector-env lanes each), so
        # only the shape-free minimum holds here; the trainer checks the
        # floor that needs the env fleet's shape (check_queue_depth)
        if self.num_buffers < max(2, self.num_actors):
            raise ValueError(
                "num_buffers (slot count) must be at least "
                "max(2, num_actors) "
                f"(got {self.num_buffers}, num_actors={self.num_actors})"
            )
        if self.actor_mode not in ("threads", "process", "serving"):
            raise ValueError(
                "actor_mode must be threads | process | serving, got "
                f"{self.actor_mode!r}"
            )
        if self.serve_max_batch < 1:
            raise ValueError(f"serve_max_batch must be >= 1, got {self.serve_max_batch}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(f"serve_max_wait_ms must be >= 0, got {self.serve_max_wait_ms}")
        if self.serve_max_pending < 0:
            raise ValueError(f"serve_max_pending must be >= 0, got {self.serve_max_pending}")


@dataclass
class ImpactArguments(ImpalaArguments):
    """IMPACT options (``scalerl_tpu.config.ImpactArguments``, arxiv
    1912.00167): a target network refreshed every
    ``target_update_frequency`` learner steps anchors a clipped surrogate,
    and a circular buffer replays each trajectory chunk ``replay_times``
    times on the IMPALA actor plane."""

    algo_name: str = "impact"
    # learner steps between target-network refreshes (pi_target <- pi)
    target_update_frequency: int = 16
    # how many learner updates each inserted chunk participates in
    replay_times: int = 2
    # circular surrogate buffer depth, in trajectory chunks
    surrogate_capacity: int = 16
    # PPO-style clip width for the pi/pi_target surrogate ratio
    impact_clip: float = 0.3

    def validate(self) -> None:
        super().validate()
        if self.target_update_frequency < 1:
            raise ValueError(
                "target_update_frequency must be >= 1, got "
                f"{self.target_update_frequency}"
            )
        if self.replay_times < 1:
            raise ValueError(
                f"replay_times must be >= 1, got {self.replay_times}"
            )
        if self.surrogate_capacity < 1:
            raise ValueError(
                f"surrogate_capacity must be >= 1, got {self.surrogate_capacity}"
            )
        if not 0.0 < self.impact_clip < 1.0:
            raise ValueError(
                f"impact_clip must be in (0, 1), got {self.impact_clip}"
            )


@dataclass
class A3CArguments(RLArguments):
    """A3C options (``scalerl_tpu.config.A3CArguments``): synchronous batched
    advantage actor-critic over ``num_workers`` env lanes; the unroll is
    ``rollout_length``."""

    algo_name: str = "a3c"
    num_workers: int = 8
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    gae_lambda: float = 1.0
    hidden_sizes: str = "128,128"  # MLP torso (flat obs)
    use_lstm: bool = True  # pixel obs: conv+LSTM
    hidden_size: int = 256  # pixel obs: LSTM width
    max_episode_steps: int = 500
    max_grad_norm: float = 50.0
    # running mean/std obs normalization (envs/atari.py::NormalizedEnv) and
    # normalized-columns head init
    normalize_obs: bool = False
    normalized_init: bool = False


@dataclass
class PPOArguments(RLArguments):
    """PPO options (``scalerl_tpu.config.PPOArguments``): the clipped
    surrogate on the on-policy runtime A3C uses, ``ppo_epochs`` passes of
    ``num_minibatches`` lane minibatches per chunk.

    Learning-rate convention: with ``loss_reduction="sum"`` the losses sum
    over ``[T, b]``, so the gradient scale grows with ``rollout_length``
    and the lanes of a minibatch; ``"mean"`` divides by that count."""

    algo_name: str = "ppo"
    num_workers: int = 8
    # Clipped-surrogate objective
    clip_range: float = 0.2
    clip_range_vf: float = 0.0  # 0 disables value clipping
    ppo_epochs: int = 4
    num_minibatches: int = 4  # minibatches per epoch, split over env lanes
    gae_lambda: float = 0.95
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    normalize_advantage: bool = True
    loss_reduction: str = "sum"  # sum | mean
    # Model (same zoo as A3C: MLP for flat obs, conv[+LSTM] for pixels)
    hidden_sizes: str = "128,128"
    use_lstm: bool = False
    hidden_size: int = 256
    max_episode_steps: int = 500
    max_grad_norm: float = 0.5
    normalize_obs: bool = False
    normalized_init: bool = False

    def validate(self) -> None:
        super().validate()
        if self.num_minibatches <= 0:
            raise ValueError(
                f"num_minibatches must be positive, got {self.num_minibatches}"
            )
        if self.num_workers % self.num_minibatches != 0:
            raise ValueError(
                "minibatches split over env lanes (full sequences, so LSTM "
                f"carries stay valid): num_workers ({self.num_workers}) must "
                f"divide by num_minibatches ({self.num_minibatches})"
            )
        if self.loss_reduction not in ("sum", "mean"):
            raise ValueError(
                f"loss_reduction must be 'sum' or 'mean', got {self.loss_reduction!r}"
            )
        if self.ppo_epochs <= 0:
            raise ValueError(f"ppo_epochs must be positive, got {self.ppo_epochs}")


@dataclass
class SACArguments(RLArguments):
    """SAC options (``scalerl_tpu.config.SACArguments``): squashed-Gaussian
    actor, clipped double-Q critics, a learned entropy temperature and
    polyak target updates, on the off-policy trainer's replay."""

    algo_name: str = "sac"
    env_id: str = "Pendulum-v1"  # continuous algo -> continuous default env
    hidden_sizes: str = "256,256"
    # Soft target update
    soft_update_tau: float = 0.005
    # Entropy temperature: alpha auto-tunes toward target entropy
    # (= -action_dim * target_entropy_scale)
    auto_alpha: bool = True
    init_alpha: float = 0.2
    target_entropy_scale: float = 1.0
    alpha_learning_rate: float = 3e-4
    actor_learning_rate: float = 3e-4  # critics use the base learning_rate
    # Replay (uniform or PER, sharing the DQN pipeline fields)
    use_per: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_beta_final: float = 1.0
    n_steps: int = 1

    def validate(self) -> None:
        super().validate()
        if not 0.0 < self.soft_update_tau <= 1.0:
            raise ValueError(
                f"soft_update_tau must be in (0, 1], got {self.soft_update_tau}"
            )
        if self.init_alpha <= 0.0:
            raise ValueError(f"init_alpha must be positive, got {self.init_alpha}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")


@dataclass
class TD3Arguments(RLArguments):
    """TD3 options (``scalerl_tpu.config.TD3Arguments``): deterministic tanh
    actor with exploration noise, clipped double-Q, target policy smoothing,
    actor and target updates every ``policy_delay`` critic steps."""

    algo_name: str = "td3"
    env_id: str = "Pendulum-v1"
    hidden_sizes: str = "256,256"
    soft_update_tau: float = 0.005
    policy_delay: int = 2
    explore_noise_std: float = 0.1  # fraction of action scale
    target_noise_std: float = 0.2
    target_noise_clip: float = 0.5
    actor_learning_rate: float = 3e-4
    use_per: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_beta_final: float = 1.0
    n_steps: int = 1

    def validate(self) -> None:
        super().validate()
        if self.policy_delay < 1:
            raise ValueError(
                f"policy_delay must be >= 1, got {self.policy_delay}"
            )
        if not 0.0 < self.soft_update_tau <= 1.0:
            raise ValueError(
                f"soft_update_tau must be in (0, 1], got {self.soft_update_tau}"
            )
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")


@dataclass
class DQNArguments(RLArguments):
    """DQN options (``scalerl_tpu.config.DQNArguments``)."""

    # Architecture flags
    double_dqn: bool = True
    dueling_dqn: bool = False
    noisy_dqn: bool = False
    noisy_std: float = 0.5
    # Categorical (C51) distributional head
    categorical_dqn: bool = False
    num_atoms: int = 51
    v_min: float = 0.0
    v_max: float = 200.0
    hidden_sizes: str = "128,128"
    # Exploration: epsilon decays linearly over exploration_fraction of
    # max_timesteps.  eps_greedy_scheduler is the JAX package's field; the
    # agents of both packages decay linearly whatever it says.
    eps_greedy_start: float = 1.0
    eps_greedy_end: float = 0.05
    eps_greedy_scheduler: str = "linear"  # linear | piecewise
    exploration_fraction: float = 0.5
    # Learning-rate schedule: "linear" decays to min_learning_rate over the
    # learn steps of the run; anything else keeps it constant.
    lr_scheduler: str = "none"  # none | linear | multistep
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
        if self.categorical_dqn:
            if self.num_atoms < 2:
                raise ValueError(f"num_atoms must be >= 2, got {self.num_atoms}")
            if not self.v_max > self.v_min:
                raise ValueError(f"v_max ({self.v_max}) must exceed v_min ({self.v_min})")


@dataclass
class ApexArguments(DQNArguments):
    """Ape-X options (``scalerl_tpu.config.ApexArguments``): N actor threads
    fold n-step transitions and prioritise them; one learner owns the PER."""

    algo_name: str = "apex"
    use_per: bool = True
    num_actors: int = 4
    actor_update_frequency: int = 100  # publish a weight snapshot every N learn steps
    priority_update_frequency: int = 1
    eps_greedy_base: float = 0.4
    eps_greedy_alpha: float = 7.0  # per-actor eps = base ** (1 + i/(N-1) * alpha)

    def validate(self) -> None:
        super().validate()
        if self.rollout_length < self.n_steps:
            raise ValueError(
                f"rollout_length ({self.rollout_length}) must be >= n_steps "
                f"({self.n_steps}): actors fold n-step windows inside each chunk"
            )


@dataclass
class R2D2Arguments(RLArguments):
    """R2D2 options (``scalerl_tpu.config.R2D2Arguments``): sequences of
    ``rollout_length`` steps stored with the actor's entering LSTM state;
    the learner burns in ``burn_in`` rows without gradient, trains on the
    rest with n-step double-Q targets under the h-rescaling, and writes back
    per-sequence priorities ``eta * max|td| + (1 - eta) * mean|td|``."""

    algo_name: str = "r2d2"
    # Model
    use_lstm: bool = True
    hidden_size: int = 256
    lstm_layers: int = 1
    dueling_dqn: bool = True
    # Sequence pipeline (actor side = the host actor plane's [T+1, B] slots)
    rollout_length: int = 20
    burn_in: int = 8
    num_actors: int = 2
    num_buffers: int = 16
    # Exploration: per-actor eps ladder (Ape-X convention)
    eps_base: float = 0.4
    eps_alpha: float = 7.0
    # Learning
    n_steps: int = 3
    batch_size: int = 16  # sequences per update
    replay_capacity: int = 2048  # sequences
    warmup_sequences: int = 64
    train_intensity: int = 1  # learn steps per inserted slot batch
    target_update_frequency: int = 400
    # PER over sequences
    per_alpha: float = 0.6
    per_beta: float = 0.4
    priority_eta: float = 0.9
    # Value rescaling h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x
    value_rescale_eps: float = 1e-3

    def validate(self) -> None:
        super().validate()
        if not 0 <= self.burn_in < self.rollout_length:
            raise ValueError(
                f"burn_in ({self.burn_in}) must be in [0, rollout_length="
                f"{self.rollout_length})"
            )
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if self.burn_in + self.n_steps >= self.rollout_length + 1:
            raise ValueError(
                "rollout_length must leave at least one trainable row: need "
                f"burn_in ({self.burn_in}) + n_steps ({self.n_steps}) <= "
                f"rollout_length ({self.rollout_length})"
            )
        if not 0.0 <= self.priority_eta <= 1.0:
            raise ValueError(f"priority_eta must be in [0, 1], got {self.priority_eta}")


@dataclass
class GenRLArguments(RLArguments):
    """Token-level sequence-RL options (``scalerl_tpu.config.GenRLArguments``).

    One generation round = generate ``genrl_batch`` sequences, score them
    with the task's rule-based reward, pack them into the prioritized
    sequence replay, sample ``genrl_sample_batch`` replay units and take one
    token-PPO learn step.  ``d_model``, ``n_layers`` and ``n_heads`` (on
    :class:`RLArguments`) size the policy.

    ``spec_enable`` turns on speculative decoding on the continuous engine
    (``spec_k`` drafts a lane a pass from an n-gram table of width
    ``spec_ngram``); ``bf16_params`` builds the policy with bfloat16
    parameters and compute and keeps the optimizer state in float32; the
    ``disagg_*`` fields configure :class:`~scalerl_torch.trainer.
    sequence_rl.DisaggSequenceRLTrainer` (generation hosts, wire
    quantization, the round timeout and the durable ledger directory).

    Refused by :meth:`validate` when set: the sharded learner's
    ``dp_size``/``mp_size`` (refused by :class:`RLArguments`), and
    ``resume``, which no sequence-RL trainer reads (the disaggregated
    trainer resumes through ``disagg_ledger_dir``).  ``genrl_iter_mode`` is
    accepted and has no effect: the port runs eagerly with one loop form.
    """

    algo_name: str = "token_ppo"
    learning_rate: float = 3e-3
    max_grad_norm: float = 1.0

    # Vocabulary and sequence geometry; the model's max_len is derived as
    # prompt bucket + response bucket.
    vocab_size: int = 16
    prompt_len: int = 4  # the task's maximum true prompt length
    max_new_tokens: int = 4
    eos_token: int = -1  # < 0: fixed-length responses (no early stop)

    # Sampling (stored logprobs are under exactly this distribution).
    temperature: float = 1.0
    top_k: int = 0

    # Token-PPO objective.
    clip_range: float = 0.2
    value_cost: float = 0.5
    entropy_cost: float = 0.01
    kl_cost: float = 0.0  # KL to the frozen initial params; 0 = no anchor forward
    adv_norm: bool = True

    # Round geometry and replay.
    genrl_rounds: int = 200
    genrl_batch: int = 32  # sequences generated per round
    genrl_sample_batch: int = 32  # replay units per learn step
    genrl_buffer_sequences: int = 64  # sequence-replay capacity
    genrl_push_every: int = 1  # publish params to the engine every N learn steps
    genrl_iter_mode: str = "auto"

    # Engine: "cohort" (one fixed-cohort round) or "continuous" (paged KV,
    # macro steps, admission into freed lanes).
    genrl_engine: str = "cohort"
    genrl_lanes: int = 0  # continuous decode lanes; 0 -> genrl_batch
    genrl_page_size: int = 8
    genrl_num_pages: int = 0  # 0 -> every lane's worst case
    genrl_macro_steps: int = 4
    genrl_admit_wait_ms: float = 0.0
    genrl_max_pending: int = 0  # admission queue bound (0 = unbounded)
    genrl_paged_attn: str = "auto"  # pallas | auto = the CUDA kernel, xla = plain
    samples_per_prompt: int = 1  # completions per prompt (group sampling)
    genrl_steps_in_flight: int = 2
    genrl_prefix_cache: bool = True
    # speculative decoding (continuous engine only): up to spec_k drafts a
    # lane a pass from the lane's own n-gram table, verified in one pass
    spec_enable: bool = False
    spec_k: int = 4  # draft tokens a pass when spec_enable (>= 1)
    spec_ngram: int = 3  # n-gram width the drafter matches

    # Packed learner: bin-pack compact sequences into [rows, learner_pack_len]
    # rows with per-token segment ids; the learn step attends within
    # segments only.
    learner_packing: bool = False
    learner_pack_len: int = 0  # 0 -> prompt bucket + response bucket
    # pallas | auto = the CUDA segment flash kernels, xla = the dense mask
    learner_packed_attn: str = "auto"

    # Disaggregated dataflow (genrl/disagg.py): generation hosts stream
    # completed sequences over the fleet wire into the learner's replay.
    disagg_hosts: int = 2
    disagg_lanes_per_host: int = 0  # 0 -> max(1, genrl_batch // disagg_hosts)
    disagg_quantize: str = "int8"  # snapshot wire format: int8 | none
    disagg_upload_batch: int = 4  # completed sequences per uplink frame
    # how long one round may wait for its batch before raising
    disagg_round_timeout_s: float = 120.0
    # non-empty: the durable learner ledger lives in <dir>/learner_ledger,
    # and a trainer built against the same dir resumes from it
    disagg_ledger_dir: str = ""

    def validate(self) -> None:
        super().validate()
        if self.resume:
            raise NotImplementedError(
                f"resume={self.resume!r}: the sequence-RL trainers read no resume path; "
                "the disaggregated trainer resumes through disagg_ledger_dir"
            )
        if self.vocab_size < 4:
            raise ValueError(f"vocab_size must be >= 4, got {self.vocab_size}")
        if self.prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError(
                "prompt_len and max_new_tokens must be >= 1, got "
                f"{self.prompt_len}/{self.max_new_tokens}"
            )
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), got {self.temperature}")
        if not 0.0 < self.clip_range < 1.0:
            raise ValueError(f"clip_range must be in (0, 1), got {self.clip_range}")
        if self.kl_cost < 0 or self.value_cost < 0:
            raise ValueError(
                f"kl_cost and value_cost must be >= 0, got {self.kl_cost}/{self.value_cost}"
            )
        if self.genrl_batch < 1 or self.genrl_sample_batch < 1:
            raise ValueError(
                "genrl_batch and genrl_sample_batch must be >= 1, got "
                f"{self.genrl_batch}/{self.genrl_sample_batch}"
            )
        if self.genrl_buffer_sequences < self.genrl_batch:
            raise ValueError(
                f"genrl_buffer_sequences ({self.genrl_buffer_sequences}) must be >= "
                f"genrl_batch ({self.genrl_batch})"
            )
        if self.genrl_push_every < 1:
            raise ValueError(f"genrl_push_every must be >= 1, got {self.genrl_push_every}")
        if self.genrl_iter_mode not in ("auto", "scan", "unroll"):
            raise ValueError(
                f"genrl_iter_mode must be auto | scan | unroll, got {self.genrl_iter_mode!r}"
            )
        if self.genrl_engine not in ("cohort", "continuous"):
            raise ValueError(
                f"genrl_engine must be cohort | continuous, got {self.genrl_engine!r}"
            )
        if self.genrl_lanes < 0 or self.genrl_page_size < 1:
            raise ValueError(
                "genrl_lanes must be >= 0 and genrl_page_size >= 1, got "
                f"{self.genrl_lanes}/{self.genrl_page_size}"
            )
        if self.genrl_macro_steps < 1:
            raise ValueError(f"genrl_macro_steps must be >= 1, got {self.genrl_macro_steps}")
        if self.genrl_paged_attn not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"genrl_paged_attn must be auto | pallas | xla, got {self.genrl_paged_attn!r}"
            )
        if self.samples_per_prompt < 1:
            raise ValueError(f"samples_per_prompt must be >= 1, got {self.samples_per_prompt}")
        if self.genrl_batch % self.samples_per_prompt != 0:
            raise ValueError(
                f"genrl_batch ({self.genrl_batch}) must be a multiple of samples_per_prompt "
                f"({self.samples_per_prompt}) so rounds hold whole groups"
            )
        if self.genrl_steps_in_flight < 1:
            raise ValueError(
                f"genrl_steps_in_flight must be >= 1, got {self.genrl_steps_in_flight}"
            )
        if self.spec_enable and self.genrl_engine != "continuous":
            raise ValueError(
                "spec_enable requires genrl_engine='continuous' (the cohort engine's round "
                f"has no verify pass), got {self.genrl_engine!r}"
            )
        if self.spec_enable and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 when spec_enable, got {self.spec_k}")
        if self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.learner_packed_attn not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"learner_packed_attn must be auto | pallas | xla, got {self.learner_packed_attn!r}"
            )
        if self.learner_pack_len < 0:
            raise ValueError(f"learner_pack_len must be >= 0, got {self.learner_pack_len}")
        if self.learner_pack_len and self.learner_pack_len < self.prompt_len + self.max_new_tokens:
            raise ValueError(
                f"learner_pack_len ({self.learner_pack_len}) must fit one maximum-length "
                f"sequence (prompt_len + max_new_tokens = {self.prompt_len + self.max_new_tokens}) "
                "or every full-length completion would be shed"
            )
        if self.disagg_hosts < 1:
            raise ValueError(f"disagg_hosts must be >= 1, got {self.disagg_hosts}")
        if self.disagg_lanes_per_host < 0 or self.disagg_upload_batch < 1:
            raise ValueError(
                "disagg_lanes_per_host must be >= 0 and disagg_upload_batch >= 1, got "
                f"{self.disagg_lanes_per_host}/{self.disagg_upload_batch}"
            )
        if self.disagg_quantize not in ("int8", "none"):
            raise ValueError(f"disagg_quantize must be int8 | none, got {self.disagg_quantize!r}")
        if self.disagg_round_timeout_s <= 0:
            raise ValueError(
                f"disagg_round_timeout_s must be positive, got {self.disagg_round_timeout_s}"
            )


_BOOL_TRUE = ("1", "true", "yes", "y", "on")
_BOOL_FALSE = ("0", "false", "no", "n", "off")


def _str2bool(v: str) -> bool:
    if v.lower() in _BOOL_TRUE:
        return True
    if v.lower() in _BOOL_FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser(
    cls: Type[T], parser: Optional[argparse.ArgumentParser] = None
) -> argparse.ArgumentParser:
    """An argparse parser with one ``--field-name`` option per field of the
    dataclass ``cls``; a boolean takes ``--flag`` (true) or ``--flag
    false``; an ``Optional[float]`` field takes a float."""
    parser = parser or argparse.ArgumentParser(description=cls.__doc__)
    hints = typing.get_type_hints(cls)
    for f in fields(cls):  # type: ignore[arg-type]
        if not f.init:
            continue
        name = "--" + f.name.replace("_", "-")
        hint = hints[f.name]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        ftype = args[0] if typing.get_origin(hint) is typing.Union and args else hint
        if ftype is bool:
            parser.add_argument(name, type=_str2bool, nargs="?", const=True,
                                default=f.default)
        else:
            parser.add_argument(name, type=ftype, default=f.default)
    return parser


def parse_args(
    cls: Type[T] = RLArguments,  # type: ignore[assignment]
    argv: Optional[Sequence[str]] = None,
    parser: Optional[argparse.ArgumentParser] = None,
) -> T:
    """Parse ``argv`` into a validated instance of ``cls``.  Options a
    caller added to ``parser`` beforehand are parsed too and ignored here."""
    ns = build_parser(cls, parser).parse_args(argv)
    args = cls(**{f.name: getattr(ns, f.name) for f in fields(cls) if f.init})  # type: ignore[arg-type]
    args.validate()  # type: ignore[attr-defined]
    return args
