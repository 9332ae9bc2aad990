"""IMPALA: the V-trace actor-learner agent.

Port of ``scalerl_tpu/agents/impala.py`` (with the parts of
``agents/policy_value.py`` it needs) for pixel observations with
``AtariNet`` (feed-forward or with its LSTM core), and for flat
observations with ``MLPPolicyNet`` or the transformer actor-critic
(``policy_arch="transformer"``, ``models/transformer_policy.py``), in
float32 or with ``bf16_params``.

The learn step is a function of an explicit ``ImpalaTrainState``, as in the
JAX package: the model is called with the state's parameters through
``torch.func.functional_call``, so the guard can keep or drop a whole update
with a device-side select.  ``agent.state.params`` holds the live weights;
the module's own parameters are only the initial ones.  Every update builds
new tensors, so actor threads acting through ``agents/policy_value.py`` read
whole parameter sets while the learner trains.

The optimizer is optax's ``chain(clip_by_global_norm, rmsprop)`` written
out, because ``torch.optim.RMSprop`` is a different update: optax 0.2.6
divides by ``sqrt(nu + eps)`` (eps inside the root) with ``nu`` starting at
0, clips by ``max_norm / norm`` only when ``norm > max_norm``, with no
1e-6 in the denominator, and applies momentum after the learning rate, so
the momentum buffer holds scaled updates (torch's holds unscaled ones,
which differs once the learning rate follows a schedule).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from scalerl_torch.agents.policy_value import PolicyValueAgent, sample_categorical  # noqa: F401
from scalerl_torch.config import ImpalaArguments
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.models.atari import AtariNet
from scalerl_torch.models.policy import MLPPolicyNet
from scalerl_torch.models.transformer_policy import build_mp_policy
from scalerl_torch.ops.losses import baseline_loss, entropy_loss, policy_gradient_loss
from scalerl_torch.ops.vtrace import vtrace_from_logits
from scalerl_torch.parallel.sharding import (
    batch_mean,
    global_batch,
    reduce_gradients,
    tree_square_sum,
)
from scalerl_torch.parallel.train_step import fp32_optimizer_state, maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclass
class ImpalaTrainState:
    params: Params
    opt_state: Dict[str, Any]  # {"nu": Params, "count": int32 tensor[, "trace": Params]}
    step: torch.Tensor  # int32, learner updates
    env_frames: torch.Tensor  # int64, env frames consumed


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (``transition_steps >= 1``): ``init -> end``
    over ``transition_steps`` counts, evaluated on the device from a count
    tensor."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm over every leaf; inside a meshed step on shards, of the
    whole tree, each sharded leaf's part summed over its shards and each
    replicated leaf counted once (``parallel/sharding.py::tree_square_sum``)."""
    return torch.sqrt(tree_square_sum(tree))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """``optax.clip_by_global_norm``: scale by ``max_norm / norm`` only when
    ``norm >= max_norm``, with nothing added to the norm (torch's
    ``clip_grad_norm_`` adds 1e-6 and always rescales)."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, (g / g_norm) * max_norm) for k, g in grads.items()}


class RMSPropOptimizer:
    """``optax.chain(clip_by_global_norm(max_norm), rmsprop(lr, decay, eps,
    momentum))``.

    State: ``{"nu": second moments, "count": updates}``, and with a
    non-zero ``momentum`` ``"trace"``, the last update; ``count`` feeds the
    learning-rate schedule, as optax's ``ScaleByScheduleState`` does.  optax
    adds ``momentum * trace`` to the update after scaling it by the learning
    rate (``trace`` after ``scale_by_learning_rate`` in its chain).  At
    momentum 0 its trace is the update itself, so the port keeps none.
    """

    def __init__(
        self,
        learning_rate: Union[float, Schedule],
        decay: float,
        eps: float,
        max_norm: float,
        momentum: float = 0.0,
    ) -> None:
        self.learning_rate = learning_rate
        self.decay = decay
        self.eps = eps
        self.max_norm = max_norm
        self.momentum = momentum

    def init(self, params: Params) -> Dict[str, Any]:
        device = next(iter(params.values())).device
        state = {
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
        if self.momentum:
            state["trace"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def update(
        self, grads: Params, opt_state: Dict[str, Any]
    ) -> Tuple[Params, Dict[str, Any]]:
        grads = clip_by_global_norm(grads, self.max_norm)
        nu = {
            k: (1 - self.decay) * torch.square(g) + self.decay * opt_state["nu"][k]
            for k, g in grads.items()
        }
        count = opt_state["count"]
        lr = self.learning_rate
        step_size = -lr(count) if callable(lr) else -lr
        updates = {
            k: step_size * (torch.rsqrt(nu[k] + self.eps) * g)
            for k, g in grads.items()
        }
        state = {"nu": nu, "count": count + 1}
        if self.momentum:
            updates = {k: u + self.momentum * opt_state["trace"][k] for k, u in updates.items()}
            state["trace"] = updates
        return updates, state


def impala_loss(
    params: Params,
    model: torch.nn.Module,
    traj: Trajectory,
    discounting: float,
    baseline_cost: float,
    entropy_cost: Union[float, torch.Tensor],
    reward_clipping: str = "abs_one",
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
    vtrace_impl: str = "scan",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The IMPALA objective over one [T+1, B] trajectory chunk.

    Keys prefixed ``mean_`` are true means over the chunk; every other key
    sums over the batch (the reference's loss convention)."""
    out, _ = functional_call(
        model, params,
        (traj.obs, traj.action, traj.reward, traj.done, traj.core_state),
    )
    target_logits = out.policy_logits  # [T+1, B, A]
    values = out.baseline  # [T+1, B]

    actions_taken = traj.action[1:]  # action taken at obs[t] is action[t+1]
    behavior_logits = traj.logits[:-1]
    rewards = traj.reward[1:]
    if reward_clipping == "abs_one":
        rewards = torch.clamp(rewards, -1.0, 1.0)
    discounts = discounting * (1.0 - traj.done[1:].to(torch.float32))

    vt = vtrace_from_logits(
        behavior_logits=behavior_logits,
        target_logits=target_logits[:-1],
        actions=actions_taken,
        discounts=discounts,
        rewards=rewards,
        values=values[:-1],
        bootstrap_value=values[-1],
        clip_rho_threshold=rho_clip,
        clip_pg_rho_threshold=rho_clip,
        clip_c_threshold=c_clip,
        impl=vtrace_impl,
    )

    pg = policy_gradient_loss(target_logits[:-1], actions_taken, vt.pg_advantages)
    bl = baseline_cost * baseline_loss(vt.vs - values[:-1])
    ent = entropy_cost * entropy_loss(target_logits[:-1])
    total = pg + bl + ent
    metrics = {
        "total_loss": total,
        "pg_loss": pg,
        "baseline_loss": bl,
        "entropy_loss": ent,
        "mean_value": batch_mean(values),
        "mean_reward": batch_mean(rewards),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_impala_learn_fn(
    model: torch.nn.Module, optimizer: RMSPropOptimizer, args: ImpalaArguments
) -> Callable[[ImpalaTrainState, Trajectory], Tuple[ImpalaTrainState, Dict]]:
    """The ``(state, traj) -> (state, metrics)`` learner update, wrapped in
    the all-finite guard unless ``args.nonfinite_guard`` is off.

    ``args.use_pallas`` routes V-trace through the CUDA kernel.  The entropy
    anneal (``entropy_cost_end`` / ``entropy_anneal_frames``) is evaluated
    at ``state.step`` on the device."""
    ent_schedule = None
    if args.entropy_cost_end is not None and args.entropy_anneal_frames > 0:
        n_updates = max(
            args.entropy_anneal_frames // (args.rollout_length * args.batch_size), 1
        )
        ent_schedule = linear_schedule(args.entropy_cost, args.entropy_cost_end, n_updates)
    vtrace_impl = "kernel" if args.use_pallas else "scan"

    def learn(state: ImpalaTrainState, traj: Trajectory):
        ent_cost = (
            ent_schedule(state.step) if ent_schedule is not None else args.entropy_cost
        )
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics = impala_loss(
            params,
            model,
            traj,
            discounting=args.discounting,
            baseline_cost=args.baseline_cost,
            entropy_cost=ent_cost,
            reward_clipping=args.reward_clipping,
            rho_clip=args.vtrace_rho_clip,
            c_clip=args.vtrace_c_clip,
            vtrace_impl=vtrace_impl,
        )
        grads = reduce_gradients(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        T, B = traj.reward.shape[0] - 1, global_batch(traj.reward.shape[1])
        new_state = ImpalaTrainState(
            params={k: state.params[k] + updates[k] for k in state.params},
            opt_state=opt_state,
            step=state.step + 1,
            env_frames=state.env_frames + T * B,
        )
        metrics["grad_norm"] = global_norm(grads)  # before clipping
        return new_state, metrics

    return maybe_guard_nonfinite(learn, args)


def make_impala_optimizer(args: ImpalaArguments):
    """RMSProp (with ``args.rmsprop_momentum``) + global-norm clip; with
    ``total_steps > 0`` the learning rate decays linearly to 0 over
    ``total_steps`` env frames, counted in learner updates.  With
    ``bf16_params`` it is wrapped in ``fp32_optimizer_state``: float32
    moments and clipping, updates cast back to each param's dtype."""
    lr: Union[float, Schedule] = args.learning_rate
    if args.total_steps > 0:
        lr = linear_schedule(
            args.learning_rate,
            0.0,
            max(args.total_steps // (args.rollout_length * args.batch_size), 1),
        )
    tx = RMSPropOptimizer(
        lr, decay=args.rmsprop_alpha, eps=args.rmsprop_eps, max_norm=args.max_grad_norm,
        momentum=args.rmsprop_momentum,
    )
    return fp32_optimizer_state(tx) if args.bf16_params else tx


def build_model(
    args: ImpalaArguments,
    obs_shape: Tuple[int, ...],
    num_actions: int,
    device: DeviceLike = "cuda",
    generator: Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """``args.policy_arch`` first (``"transformer"`` ->
    ``TransformerPolicyNet``, as the JAX function dispatches through
    ``build_mp_policy``); then pixel obs -> ``AtariNet``, flat obs ->
    ``MLPPolicyNet`` with two hidden layers of ``hidden_size``."""
    mp_model = build_mp_policy(args, obs_shape, num_actions, device, generator)
    if mp_model is not None:
        return mp_model
    if len(obs_shape) != 3:
        return MLPPolicyNet(num_actions, obs_shape[-1], (args.hidden_size, args.hidden_size),
                            device=device, generator=generator)
    return AtariNet(
        num_actions=num_actions,
        use_lstm=args.use_lstm,
        hidden_size=args.hidden_size,
        obs_shape=tuple(obs_shape),
        dtype=getattr(torch, args.compute_dtype),
        device=device,
        generator=generator,
    )


class ImpalaAgent(PolicyValueAgent):
    """Host-facing IMPALA agent: act (thread-safe, ``agents/policy_value.py``),
    learn, weight get/set and checkpoints."""

    def __init__(
        self,
        args: ImpalaArguments,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.model = build_model(
            args, obs_shape, num_actions, self.device,
            generator=torch.Generator().manual_seed(args.seed),
        )
        self.optimizer = make_impala_optimizer(args)
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.state = ImpalaTrainState(
            params=params,
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            env_frames=torch.zeros((), dtype=torch.int64, device=self.device),
        )
        self._learn = self.make_learn_fn()
        self._setup_host(args.seed)

    def make_learn_fn(self):
        """The learn step of this agent's model, optimizer and args."""
        return make_impala_learn_fn(self.model, self.optimizer, self.args)

    def learn_device(self, traj: Trajectory) -> Dict[str, torch.Tensor]:
        """One train step; metrics stay on the device."""
        (metrics,) = self._learn_step(traj)
        return metrics

    def learn(self, traj: Trajectory) -> Dict[str, float]:
        return get_metrics(self.learn_device(traj))  # one batched copy

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
        self._eval_state.reset()  # a carried core came from the old weights
