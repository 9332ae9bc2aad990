"""A3C: synchronous batched advantage actor-critic.

Port of ``scalerl_tpu/agents/a3c.py``.  The fleet of env lanes feeds one
synchronous update: GAE advantages (``gae_lambda=1`` is the reference's
discounted-return advantage), the policy-gradient, value and entropy terms
summed over ``[T, B]``, and one step of ``clip_by_global_norm`` then Adam
(``agents/dqn.py::AdamOptimizer``, optax's form) for the whole fleet.

The learn step is a function of an explicit ``A3CTrainState`` run through
``torch.func.functional_call``, as IMPALA's is, so the all-finite guard
keeps or drops a whole update on the device; the act surface (thread-safe
``act``, ``get_action``/``predict`` with a carried core, checkpoints) is
``agents/policy_value.py``'s.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from scalerl_torch.agents.dqn import AdamOptimizer
from scalerl_torch.agents.impala import global_norm
from scalerl_torch.agents.policy_value import PolicyValueAgent
from scalerl_torch.config import A3CArguments
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.models.atari import AtariNet
from scalerl_torch.models.mlp import parse_hidden
from scalerl_torch.models.policy import MLPPolicyNet
from scalerl_torch.models.transformer_policy import build_mp_policy
from scalerl_torch.ops.losses import baseline_loss, entropy_loss, policy_gradient_loss
from scalerl_torch.ops.returns import gae_advantages
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclass
class A3CTrainState:
    params: Params
    opt_state: Dict[str, Any]  # {"mu": Params, "nu": Params, "count": int32 tensor}
    step: torch.Tensor  # int32, learner updates
    env_frames: torch.Tensor  # int64, env frames consumed


def a3c_loss(
    params: Params,
    model: torch.nn.Module,
    traj: Trajectory,
    gamma: float,
    gae_lambda: float,
    value_loss_coef: float,
    entropy_coef: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The A2C objective over one on-policy ``[T+1, B]`` chunk: GAE
    advantages (detached in both uses), NLL x advantage, ``0.5 * sum(R -
    V)^2`` and the entropy bonus."""
    out, _ = functional_call(
        model, params, (traj.obs, traj.action, traj.reward, traj.done, traj.core_state))
    logits = out.policy_logits  # [T+1, B, A]
    values = out.baseline  # [T+1, B]

    actions_taken = traj.action[1:]
    rewards = traj.reward[1:]
    discounts = gamma * (1.0 - traj.done[1:].to(torch.float32))
    advantages, vs = gae_advantages(rewards, discounts, values[:-1], values[-1],
                                    lambda_=gae_lambda)

    pg = policy_gradient_loss(logits[:-1], actions_taken, advantages)
    vl = value_loss_coef * baseline_loss(vs.detach() - values[:-1])
    ent = entropy_coef * entropy_loss(logits[:-1])
    total = pg + vl + ent
    metrics = {
        "total_loss": total,
        "pg_loss": pg,
        "value_loss": vl,
        "entropy_loss": ent,
        "mean_value": torch.mean(values),
        "mean_reward": torch.mean(rewards),
        "mean_advantage": torch.mean(advantages),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_a3c_learn_fn(
    model: torch.nn.Module, optimizer: AdamOptimizer, args: A3CArguments
) -> Callable[[A3CTrainState, Trajectory], Tuple[A3CTrainState, Dict]]:
    """The ``(state, traj) -> (state, metrics)`` A2C update, wrapped in the
    all-finite guard unless ``args.nonfinite_guard`` is off."""

    def learn(state: A3CTrainState, traj: Trajectory):
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics = a3c_loss(
            params, model, traj, gamma=args.gamma, gae_lambda=args.gae_lambda,
            value_loss_coef=args.value_loss_coef, entropy_coef=args.entropy_coef,
        )
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        T, B = traj.reward.shape[0] - 1, traj.reward.shape[1]
        new_state = A3CTrainState(
            params={k: state.params[k] + updates[k] for k in state.params},
            opt_state=opt_state,
            step=state.step + 1,
            env_frames=state.env_frames + T * B,
        )
        metrics["grad_norm"] = global_norm(grads)  # before clipping
        return new_state, metrics

    return maybe_guard_nonfinite(learn, args)


def make_a3c_optimizer(args: A3CArguments) -> AdamOptimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(learning_rate))``,
    the one optimizer the fleet shares."""
    return AdamOptimizer(args.learning_rate, max_norm=args.max_grad_norm)


def build_model(
    args: A3CArguments,
    obs_shape: Tuple[int, ...],
    num_actions: int,
    device: DeviceLike = "cuda",
    generator: Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """``args.policy_arch`` first (``build_mp_policy``); then pixel obs ->
    ``AtariNet`` with the LSTM core of ``hidden_size`` (256 by default),
    flat obs -> ``MLPPolicyNet`` over ``hidden_sizes``; ``normalized_init``
    gives either the A3C head init."""
    mp_model = build_mp_policy(args, obs_shape, num_actions, device, generator)
    if mp_model is not None:
        return mp_model
    if len(obs_shape) == 3:
        return AtariNet(num_actions=num_actions, use_lstm=args.use_lstm,
                        hidden_size=args.hidden_size, obs_shape=tuple(obs_shape),
                        normalized_init=args.normalized_init, device=device,
                        generator=generator)
    return MLPPolicyNet(num_actions, obs_shape[-1], parse_hidden(args.hidden_sizes),
                        normalized_init=args.normalized_init, device=device,
                        generator=generator)


class OnPolicyAgent(PolicyValueAgent):
    """The host-facing agent both on-policy learners share: a model from
    :func:`build_model`, the clip-then-Adam optimizer, the train state and
    the learn step of the subclass's ``make_learn_fn``."""

    def __init__(self, args: Any, obs_shape: Tuple[int, ...], num_actions: int,
                 device: DeviceLike = "cuda") -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.model = build_model(args, obs_shape, num_actions, self.device,
                                 generator=torch.Generator().manual_seed(args.seed))
        self.optimizer = make_a3c_optimizer(args)
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.state = A3CTrainState(
            params=params,
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            env_frames=torch.zeros((), dtype=torch.int64, device=self.device),
        )
        self._learn = self.make_learn_fn()
        self._setup_host(args.seed)

    def make_learn_fn(self) -> Callable:
        raise NotImplementedError

    def learn_device(self, traj: Trajectory) -> Dict[str, torch.Tensor]:
        """One train step; metrics stay on the device."""
        (metrics,) = self._learn_step(traj)
        return metrics

    def learn(self, traj: Trajectory) -> Dict[str, float]:
        return get_metrics(self.learn_device(traj))  # one batched copy

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
        self._eval_state.reset()  # a carried core came from the old weights


class A3CAgent(OnPolicyAgent):
    """Host-facing A3C agent: batched act and the synchronous update."""

    def make_learn_fn(self) -> Callable:
        """The learn step of this agent's model, optimizer and args."""
        return make_a3c_learn_fn(self.model, self.optimizer, self.args)
