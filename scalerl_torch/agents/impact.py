"""IMPACT: importance-weighted actor-learner with a clipped target network
(Luo et al. 2020, arxiv 1912.00167).

Port of ``scalerl_tpu/agents/impact.py``.  Each chunk from the actor plane
goes into a circular surrogate buffer (``data/circular.py``) and takes part
in ``replay_times`` learner updates; a slow target network makes those
replays safe:

- the target ``pi_target`` is refreshed from the learner every
  ``target_update_frequency`` updates, by a device-side select;
- V-trace runs target-vs-behaviour (``rho = pi_target / mu``), through the
  CUDA kernel under ``use_pallas`` (``ops/vtrace.py``), one launch per
  update;
- the policy loss is the clipped surrogate of the learner-vs-target ratio
  ``r = pi / pi_target``: ``-sum(min(r * adv, clip(r, 1 - eps, 1 + eps) *
  adv))``.

The target forward runs under ``torch.no_grad()`` (the JAX package's
``stop_gradient``), so it holds no graph.  Env frames are counted once per
inserted chunk, however many replays follow.  The agent has IMPALA's act
surface and runs on ``trainer/actor_learner.py::HostActorLearnerTrainer``
unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from scalerl_torch.agents.impala import (
    RMSPropOptimizer,
    build_model,
    global_norm,
    make_impala_optimizer,
)
from scalerl_torch.agents.policy_value import PolicyValueAgent
from scalerl_torch.config import ImpactArguments
from scalerl_torch.data.circular import CircularTrajectoryBuffer
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.ops.losses import baseline_loss, entropy_loss
from scalerl_torch.ops.vtrace import vtrace_from_logits
from scalerl_torch.parallel.sharding import batch_mean, batch_sum, reduce_gradients
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclass
class ImpactTrainState:
    params: Params
    target_params: Params
    opt_state: Dict[str, Any]  # RMSProp's, as IMPALA's
    step: torch.Tensor  # int32, learner updates
    env_frames: torch.Tensor  # int64, env frames inserted


def _action_logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a_t | s_t) over [T, B] from [T, B, A] logits."""
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def impact_loss(
    params: Params,
    target_params: Params,
    model: torch.nn.Module,
    traj: Trajectory,
    discounting: float,
    baseline_cost: float,
    entropy_cost: float,
    clip_eps: float,
    reward_clipping: str = "abs_one",
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
    vtrace_impl: str = "scan",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The IMPACT objective over one ``[T+1, B]`` chunk; ``mean_`` keys are
    means, the rest sum over the batch (``impala_loss``'s contract)."""
    inputs = (traj.obs, traj.action, traj.reward, traj.done, traj.core_state)
    out, _ = functional_call(model, params, inputs)
    with torch.no_grad():
        tout, _ = functional_call(model, target_params, inputs)
    logits = out.policy_logits  # [T+1, B, A], learner policy
    target_logits = tout.policy_logits
    values = out.baseline  # [T+1, B], learner critic

    actions_taken = traj.action[1:]
    behavior_logits = traj.logits[:-1]
    rewards = traj.reward[1:]
    if reward_clipping == "abs_one":
        rewards = torch.clamp(rewards, -1.0, 1.0)
    discounts = discounting * (1.0 - traj.done[1:].to(torch.float32))

    # V-trace target-vs-behaviour: the slow anchor absorbs the
    # off-policyness, so the K replays of a chunk see stable advantages
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

    # clipped surrogate on the learner-vs-target ratio (IMPACT eq. 1)
    logp_cur = _action_logp(logits[:-1], actions_taken)
    logp_tgt = _action_logp(target_logits[:-1], actions_taken)
    ratio = torch.exp(logp_cur - logp_tgt)
    adv = vt.pg_advantages.detach()
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -batch_sum(torch.minimum(ratio * adv, clipped * adv))
    bl = baseline_cost * baseline_loss(vt.vs - values[:-1])
    ent = entropy_cost * entropy_loss(logits[:-1])
    total = pg + bl + ent
    metrics = {
        "total_loss": total,
        "pg_loss": pg,
        "baseline_loss": bl,
        "entropy_loss": ent,
        "mean_value": batch_mean(values),
        "mean_reward": batch_mean(rewards),
        "mean_ratio": batch_mean(ratio),
        "mean_clip_frac": batch_mean((torch.abs(ratio - 1.0) > clip_eps).to(torch.float32)),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_impact_learn_fn(
    model: torch.nn.Module, optimizer: RMSPropOptimizer, args: ImpactArguments
) -> Callable[[ImpactTrainState, Trajectory], Tuple[ImpactTrainState, Dict]]:
    """The ``(state, traj) -> (state, metrics)`` IMPACT update, wrapped in
    the all-finite guard unless ``args.nonfinite_guard`` is off.  Every
    ``target_update_frequency`` updates a ``torch.where`` copies the new
    params over the target's, with no host read; ``env_frames`` is left to
    the agent, which counts it at insertion."""
    vtrace_impl = "kernel" if args.use_pallas else "scan"

    def learn(state: ImpactTrainState, traj: Trajectory):
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics = impact_loss(
            params, state.target_params, model, traj,
            discounting=args.discounting, baseline_cost=args.baseline_cost,
            entropy_cost=args.entropy_cost, clip_eps=args.impact_clip,
            reward_clipping=args.reward_clipping, rho_clip=args.vtrace_rho_clip,
            c_clip=args.vtrace_c_clip, vtrace_impl=vtrace_impl,
        )
        grads = reduce_gradients(
            dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        new_params = {k: state.params[k] + updates[k] for k in state.params}
        new_step = state.step + 1
        refresh = (new_step % args.target_update_frequency) == 0
        target_params = {k: torch.where(refresh, new_params[k], t)
                         for k, t in state.target_params.items()}
        new_state = ImpactTrainState(
            params=new_params,
            target_params=target_params,
            opt_state=opt_state,
            step=new_step,
            env_frames=state.env_frames,
        )
        metrics["grad_norm"] = global_norm(grads)  # before clipping
        return new_state, metrics

    return maybe_guard_nonfinite(learn, args)


class ImpactAgent(PolicyValueAgent):
    """Host-facing IMPACT agent: IMPALA's act surface and model, the clipped
    target surrogate replayed out of the circular buffer.  ``learn`` /
    ``learn_device`` insert the chunk and run ``replay_times`` updates; the
    metrics of the last one come back (on the device from
    ``learn_device``), so K replays still cost one host read."""

    def __init__(
        self,
        args: ImpactArguments,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.model = build_model(args, obs_shape, num_actions, self.device,
                                 generator=torch.Generator().manual_seed(args.seed))
        self.optimizer = make_impala_optimizer(args)
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.state = ImpactTrainState(
            params=params,
            target_params={k: v.clone() for k, v in params.items()},
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            env_frames=torch.zeros((), dtype=torch.int64, device=self.device),
        )
        self._learn = self.make_learn_fn()
        self._setup_host(args.seed)
        self.surrogate = CircularTrajectoryBuffer(
            capacity=args.surrogate_capacity, replay_times=args.replay_times)

    def make_learn_fn(self) -> Callable:
        """The learn step of this agent's model, optimizer and args."""
        return make_impact_learn_fn(self.model, self.optimizer, self.args)

    def learn_device(self, traj: Trajectory) -> Dict[str, torch.Tensor]:
        """Insert ``traj`` and run ``replay_times`` surrogate updates; the
        last update's metrics stay on the device."""
        self.surrogate.add(traj)
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(self.args.replay_times):
            (metrics,) = self._learn_step(self.surrogate.sample())
        T, B = traj.reward.shape[0] - 1, traj.reward.shape[1]
        self.state = dataclasses.replace(self.state, env_frames=self.state.env_frames + T * B)
        return metrics

    def learn(self, traj: Trajectory) -> Dict[str, float]:
        return get_metrics(self.learn_device(traj))  # one batched copy

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
        self._eval_state.reset()  # a carried core came from the old weights
