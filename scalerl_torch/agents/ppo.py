"""PPO: the clipped surrogate on the on-policy runtime.

Port of ``scalerl_tpu/agents/ppo.py``.  One learn call consumes one
``[T+1, B]`` on-policy chunk:

- GAE advantages, value targets and the behaviour log-probabilities are
  computed once, under the pre-update parameters;
- then ``ppo_epochs`` passes of ``num_minibatches`` clipped-surrogate steps
  (clip-then-Adam, ``agents/a3c.py``'s optimizer), where the JAX package
  runs one ``lax.scan``;
- minibatches split the env *lanes* (whole ``[T+1]`` sequences), never
  time, and carry each lane's entering LSTM state, so a recurrent policy
  replays each lane exactly as it was collected.

The lane shuffle of each epoch is a pure function of ``(args.seed,
state.step)``, drawn on the device (``utils/counter_rng.py``), so a resumed
run repeats it and the learn step reads nothing on the host: it runs inside
``DeviceActorLearnerLoop`` as the IMPALA step does.  The stream differs from
``jax.random``'s; ``learn(state, traj, perms)`` takes injected ``[E, B]``
permutations instead (the parity tests pass the JAX ones).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from scalerl_torch.agents.a3c import A3CTrainState, OnPolicyAgent
from scalerl_torch.agents.dqn import AdamOptimizer
from scalerl_torch.agents.impala import global_norm
from scalerl_torch.config import PPOArguments
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.ops.losses import clipped_surrogate_loss, entropy_loss
from scalerl_torch.ops.returns import gae_advantages
from scalerl_torch.ops.vtrace import action_log_probs
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.utils import counter_rng

PPOTrainState = A3CTrainState
Params = Dict[str, torch.Tensor]
PERM_STREAM = 0


def ppo_loss(
    params: Params,
    model: torch.nn.Module,
    mb: Dict[str, Any],
    clip_range: float,
    clip_range_vf: float,
    value_loss_coef: float,
    entropy_coef: float,
    normalize_advantage: bool,
    loss_reduction: str = "sum",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate + (optionally clipped) value loss + entropy bonus
    over one lane minibatch (``[T+1, b]`` rows plus the chunk-level
    ``advantages``, ``value_targets``, ``behavior_logp`` and ``old_values``
    of its lanes); sums over ``[T, b]``, or means with
    ``loss_reduction="mean"``."""
    out, _ = functional_call(
        model, params, (mb["obs"], mb["action"], mb["reward"], mb["done"], mb["core_state"]))
    logits = out.policy_logits[:-1]  # [T, b, A]
    values_new = out.baseline[:-1]  # [T, b]
    actions_taken = mb["action"][1:]

    adv = mb["advantages"]
    if normalize_advantage:
        adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-8)

    new_logp = action_log_probs(logits, actions_taken)
    pg, aux = clipped_surrogate_loss(new_logp, mb["behavior_logp"], adv, clip_range)

    vs = mb["value_targets"].detach()
    if clip_range_vf > 0.0:
        # PPO2 value clip around the pre-update prediction, the worse of
        # the two errors
        v_old = mb["old_values"].detach()
        v_clipped = v_old + torch.clamp(values_new - v_old, -clip_range_vf, clip_range_vf)
        vl = 0.5 * torch.sum(torch.maximum(torch.square(values_new - vs),
                                           torch.square(v_clipped - vs)))
    else:
        vl = 0.5 * torch.sum(torch.square(values_new - vs))
    vl = value_loss_coef * vl
    ent = entropy_coef * entropy_loss(logits)

    if loss_reduction == "mean":
        scale = 1.0 / (values_new.shape[0] * values_new.shape[1])  # [T, b] count
        pg, vl, ent = pg * scale, vl * scale, ent * scale

    total = pg + vl + ent
    metrics = {
        "total_loss": total.detach(),
        "pg_loss": pg.detach(),
        "value_loss": vl.detach(),
        "entropy_loss": ent.detach(),
        "mean_value": torch.mean(values_new).detach(),
        "mean_advantage": torch.mean(mb["advantages"]),
        **aux,
    }
    return total, metrics


def _take_lanes(x: Any, lanes: torch.Tensor, axis: int) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.index_select(x, axis, lanes)
    return tuple(_take_lanes(leaf, lanes, axis) for leaf in x)


def make_ppo_learn_fn(
    model: torch.nn.Module, optimizer: AdamOptimizer, args: PPOArguments
) -> Callable[..., Tuple[PPOTrainState, Dict]]:
    """The ``(state, traj[, perms]) -> (state, metrics)`` PPO update over
    one chunk; the logged metrics are means over its ``ppo_epochs x
    num_minibatches`` steps.  ``perms`` (int ``[ppo_epochs, B]``) replaces
    the drawn lane shuffle."""
    E, M = args.ppo_epochs, args.num_minibatches

    def learn(state: PPOTrainState, traj: Trajectory, perms: Optional[torch.Tensor] = None):
        T1, B = traj.reward.shape
        T = T1 - 1
        if B % M != 0:
            raise ValueError(
                f"trajectory batch ({B} env lanes) must divide by "
                f"num_minibatches ({M})"
            )
        mb_lanes = B // M

        # chunk-level precomputation under the pre-update policy
        with torch.no_grad():
            out, _ = functional_call(
                model, state.params,
                (traj.obs, traj.action, traj.reward, traj.done, traj.core_state))
            values = out.baseline  # [T+1, B]
            rewards = traj.reward[1:]
            discounts = args.gamma * (1.0 - traj.done[1:].to(torch.float32))
            advantages, value_targets = gae_advantages(
                rewards, discounts, values[:-1], values[-1], lambda_=args.gae_lambda)
            behavior_logp = action_log_probs(traj.logits[:-1], traj.action[1:])

        if perms is None:
            perms = counter_rng.permutations(args.seed, PERM_STREAM, state.step, E, B)
        lane_slabs = perms.to(device=traj.reward.device, dtype=torch.int64).reshape(
            E * M, mb_lanes)

        params, opt_state = state.params, state.opt_state
        scanned = []
        for lanes in lane_slabs:
            mb = {
                "obs": _take_lanes(traj.obs, lanes, 1),
                "action": _take_lanes(traj.action, lanes, 1),
                "reward": _take_lanes(traj.reward, lanes, 1),
                "done": _take_lanes(traj.done, lanes, 1),
                "core_state": _take_lanes(traj.core_state, lanes, 0),
                "advantages": _take_lanes(advantages, lanes, 1),
                "value_targets": _take_lanes(value_targets, lanes, 1),
                "behavior_logp": _take_lanes(behavior_logp, lanes, 1),
                "old_values": _take_lanes(values[:-1], lanes, 1),
            }
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, metrics = ppo_loss(
                leaves, model, mb, clip_range=args.clip_range,
                clip_range_vf=args.clip_range_vf, value_loss_coef=args.value_loss_coef,
                entropy_coef=args.entropy_coef, normalize_advantage=args.normalize_advantage,
                loss_reduction=args.loss_reduction,
            )
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            updates, opt_state = optimizer.update(grads, opt_state)
            params = {k: params[k] + updates[k] for k in params}
            metrics["grad_norm"] = global_norm(grads)
            scanned.append(metrics)
        metrics = {k: torch.mean(torch.stack([m[k] for m in scanned])) for k in scanned[0]}
        new_state = PPOTrainState(
            params=params,
            opt_state=opt_state,
            step=state.step + 1,
            env_frames=state.env_frames + T * B,
        )
        return new_state, metrics

    return maybe_guard_nonfinite(learn, args)


class PPOAgent(OnPolicyAgent):
    """Host-facing PPO agent on ``trainer/on_policy.py`` (A3C's act and
    learn surface and model zoo).  Under a mesh each rank keeps the whole
    chunk: the minibatch shuffle spans the lanes of all of it."""

    _split_batch = False

    def make_learn_fn(self) -> Callable:
        """The learn step of this agent's model, optimizer and args."""
        return make_ppo_learn_fn(self.model, self.optimizer, self.args)
