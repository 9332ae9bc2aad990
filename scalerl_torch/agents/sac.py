"""SAC: soft actor-critic for continuous control.

Port of ``scalerl_tpu/agents/sac.py``.  One learn step over a replay batch:
the clipped double-Q critic target with the entropy bonus, one Adam step of
the twin critics, one of the squashed-Gaussian actor (reparameterised, on
the new critics), the temperature's step toward ``-action_dim *
target_entropy_scale`` (``auto_alpha``), and the polyak update of the
target critics.  The optimizers are plain ``optax.adam`` (no clip), written
out in ``agents/dqn.py::AdamOptimizer``.

The step's two normal draws (the next action's and the policy's) are a
pure function of ``(seed + 0x5AC, state.step)`` drawn on the device
(``utils/counter_rng.py``), as the JAX step folds its key out of the step
counter; ``learn(state, batch, noise)`` takes them injected instead.  The
per-sample ``|Q1 - target|`` comes back for the PER priority update.  The
squash correction keeps the stable form ``2 (log 2 - u - softplus(-2u))``:
``log(1 - tanh(u)^2)`` is -inf in float32 once |u| passes about 9.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from scalerl_torch.agents.base import BaseAgent
from scalerl_torch.agents.dqn import AdamOptimizer
from scalerl_torch.config import SACArguments
from scalerl_torch.models.mlp import TanhGaussianActor, TwinQNet
from scalerl_torch.parallel.sharding import (
    batch_mean,
    global_batch,
    local_rows,
    reduce_gradients,
)
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils import counter_rng
from scalerl_torch.utils.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
SAC_SEED_OFFSET = 0x5AC


def squash_log_prob(u: torch.Tensor, log_std: torch.Tensor, mean: torch.Tensor,
                    action_scale: torch.Tensor) -> torch.Tensor:
    """``log pi(a|s)`` for ``a = tanh(u) * scale + bias``, ``u ~ N(mean,
    std)``: the Gaussian log-density, less the tanh correction
    ``log(1 - tanh(u)^2) = 2 (log 2 - u - softplus(-2u))`` and the affine
    term ``sum(log scale)``."""
    std = torch.exp(log_std)
    normal_logp = torch.sum(
        -0.5 * torch.square((u - mean) / std) - log_std - 0.5 * math.log(2.0 * math.pi),
        dim=-1,
    )
    tanh_corr = torch.sum(2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)), dim=-1)
    scale_corr = torch.sum(torch.log(action_scale))
    return normal_logp - tanh_corr - scale_corr


def squash(u: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor) -> torch.Tensor:
    """``a = tanh(u) * scale + bias``, the one squash every sampler uses."""
    return torch.tanh(u) * action_scale + action_bias


@dataclass
class SACTrainState:
    actor_params: Params
    critic_params: Params
    target_critic_params: Params
    log_alpha: Params  # {"log_alpha": 0-dim float32}
    actor_opt: Dict[str, Any]  # Adam: {"mu", "nu", "count"}
    critic_opt: Dict[str, Any]
    alpha_opt: Dict[str, Any]
    step: torch.Tensor  # int32, learner updates


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    """The gradient dict, summed over the batch shards under a mesh."""
    return reduce_gradients(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))


def _requires_grad(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _apply(params: Params, updates: Params) -> Params:
    return {k: params[k] + updates[k] for k in params}


def batch_discount(batch: Mapping[str, torch.Tensor], gamma: float, n_steps: int) -> torch.Tensor:
    """``(1 - done) * gamma^k``, k the realised n-step window length where
    the batch carries ``n_steps`` (the sampler's n-step contract)."""
    done = batch["done"].to(torch.float32)
    k = batch.get("n_steps")
    if k is None:
        return (1.0 - done) * (gamma**n_steps)
    return (1.0 - done) * (gamma ** k.to(torch.float32))


def make_sac_learn_fn(
    actor: TanhGaussianActor,
    critic: TwinQNet,
    actor_tx: AdamOptimizer,
    critic_tx: AdamOptimizer,
    alpha_tx: AdamOptimizer,
    args: SACArguments,
    action_scale: torch.Tensor,
    action_bias: torch.Tensor,
    target_entropy: float,
) -> Callable:
    """The ``(state, batch[, noise]) -> (state, metrics, td_abs)`` SAC
    update, wrapped in the all-finite guard unless ``args.nonfinite_guard``
    is off.  ``noise``: ``{"next": eps, "pi": eps}``, standard normals of
    the actions' shape, replacing the drawn ones."""
    seed = args.seed + SAC_SEED_OFFSET

    def sample_action(actor_params: Params, obs: torch.Tensor, eps: torch.Tensor):
        mean, log_std = functional_call(actor, actor_params, (obs,))
        u = mean + torch.exp(log_std) * eps
        return squash(u, action_scale, action_bias), squash_log_prob(u, log_std, mean,
                                                                    action_scale)

    def learn(state: SACTrainState, batch: Mapping[str, torch.Tensor],
              noise: Optional[Mapping[str, torch.Tensor]] = None):
        obs, next_obs = batch["obs"], batch["next_obs"]
        action = batch["action"]
        reward = batch["reward"].to(torch.float32)
        weights = batch.get("weights")
        weights = torch.ones_like(reward) if weights is None else weights
        shape = (global_batch(reward.shape[0]), action_scale.shape[0])
        if noise is None:  # drawn for the global batch, this shard's rows kept
            noise = {"next": local_rows(counter_rng.normal(seed, 0, state.step, shape)),
                     "pi": local_rows(counter_rng.normal(seed, 1, state.step, shape))}
        alpha = torch.exp(state.log_alpha["log_alpha"])

        # critics: the clipped double-Q target with the entropy bonus
        discount = batch_discount(batch, args.gamma, args.n_steps)
        with torch.no_grad():
            next_a, next_logp = sample_action(state.actor_params, next_obs, noise["next"])
            tq1, tq2 = functional_call(critic, state.target_critic_params, (next_obs, next_a))
            target = reward + discount * (torch.minimum(tq1, tq2) - alpha * next_logp)

        cp = _requires_grad(state.critic_params)
        q1, q2 = functional_call(critic, cp, (obs, action))
        c_loss = 0.5 * batch_mean(weights * (torch.square(q1 - target)
                                             + torch.square(q2 - target)))
        td_abs = torch.abs(q1 - target).detach()
        c_updates, critic_opt = critic_tx.update(_grads(c_loss, cp), state.critic_opt)
        critic_params = _apply(state.critic_params, c_updates)

        # actor: maximise E[min Q - alpha * logp] through the new critics
        ap = _requires_grad(state.actor_params)
        a, logp = sample_action(ap, obs, noise["pi"])
        q1_pi, q2_pi = functional_call(critic, critic_params, (obs, a))
        a_loss = batch_mean(alpha * logp - torch.minimum(q1_pi, q2_pi))
        a_updates, actor_opt = actor_tx.update(_grads(a_loss, ap), state.actor_opt)
        actor_params = _apply(state.actor_params, a_updates)
        logp = logp.detach()

        # temperature: drive E[logp] toward -target_entropy
        if args.auto_alpha:
            la = _requires_grad(state.log_alpha)
            al_loss = -batch_mean(torch.exp(la["log_alpha"]) * (logp + target_entropy))
            al_updates, alpha_opt = alpha_tx.update(_grads(al_loss, la), state.alpha_opt)
            log_alpha = _apply(state.log_alpha, al_updates)
        else:
            al_loss = torch.zeros((), device=reward.device)
            alpha_opt, log_alpha = state.alpha_opt, state.log_alpha

        tau = args.soft_update_tau
        target_critic_params = {k: (1.0 - tau) * t + tau * critic_params[k]
                                for k, t in state.target_critic_params.items()}
        new_state = SACTrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params=target_critic_params,
            log_alpha=log_alpha,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            alpha_opt=alpha_opt,
            step=state.step + 1,
        )
        metrics = {
            "loss": c_loss.detach(),  # the off-policy trainer's log line reads it
            "critic_loss": c_loss.detach(),
            "actor_loss": a_loss.detach(),
            "alpha_loss": al_loss.detach(),
            "alpha": torch.exp(log_alpha["log_alpha"]).detach(),
            "entropy": -batch_mean(logp),
            "mean_q_target": batch_mean(target),
        }
        return new_state, metrics, td_abs

    return maybe_guard_nonfinite(learn, args)


class ContinuousAgent(BaseAgent):
    """What SAC and TD3 share: the Box bounds on the device, the host and
    device observation batches, the guarded learn step and its
    ``(metrics, td_abs)`` on the device, and its mesh."""

    _shard_batch = None
    _acting_field = "actor_params"

    def _setup_bounds(self, obs_shape, action_low, action_high, device: DeviceLike) -> None:
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        low = np.asarray(action_low, np.float32)
        high = np.asarray(action_high, np.float32)
        if low.ndim != 1:
            raise ValueError(
                f"{type(self).__name__} expects a 1-D Box action space; got bounds of "
                f"shape {low.shape}"
            )
        self.action_dim = int(low.shape[0])
        self.action_scale = torch.tensor((high - low) / 2.0, device=self.device)
        self.action_bias = torch.tensor((high + low) / 2.0, device=self.device)
        self.low = torch.tensor(low, device=self.device)
        self.high = torch.tensor(high, device=self.device)

    def _obs_batch(self, obs) -> torch.Tensor:
        return torch.as_tensor(obs, dtype=torch.float32, device=self.device)

    def enable_mesh(self, mesh_or_spec) -> None:
        """Data-parallel learn step over a mesh
        (``parallel/train_step.py::enable_offpolicy_mesh``)."""
        from scalerl_torch.parallel.train_step import enable_offpolicy_mesh

        enable_offpolicy_mesh(self, mesh_or_spec)

    def learn_device(self, batch: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One train step; its metrics and the per-sample ``|Q1 - target|``
        stay on the device."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self._shard_batch is not None:
            batch = self._shard_batch(batch)
        self.state, metrics, td_abs = self._learn(self.state, batch)
        return metrics, td_abs

    def learn(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        metrics, td_abs = self.learn_device(batch)
        out: Dict[str, Any] = get_metrics(metrics)  # one batched copy
        out["td_abs"] = td_abs  # device tensor, PER priority feedback
        return out

    def get_weights(self) -> Params:
        return self.acting_params()

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, actor_params=dict(weights))


class SACAgent(ContinuousAgent):
    """Host-facing SAC agent: sampled and mean actions as float32 tensors
    on the device (the trainer hands them to the env in its own form), the
    learn step, weights and checkpoints."""

    def __init__(
        self,
        args: SACArguments,
        obs_shape: Tuple[int, ...],
        action_low,
        action_high,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self._setup_bounds(obs_shape, action_low, action_high, device)
        obs_dim = int(np.prod(self.obs_shape))
        init = torch.Generator().manual_seed(args.seed)
        self.actor = TanhGaussianActor(obs_dim, self.action_dim, args.hidden_sizes,
                                       device=self.device, generator=init)
        self.critic = TwinQNet(obs_dim, self.action_dim, args.hidden_sizes,
                               device=self.device, generator=init)
        actor_tx = AdamOptimizer(args.actor_learning_rate)
        critic_tx = AdamOptimizer(args.learning_rate)
        alpha_tx = AdamOptimizer(args.alpha_learning_rate)
        actor_params = {k: v.detach().clone() for k, v in self.actor.named_parameters()}
        critic_params = {k: v.detach().clone() for k, v in self.critic.named_parameters()}
        log_alpha = {"log_alpha": torch.tensor(np.log(args.init_alpha), dtype=torch.float32,
                                               device=self.device)}
        self.state = SACTrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_critic_params={k: v.clone() for k, v in critic_params.items()},
            log_alpha=log_alpha,
            actor_opt=actor_tx.init(actor_params),
            critic_opt=critic_tx.init(critic_params),
            alpha_opt=alpha_tx.init(log_alpha),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self.target_entropy = -self.action_dim * args.target_entropy_scale
        self._learn = make_sac_learn_fn(self.actor, self.critic, actor_tx, critic_tx, alpha_tx,
                                        args, self.action_scale, self.action_bias,
                                        self.target_entropy)
        # acting draws from its own stream on the device
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)

    @torch.no_grad()
    def get_action(self, obs, *, done=None) -> torch.Tensor:
        """``squash(mean + std * eps)`` with ``eps`` from the agent's device
        generator."""
        mean, log_std = functional_call(self.actor, self.acting_params(),
                                        (self._obs_batch(obs),))
        eps = torch.randn(mean.shape, generator=self.generator, device=mean.device)
        return squash(mean + torch.exp(log_std) * eps, self.action_scale, self.action_bias)

    @torch.no_grad()
    def predict(self, obs, *, done=None) -> torch.Tensor:
        mean, _ = functional_call(self.actor, self.acting_params(),
                                  (self._obs_batch(obs),))
        return squash(mean, self.action_scale, self.action_bias)
