"""TD3: twin-delayed DDPG for continuous control.

Port of ``scalerl_tpu/agents/td3.py``: a deterministic tanh actor with
exploration noise, clipped double-Q critics, target policy smoothing
(Gaussian noise on the target action, clipped at ``target_noise_clip x
action_scale``), and the actor and target updates applied only every
``policy_delay`` critic steps.

The delay is a masked update, as in the JAX package: the actor's step is
computed every time and kept, together with its Adam state, only where
``(step + 1) % policy_delay == 0``, by ``torch.where`` on the device step
counter, so Adam's count advances only on applied steps; the polyak ``tau``
is masked the same way.  The smoothing noise is a pure function of ``(seed
+ 0x7D3, state.step)`` drawn on the device (``utils/counter_rng.py``);
``learn(state, batch, noise)`` takes it injected instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from scalerl_torch.agents.dqn import AdamOptimizer
from scalerl_torch.agents.sac import (
    ContinuousAgent,
    _apply,
    _grads,
    _requires_grad,
    batch_discount,
)
from scalerl_torch.config import TD3Arguments
from scalerl_torch.models.mlp import DeterministicActor, TwinQNet
from scalerl_torch.parallel.sharding import batch_mean, global_batch, local_rows
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite, tree_select
from scalerl_torch.utils import counter_rng
from scalerl_torch.utils.platform import DeviceLike

Params = Dict[str, torch.Tensor]
TD3_SEED_OFFSET = 0x7D3


@dataclass
class TD3TrainState:
    actor_params: Params
    target_actor_params: Params
    critic_params: Params
    target_critic_params: Params
    actor_opt: Dict[str, Any]  # Adam: {"mu", "nu", "count"}
    critic_opt: Dict[str, Any]
    step: torch.Tensor  # int32, learner updates


def make_td3_learn_fn(
    actor: DeterministicActor,
    critic: TwinQNet,
    actor_tx: AdamOptimizer,
    critic_tx: AdamOptimizer,
    args: TD3Arguments,
    action_scale: torch.Tensor,
    action_bias: torch.Tensor,
) -> Callable:
    """The ``(state, batch[, noise]) -> (state, metrics, td_abs)`` TD3
    update, wrapped in the all-finite guard unless ``args.nonfinite_guard``
    is off.  ``noise``: standard normals of the actions' shape for the
    target smoothing, replacing the drawn ones."""
    seed = args.seed + TD3_SEED_OFFSET
    low, high = action_bias - action_scale, action_bias + action_scale

    def learn(state: TD3TrainState, batch: Mapping[str, torch.Tensor],
              noise: Optional[torch.Tensor] = None):
        obs, next_obs = batch["obs"], batch["next_obs"]
        action = batch["action"]
        reward = batch["reward"].to(torch.float32)
        weights = batch.get("weights")
        weights = torch.ones_like(reward) if weights is None else weights
        discount = batch_discount(batch, args.gamma, args.n_steps)
        if noise is None:  # drawn for the global batch, this shard's rows kept
            noise = local_rows(counter_rng.normal(
                seed, 0, state.step, (global_batch(reward.shape[0]), action_scale.shape[0])))

        # target policy smoothing: clipped noise on the target action
        with torch.no_grad():
            next_a = functional_call(actor, state.target_actor_params, (next_obs,))
            next_a = next_a * action_scale + action_bias
            bound = args.target_noise_clip * action_scale
            eps = torch.clamp(args.target_noise_std * action_scale * noise, -bound, bound)
            next_a = torch.clamp(next_a + eps, low, high)
            tq1, tq2 = functional_call(critic, state.target_critic_params, (next_obs, next_a))
            target = reward + discount * torch.minimum(tq1, tq2)

        cp = _requires_grad(state.critic_params)
        q1, q2 = functional_call(critic, cp, (obs, action))
        c_loss = 0.5 * batch_mean(weights * (torch.square(q1 - target)
                                             + torch.square(q2 - target)))
        td_abs = torch.abs(q1 - target).detach()
        c_updates, critic_opt = critic_tx.update(_grads(c_loss, cp), state.critic_opt)
        critic_params = _apply(state.critic_params, c_updates)

        # delayed actor and targets: computed every step, kept every
        # policy_delay-th (the Adam state with them)
        ap = _requires_grad(state.actor_params)
        a = functional_call(actor, ap, (obs,)) * action_scale + action_bias
        q1_pi, _ = functional_call(critic, critic_params, (obs, a))
        a_loss = -batch_mean(q1_pi)
        a_updates, actor_opt_new = actor_tx.update(_grads(a_loss, ap), state.actor_opt)
        actor_params_new = _apply(state.actor_params, a_updates)

        step = state.step + 1
        apply_actor = (step % args.policy_delay) == 0
        actor_params = tree_select(apply_actor, actor_params_new, state.actor_params)
        actor_opt = tree_select(apply_actor, actor_opt_new, state.actor_opt)
        tau = args.soft_update_tau * apply_actor.to(torch.float32)
        target_actor_params = {k: (1.0 - tau) * t + tau * actor_params[k]
                               for k, t in state.target_actor_params.items()}
        target_critic_params = {k: (1.0 - tau) * t + tau * critic_params[k]
                                for k, t in state.target_critic_params.items()}
        new_state = TD3TrainState(
            actor_params=actor_params,
            target_actor_params=target_actor_params,
            critic_params=critic_params,
            target_critic_params=target_critic_params,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            step=step,
        )
        metrics = {
            "loss": c_loss.detach(),
            "critic_loss": c_loss.detach(),
            "actor_loss": a_loss.detach(),
            "mean_q_target": batch_mean(target),
        }
        return new_state, metrics, td_abs

    return maybe_guard_nonfinite(learn, args)


class TD3Agent(ContinuousAgent):
    """Host-facing TD3 agent: actions with Gaussian exploration noise
    (``explore_noise_std x action_scale``, clipped to the bounds) or
    without it, as float32 tensors on the device; the learn step, weights
    and checkpoints."""

    def __init__(
        self,
        args: TD3Arguments,
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
        self.actor = DeterministicActor(obs_dim, self.action_dim, args.hidden_sizes,
                                        device=self.device, generator=init)
        self.critic = TwinQNet(obs_dim, self.action_dim, args.hidden_sizes,
                               device=self.device, generator=init)
        actor_tx = AdamOptimizer(args.actor_learning_rate)
        critic_tx = AdamOptimizer(args.learning_rate)
        actor_params = {k: v.detach().clone() for k, v in self.actor.named_parameters()}
        critic_params = {k: v.detach().clone() for k, v in self.critic.named_parameters()}
        self.state = TD3TrainState(
            actor_params=actor_params,
            target_actor_params={k: v.clone() for k, v in actor_params.items()},
            critic_params=critic_params,
            target_critic_params={k: v.clone() for k, v in critic_params.items()},
            actor_opt=actor_tx.init(actor_params),
            critic_opt=critic_tx.init(critic_params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self._learn = make_td3_learn_fn(self.actor, self.critic, actor_tx, critic_tx, args,
                                        self.action_scale, self.action_bias)
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)

    @torch.no_grad()
    def _act(self, obs, noise_std: float) -> torch.Tensor:
        a = functional_call(self.actor, self.acting_params(), (self._obs_batch(obs),))
        a = a * self.action_scale + self.action_bias
        if noise_std:
            eps = torch.randn(a.shape, generator=self.generator, device=a.device)
            a = a + noise_std * self.action_scale * eps
        return torch.clamp(a, self.low, self.high)

    def get_action(self, obs, *, done=None) -> torch.Tensor:
        return self._act(obs, self.args.explore_noise_std)

    def predict(self, obs, *, done=None) -> torch.Tensor:
        return self._act(obs, 0.0)
