"""DQN: the double-DQN learner and an epsilon-greedy actor on the device.

Port of ``scalerl_tpu/agents/dqn.py`` for the scalar-Q ``QNet`` (the C51
head, the Ape-X priority function and checkpoints are not ported yet).

As in the JAX package, the learn step is a function of an explicit
``DQNTrainState`` (online and target parameters, optimizer state, step
count): the model runs with the state's parameters through
``torch.func.functional_call``, so the all-finite guard can keep or drop a
whole update with a device-side select, and the per-sample |TD| comes back
as a device tensor for the PER priority update.

The optimizer is optax's ``chain(clip_by_global_norm, adam)`` written out:
the clip only rescales when the norm reaches the limit and adds nothing to
the norm, and Adam adds ``eps`` outside the square root of the
bias-corrected second moment, with bias correction ``1 - b**t``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch.func import functional_call

from scalerl_torch.agents.base import BaseAgent
from scalerl_torch.agents.impala import Schedule, clip_by_global_norm, linear_schedule
from scalerl_torch.config import DQNArguments
from scalerl_torch.models.mlp import QNet
from scalerl_torch.ops.losses import double_dqn_targets, dqn_loss
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.platform import DeviceLike, resolve_device
from scalerl_torch.utils.schedulers import LinearDecayScheduler
from scalerl_torch.utils.tree import soft_target_update

Params = Dict[str, torch.Tensor]


@dataclass
class DQNTrainState:
    params: Params
    target_params: Params
    opt_state: Dict[str, Any]  # {"mu": Params, "nu": Params, "count": int32 tensor}
    step: torch.Tensor  # int32, learner updates


class AdamOptimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adam(learning_rate))``
    with optax's defaults b1 = 0.9, b2 = 0.999, eps = 1e-8; no clip when
    ``max_norm`` is falsy.  With a schedule, the learning rate is evaluated
    at the update count before this update, as optax's ``scale_by_schedule``
    does."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: Union[float, Schedule], max_norm: Optional[float] = None) -> None:
        self.learning_rate = learning_rate
        self.max_norm = max_norm

    def init(self, params: Params) -> Dict[str, Any]:
        device = next(iter(params.values())).device
        return {
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(self, grads: Params, opt_state: Dict[str, Any]) -> Tuple[Params, Dict[str, Any]]:
        if self.max_norm:
            grads = clip_by_global_norm(grads, self.max_norm)
        b1, b2 = self.B1, self.B2
        mu = {k: (1 - b1) * g + b1 * opt_state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * torch.square(g) + b2 * opt_state["nu"][k] for k, g in grads.items()}
        count = opt_state["count"]
        count_inc = count + 1
        t = count_inc.to(torch.float32)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        lr = self.learning_rate
        step_size = -lr(count) if callable(lr) else -lr
        updates = {
            k: step_size * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.EPS))
            for k in grads
        }
        return updates, {"mu": mu, "nu": nu, "count": count_inc}


def make_dqn_learn_fn(
    network: QNet,
    optimizer: AdamOptimizer,
    gamma: float,
    n_step: int,
    double_dqn: bool,
    use_soft_update: bool,
    soft_update_tau: float,
    target_update_frequency: int,
) -> Callable[[DQNTrainState, Mapping[str, torch.Tensor]], Tuple[DQNTrainState, Dict, torch.Tensor]]:
    """The ``(state, batch) -> (state, metrics, td_abs)`` update: double-DQN
    targets from the online and target nets, the (importance-weighted) TD
    loss, one optimizer step, then the soft or periodic target update."""

    def q_of(params: Params, obs: torch.Tensor) -> torch.Tensor:
        return functional_call(network, params, (obs,))

    def learn(state: DQNTrainState, batch: Mapping[str, torch.Tensor]):
        actions = batch["action"].long()
        rewards = batch["reward"].to(torch.float32)
        dones = batch["done"].to(torch.float32)
        weights = batch.get("weights")
        # n-step samples discount by gamma^k with the realised window length
        n_steps = batch.get("n_steps")
        if n_steps is None:
            discounts = (1.0 - dones) * (gamma**n_step)
        else:
            discounts = (1.0 - dones) * (gamma ** n_steps.to(torch.float32))
        with torch.no_grad():
            q_next_online = q_of(state.params, batch["next_obs"])
            q_next_target = q_of(state.target_params, batch["next_obs"])
        targets = double_dqn_targets(
            q_next_online, q_next_target, rewards, discounts, double_dqn=double_dqn
        )

        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        q = q_of(params, batch["obs"])
        loss, td_abs = dqn_loss(q, actions, targets, weights=weights)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        new_params = {k: state.params[k] + updates[k] for k in state.params}

        step = state.step + 1
        if use_soft_update:
            target_params = soft_target_update(new_params, state.target_params, soft_update_tau)
        else:
            do_update = (step % target_update_frequency) == 0
            target_params = {
                k: torch.where(do_update, new_params[k], t) for k, t in state.target_params.items()
            }
        new_state = DQNTrainState(new_params, target_params, opt_state, step)
        metrics = {
            "loss": loss.detach(),
            "td_error_mean": torch.mean(td_abs),
            "q_mean": torch.mean(q.detach()),
        }
        return new_state, metrics, td_abs

    return learn


def make_dqn_optimizer(args: DQNArguments) -> AdamOptimizer:
    """Adam behind the global-norm clip; ``lr_scheduler="linear"`` decays
    the learning rate to ``min_learning_rate`` over the run's learn steps."""
    lr: Union[float, Schedule] = args.learning_rate
    transition = int(args.max_timesteps // max(args.train_frequency, 1))
    if args.lr_scheduler == "linear" and transition >= 1:
        lr = linear_schedule(args.learning_rate, args.min_learning_rate, transition)
    return AdamOptimizer(lr, max_norm=args.max_grad_norm or None)


class DQNAgent(BaseAgent):
    """Host-facing DQN agent: act, learn and weight get/set."""

    def __init__(
        self,
        args: DQNArguments,
        obs_shape: Tuple[int, ...],
        action_dim: int,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.action_dim = action_dim
        self.obs_shape = tuple(obs_shape)
        self.network = QNet(
            self.obs_shape, action_dim, hidden_sizes=args.hidden_sizes,
            dueling=args.dueling_dqn, noisy=args.noisy_dqn,
            device=self.device, generator=torch.Generator().manual_seed(args.seed),
        )
        self.optimizer = make_dqn_optimizer(args)
        params = {k: v.detach().clone() for k, v in self.network.named_parameters()}
        self.state = DQNTrainState(
            params=params,
            target_params={k: v.clone() for k, v in params.items()},
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self.eps_scheduler = LinearDecayScheduler(
            args.eps_greedy_start,
            args.eps_greedy_end,
            int(args.max_timesteps * args.exploration_fraction),
        )
        self.eps = args.eps_greedy_start
        learn_fn = make_dqn_learn_fn(
            self.network,
            self.optimizer,
            gamma=args.gamma,
            n_step=args.n_steps,
            double_dqn=args.double_dqn,
            use_soft_update=args.use_soft_update,
            soft_update_tau=args.soft_update_tau,
            target_update_frequency=args.target_update_frequency,
        )
        # all-finite guard: a non-finite update is skipped and counted, and
        # its |TD| is zeroed before it can reach the replay's priorities
        self._learn = maybe_guard_nonfinite(learn_fn, args)
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)

    def _obs_batch(self, obs) -> Tuple[torch.Tensor, bool]:
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        squeeze = obs.dim() == len(self.obs_shape)
        return (obs[None] if squeeze else obs), squeeze

    @torch.no_grad()
    def _q(self, obs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.network, self.state.params, (obs,))

    def get_action(self, obs, *, done=None) -> torch.Tensor:
        """Epsilon-greedy actions as an int64 tensor on the agent's device
        (the JAX agent returns numpy); the random draws come from the
        agent's device generator, so acting never waits on the host."""
        obs, squeeze = self._obs_batch(obs)
        greedy = torch.argmax(self._q(obs), dim=-1)
        random_actions = torch.randint(
            0, self.action_dim, greedy.shape, generator=self.generator, device=self.device
        )
        explore = torch.rand(greedy.shape, generator=self.generator, device=self.device) < self.eps
        actions = torch.where(explore, random_actions, greedy)
        return actions[0] if squeeze else actions

    def predict(self, obs, *, done=None) -> torch.Tensor:
        """Greedy actions, as :meth:`get_action` returns them."""
        obs, squeeze = self._obs_batch(obs)
        actions = torch.argmax(self._q(obs), dim=-1)
        return actions[0] if squeeze else actions

    def update_exploration(self, num_env_steps: int = 1) -> float:
        self.eps = self.eps_scheduler.step(num_env_steps)
        return self.eps

    def learn_device(self, batch: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One train step; returns its metrics and the per-sample |TD|, both
        still on the device."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        self.state, metrics, td_abs = self._learn(self.state, batch)
        return metrics, td_abs

    def learn(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        metrics, td_abs = self.learn_device(batch)
        out = get_metrics(metrics)  # one batched device->host copy
        out["td_abs"] = td_abs  # device tensor, for the PER priority update
        out["eps"] = self.eps
        return out

    def get_weights(self) -> Params:
        return self.state.params

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
