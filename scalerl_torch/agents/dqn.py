"""DQN: the double-DQN and C51 learners and an epsilon-greedy actor on the device.

Port of ``scalerl_tpu/agents/dqn.py``: scalar-Q ``QNet`` and categorical
``C51QNet`` learners on one shared update (:func:`_make_learn_core`), the
Ape-X priority function (:func:`make_dqn_priority_fn`), NoisyNet layers.

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
from scalerl_torch.models.mlp import C51QNet, QNet
from scalerl_torch.ops.losses import (
    c51_loss,
    categorical_projection,
    categorical_q_values,
    double_dqn_targets,
    dqn_loss,
    make_support,
)
from scalerl_torch.parallel.sharding import batch_mean, reduce_gradients
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


def _make_learn_core(
    network: QNet,
    optimizer: AdamOptimizer,
    gamma: float,
    n_step: int,
    use_soft_update: bool,
    soft_update_tau: float,
    target_update_frequency: int,
    make_loss_fn: Callable,
    noise_generator: Optional[torch.Generator] = None,
) -> Callable[[DQNTrainState, Mapping[str, torch.Tensor]], Tuple[DQNTrainState, Dict, torch.Tensor]]:
    """The ``(state, batch) -> (state, metrics, per_sample)`` update both
    variants share: batch unpack and n-step discounts, one optimizer step,
    the soft or periodic target update, metrics.

    ``make_loss_fn(state, q_of, batch, actions, rewards, discounts,
    weights)`` returns the variant's ``loss_fn(params) -> (loss,
    (per_sample, q))``; ``q_of(params, obs, target)`` runs the network.
    With ``noise_generator`` (a noisy network), each update draws one noise
    sample for the online network's forwards and one for the target's."""

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
        noise = {}
        if noise_generator is not None:
            noise = {False: network.sample_noise(noise_generator),
                     True: network.sample_noise(noise_generator)}

        def q_of(params: Params, obs: torch.Tensor, target: bool = False) -> torch.Tensor:
            return functional_call(network, params, (obs,), {"noise": noise.get(target)})

        loss_fn = make_loss_fn(state, q_of, batch, actions, rewards, discounts, weights)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, (per_sample, q) = loss_fn(params)
        # noisy layers at their mean weights leave the sigmas out of the
        # graph: their gradient is zero, as in the JAX package
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = reduce_gradients({k: torch.zeros_like(v) if g is None else g
                                  for (k, v), g in zip(params.items(), grads)})
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
            "td_error_mean": batch_mean(per_sample),
            "q_mean": batch_mean(q.detach()),
        }
        return new_state, metrics, per_sample

    return learn


def make_dqn_learn_fn(
    network: QNet,
    optimizer: AdamOptimizer,
    gamma: float,
    n_step: int,
    double_dqn: bool,
    use_soft_update: bool,
    soft_update_tau: float,
    target_update_frequency: int,
    noise_generator: Optional[torch.Generator] = None,
) -> Callable[[DQNTrainState, Mapping[str, torch.Tensor]], Tuple[DQNTrainState, Dict, torch.Tensor]]:
    """The ``(state, batch) -> (state, metrics, td_abs)`` update: double-DQN
    targets from the online and target nets, the (importance-weighted) TD
    loss, one optimizer step, then the soft or periodic target update."""

    def make_loss_fn(state, q_of, batch, actions, rewards, discounts, weights):
        with torch.no_grad():
            q_next_online = q_of(state.params, batch["next_obs"])
            q_next_target = q_of(state.target_params, batch["next_obs"], True)
        targets = double_dqn_targets(
            q_next_online, q_next_target, rewards, discounts, double_dqn=double_dqn
        )

        def loss_fn(params):
            q = q_of(params, batch["obs"])
            loss, td_abs = dqn_loss(q, actions, targets, weights=weights)
            return loss, (td_abs, q)

        return loss_fn

    return _make_learn_core(network, optimizer, gamma, n_step, use_soft_update,
                            soft_update_tau, target_update_frequency, make_loss_fn,
                            noise_generator)


def make_c51_learn_fn(
    network: C51QNet,
    optimizer: AdamOptimizer,
    support: torch.Tensor,
    gamma: float,
    n_step: int,
    double_dqn: bool,
    use_soft_update: bool,
    soft_update_tau: float,
    target_update_frequency: int,
    noise_generator: Optional[torch.Generator] = None,
) -> Callable[[DQNTrainState, Mapping[str, torch.Tensor]], Tuple[DQNTrainState, Dict, torch.Tensor]]:
    """The categorical (C51) variant of :func:`make_dqn_learn_fn`: the TD
    target is the projected Bellman distribution of the next state's
    (double-Q) greedy action and the loss the cross-entropy to it; the
    per-sample cross-entropy is the PER priority signal."""

    def make_loss_fn(state, q_of, batch, actions, rewards, discounts, weights):
        with torch.no_grad():
            logits_next_t = q_of(state.target_params, batch["next_obs"], True)  # [B, A, N]
            logits_next = q_of(state.params, batch["next_obs"]) if double_dqn else logits_next_t
            next_actions = torch.argmax(categorical_q_values(logits_next, support), dim=-1)
            index = next_actions[:, None, None].expand(-1, 1, logits_next_t.shape[-1])
            next_probs = torch.softmax(torch.gather(logits_next_t, 1, index)[:, 0], dim=-1)
        target_probs = categorical_projection(next_probs, rewards, discounts, support)

        def loss_fn(params):
            logits = q_of(params, batch["obs"])
            loss, ce = c51_loss(logits, actions, target_probs, weights=weights)
            return loss, (ce, categorical_q_values(logits.detach(), support))

        return loss_fn

    return _make_learn_core(network, optimizer, gamma, n_step, use_soft_update,
                            soft_update_tau, target_update_frequency, make_loss_fn,
                            noise_generator)


def make_dqn_priority_fn(network: QNet, gamma: float, double_dqn: bool) -> Callable:
    """The |TD-error| function Ape-X actors compute their transitions'
    initial priorities with: ``(params, target_params, obs, action, reward,
    next_obs, done, n_steps) -> [B]``, under no gradient, noisy layers at
    their mean weights.  ``network`` is the caller's own module: the
    function swaps the parameters into it (``functional_call``), so threads
    each pass their own copy."""

    @torch.no_grad()
    def priority(params, target_params, obs, action, reward, next_obs, done, n_steps):
        discounts = (1.0 - done.to(torch.float32)) * (gamma ** n_steps.to(torch.float32))
        q_next_online = functional_call(network, params, (next_obs,))
        q_next_target = functional_call(network, target_params, (next_obs,))
        targets = double_dqn_targets(
            q_next_online, q_next_target, reward, discounts, double_dqn=double_dqn
        )
        q = functional_call(network, params, (obs,))
        q_sa = torch.gather(q, -1, action.long()[:, None])[:, 0]
        return torch.abs(q_sa - targets)

    return priority


def make_dqn_optimizer(args: DQNArguments) -> AdamOptimizer:
    """Adam behind the global-norm clip; ``lr_scheduler="linear"`` decays
    the learning rate to ``min_learning_rate`` over the run's learn steps."""
    lr: Union[float, Schedule] = args.learning_rate
    transition = int(args.max_timesteps // max(args.train_frequency, 1))
    if args.lr_scheduler == "linear" and transition >= 1:
        lr = linear_schedule(args.learning_rate, args.min_learning_rate, transition)
    return AdamOptimizer(lr, max_norm=args.max_grad_norm or None)


class DQNAgent(BaseAgent):
    """Host-facing DQN agent: act, learn and weight get/set.  With
    ``categorical_dqn`` the network is ``C51QNet`` and the learner C51's;
    with ``noisy_dqn`` every act and every learn step draws fresh noise from
    the agent's device generator (the JAX agent passes no ``noise`` rng, so
    its noisy layers always use their mean weights)."""

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
        self.categorical = bool(args.categorical_dqn)
        net_kw = dict(hidden_sizes=args.hidden_sizes, dueling=args.dueling_dqn,
                      noisy=args.noisy_dqn, noisy_std=args.noisy_std, device=self.device,
                      generator=torch.Generator().manual_seed(args.seed))
        if self.categorical:
            self.support = make_support(args.v_min, args.v_max, args.num_atoms, self.device)
            self.network: QNet = C51QNet(self.obs_shape, action_dim, args.num_atoms, **net_kw)
        else:
            self.support = None
            self.network = QNet(self.obs_shape, action_dim, **net_kw)
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
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)
        self._learn = maybe_guard_nonfinite(self.make_learn_fn(), args)
        self._shard_batch = None

    def make_learn_fn(self, noise: bool = True) -> Callable:
        """The unguarded learn function; ``noise=False`` runs noisy layers
        at their mean weights."""
        args = self.args
        kw = dict(
            gamma=args.gamma,
            n_step=args.n_steps,
            double_dqn=args.double_dqn,
            use_soft_update=args.use_soft_update,
            soft_update_tau=args.soft_update_tau,
            target_update_frequency=args.target_update_frequency,
            noise_generator=self.generator if noise and args.noisy_dqn else None,
        )
        if self.categorical:
            return make_c51_learn_fn(self.network, self.optimizer, self.support, **kw)
        return make_dqn_learn_fn(self.network, self.optimizer, **kw)

    def _obs_batch(self, obs) -> Tuple[torch.Tensor, bool]:
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        squeeze = obs.dim() == len(self.obs_shape)
        return (obs[None] if squeeze else obs), squeeze

    @torch.no_grad()
    def q_values(self, params: Params, obs: torch.Tensor, network: Optional[QNet] = None,
                 noise: bool = False) -> torch.Tensor:
        """``[B, A]`` Q-values (C51: the expectation over the support) of
        ``network`` (the agent's by default) under ``params``; ``noise``
        draws one NoisyNet sample from the agent's generator."""
        network = self.network if network is None else network
        draw = network.sample_noise(self.generator) if noise and self.args.noisy_dqn else None
        out = functional_call(network, params, (obs,), {"noise": draw})
        return categorical_q_values(out, self.support) if self.categorical else out

    def epsilon_greedy(self, q: torch.Tensor, eps: float,
                       generator: torch.Generator) -> torch.Tensor:
        """Greedy actions of ``q`` [B, A], each replaced by a uniform one with
        probability ``eps``; the draws come from ``generator``."""
        greedy = torch.argmax(q, dim=-1)
        random_actions = torch.randint(0, self.action_dim, greedy.shape, generator=generator,
                                       device=q.device)
        explore = torch.rand(greedy.shape, generator=generator, device=q.device) < eps
        return torch.where(explore, random_actions, greedy)

    def get_action(self, obs, *, done=None) -> torch.Tensor:
        """Epsilon-greedy actions as an int64 tensor on the agent's device
        (the JAX agent returns numpy); the random draws come from the
        agent's device generator, so acting never waits on the host."""
        obs, squeeze = self._obs_batch(obs)
        q = self.q_values(self.acting_params(), obs, noise=True)
        actions = self.epsilon_greedy(q, self.eps, self.generator)
        return actions[0] if squeeze else actions

    def predict(self, obs, *, done=None) -> torch.Tensor:
        """Greedy actions of the mean network, as :meth:`get_action`
        returns them."""
        obs, squeeze = self._obs_batch(obs)
        actions = torch.argmax(self.q_values(self.acting_params(), obs), dim=-1)
        return actions[0] if squeeze else actions

    def update_exploration(self, num_env_steps: int = 1) -> float:
        self.eps = self.eps_scheduler.step(num_env_steps)
        return self.eps

    def learn_device(self, batch: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One train step; returns its metrics and the per-sample |TD| (C51:
        cross-entropy), both still on the device.  The new state replaces
        the old one in a single assignment and no old tensor is written, so
        threads that read ``agent.state`` meanwhile see one whole state."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self._shard_batch is not None:
            batch = self._shard_batch(batch)
        self.state, metrics, td_abs = self._learn(self.state, batch)
        return metrics, td_abs

    def learn(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        metrics, td_abs = self.learn_device(batch)
        out = get_metrics(metrics)  # one batched device->host copy
        out["td_abs"] = td_abs  # device tensor, for the PER priority update
        out["eps"] = self.eps
        return out

    def get_weights(self) -> Params:
        return self.acting_params()

    def enable_mesh(self, mesh_or_spec) -> None:
        """Data-parallel learn step over a mesh
        (``parallel/train_step.py::enable_offpolicy_mesh``): the replay
        batch splits over ``dp`` x ``fsdp`` and the per-sample |TD| comes
        back whole for the PER write-back (in the step's ``"replay_shard"``
        batch mode, which ``ApexTrainer`` asks for over its sharded replay,
        each rank's batch is its shard's rows and the |TD| those rows')."""
        from scalerl_torch.parallel.train_step import enable_offpolicy_mesh

        enable_offpolicy_mesh(self, mesh_or_spec)

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
