"""R2D2: recurrent replay distributed DQN (Kapturowski et al. 2019).

Port of ``scalerl_tpu/agents/r2d2.py``: sequence replay with the actor's
stored LSTM state, burn-in rows that advance both cores without gradient,
n-step double-Q targets under the invertible value rescaling ``h``, and
per-sequence priorities ``eta * max|td| + (1 - eta) * mean|td|``.

The learn step is a function of an explicit ``R2D2TrainState`` (online and
target parameters, Adam state, step count), run through
``torch.func.functional_call`` under the all-finite guard, as the port's
DQN learner is; it takes sequence batches ``[B, T+1, ...]`` and its new
priorities stay on the device.

Actor threads act through :class:`EpsGreedyActorView`: each view owns a copy
of the model (``functional_call`` swaps a module's parameters in place, so
two threads must not run one module) and its own device generator, and
reads ``agent.state.params`` once per act; the learner swaps the whole
state in one assignment.  ``enable_mesh`` splits the sequence batch over
``dp`` x ``fsdp`` (``parallel/train_step.py``); the per-sequence
priorities come back whole for the PER write-back.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from scalerl_torch.agents.base import BaseAgent, RecurrentEvalState
from scalerl_torch.agents.dqn import AdamOptimizer, Params
from scalerl_torch.agents.policy_value import pack_host_inputs
from scalerl_torch.config import R2D2Arguments
from scalerl_torch.models.recurrent_q import RecurrentQNet
from scalerl_torch.parallel.sharding import batch_mean, batch_sum, reduce_gradients
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.platform import DeviceLike, resolve_device


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """``h(x) = sign(x) (sqrt(|x| + 1) - 1) + eps x`` (Pohlen et al. 2018)."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """The closed-form inverse of :func:`value_rescale`."""
    return torch.sign(x) * (
        torch.square((torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0)
                     / (2.0 * eps))
        - 1.0
    )


@dataclass
class R2D2TrainState:
    params: Params
    target_params: Params
    opt_state: Dict[str, Any]  # Adam: {"mu", "nu", "count"}
    step: torch.Tensor  # int32, learner updates


def build_model(args: R2D2Arguments, obs_shape: Tuple[int, ...], num_actions: int,
                device: DeviceLike = "cuda") -> RecurrentQNet:
    return RecurrentQNet(
        obs_shape, num_actions, use_lstm=args.use_lstm, hidden_size=args.hidden_size,
        lstm_layers=args.lstm_layers, dueling=args.dueling_dqn, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )


def n_step_double_q_targets(
    q_online: torch.Tensor,  # [Tt, B, A] over the train rows (after burn-in)
    q_target: torch.Tensor,  # [Tt, B, A]
    action: torch.Tensor,  # [T1, B] trajectory rows (model-input convention)
    reward: torch.Tensor,  # [T1, B]
    done: torch.Tensor,  # [T1, B] bool
    burn_in: int,
    n_steps: int,
    gamma: float,
    rescale_eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(td_errors [M, B], qa [M, B])`` over the ``M = T1 - burn_in - n``
    rows with a full window.

    Row convention (``data/trajectory.py``): ``action[t]`` and ``reward[t]``
    lead TO ``obs[t]``, so the transition at row g pairs ``Q(s_g,
    action[g+1])`` with rewards ``g+1 .. g+n`` and bootstraps at row
    ``g+n``, through the target net at the online net's argmax.  The target
    is detached."""
    T1 = action.shape[0]
    b = burn_in
    M = T1 - b - n_steps
    a_taken = action[b + 1:b + 1 + M].long()
    qa = torch.gather(q_online[:M], -1, a_taken[..., None])[..., 0]
    with torch.no_grad():
        rewards = reward[1:]
        disc = 1.0 - done[1:].to(torch.float32)
        ret = torch.zeros_like(qa)
        live = torch.ones_like(qa)
        for k in range(n_steps):
            ret = ret + (gamma**k) * live * rewards[b + k:b + k + M]
            live = live * disc[b + k:b + k + M]
        a_star = torch.argmax(q_online[n_steps:n_steps + M], dim=-1)
        boot = torch.gather(q_target[n_steps:n_steps + M], -1, a_star[..., None])[..., 0]
        target = value_rescale(
            ret + (gamma**n_steps) * live * value_rescale_inv(boot, rescale_eps), rescale_eps)
    return qa - target, qa


def make_r2d2_learn_fn(model: RecurrentQNet, optimizer: AdamOptimizer,
                       args: R2D2Arguments) -> Callable:
    """``(state, fields [B, T1, ...], core, is_weights [B]) -> (state,
    metrics, new_priorities [B])`` under the all-finite guard: burn-in
    without gradient, n-step double-Q on the train rows, the IS-weighted
    loss ``0.5 * sum_b w_b mean_t td^2`` (sums over the batch, the JAX
    package's convention), one Adam step, and the periodic target sync."""
    b = args.burn_in

    def unroll(params, obs, action, reward, done, core):
        out, core = functional_call(model, params, (obs, action, reward, done, core))
        return out.q_values, core

    def learn(state: R2D2TrainState, fields: Mapping[str, torch.Tensor], core, weights):
        obs, action, reward, done = (fields[k].movedim(0, 1)
                                     for k in ("obs", "action", "reward", "done"))
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        warm_core = warm_core_t = core
        with torch.no_grad():
            if b > 0:  # burn-in: advance both cores over the stale prefix
                _, warm_core = unroll(state.params, obs[:b], action[:b], reward[:b],
                                      done[:b], core)
                _, warm_core_t = unroll(state.target_params, obs[:b], action[:b],
                                        reward[:b], done[:b], core)
            q_target, _ = unroll(state.target_params, obs[b:], action[b:], reward[b:],
                                 done[b:], warm_core_t)
        q_online, _ = unroll(params, obs[b:], action[b:], reward[b:], done[b:], warm_core)
        td, qa = n_step_double_q_targets(
            q_online, q_target, action, reward, done, burn_in=b, n_steps=args.n_steps,
            gamma=args.gamma, rescale_eps=args.value_rescale_eps)
        per_seq = torch.mean(torch.square(td), dim=0)  # [B]
        loss = 0.5 * batch_sum(weights * per_seq)
        grads = reduce_gradients(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        new_params = {k: state.params[k] + updates[k] for k in state.params}
        step = state.step + 1
        sync = (step % args.target_update_frequency) == 0
        target_params = {k: torch.where(sync, new_params[k], t)
                         for k, t in state.target_params.items()}
        abs_td = torch.abs(td.detach())
        new_prio = (args.priority_eta * torch.amax(abs_td, dim=0)
                    + (1.0 - args.priority_eta) * torch.mean(abs_td, dim=0))
        metrics = {"total_loss": loss.detach(), "mean_q": batch_mean(qa.detach()),
                   "mean_abs_td": batch_mean(abs_td)}
        return R2D2TrainState(new_params, target_params, opt_state, step), metrics, new_prio

    return maybe_guard_nonfinite(learn, args)


class EpsGreedyActorView:
    """One actor's acting facade (``initial_state`` + ``act``) over the
    agent's live parameters: epsilon-greedy with the actor's own ``eps``
    and device generator, through the view's own copy of the model."""

    def __init__(self, agent: "R2D2Agent", eps: float, seed: int) -> None:
        self._agent = agent
        self.eps = eps
        self.model = copy.deepcopy(agent._act_template)
        self.generator = torch.Generator(device=agent.device).manual_seed(seed)

    def initial_state(self, batch_size: int):
        return self._agent.initial_state(batch_size)

    def act(self, obs, last_action, reward, done, core_state):
        """One step over ``[B, ...]`` lanes -> ``(actions, q, core)``: numpy
        actions (int32) and Q-values for numpy inputs (one copy each way),
        device tensors for tensor inputs; the core stays on the device."""
        params = self._agent.acting_params()  # one read of the state
        if isinstance(obs, torch.Tensor):
            return self._agent.act_on(self.model, params, obs, last_action,
                                      reward, done, core_state, self.eps, self.generator)
        inputs = pack_host_inputs(obs, last_action, reward, done, self._agent.device)
        action, q, core = self._agent.act_on(self.model, params, *inputs,
                                             core_state, self.eps, self.generator)
        host = torch.cat([q, action[:, None].to(q.dtype)], dim=1).cpu().numpy()
        return host[:, -1].astype(np.int32), host[:, :-1], core

    def close(self) -> None:
        pass


class R2D2Agent(BaseAgent):
    def __init__(
        self,
        args: R2D2Arguments,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        obs_dtype: Any = np.float32,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.obs_dtype = obs_dtype
        self.model = build_model(args, self.obs_shape, num_actions, self.device)
        # actor views copy this module; it is never run, so never swapped
        self._act_template = copy.deepcopy(self.model)
        max_norm = args.max_grad_norm if args.max_grad_norm and args.max_grad_norm > 0 else None
        self.optimizer = AdamOptimizer(args.learning_rate, max_norm=max_norm)
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.state = R2D2TrainState(
            params=params,
            target_params={k: v.clone() for k, v in params.items()},
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self._learn = make_r2d2_learn_fn(self.model, self.optimizer, args)
        self._eval_state = RecurrentEvalState(self.initial_state)
        self._views: Dict[str, EpsGreedyActorView] = {}
        self._shard_batch = None

    # -- acting --------------------------------------------------------
    @torch.no_grad()
    def act_on(self, model: RecurrentQNet, params: Params, obs, last_action, reward, done,
               core, eps: float, generator: torch.Generator):
        """Epsilon-greedy over one step of ``[B, ...]`` device tensors
        through ``model`` (the caller's own module) under ``params`` ->
        ``(actions int64, q [B, A], core)``."""
        out, new_core = functional_call(
            model, params, (obs[None], last_action[None], reward[None], done[None], core))
        q = out.q_values[0]
        greedy = torch.argmax(q, dim=-1)
        explore = torch.rand(greedy.shape, generator=generator, device=q.device) < eps
        random_a = torch.randint(0, self.num_actions, greedy.shape, generator=generator,
                                 device=q.device)
        return torch.where(explore, random_a, greedy), q, new_core

    def actor_view(self, actor_id: int) -> EpsGreedyActorView:
        """The Ape-X epsilon ladder: ``eps_i = eps_base ** (1 + i/(N-1) *
        eps_alpha)``; actor ``i``'s generator is seeded ``seed + 101 i``."""
        n = max(self.args.num_actors, 1)
        frac = actor_id / max(n - 1, 1)
        eps = self.args.eps_base ** (1.0 + frac * self.args.eps_alpha)
        return EpsGreedyActorView(self, eps, self.args.seed + 101 * actor_id)

    def initial_state(self, batch_size: int):
        return self.model.initial_state(batch_size)

    def _host_step(self, mode: str, obs, done) -> np.ndarray:
        """One per-call host step with the mode's carried core."""
        view = self._views.get(mode)
        if view is None:
            view = self._views[mode] = self.actor_view(0)
            if mode == "greedy":
                view.eps = 0.0
        B = np.asarray(obs).shape[0]
        core, prev_a, prev_r, done_in = self._eval_state.step_inputs(mode, B, done)
        a, _q, new_core = view.act(np.asarray(obs), prev_a, prev_r, done_in, core)
        self._eval_state.update(mode, a, new_core)
        return a

    def get_action(self, obs, *, done=None) -> np.ndarray:
        """Epsilon-greedy actions (actor 0's epsilon) with a persistent LSTM
        carry: rows reset where ``done`` (the previous step's ``term |
        trunc``) is True."""
        return self._host_step("explore", obs, done)

    def predict(self, obs, *, done=None) -> np.ndarray:
        """Greedy actions, with the same persistent-core contract."""
        return self._host_step("greedy", obs, done)

    # -- learning ------------------------------------------------------
    def enable_mesh(self, mesh_or_spec) -> None:
        """Data-parallel learn step over a mesh: the sequence batch splits
        over ``dp`` x ``fsdp``, the params by the fsdp/tp rule (replicated:
        the model has an LSTM core), and the priorities come back whole (in
        the step's ``"replay_shard"`` batch mode, which ``R2D2Trainer`` asks
        for over its sharded replay, each rank's batch is its shard's rows
        and the priorities are those rows')."""
        from scalerl_torch.parallel.mesh import resolve_mesh
        from scalerl_torch.parallel.train_step import make_parallel_learn_fn

        mesh = resolve_mesh(mesh_or_spec)
        n_shards = mesh.extent(("dp", "fsdp"))
        if self.args.batch_size % n_shards != 0:
            raise ValueError(
                f"batch_size ({self.args.batch_size}) must divide by the mesh's dp*fsdp "
                f"extent ({n_shards}) to shard the sequence batch")
        models = [m for m in vars(self).values() if isinstance(m, torch.nn.Module)]
        plearn = make_parallel_learn_fn(self._learn, mesh, self.state, batch_time_major=False,
                                        modules=models)
        self.mesh = mesh
        self.state = plearn.shard_state(self.state)
        self._learn = plearn
        self._shard_batch = plearn.shard_batch

    def learn_sequences(self, fields, core, weights) -> Tuple[Dict[str, torch.Tensor],
                                                              torch.Tensor]:
        """One update on a sampled sequence batch (this rank's sequences of
        it under a mesh); returns (metrics, new priorities), both on the
        device, with the state replaced whole."""
        batch = (fields, core, weights)
        if self._shard_batch is not None:
            batch = tuple(self._shard_batch(b) for b in batch)
        self.state, metrics, prio = self._learn(self.state, *batch)
        return metrics, prio

    def learn(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        metrics, _ = self.learn_sequences(batch["fields"], batch["core"], batch["weights"])
        return get_metrics(metrics)  # one batched device->host copy

    def get_weights(self) -> Params:
        return self.acting_params()

    def set_weights(self, weights: Params) -> None:
        self.state = dataclasses.replace(self.state, params=dict(weights))
        self._eval_state.reset()  # a carried core came from the old weights

    def load_checkpoint(self, path: str) -> None:
        super().load_checkpoint(path)
        self._eval_state.reset()
