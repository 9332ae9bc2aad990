"""Token-level PPO learner for the sequence-RL plane.

Port of ``scalerl_tpu/agents/token_ppo.py``: a PPO-clip update over
generated token sequences where every response token is one action.

- per-token importance ratios against the STORED behaviour logprobs;
- an optional KL penalty to a frozen copy of the initial parameters
  (``kl_cost > 0`` runs the reference forward, 0 leaves it out);
- the padded bucket-pair layout (:func:`token_ppo_loss`) and the packed-row
  layout (:func:`token_ppo_packed_loss`, batches that carry
  ``segment_ids``): the same loss over the same tokens, the packed one
  without the pad;
- one ``(state, batch) -> (state, metrics)`` update behind the all-finite
  guard, metrics read back with ONE batched copy.

As in the port's other agents, the learn step is a function of an explicit
:class:`TokenPPOTrainState`: the model runs with the state's parameters
through ``torch.func.functional_call`` and every update builds new tensors,
so the guard can keep the old state with a device-side select, the frozen
``ref_params`` are never written, and the weights handed to an engine stay
what they were.  The optimizer is ``optax.chain(clip_by_global_norm, adam)``
written out (``agents/dqn.py::AdamOptimizer``), wrapped in
``fp32_optimizer_state`` under ``bf16_params``.  Checkpoints go through
``utils/checkpoint.py``.  ``enable_mesh`` splits the rows over ``dp`` x
``fsdp`` and, with ``mp > 1``, lays the state out by the logical rule table
(``parallel/logical.py``); every masked mean then spans the whole batch.
A meshed agent keeps no gathered acting copy: its engines take the rank's
local shards (:meth:`TokenPPOAgent.engine_weights`, with
:attr:`TokenPPOAgent.shard_ctx`), and :meth:`TokenPPOAgent.get_weights`
gathers the whole tree where it is called, on every rank alike.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.func import functional_call

from scalerl_torch.agents.dqn import AdamOptimizer
from scalerl_torch.agents.impala import global_norm
from scalerl_torch.models.transformer import (
    TransformerPolicy,
    sequence_attention_mask,
    sequence_positions,
)
from scalerl_torch.parallel.sharding import (
    MeshedAgentState,
    ShardContext,
    batch_mean,
    batch_sum,
    gather_tree,
    reduce_gradients,
    to_local,
)
from scalerl_torch.parallel.train_step import fp32_optimizer_state, maybe_guard_nonfinite
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from scalerl_torch.utils.tree import tree_map

Params = Dict[str, torch.Tensor]
Batch = Mapping[str, torch.Tensor]


@dataclass
class TokenPPOTrainState:
    params: Params
    ref_params: Params  # frozen KL anchor (identity through every update)
    opt_state: Dict[str, Any]  # {"mu": Params, "nu": Params, "count": int32 tensor}
    step: torch.Tensor  # int32, learner updates
    tokens_seen: torch.Tensor  # int32, real response tokens consumed


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over positions where ``mask`` is 1 (safe on empty)."""
    return batch_sum(x * mask) / batch_sum(mask).clamp(min=1.0)


def _ppo_terms(
    logits: torch.Tensor,  # [N, L, V] outputs that predict `target`
    values: torch.Tensor,  # [N, L]
    target: torch.Tensor,  # [N, L] int
    behavior_logp: torch.Tensor,
    behavior_value: torch.Tensor,
    reward: torch.Tensor,  # broadcastable to [N, L]
    mask: torch.Tensor,  # [N, L] loss mask
    w_mask: torch.Tensor,  # mask times the per-unit importance weight
    ref_logits: Callable[[], torch.Tensor],  # the frozen reference's logits, on demand
    clip_range: float,
    value_cost: float,
    entropy_cost: float,
    kl_cost: float,
    adv_norm: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss terms both layouts share, over already aligned per-token
    tensors; the layout-specific diagnostics are added by the callers."""
    logp_all = torch.log_softmax(logits, dim=-1)
    new_logp = logp_all.gather(-1, target.long()[..., None])[..., 0]

    # terminal sequence-level reward, undiscounted credit to every real
    # token; the baseline is the sampling-time value estimate
    adv = reward - behavior_value
    if adv_norm:
        mu = masked_mean(adv, mask)
        var = masked_mean(torch.square(adv - mu), mask)
        adv = (adv - mu) * torch.rsqrt(var + 1e-8)
    adv = (adv * mask).detach()

    log_ratio = new_logp - behavior_logp.detach()
    ratio = torch.exp(log_ratio)
    unclipped = ratio * adv
    clipped = ratio.clamp(1.0 - clip_range, 1.0 + clip_range) * adv
    pg_loss = -masked_mean(torch.minimum(unclipped, clipped), w_mask)
    value_loss = value_cost * 0.5 * masked_mean(torch.square(values - reward), w_mask)
    # entropy bonus (negative entropy minimised, the ops/losses convention)
    ent = torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    total = pg_loss + value_loss + entropy_cost * masked_mean(ent, w_mask)
    metrics = {
        "pg_loss": pg_loss,
        "value_loss": value_loss,
        "entropy": -masked_mean(ent, mask),
        "mean_ratio": masked_mean(ratio, mask),
        "mean_approx_kl": masked_mean((ratio - 1.0) - log_ratio, mask),
        "mean_clip_frac": masked_mean((torch.abs(ratio - 1.0) > clip_range).float(), mask),
        "mean_value": masked_mean(values, mask),
    }
    if kl_cost > 0.0:
        ref_logp = torch.log_softmax(ref_logits(), dim=-1).detach()
        # forward KL(pi || pi_ref), per token, over the full vocabulary
        kl = torch.sum(torch.exp(logp_all) * (logp_all - ref_logp), dim=-1)
        total = total + kl_cost * masked_mean(kl, w_mask)
        metrics["kl_ref"] = masked_mean(kl, mask)
    return total, metrics


def _finish_metrics(total: torch.Tensor, metrics: Dict[str, torch.Tensor]):
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["total_loss"] = total
    return total, metrics


def token_ppo_loss(
    params: Params,
    ref_params: Params,
    model: TransformerPolicy,
    batch: Batch,
    clip_range: float,
    value_cost: float,
    entropy_cost: float,
    kl_cost: float,
    adv_norm: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO-clip over one padded ``[B, S]`` batch of ``genrl/rollout.py``'s
    fields: ``tokens`` ``[B, S]`` (left-padded prompt + response),
    ``behavior_logp`` / ``value`` / ``mask`` ``[B, R]``, ``reward`` /
    ``prompt_len`` / ``generation`` ``[B]`` and an optional ``is_weight``
    ``[B]`` (PER importance weights).  The prompt pad is ``P = S - R``."""
    tokens = batch["tokens"]
    mask = batch["mask"]
    reward = batch["reward"]
    prompt_len = batch["prompt_len"]
    S = tokens.shape[1]
    R = batch["behavior_logp"].shape[1]
    P = S - R
    seq_w = batch.get("is_weight")
    w_mask = mask if seq_w is None else mask * seq_w[:, None]

    positions = sequence_positions(prompt_len, P, S)
    attn_mask = sequence_attention_mask(prompt_len, P, S)

    def forward(p: Params):
        return functional_call(model, p, (tokens,), dict(positions=positions, attn_mask=attn_mask))

    out = forward(params)
    # the token at absolute position p is predicted by the output at p - 1:
    # response tokens occupy [P, S), predicted by the slice [P - 1, S - 1)
    total, metrics = _ppo_terms(
        out.policy_logits[:, P - 1:S - 1], out.baseline[:, P - 1:S - 1], tokens[:, P:S],
        batch["behavior_logp"], batch["value"], reward[:, None], mask, w_mask,
        lambda: forward(ref_params).policy_logits[:, P - 1:S - 1],
        clip_range, value_cost, entropy_cost, kl_cost, adv_norm,
    )
    metrics.update(
        mean_reward=batch_mean(reward),
        mean_generation=batch_mean(batch["generation"].float()),
        mean_response_len=batch_mean(torch.sum(mask, dim=1)),
    )
    return _finish_metrics(total, metrics)


def token_ppo_packed_loss(
    params: Params,
    ref_params: Params,
    model: TransformerPolicy,
    batch: Batch,
    clip_range: float,
    value_cost: float,
    entropy_cost: float,
    kl_cost: float,
    adv_norm: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO-clip over PACKED learner rows, the pad-free twin of
    :func:`token_ppo_loss`.

    ``batch`` carries ``genrl/rollout.py``'s packed-row fields, all
    ``[N, S]`` per token: ``tokens``, ``segment_ids`` (0 = pad),
    ``positions`` (reset per segment), ``behavior_logp`` / ``value`` /
    ``reward`` / ``generation`` at each response token's own offset, and
    ``mask`` (1 exactly on response tokens).  Token ``t`` is predicted by
    the output at ``t - 1``, always inside its segment because every
    segment starts with a prompt token, so every per-token term shifts by
    one.  An optional ``is_weight`` ``[N]`` (per ROW, the replay unit)
    scales the loss mask."""
    tokens = batch["tokens"]
    seg = batch["segment_ids"]
    positions = batch["positions"]
    seq_w = batch.get("is_weight")
    w_full = batch["mask"] if seq_w is None else batch["mask"] * seq_w[:, None]
    mask = batch["mask"][:, 1:]
    reward = batch["reward"][:, 1:]

    def forward(p: Params):
        return functional_call(model, p, (tokens,), dict(positions=positions, segment_ids=seg))

    out = forward(params)
    # the output at row offset t - 1 predicts the token at offset t
    total, metrics = _ppo_terms(
        out.policy_logits[:, :-1], out.baseline[:, :-1], tokens[:, 1:],
        batch["behavior_logp"][:, 1:], batch["value"][:, 1:], reward, mask, w_full[:, 1:],
        lambda: forward(ref_params).policy_logits[:, :-1],
        clip_range, value_cost, entropy_cost, kl_cost, adv_norm,
    )
    # rows hold several sequences: the sequence count is the sum of each
    # row's largest segment id, and the reward and generation means are
    # token-weighted (the padded ones are sequence-weighted)
    num_seqs = batch_sum(seg.amax(dim=1).float())
    metrics.update(
        mean_reward=masked_mean(reward, mask),
        mean_generation=masked_mean(batch["generation"][:, 1:].float(), mask),
        mean_response_len=batch_sum(batch["mask"]) / num_seqs.clamp(min=1.0),
        real_token_frac=batch_mean((seg > 0).float()),
    )
    return _finish_metrics(total, metrics)


def make_token_ppo_learn_fn(model: TransformerPolicy, optimizer: AdamOptimizer, args) -> Callable:
    """The ``(state, batch) -> (state, metrics)`` update behind the
    all-finite guard.  A batch that carries ``segment_ids`` takes the
    packed-row loss, any other the padded one, so one learn fn serves both
    layouts."""

    def learn(state: TokenPPOTrainState, batch: Batch):
        loss_fn = token_ppo_packed_loss if "segment_ids" in batch else token_ppo_loss
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics = loss_fn(
            params, state.ref_params, model, batch,
            clip_range=args.clip_range, value_cost=args.value_cost,
            entropy_cost=args.entropy_cost, kl_cost=args.kl_cost, adv_norm=args.adv_norm,
        )
        grads = reduce_gradients(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        new_state = TokenPPOTrainState(
            params={k: state.params[k] + updates[k] for k in state.params},
            ref_params=state.ref_params,
            opt_state=opt_state,
            step=state.step + 1,
            tokens_seen=state.tokens_seen + batch_sum(batch["mask"]).to(state.tokens_seen.dtype),
        )
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        return new_state, metrics

    return maybe_guard_nonfinite(learn, args)


class TokenPPOAgent(MeshedAgentState):
    """Host-facing token-PPO agent: the learn step and weight get/set.

    The acting path is the generation engine, not this agent.
    ``learn_device`` leaves the metrics on the device; ``learn`` reads them
    back with ONE batched copy.  The agent lives on ``model``'s device and
    starts from ``model``'s parameters (``trainer/sequence_rl.py::
    build_genrl_model`` seeds them from ``args.seed``).
    """

    # single-threaded callers only (the trainers' rounds): no gathered copy
    _acting_copy = False

    def __init__(self, args, model: TransformerPolicy) -> None:
        if model.vocab_size is None:
            raise ValueError("TokenPPOAgent needs a token-mode TransformerPolicy (vocab_size set)")
        self.args = args
        self.model = model
        self.device = model.pos_embed.device
        self.optimizer = self._make_optimizer(args)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        self.state = TokenPPOTrainState(
            params=params,
            # a real copy: the anchor must not follow the live parameters
            ref_params={k: v.clone() for k, v in params.items()},
            opt_state=self.optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            tokens_seen=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self._learn = self.make_learn_fn()
        self._shard_batch = None

    @staticmethod
    def _make_optimizer(args):
        """Global-norm clip + Adam; with ``bf16_params`` wrapped in
        ``fp32_optimizer_state``: float32 moments and clipping, each update
        cast back to its param's dtype."""
        tx = AdamOptimizer(args.learning_rate, max_norm=args.max_grad_norm)
        return fp32_optimizer_state(tx) if getattr(args, "bf16_params", False) else tx

    def make_learn_fn(self) -> Callable:
        return make_token_ppo_learn_fn(self.model, self.optimizer, self.args)

    def enable_mesh(self, mesh_or_spec, batch_example=None) -> None:
        """Shard the learn step over a mesh: rows over ``dp`` x ``fsdp``;
        with ``mp > 1`` the state laid out by the logical rule table and
        the model's ``constrain`` seam set to ``activation_constraint``."""
        from scalerl_torch.parallel.logical import (
            activation_constraint,
            has_mp_params,
            mp_param_spec,
        )
        from scalerl_torch.parallel.mesh import resolve_mesh
        from scalerl_torch.parallel.train_step import make_parallel_learn_fn

        mesh = resolve_mesh(mesh_or_spec)
        spec_fn = None
        if mesh.shape["mp"] > 1:
            if not has_mp_params(self.state.params):
                raise ValueError(
                    "mesh has mp > 1 but the model carries no model-parallel shardable params")
            if self.model.constrain is None:
                self.model.constrain = activation_constraint(mesh)
            spec_fn = lambda path, x: mp_param_spec(path, x, mesh)  # noqa: E731
        plearn = make_parallel_learn_fn(self.make_learn_fn(), mesh, self.state,
                                        batch_example=batch_example, batch_time_major=False,
                                        param_specs=spec_fn, modules=(self.model,))
        self.mesh = mesh
        self.state = plearn.shard_state(self.state)
        self._learn = plearn
        self._shard_batch = plearn.shard_batch

    def learn_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step (on this rank's rows under a mesh), metrics left
        as device tensors."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self._shard_batch is not None:
            batch = self._shard_batch(batch)
        self.state, metrics = self._learn(self.state, batch)
        return metrics

    def learn(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        return get_metrics(self.learn_device(batch))  # one batched device->host copy

    def get_weights(self) -> Params:
        """The whole params: the state's own, or under a mesh gathered to
        full tensors, a collective that every rank calls in the same
        order."""
        return gather_tree(self.state.params)

    def engine_weights(self) -> Params:
        """What a generation engine runs: the params, under a mesh each
        leaf's local shard on this rank (nothing is gathered)."""
        return tree_map(to_local, self.state.params)

    @property
    def shard_ctx(self) -> Optional[ShardContext]:
        """The meshed learn step's computation on shards, which an engine
        on :meth:`engine_weights` runs in (None without a process group)."""
        return getattr(self._learn, "shard_ctx", None)

    def set_weights(self, weights: Params) -> None:
        """Whole params, :meth:`get_weights`' inverse: under a mesh each rank
        keeps its slice of its own copy (the same on every rank)."""
        weights = dict(weights)
        if self.mesh is not None:
            from scalerl_torch.parallel.logical import apply_fns, make_shard_and_gather_fns

            shard_fns, _ = make_shard_and_gather_fns(self._learn.state_sharding, self.mesh)
            weights = apply_fns(shard_fns.params, weights)
        self.state = dataclasses.replace(self.state, params=weights)

    def save_checkpoint(self, path: str) -> str:
        if self.mesh is not None:
            from scalerl_torch.parallel.train_step import save_sharded

            return save_sharded(self, path)
        return save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        if self.mesh is not None:
            from scalerl_torch.parallel.train_step import load_sharded

            self.state = load_sharded(self, path)
            return
        self.state = load_checkpoint(path, self.state)
