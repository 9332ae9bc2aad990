"""Switch-routed mixture of experts: port of ``scalerl_tpu/models/moe.py``.

Top-1 routing with capacity dropping: token ``n`` goes to the expert its
router gate ranks first (the first one on a tie, as ``argmax`` takes it),
into that expert's next free slot of ``C = max(int(capacity_factor * N /
E), 1)``; a token past its expert's capacity passes through the residual
only.  The Switch load-balancing loss ``E * sum_e mean(gate_e) *
frac_tokens_e`` comes back beside the output.

The JAX layer builds dense one-hot ``[N, E, C]`` dispatch and combine
tensors and contracts them with einsums.  Every token has at most one
nonzero there, so :class:`MoEMLP` computes the same function in index form:
it gathers the kept tokens into ``[E, C, M]`` by (expert, slot), runs the
two expert products as batched matmuls, and gathers each token's result
back times its gate.  Products with a one-hot entry are exact, so the two
forms agree to the rounding of the expert matmuls.  The index form moves
``O(N * M)`` bytes where the dense one walks ``N * E * C`` entries (925 MB
in float32 at the IMPALA learner's 10,752 tokens), and it is free of host
syncs.  :func:`top1_dispatch` and ``MoEMLP(dense_dispatch=True)`` keep the
dense form as the plain twin the tests hold the index form to.

Expert banks keep the JAX layout: ``w_in`` ``[E, M, H]`` and ``w_out``
``[E, H, M]`` (``parallel/logical.py`` shards their leading dim over
``mp``, ``parallel/expert.py`` over ``ep``).  The dense layers are
``torch.nn.Linear`` (``[out, in]``); ``convert.py::moe_policy_net_to_torch``
loads a Flax tree.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.models.atari import AtariNetOutput, lecun_normal_
from scalerl_torch.utils.platform import DeviceLike, resolve_device


class MoEOutput(NamedTuple):
    out: torch.Tensor  # [N, d_model] combined expert outputs
    aux_loss: torch.Tensor  # scalar load-balancing loss
    dispatch_frac: torch.Tensor  # scalar: fraction of tokens not dropped


def capacity(num_tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots an expert holds: the JAX layer's expression in Python floats."""
    return max(int(capacity_factor * num_tokens / num_experts), 1)


def _onehot(expert: torch.Tensor, num_experts: int, dtype: torch.dtype) -> torch.Tensor:
    # a comparison, not F.one_hot, which checks its input's range on the host
    return (expert[:, None] == torch.arange(num_experts, device=expert.device)).to(dtype)


def top1_dispatch(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense dispatch and combine tensors for top-1 routing (the plain twin
    of the JAX function).  ``gates`` ``[N, E]`` softmax router outputs ->
    ``(dispatch [N, E, C], combine [N, E, C], aux)``; slots come from an
    integer cumsum, exact where JAX's float cumsum is."""
    N, E = gates.shape
    expert = gates.argmax(dim=-1)
    hot = _onehot(expert, E, torch.int64)
    pos = torch.cumsum(hot, dim=0) * hot - hot  # [N, E], 0-based
    onehot = hot.to(gates.dtype)
    keep = (pos < capacity).to(gates.dtype) * onehot
    pos_cap = _onehot(pos.clamp(0, capacity - 1).reshape(-1), capacity, gates.dtype)
    dispatch = keep[..., None] * pos_cap.reshape(N, E, capacity)
    gate_val = (gates * onehot).sum(dim=-1, keepdim=True)  # [N, 1]
    combine = dispatch * gate_val[..., None]
    aux = E * (onehot.mean(dim=0) * gates.mean(dim=0)).sum()
    return dispatch, combine, aux


class Routing(NamedTuple):
    """Top-1 routing in index form over ``N`` tokens and ``E`` experts."""

    expert: torch.Tensor  # [N] int64, the expert each token goes to
    slot: torch.Tensor  # [N] int64, its 0-based place in that expert's queue
    keep: torch.Tensor  # [N] bool, slot < capacity
    gate: torch.Tensor  # [N] the chosen expert's router probability (has grad)
    aux: torch.Tensor  # scalar Switch loss
    dispatch_frac: torch.Tensor  # scalar, kept / N


def route_top1(gates: torch.Tensor, capacity: int) -> Routing:
    """:func:`top1_dispatch`'s routing without the dense tensors."""
    N, E = gates.shape
    expert = gates.argmax(dim=-1)
    hot = _onehot(expert, E, torch.int64)
    slot = (torch.cumsum(hot, dim=0) * hot).sum(dim=-1) - 1
    keep = slot < capacity
    gate = gates.gather(1, expert[:, None]).squeeze(1)
    aux = E * (hot.to(gates.dtype).mean(dim=0) * gates.mean(dim=0)).sum()
    return Routing(expert, slot, keep, gate, aux, keep.sum().to(gates.dtype) / N)


def expert_outputs(x: torch.Tensor, routing: Routing, w_in: torch.Tensor, w_out: torch.Tensor,
                   capacity: int, first_expert: int = 0) -> torch.Tensor:
    """Each token's raw expert output ``[N, M]`` (before its gate) from the
    experts ``[first_expert, first_expert + w_in.shape[0])`` whose banks are
    given; zero for tokens dropped or routed elsewhere.

    Kept tokens are gathered into ``[E_local, C, M]`` through a slot table
    (an empty slot reads a zero row, so its expert output is zero: the
    experts have no bias), the two products run as batched matmuls, and
    each token reads its slot back.  Every index of the two gathers names
    one token or one slot, so the backward's sums have one term each and
    come out the same in any order."""
    N, M = x.shape
    E_local = w_in.shape[0]
    local = routing.keep & (routing.expert >= first_expert) & (
        routing.expert < first_expert + E_local)
    n_slots = E_local * capacity
    dest = torch.where(local, (routing.expert - first_expert) * capacity + routing.slot,
                       n_slots)  # n_slots: the bin past the table for every other token
    table = torch.full((n_slots + 1,), N, dtype=torch.int64, device=x.device)
    table.scatter_(0, dest, torch.arange(N, device=x.device))
    x_pad = torch.cat([x, x.new_zeros(1, M)])  # row N: the empty slot's input
    expert_in = x_pad.index_select(0, table[:n_slots]).reshape(E_local, capacity, M)
    h = F.relu(torch.bmm(expert_in, w_in))
    y = torch.bmm(h, w_out).reshape(n_slots, M)
    return torch.cat([y, y.new_zeros(1, M)]).index_select(0, dest)


def moe_dense(x: torch.Tensor, gates: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
              capacity: int) -> MoEOutput:
    """The JAX layer's dense form over ``top1_dispatch`` (the plain twin)."""
    dispatch, combine, aux = top1_dispatch(gates, capacity)
    expert_in = torch.einsum("nec,nm->ecm", dispatch, x)
    h = F.relu(torch.einsum("ecm,emh->ech", expert_in, w_in))
    expert_out = torch.einsum("ech,ehm->ecm", h, w_out)
    out = torch.einsum("nec,ecm->nm", combine, expert_out)
    return MoEOutput(out, aux, dispatch.sum() / x.shape[0])


class MoEMLP(nn.Module):
    """Switch-routed expert FFN over flattened tokens ``[N, d_model]``
    (Flax ``MoEMLP``: ``router`` without bias, ``w_in``, ``w_out``).
    ``dense_dispatch=True`` runs the dense one-hot form instead of the index
    form (the plain twin; same function).  ``generator``: a host generator
    for Flax's LeCun-normal initial weights."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 capacity_factor: float = 1.25, dense_dispatch: bool = False,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_experts = num_experts
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.capacity_factor = capacity_factor
        self.dense_dispatch = dense_dispatch
        self.router = nn.Linear(d_model, num_experts, bias=False)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, d_hidden))
        self.w_out = nn.Parameter(torch.empty(num_experts, d_hidden, d_model))
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # Flax's lecun_normal on a [E, in, out] bank counts E into the fan-in
        lecun_normal_(self.router.weight, self.d_model, generator)
        lecun_normal_(self.w_in, self.num_experts * self.d_model, generator)
        lecun_normal_(self.w_out, self.num_experts * self.d_hidden, generator)

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.router(x), dim=-1)

    def forward(self, x: torch.Tensor) -> MoEOutput:
        C = capacity(x.shape[0], self.num_experts, self.capacity_factor)
        gates = self.gates(x)
        if self.dense_dispatch:
            return moe_dense(x, gates, self.w_in, self.w_out, C)
        routing = route_top1(gates, C)
        y = expert_outputs(x, routing, self.w_in, self.w_out, C)
        return MoEOutput(y * routing.gate[:, None], routing.aux, routing.dispatch_frac)


class MoEPolicy(nn.Module):
    """Small actor-critic whose trunk is dense -> MoE -> LayerNorm over
    per-step features ``[N, obs...]`` (flattened, cast to float32 with no
    scaling, as in Flax).  Returns ``(policy_logits, baseline, aux_loss)``.

    ``constrain`` is the activation-layout seam (``parallel/logical.py::
    activation_constraint``), applied after the embedding and after the
    norm; the meshed learn step computes on gathered plain tensors, which
    pass through it unchanged."""

    constrain: Optional[Callable] = None

    def __init__(self, num_actions: int, obs_dim: int, d_model: int = 128,
                 num_experts: int = 8, d_hidden: int = 256, capacity_factor: float = 2.0,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None) -> None:
        """``generator``: a host generator for Flax's default initial weights
        (LeCun-normal kernels, zero biases, unit norm scale)."""
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.embed = nn.Linear(obs_dim, d_model)
        self.moe = MoEMLP(num_experts, d_model, d_hidden, capacity_factor, device="cpu",
                          generator=generator)
        self.norm = nn.LayerNorm(d_model, eps=1e-6)
        self.policy_head = nn.Linear(d_model, num_actions)
        self.value_head = nn.Linear(d_model, 1)
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.embed, self.policy_head, self.value_head):
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()

    def forward(self, obs: torch.Tensor):
        c = self.constrain if self.constrain is not None else (lambda t: t)
        x = c(F.relu(self.embed(obs.reshape(obs.shape[0], -1).float())))
        moe = self.moe(x)
        x = c(self.norm(x + moe.out))
        return self.policy_head(x), self.value_head(x).squeeze(-1), moe.aux_loss


class MoEPolicyNet(nn.Module):
    """Switch-routed MoE actor-critic on the recurrent signature
    (``models/transformer_policy.py``): ``[T, B, ...]`` obs flatten to
    ``T * B`` tokens, so expert capacity is sized off the whole chunk; the
    aux loss is not surfaced, as in JAX; ``core_state`` is empty.  Params
    live under ``moe_policy.*``, the Flax tree's ``moe_policy/``."""

    def __init__(self, num_actions: int, obs_shape: Tuple[int, ...], d_model: int = 128,
                 num_experts: int = 8, d_hidden: int = 256, capacity_factor: float = 2.0,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_actions = num_actions
        self.moe_policy = MoEPolicy(num_actions, math.prod(obs_shape), d_model, num_experts,
                                    d_hidden, capacity_factor, device=device,
                                    generator=generator)

    def initial_state(self, batch_size: int):
        return ()

    def forward(self, obs, last_action, reward, done, core_state=()):
        del last_action, reward, done
        T, B = obs.shape[0], obs.shape[1]
        logits, baseline, _aux = self.moe_policy(obs.reshape(T * B, -1))
        return AtariNetOutput(policy_logits=logits.reshape(T, B, self.num_actions),
                              baseline=baseline.reshape(T, B)), core_state


def expert_sharding_rule(path: Tuple[str, ...]) -> Optional[Tuple]:
    """Spec rule for expert-leading tensors: ``w_in``/``w_out`` over
    ``ep``; None for everything else."""
    name = path[-1] if path else ""
    if name in ("w_in", "w_out"):
        return ("ep", None, None)
    return None
