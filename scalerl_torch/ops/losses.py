"""Loss terms (port of ``scalerl_tpu/ops/losses.py``).

The IMPALA terms (``losses.py:21-41``) and the PPO clipped surrogate
(``losses.py:44-73``) SUM over ``[T, B]``, the reference's convention; the DQN TD loss (``losses.py:76-93,167-188``) and the C51 terms
(``losses.py:96-164``) average over the batch, as the JAX package's do.
The batch reductions go through ``parallel/sharding.py``'s ``batch_sum`` /
``batch_mean``, which are ``torch.sum`` / ``torch.mean`` outside a sharded
learn step and span every batch shard inside one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from scalerl_torch.parallel.sharding import batch_mean, batch_sum


def baseline_loss(advantages: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(advantages^2)."""
    return 0.5 * batch_sum(torch.square(advantages))


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """sum(p * log p): the negative entropy (minimising adds entropy bonus)."""
    log_policy = F.log_softmax(logits, dim=-1)
    policy = torch.exp(log_policy)
    return batch_sum(policy * log_policy)


def policy_gradient_loss(
    logits: torch.Tensor,
    actions: torch.Tensor,
    advantages: torch.Tensor,
) -> torch.Tensor:
    """sum over [T, B] of -log pi(a_t|x_t) * advantage (advantage detached)."""
    log_policy = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_policy, -1, actions.long().unsqueeze(-1)).squeeze(-1)
    return batch_sum(nll * advantages.detach())


def clipped_surrogate_loss(
    new_logp: torch.Tensor,
    behavior_logp: torch.Tensor,
    advantages: torch.Tensor,
    clip_range: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO's clipped surrogate objective (Schulman et al. 2017, eq. 7),
    summed over ``[T, B]``; the behaviour log-probabilities and the
    advantages are detached.  Returns ``(loss, aux)`` with the detached
    diagnostics ``mean_ratio``, ``mean_approx_kl`` (the k3 estimator
    ``E[(r - 1) - log r]``) and ``mean_clip_frac``."""
    log_ratio = new_logp - behavior_logp.detach()
    ratio = torch.exp(log_ratio)
    adv = advantages.detach()
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range) * adv
    loss = -batch_sum(torch.minimum(unclipped, clipped))
    aux = {
        "mean_ratio": batch_mean(ratio),
        "mean_approx_kl": batch_mean((ratio - 1.0) - log_ratio),
        "mean_clip_frac": batch_mean((torch.abs(ratio - 1.0) > clip_range).to(torch.float32)),
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def double_dqn_targets(
    q_next_online: torch.Tensor,
    q_next_target: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    double_dqn: bool = True,
) -> torch.Tensor:
    """TD targets ``r + discount * Q_target(s', argmax_a Q_online(s', a))``,
    detached.  ``double_dqn=False`` selects the action with the target net
    (vanilla DQN).  Shapes: q_* [B, A]; rewards/discounts [B]."""
    chooser = q_next_online if double_dqn else q_next_target
    next_actions = torch.argmax(chooser, dim=-1)
    q_next = torch.gather(q_next_target, -1, next_actions[:, None]).squeeze(-1)
    return (rewards + discounts * q_next).detach()


def dqn_loss(
    q_values: torch.Tensor,
    actions: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared TD loss of the chosen actions (the JAX version's Huber
    option has no caller here); returns (loss, detached |td error|, the PER
    priority signal).  Shapes: q_values [B, A], actions [B], targets [B],
    weights [B] or None."""
    q_sa = torch.gather(q_values, -1, actions.long()[:, None]).squeeze(-1)
    td_error = q_sa - targets
    per_elem = 0.5 * torch.square(td_error)
    if weights is not None:
        per_elem = per_elem * weights
    return batch_mean(per_elem), torch.abs(td_error.detach())


def make_support(v_min: float, v_max: float, num_atoms: int, device=None) -> torch.Tensor:
    """The fixed C51 atom grid ``z_i = v_min + i * dz``, float32."""
    return torch.linspace(v_min, v_max, num_atoms, dtype=torch.float32, device=device)


def categorical_q_values(logits: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Expected Q per action from atom logits: ``[B, A, N] -> [B, A]``."""
    return torch.sum(torch.softmax(logits, dim=-1) * support, dim=-1)


def categorical_projection(
    next_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    support: torch.Tensor,
) -> torch.Tensor:
    """C51 projected Bellman target (Bellemare et al. 2017, Alg. 1), detached.

    Shifts the next-state atom distribution by ``r + discount * z``, clips it
    to the support, and splits each shifted atom's mass linearly between its
    two neighbouring grid points; where a shifted atom lands exactly on a
    grid point (``low == up``) all its mass goes there.  As in the JAX
    package, the split is a dense ``[B, N, N]`` interpolation tensor
    contracted with the probabilities.

    Shapes: next_probs ``[B, N]``, rewards/discounts ``[B]``, support ``[N]``;
    returns ``[B, N]``."""
    num_atoms = support.shape[0]
    v_min, v_max = support[0], support[-1]
    dz = (v_max - v_min) / (num_atoms - 1)
    tz = torch.clamp(rewards[:, None] + discounts[:, None] * support[None, :], v_min, v_max)
    b = (tz - v_min) / dz  # fractional grid coordinates
    low, up = torch.floor(b), torch.ceil(b)
    w_low = torch.where(low == up, 1.0, up - b)
    w_up = b - low
    grid = torch.arange(num_atoms, dtype=b.dtype, device=b.device)
    w = w_low[..., None] * (low[..., None] == grid) + w_up[..., None] * (up[..., None] == grid)
    return torch.einsum("bs,bsd->bd", next_probs, w).detach()


def c51_loss(
    logits: torch.Tensor,
    actions: torch.Tensor,
    target_probs: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy between the projected target and the predicted
    distribution of the chosen actions; returns (the batch-mean loss, the
    detached per-sample cross-entropy, the PER priority signal).

    Shapes: logits ``[B, A, N]``, actions ``[B]``, target_probs ``[B, N]``."""
    log_p = F.log_softmax(logits, dim=-1)
    index = actions.long()[:, None, None].expand(-1, 1, logits.shape[-1])
    log_p_a = torch.gather(log_p, 1, index)[:, 0]  # [B, N]
    ce = -torch.sum(target_probs * log_p_a, dim=-1)
    per_elem = ce if weights is None else ce * weights
    return batch_mean(per_elem), ce.detach()
