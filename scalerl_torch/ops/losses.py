"""Loss terms (port of ``scalerl_tpu/ops/losses.py``).

The IMPALA terms (``losses.py:21-41``) SUM over ``[T, B]``, the reference's
convention; the DQN TD loss (``losses.py:76-93,167-188``) averages over the
batch, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def baseline_loss(advantages: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(advantages^2)."""
    return 0.5 * torch.sum(torch.square(advantages))


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """sum(p * log p): the negative entropy (minimising adds entropy bonus)."""
    log_policy = F.log_softmax(logits, dim=-1)
    policy = torch.exp(log_policy)
    return torch.sum(policy * log_policy)


def policy_gradient_loss(
    logits: torch.Tensor,
    actions: torch.Tensor,
    advantages: torch.Tensor,
) -> torch.Tensor:
    """sum over [T, B] of -log pi(a_t|x_t) * advantage (advantage detached)."""
    log_policy = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_policy, -1, actions.long().unsqueeze(-1)).squeeze(-1)
    return torch.sum(nll * advantages.detach())


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
    return torch.mean(per_elem), torch.abs(td_error.detach())
