"""IMPALA loss terms (port of ``scalerl_tpu/ops/losses.py:21-41``).

Each one SUMS over ``[T, B]``, the reference's convention; none averages.
"""

from __future__ import annotations

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
