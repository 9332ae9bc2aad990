"""Returns and advantages over the time axis (port of ``scalerl_tpu/ops/returns.py``).

- ``discounted_returns``: ``R_t = r_t + discount_t * R_{t+1}`` from a
  bootstrap value;
- ``n_step_returns``: truncated n-step returns with episode-boundary
  masking over a whole ``[T, B]`` trajectory;
- ``gae_advantages``: generalized advantage estimation and its value
  targets.

The JAX versions are reverse ``lax.scan``s; here each is a reverse Python
loop over T on the inputs' device, with no host read, so it runs inside a
learn step without a synchronisation.  All inputs are time-major ``[T, B]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def discounted_returns(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
) -> torch.Tensor:
    """``R_t = r_t + discount_t * R_{t+1}``, seeded with the bootstrap value.

    Args:
      rewards: [T, B].
      discounts: [T, B] (gamma * (1 - done)).
      bootstrap_value: [B].
    """
    acc = bootstrap_value
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = rewards[t] + discounts[t] * acc
        out.append(acc)
    return torch.stack(out[::-1])


def n_step_returns(
    rewards: torch.Tensor,
    dones: torch.Tensor,
    values_tpn: torch.Tensor,
    gamma: float,
    n: int,
) -> torch.Tensor:
    """Truncated n-step returns with episode-boundary masking.

    With ``k_eff(t) = min(n, T - t)`` (the window truncates at the rollout
    end)::

        G_t = sum_{k<k_eff} gamma^k r_{t+k} prod_{j<k}(1 - d_{t+j})
              + gamma^k_eff prod_{j<k_eff}(1 - d_{t+j}) values_tpn[t]

    ``values_tpn[t] = V(x_{min(t+n, T)})`` is the bootstrap value, read only
    where no done fell inside the window."""
    T = rewards.shape[0]
    cont = 1.0 - dones.to(rewards.dtype)
    acc_r = torch.zeros_like(rewards)
    alive = torch.ones_like(rewards)
    for k in range(n):
        # reward at t+k (zero past the rollout end) masked by survival
        # through t..t+k-1; cont is padded with ones, so only real dones
        # cut the bootstrap of the truncated tail
        r_k = torch.cat([rewards[k:], torch.zeros_like(rewards[:k])])[:T]
        acc_r = acc_r + (gamma**k) * alive * r_k
        c_k = torch.cat([cont[k:], torch.ones_like(cont[:k])])[:T]
        alive = alive * c_k
    k_eff = torch.clamp(T - torch.arange(T, device=rewards.device), max=n).to(rewards.dtype)
    gamma_eff = torch.pow(torch.full_like(k_eff, gamma), k_eff)
    gamma_eff = gamma_eff.reshape((T,) + (1,) * (rewards.dim() - 1))
    return acc_r + gamma_eff * alive * values_tpn


def gae_advantages(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    lambda_: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation::

        A_t = delta_t + discount_t * lambda * A_{t+1}
        delta_t = r_t + discount_t * V_{t+1} - V_t

    Returns ``(advantages [T, B], value targets A + V)``."""
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]])
    deltas = rewards + discounts * values_t_plus_1 - values
    acc = torch.zeros_like(bootstrap_value)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * lambda_ * acc
        out.append(acc)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values
