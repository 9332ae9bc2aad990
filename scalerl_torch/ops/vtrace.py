"""V-trace off-policy actor-critic targets (IMPALA).

Port of ``scalerl_tpu/ops/vtrace.py``.  All inputs are time-major
``[T, B, ...]``.  V-trace is grad-free: both public functions run under
``torch.no_grad`` and return constants, as the reference ``stop_gradient``s
its outputs.

``impl="scan"`` is the plain PyTorch version, a Python loop over T in the
reference's order of operations; ``impl="kernel"`` goes through the CUDA
kernel wrapper (``ops/cuda_vtrace.py``), which runs this plain version for
host tensors.  ``RLArguments.use_pallas`` selects the kernel on the learn
path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class VTraceOutput(NamedTuple):
    vs: torch.Tensor  # [T, B] V-trace value targets
    pg_advantages: torch.Tensor  # [T, B] clipped policy-gradient advantages


def action_log_probs(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|s) from unnormalised logits, any leading batch dims."""
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long().unsqueeze(-1)).squeeze(-1)


def _clip_max(x: torch.Tensor, threshold: Optional[float]) -> torch.Tensor:
    return x if threshold is None else torch.clamp(x, max=threshold)


@torch.no_grad()
def vtrace_scan(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: float = 1.0,
) -> VTraceOutput:
    """The plain version: the reference's reverse ``lax.scan`` as a loop."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = _clip_max(rhos, clip_rho_threshold)
    cs = _clip_max(rhos, clip_c_threshold)

    # V(x_{t+1}) with the bootstrap at the end.
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values

    # Advantage for the policy gradient: r + gamma * vs_{t+1} - V(x_t).
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = _clip_max(rhos, clip_pg_rho_threshold)
    pg_advantages = clipped_pg_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return VTraceOutput(vs=vs, pg_advantages=pg_advantages)


@torch.no_grad()
def vtrace_from_importance_weights(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: float = 1.0,
    impl: str = "scan",
) -> VTraceOutput:
    """V-trace targets from log importance weights.

    Args:
      log_rhos: [T, B] log(pi_target(a)/pi_behavior(a)).
      discounts: [T, B] per-step discount (gamma * (1 - done)).
      rewards: [T, B].
      values: [T, B] value estimates V(x_t) under the target policy.
      bootstrap_value: [B] V(x_T).
      clip_rho_threshold: rho-hat clip (None = no clipping).
      clip_pg_rho_threshold: clip for the pg-advantage rhos (None = none).
      clip_c_threshold: c-hat clip.
      impl: ``"scan"`` (plain PyTorch) or ``"kernel"`` (the CUDA kernel).
    """
    kwargs = dict(
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        clip_c_threshold=clip_c_threshold,
    )
    if impl == "kernel":
        from scalerl_torch.ops.cuda_vtrace import (
            vtrace_from_importance_weights_kernel,
        )

        return vtrace_from_importance_weights_kernel(
            log_rhos.contiguous(), discounts.contiguous(), rewards.contiguous(),
            values.contiguous(), bootstrap_value.contiguous(), **kwargs,
        )
    if impl != "scan":
        raise ValueError(f"impl must be 'scan' or 'kernel', got {impl!r}")
    return vtrace_scan(
        log_rhos, discounts, rewards, values, bootstrap_value, **kwargs
    )


@torch.no_grad()
def vtrace_from_logits(
    behavior_logits: torch.Tensor,
    target_logits: torch.Tensor,
    actions: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: float = 1.0,
    impl: str = "scan",
) -> VTraceOutput:
    """V-trace from behavior/target policy logits ([T, B, A]) and actions ([T, B])."""
    log_rhos = action_log_probs(target_logits, actions) - action_log_probs(
        behavior_logits, actions
    )
    return vtrace_from_importance_weights(
        log_rhos=log_rhos,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        clip_c_threshold=clip_c_threshold,
        impl=impl,
    )
