"""The transformer actor-critic on the recurrent-policy signature.

Port of ``scalerl_tpu/models/transformer_policy.py`` for
``TransformerPolicyNet`` and ``build_mp_policy``.  The actor-learner agents
drive every model through the time-major signature::

    (obs[T, B, ...], last_action[T, B], reward[T, B], done[T, B], core_state)
        -> (AtariNetOutput(policy_logits[T, B, A], baseline[T, B]), core_state)

and ``TransformerPolicy`` speaks batch-major ``[B, T, ...]``; the adapter
moves the axes both ways.  The transformer attends causally within the
chunk it is given, so ``core_state`` is empty.  ``MoEPolicyNet`` (the
Switch-MoE actor-critic) lives in ``models/moe.py``; this module's
:func:`build_mp_policy` dispatches to it.  The activation-layout seam
``constrain`` lives on the inner ``TransformerPolicy`` (or ``MoEPolicy``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from scalerl_torch.models.atari import AtariNetOutput
from scalerl_torch.models.moe import MoEPolicyNet
from scalerl_torch.models.transformer import TransformerPolicy
from scalerl_torch.utils.platform import DeviceLike


class TransformerPolicyNet(nn.Module):
    """Causal transformer actor-critic over flat ``[T, B, obs...]``
    observations (Flax infers the embedding's input width; here it is
    ``prod(obs_shape)``).  ``dtype``/``param_dtype`` bfloat16 gives the
    sharded learner's mixed precision with float32 heads; ``use_flash``
    routes attention through the flash kernels.  Params live under
    ``transformer.*``, the Flax tree's ``transformer/``."""

    def __init__(
        self,
        num_actions: int,
        obs_shape: Tuple[int, ...],
        d_model: int = 128,
        num_heads: int = 4,
        num_layers: int = 2,
        mlp_ratio: int = 4,
        max_len: int = 1024,
        use_flash: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_actions = num_actions
        self.transformer = TransformerPolicy(
            num_actions=num_actions, d_model=d_model, num_heads=num_heads,
            num_layers=num_layers, mlp_ratio=mlp_ratio, max_len=max_len,
            use_flash=use_flash, obs_dim=math.prod(obs_shape), dtype=dtype,
            param_dtype=param_dtype, device=device, generator=generator,
        )

    def initial_state(self, batch_size: int):
        return ()

    def forward(self, obs, last_action, reward, done, core_state=()):
        del last_action, reward, done  # context = the obs sequence itself
        out = self.transformer(obs.transpose(0, 1))  # [T, B, ...] -> [B, T, ...]
        return AtariNetOutput(policy_logits=out.policy_logits.transpose(0, 1),
                              baseline=out.baseline.transpose(0, 1)), core_state


def build_mp_policy(args, obs_shape: Tuple[int, ...], num_actions: int,
                    device: DeviceLike = "cuda",
                    generator: Optional[torch.Generator] = None) -> Optional[nn.Module]:
    """The ``policy_arch`` dispatch of the agents' ``build_model``:
    ``"transformer"`` returns a :class:`TransformerPolicyNet` sized from
    ``RLArguments`` (``d_model``, ``n_layers``, ``n_heads``,
    ``bf16_params``; ``max_len = rollout_length + 1``, the learner's
    ``[T+1, B]`` chunk); ``"moe"`` a :class:`~scalerl_torch.models.moe.
    MoEPolicyNet` (``d_model``, ``moe_experts``, ``moe_hidden``; float32,
    as in JAX); ``"auto"`` returns None and the caller keeps its own model.
    ``args.use_pallas``, the port's one switch for its kernels (it routes
    V-trace and PER too), turns on ``use_flash``; the JAX function leaves
    ``use_flash`` off, and both compute the same attention."""
    arch = args.policy_arch
    if arch in ("auto", "", None):
        return None
    if arch == "moe":
        return MoEPolicyNet(num_actions=num_actions, obs_shape=tuple(obs_shape),
                            d_model=args.d_model, num_experts=args.moe_experts,
                            d_hidden=args.moe_hidden, device=device, generator=generator)
    if arch != "transformer":
        raise ValueError(f"unknown policy_arch {arch!r}; expected auto | transformer | moe")
    dtype = torch.bfloat16 if args.bf16_params else torch.float32
    return TransformerPolicyNet(
        num_actions=num_actions, obs_shape=tuple(obs_shape), d_model=args.d_model,
        num_heads=args.n_heads, num_layers=args.n_layers,
        max_len=int(args.rollout_length) + 1, use_flash=bool(args.use_pallas), dtype=dtype,
        param_dtype=dtype, device=device, generator=generator,
    )
