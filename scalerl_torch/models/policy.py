"""Feed-forward actor-critic on flat observations, with the recurrent signature.

Port of ``scalerl_tpu/models/policy.py::MLPPolicyNet``: ``hidden_sizes``
ReLU dense layers, then the ``policy`` and ``baseline`` heads, called as
every IMPALA model is::

    (obs [T, B, D], last_action, reward, done, core_state)
        -> (AtariNetOutput(policy_logits [T, B, A], baseline [T, B]), core_state)

``last_action``, ``reward`` and ``done`` are ignored and the core state is
empty.  The hidden layers sit in ``self.dense`` in the order Flax names them
(``Dense_0``, ``Dense_1``, ...), so ``convert.mlp_policy_to_torch`` maps
``Dense_i`` to ``dense.i``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.models.atari import AtariNetOutput, lecun_normal_
from scalerl_torch.models.mlp import normalized_columns_init_
from scalerl_torch.utils.platform import DeviceLike, resolve_device


class MLPPolicyNet(nn.Module):
    def __init__(
        self,
        num_actions: int,
        obs_dim: int,
        hidden_sizes: Sequence[int] = (256, 256),
        normalized_init: bool = False,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's ``Dense`` defaults: truncated LeCun-normal kernels, zero
        biases; with ``normalized_init`` the A3C heads, norm 0.01 for the
        policy and 1.0 for the baseline)."""
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.normalized_init = normalized_init
        widths = [obs_dim, *hidden_sizes]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.policy = nn.Linear(widths[-1], num_actions)
        self.baseline = nn.Linear(widths[-1], 1)
        self.reset_parameters(generator)  # on the host: one seed, same weights
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in [*self.dense, self.policy, self.baseline]:
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()
        if self.normalized_init:
            normalized_columns_init_(self.policy.weight, 0.01, generator)
            normalized_columns_init_(self.baseline.weight, 1.0, generator)

    def initial_state(self, batch_size: int) -> tuple:
        return ()

    def forward(
        self,
        obs: torch.Tensor,  # [T, B, D]
        last_action: torch.Tensor,  # ignored: no action feedback
        reward: torch.Tensor,  # ignored
        done: torch.Tensor,  # ignored: feed-forward
        core_state: tuple = (),
    ) -> Tuple[AtariNetOutput, tuple]:
        x = obs.to(torch.float32)
        for layer in self.dense:
            x = F.relu(layer(x))
        return (
            AtariNetOutput(policy_logits=self.policy(x), baseline=self.baseline(x).squeeze(-1)),
            core_state,
        )
