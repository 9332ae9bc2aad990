"""MLP Q-network.

Port of ``QNet`` of ``scalerl_tpu/models/mlp.py``: dense layers with ReLU
and a plain or dueling head.  The layers sit in ``self.dense`` in the
order Flax names them (``Dense_0``, ``Dense_1``, ...; the dueling head's
advantage layer before its value layer), so ``convert.py`` maps
``Dense_i`` to ``dense.i``.  NoisyNet layers (``noisy=True``) are not
ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from scalerl_torch.models.atari import lecun_normal_
from scalerl_torch.utils.platform import DeviceLike, resolve_device


def parse_hidden(hidden_sizes: Union[str, Sequence[int]]) -> Tuple[int, ...]:
    if isinstance(hidden_sizes, str):
        return tuple(int(h) for h in hidden_sizes.split(",") if h)
    return tuple(hidden_sizes)


class QNet(nn.Module):
    """``obs [B, ...] -> Q [B, action_dim]``; observations are flattened
    past the batch axis and cast to float32."""

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        action_dim: int,
        hidden_sizes: Union[str, Sequence[int]] = (128, 128),
        dueling: bool = False,
        noisy: bool = False,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's ``Dense`` defaults: truncated LeCun-normal kernels, zero
        biases)."""
        super().__init__()
        if noisy:
            raise NotImplementedError("NoisyDense is not ported yet; use noisy=False")
        device = resolve_device(device)
        self.action_dim = action_dim
        self.dueling = dueling
        widths = [math.prod(obs_shape), *parse_hidden(hidden_sizes)]
        layers = [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
        self.num_hidden = len(layers)
        layers.append(nn.Linear(widths[-1], action_dim))
        if dueling:
            layers.append(nn.Linear(widths[-1], 1))
        self.dense = nn.ModuleList(layers)
        self.reset_parameters(generator)  # on the host: one seed, same weights
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.dense:
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(torch.float32)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        for layer in self.dense[: self.num_hidden]:
            x = F.relu(layer(x))
        if self.dueling:
            adv = self.dense[self.num_hidden](x)
            val = self.dense[self.num_hidden + 1](x)
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return self.dense[self.num_hidden](x)


def normalized_columns_init_(
    weight: torch.Tensor, std: float, generator: torch.Generator | None = None
) -> None:
    """The A3C head init (``scalerl_tpu/models/mlp.py::normalized_columns_init``):
    normal noise rescaled so each output unit's weights have L2 norm
    ``std``.  Flax kernels are ``[in, out]``; here a unit is a row of the
    ``[out, in]`` weight."""
    with torch.no_grad():
        weight.normal_(generator=generator)
        weight.mul_(std / (weight.norm(dim=1, keepdim=True) + 1e-12))
