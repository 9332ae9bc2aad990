"""MLP networks: the Q-networks ``QNet`` and ``C51QNet``, the NoisyNet layer,
and the actor-critic heads of A3C, SAC and TD3.

Port of ``QNet``, ``C51QNet`` and ``NoisyDense`` of
``scalerl_tpu/models/mlp.py``: dense layers with ReLU and a plain or
dueling head, of ``nn.Linear`` or, with ``noisy=True``, of
:class:`NoisyDense`.  The layers sit in ``self.dense`` in the order Flax
names them (``Dense_0``, ``Dense_1``, ... or ``NoisyDense_0``, ...; the
dueling head's advantage layer before its value layer), so ``convert.py``
maps layer ``i`` to ``dense.i``.

Noise is an argument, not module state: ``forward(obs, noise)`` takes one
``(eps_in, eps_out)`` pair per noisy layer (:meth:`QNet.sample_noise` draws
them from a ``torch.Generator``), and with ``noise=None`` the noisy layers
use their mean weights, as the Flax layer does without a ``noise`` rng.

``ActorNet``, ``CriticNet``, ``ActorCriticNet``, ``TanhGaussianActor``,
``DeterministicActor`` and ``TwinQNet`` (``mlp.py:151-269``) keep their
layers in ``self.layers`` under Flax's own names (:class:`DenseNet`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from scalerl_torch.models.atari import lecun_normal_
from scalerl_torch.utils.platform import DeviceLike, resolve_device

# One (eps_in [in], eps_out [out]) pair per noisy layer, in layer order.
Noise = Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]


class NoisyDense(nn.Module):
    """Factorised-Gaussian NoisyNet linear layer (Fortunato et al. 2018).

    ``w = w_mu + w_sigma * f(eps_out) f(eps_in)^T`` and ``b = b_mu +
    b_sigma * f(eps_out)`` with ``f(e) = sign(e) sqrt(|e|)``; the weights
    are ``[out, in]`` (Flax's ``w_mu`` is ``[in, out]``)."""

    def __init__(self, in_features: int, out_features: int, sigma0: float = 0.5) -> None:
        super().__init__()
        self.in_features, self.out_features, self.sigma0 = in_features, out_features, sigma0
        self.w_mu = nn.Parameter(torch.empty(out_features, in_features))
        self.b_mu = nn.Parameter(torch.empty(out_features))
        self.w_sigma = nn.Parameter(torch.empty(out_features, in_features))
        self.b_sigma = nn.Parameter(torch.empty(out_features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        # Flax's: means uniform in [-1/sqrt(in), 1/sqrt(in)), sigmas constant
        bound = 1.0 / math.sqrt(self.in_features)
        for mu in (self.w_mu, self.b_mu):
            mu.uniform_(-bound, bound, generator=generator)
        for sigma in (self.w_sigma, self.b_sigma):
            sigma.fill_(self.sigma0 / math.sqrt(self.in_features))

    def sample_noise(self, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(eps_in, eps_out)`` standard normals on the layer's device."""
        device = self.w_mu.device
        eps_in = torch.randn(self.in_features, generator=generator, device=device)
        eps_out = torch.randn(self.out_features, generator=generator, device=device)
        return eps_in, eps_out

    def forward(self, x: torch.Tensor,
                eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        if eps is None:
            return F.linear(x, self.w_mu, self.b_mu)
        f_in, f_out = (torch.sign(e) * torch.sqrt(torch.abs(e)) for e in eps)
        w = self.w_mu + self.w_sigma * torch.outer(f_out, f_in)
        return F.linear(x, w, self.b_mu + self.b_sigma * f_out)


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
        noisy_std: float = 0.5,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's defaults: truncated LeCun-normal kernels and zero biases for
        ``Dense``, :meth:`NoisyDense.reset_parameters` for noisy layers)."""
        super().__init__()
        device = resolve_device(device)
        self.action_dim = action_dim
        self.dueling = dueling
        self.noisy = noisy
        widths = [math.prod(obs_shape), *parse_hidden(hidden_sizes)]

        def dense(a: int, b: int) -> nn.Module:
            return NoisyDense(a, b, noisy_std) if noisy else nn.Linear(a, b)

        layers = [dense(a, b) for a, b in zip(widths[:-1], widths[1:])]
        self.num_hidden = len(layers)
        layers.append(dense(widths[-1], self.head_width))
        if dueling:
            layers.append(dense(widths[-1], self.head_width // action_dim))
        self.dense = nn.ModuleList(layers)
        self.reset_parameters(generator)  # on the host: one seed, same weights
        self.to(device)

    @property
    def head_width(self) -> int:
        return self.action_dim

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.dense:
            if isinstance(layer, NoisyDense):
                layer.reset_parameters(generator)
            else:
                lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()

    def sample_noise(self, generator: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One noise draw for every noisy layer, in layer order (empty
        without ``noisy``)."""
        return [layer.sample_noise(generator) for layer in self.dense
                if isinstance(layer, NoisyDense)]

    def _layer(self, i: int, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        if self.noisy:
            return self.dense[i](x, None if noise is None else noise[i])
        return self.dense[i](x)

    def _head(self, x: torch.Tensor, noise: Noise) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The flattened torso's advantage (or Q) head and, dueling, its
        value head."""
        x = x.to(torch.float32)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        for i in range(self.num_hidden):
            x = F.relu(self._layer(i, x, noise))
        adv = self._layer(self.num_hidden, x, noise)
        val = self._layer(self.num_hidden + 1, x, noise) if self.dueling else None
        return adv, val

    def forward(self, obs: torch.Tensor, noise: Noise = None) -> torch.Tensor:
        adv, val = self._head(obs, noise)
        if self.dueling:
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return adv


class C51QNet(QNet):
    """Categorical (C51) Q-network: ``obs -> atom logits [B, A, N]``, with
    QNet's dueling and noisy composition (value ``[B, 1, N]`` plus the
    advantage less its mean over actions); expectations against the
    support live in ``ops/losses.py::categorical_q_values``."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int, num_atoms: int = 51,
                 **kw) -> None:
        self.num_atoms = num_atoms
        super().__init__(obs_shape, action_dim, **kw)

    @property
    def head_width(self) -> int:
        return self.action_dim * self.num_atoms

    def forward(self, obs: torch.Tensor, noise: Noise = None) -> torch.Tensor:
        adv, val = self._head(obs, noise)
        adv = adv.reshape(-1, self.action_dim, self.num_atoms)
        if self.dueling:
            val = val.reshape(-1, 1, self.num_atoms)
            return val + adv - adv.mean(dim=1, keepdim=True)
        return adv


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


class DenseNet(nn.Module):
    """Base of the actor-critic heads below: ``nn.Linear`` layers kept in
    ``self.layers`` under their Flax names (``Dense_0``, ``mean``,
    ``q0_dense1``, ...), so ``convert.flax_mlp_to_torch`` maps each Flax
    layer to ``layers.<name>``; initialised as Flax's ``Dense`` is
    (truncated LeCun-normal kernels, zero biases) from a host generator,
    then moved to ``device``."""

    def __init__(self) -> None:
        super().__init__()
        self.layers = nn.ModuleDict()

    def _finish(self, device: DeviceLike, generator: torch.Generator | None) -> None:
        self.reset_parameters(generator)  # on the host: one seed, same weights
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.layers.values():
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()

    def _stack(self, in_dim: int, hidden: Tuple[int, ...], prefix: str = "Dense_") -> int:
        """Declare the hidden layers ``prefix{i}``; returns the last width."""
        for i, h in enumerate(hidden):
            self.layers[f"{prefix}{i}"] = nn.Linear(in_dim, h)
            in_dim = h
        return in_dim

    def _torso(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        x = x.to(torch.float32)
        for name in names:
            x = F.relu(self.layers[name](x))
        return x


class ActorNet(DenseNet):
    """Categorical policy head: ``obs [..., D] -> logits [..., A]``
    (``scalerl_tpu/models/mlp.py::ActorNet``)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Union[str, Sequence[int]] = (128, 128),
                 device: DeviceLike = "cuda", generator: torch.Generator | None = None) -> None:
        super().__init__()
        hidden = parse_hidden(hidden_sizes)
        width = self._stack(obs_dim, hidden)
        self.hidden = [f"Dense_{i}" for i in range(len(hidden))]
        self.layers[f"Dense_{len(hidden)}"] = nn.Linear(width, action_dim)
        self.head = f"Dense_{len(hidden)}"
        self._finish(device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.layers[self.head](self._torso(obs, self.hidden))


class CriticNet(ActorNet):
    """State-value head: ``obs [..., D] -> value [...]``
    (``scalerl_tpu/models/mlp.py::CriticNet``)."""

    def __init__(self, obs_dim: int, hidden_sizes: Union[str, Sequence[int]] = (128, 128),
                 device: DeviceLike = "cuda", generator: torch.Generator | None = None) -> None:
        super().__init__(obs_dim, 1, hidden_sizes, device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return super().forward(obs).squeeze(-1)


class ActorCriticNet(DenseNet):
    """Shared-torso actor-critic: ``obs -> (logits, value)``
    (``scalerl_tpu/models/mlp.py::ActorCriticNet``).  With
    ``normalized_init`` the heads take the A3C init (norm 0.01 for the
    policy, 1.0 for the value)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Union[str, Sequence[int]] = (128, 128),
                 normalized_init: bool = False, device: DeviceLike = "cuda",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        hidden = parse_hidden(hidden_sizes)
        width = self._stack(obs_dim, hidden)
        self.hidden = [f"Dense_{i}" for i in range(len(hidden))]
        self.logits_head, self.value_head = f"Dense_{len(hidden)}", f"Dense_{len(hidden) + 1}"
        self.layers[self.logits_head] = nn.Linear(width, action_dim)
        self.layers[self.value_head] = nn.Linear(width, 1)
        self.normalized_init = normalized_init
        self._finish(device, generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        if self.normalized_init:
            normalized_columns_init_(self.layers[self.logits_head].weight, 0.01, generator)
            normalized_columns_init_(self.layers[self.value_head].weight, 1.0, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._torso(obs, self.hidden)
        return self.layers[self.logits_head](x), self.layers[self.value_head](x).squeeze(-1)


class TanhGaussianActor(DenseNet):
    """SAC's squashed-Gaussian policy: ``obs -> (mean_u, log_std)`` in
    pre-squash space, ``log_std`` clipped to ``[log_std_min, log_std_max]``
    (``scalerl_tpu/models/mlp.py::TanhGaussianActor``); sampling and the
    log-probability live in ``agents/sac.py``."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Union[str, Sequence[int]] = (256, 256),
                 log_std_min: float = -20.0, log_std_max: float = 2.0,
                 device: DeviceLike = "cuda", generator: torch.Generator | None = None) -> None:
        super().__init__()
        hidden = parse_hidden(hidden_sizes)
        width = self._stack(obs_dim, hidden)
        self.hidden = [f"Dense_{i}" for i in range(len(hidden))]
        self.layers["mean"] = nn.Linear(width, action_dim)
        self.layers["log_std"] = nn.Linear(width, action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self._finish(device, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._torso(obs, self.hidden)
        log_std = torch.clamp(self.layers["log_std"](x), self.log_std_min, self.log_std_max)
        return self.layers["mean"](x), log_std


class DeterministicActor(ActorNet):
    """TD3's actor: ``obs -> tanh(MLP(obs))`` in ``[-1, 1]^d``, scaled by
    the caller (``scalerl_tpu/models/mlp.py::DeterministicActor``)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Union[str, Sequence[int]] = (256, 256),
                 device: DeviceLike = "cuda", generator: torch.Generator | None = None) -> None:
        super().__init__(obs_dim, action_dim, hidden_sizes, device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(obs))


class TwinQNet(DenseNet):
    """Two independent critics ``Q(s, a)`` in one module, ``(obs, action) ->
    (q1, q2)`` (``scalerl_tpu/models/mlp.py::TwinQNet``); the layers are
    ``q{i}_dense{j}`` and ``q{i}_out``, Flax's names."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden_sizes: Union[str, Sequence[int]] = (256, 256),
                 device: DeviceLike = "cuda", generator: torch.Generator | None = None) -> None:
        super().__init__()
        hidden = parse_hidden(hidden_sizes)
        self.hidden = []
        for i in range(2):
            width = self._stack(obs_dim + action_dim, hidden, prefix=f"q{i}_dense")
            self.hidden.append([f"q{i}_dense{j}" for j in range(len(hidden))])
            self.layers[f"q{i}_out"] = nn.Linear(width, 1)
        self._finish(device, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x0 = torch.cat([obs.to(torch.float32), action.to(torch.float32)], dim=-1)
        q1, q2 = (self.layers[f"q{i}_out"](self._torso(x0, self.hidden[i])).squeeze(-1)
                  for i in range(2))
        return q1, q2
