"""IMPALA Atari network: conv torso + optional done-masked LSTM core.

Port of ``scalerl_tpu/models/atari.py::AtariNet``: three convs (32@8s4 /
64@4s2 / 64@3s1) -> fc(hidden) -> concat[fc, one-hot last action, clipped
reward] -> with ``use_lstm``, ``lstm_layers`` stacked LSTM cells of width
``hidden + num_actions + 1`` whose carry is zeroed where ``done`` -> policy-
logits and baseline heads.

The LSTM core is flax's ``OptimizedLSTMCell`` under ``nn.scan``: gates in
the order i, f, g, o, ``c' = f c + i g`` and ``h' = o tanh(c')`` with no
forget-gate offset; each step first multiplies the carry of every layer by
``~done``.  It runs in float32 whatever the torso's dtype.  The port runs
it layer by layer: one GEMM projects all T inputs of a layer against its
four input kernels at once, then a loop over T does the one product that
needs the previous step, ``[B, H] x [H, 4H]``.  That is flax's arithmetic
(a layer's step t reads only its own carry and the step-t output of the
layer below) with fewer launches.

Layout traps the port keeps exact:

- Frames arrive NHWC (``[T, B, H, W, C]`` uint8) as in the JAX package.  The
  convs run on an NHWC-strided view (PyTorch's channels-last format), and
  the conv output is flattened in (h, w, c) order, the order of Flax's
  ``Dense_0`` rows.
- Flax's ``nn.Conv`` pads SAME.  For a stride-s conv of width k over n
  inputs that is ``ceil(n/s)`` outputs with ``(s*(out-1) + k - n)`` pad,
  the smaller half on the left: (2, 2) for 8s4 at 84, (1, 2) for 4s2 at 21,
  (1, 1) for 3s1.  ``F.pad`` then ``conv2d`` with no padding.
- ``compute_dtype=bfloat16`` casts the f32 params to bf16 for the conv and
  fc layers (the concat too, as Flax does); the core and the heads compute
  in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.utils.platform import DeviceLike, resolve_device


# The recurrent carry: ((c, h),) per LSTM layer, each [B, core_size]
# float32; () without the LSTM.
LSTMState = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class AtariNetOutput(NamedTuple):
    policy_logits: torch.Tensor  # [T, B, num_actions]
    baseline: torch.Tensor  # [T, B]


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(left, right) padding of a SAME conv over ``n`` inputs."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # Flax's default kernel init: variance 1/fan_in, normal truncated at two
    # standard deviations (scaled so the truncated law keeps that variance)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


# (features, kernel, stride) of the three convs
CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


class LSTMLayer(nn.Module):
    """One cell of the core: ``input`` holds the kernels ``ii|if|ig|io``
    (no bias), ``hidden`` the kernels ``hi|hf|hg|ho`` and their biases,
    each stacked along the output axis in flax's gate order."""

    def __init__(self, in_features: int, hidden: int) -> None:
        super().__init__()
        self.hidden_size = hidden
        self.input = nn.Linear(in_features, 4 * hidden, bias=False)
        self.hidden = nn.Linear(hidden, 4 * hidden)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        # flax's defaults: LeCun-normal input kernels, each recurrent kernel
        # orthogonal on its own, zero biases
        lecun_normal_(self.input.weight, self.input.in_features, generator)
        for gate in self.hidden.weight.split(self.hidden_size):
            nn.init.orthogonal_(gate, generator=generator)
        self.hidden.bias.zero_()

    def forward(self, x: torch.Tensor, keep: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
        """``x`` [T, B, in], ``keep`` [T, B, 1] (1 - done) -> (the [T, B, H]
        outputs, the last (c, h))."""
        gates_x = F.linear(x, self.input.weight) + self.hidden.bias
        weight_h = self.hidden.weight.t()
        outputs = []
        for t in range(x.shape[0]):
            c, h = c * keep[t], h * keep[t]
            # chunk, not slices: its backward is one cat, where each slice's
            # would zero-fill a [B, 4H] gradient
            i, f, g, o = torch.addmm(gates_x[t], h, weight_h).chunk(4, dim=1)
            c = torch.addcmul(torch.sigmoid(f) * c, torch.sigmoid(i), torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            outputs.append(h)
        return torch.stack(outputs), (c, h)


class AtariNet(nn.Module):
    """Conv actor-critic for 84x84 pixel observations."""

    def __init__(
        self,
        num_actions: int,
        use_lstm: bool = True,
        hidden_size: int = 512,
        lstm_layers: int = 2,
        obs_shape: Tuple[int, int, int] = (84, 84, 4),
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
        normalized_init: bool = False,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's defaults: truncated LeCun-normal kernels, orthogonal
        recurrent kernels, zero biases; with ``normalized_init`` the A3C
        heads, norm 0.01 for the policy and 1.0 for the baseline)."""
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.normalized_init = normalized_init
        self.hidden_size = hidden_size
        self.use_lstm = use_lstm
        self.dtype = dtype
        height, width, channels = obs_shape
        convs = []
        for feat, kern, stride in CONVS:
            convs.append(nn.Conv2d(channels, feat, kern, stride))
            channels = feat
            height, width = -(-height // stride), -(-width // stride)
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(height * width * channels, hidden_size)
        layers = lstm_layers if use_lstm else 0
        self.core = nn.ModuleList(LSTMLayer(self.core_size, self.core_size) for _ in range(layers))
        self.policy = nn.Linear(self.core_size, num_actions)
        self.baseline = nn.Linear(self.core_size, 1)
        # initialised on the host, so one seed gives the same weights on
        # every device
        self.reset_parameters(generator)
        self.to(device)

    @property
    def core_size(self) -> int:
        return self.hidden_size + self.num_actions + 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in [*self.convs, self.fc, self.policy, self.baseline]:
            fan_in = layer.weight[0].numel()
            lecun_normal_(layer.weight, fan_in, generator)
            layer.bias.zero_()
        for layer in self.core:
            layer.reset_parameters(generator)
        if self.normalized_init:
            from scalerl_torch.models.mlp import normalized_columns_init_

            normalized_columns_init_(self.policy.weight, 0.01, generator)
            normalized_columns_init_(self.baseline.weight, 1.0, generator)

    def initial_state(self, batch_size: int) -> LSTMState:
        shape, device = (batch_size, self.core_size), self.policy.weight.device
        return tuple((torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                     for _ in self.core)

    def forward(
        self,
        frame: torch.Tensor,  # [T, B, H, W, C] uint8 (or float)
        last_action: torch.Tensor,  # [T, B] int
        reward: torch.Tensor,  # [T, B] float
        done: torch.Tensor,  # [T, B] bool (read by the LSTM core only)
        core_state: LSTMState = (),
    ) -> Tuple[AtariNetOutput, LSTMState]:
        # the layers' own code, or on their shards inside a meshed learn step
        from scalerl_torch.parallel.shard_compute import conv2d, linear

        T, B = frame.shape[0], frame.shape[1]
        dt = self.dtype
        x = frame.to(dt) / 255.0
        # NHWC memory seen as NCHW: the convs run channels-last
        x = x.reshape((T * B,) + tuple(frame.shape[2:])).permute(0, 3, 1, 2)
        for conv, (_, kern, stride) in zip(self.convs, CONVS):
            top, bottom = same_padding(x.shape[2], kern, stride)
            left, right = same_padding(x.shape[3], kern, stride)
            x = F.pad(x, (left, right, top, bottom))
            x = F.relu(conv2d(conv, x, dt))
        x = x.permute(0, 2, 3, 1).reshape(T * B, -1)  # (h, w, c) order
        x = F.relu(linear(self.fc, x, dt))

        actions = torch.arange(self.num_actions, device=frame.device)
        one_hot_action = (last_action.reshape(T * B, 1) == actions).to(dt)
        clipped_reward = torch.clamp(reward, -1.0, 1.0).reshape(T * B, 1).to(dt)
        core_output = torch.cat([x, one_hot_action, clipped_reward], dim=-1)

        core_output = core_output.to(torch.float32)
        if self.use_lstm:
            if not core_state:
                core_state = self.initial_state(B)
            keep = (~done).to(torch.float32).reshape(T, B, 1)
            core_output = core_output.reshape(T, B, -1)
            new_state = []
            for layer, (c, h) in zip(self.core, core_state):
                core_output, carry = layer(core_output, keep, c, h)
                new_state.append(carry)
            core_state = tuple(new_state)
            core_output = core_output.reshape(T * B, -1)
        policy_logits = self.policy(core_output)
        baseline = self.baseline(core_output)
        return (
            AtariNetOutput(
                policy_logits=policy_logits.reshape(T, B, self.num_actions),
                baseline=baseline.reshape(T, B),
            ),
            core_state,
        )
