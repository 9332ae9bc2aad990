"""IMPALA Atari network: conv torso + linear heads (feed-forward).

Port of ``scalerl_tpu/models/atari.py::AtariNet`` with ``use_lstm=False``:
three convs (32@8s4 / 64@4s2 / 64@3s1) -> fc(hidden) -> concat[fc, one-hot
last action, clipped reward] -> policy-logits and baseline heads.  The
done-masked LSTM core is not ported yet; ``use_lstm=True`` raises.

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
  fc layers (the concat too, as Flax does); the heads compute in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.utils.platform import DeviceLike, resolve_device


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


class AtariNet(nn.Module):
    """Conv actor-critic for 84x84 pixel observations."""

    def __init__(
        self,
        num_actions: int,
        use_lstm: bool = True,
        hidden_size: int = 512,
        obs_shape: Tuple[int, int, int] = (84, 84, 4),
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's defaults: truncated LeCun-normal kernels, zero biases)."""
        super().__init__()
        if use_lstm:
            raise NotImplementedError(
                "the LSTM core of AtariNet is not ported yet; use use_lstm=False"
            )
        device = resolve_device(device)
        self.num_actions = num_actions
        self.hidden_size = hidden_size
        self.dtype = dtype
        height, width, channels = obs_shape
        convs = []
        for feat, kern, stride in CONVS:
            convs.append(nn.Conv2d(channels, feat, kern, stride))
            channels = feat
            height, width = -(-height // stride), -(-width // stride)
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(height * width * channels, hidden_size)
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

    def initial_state(self, batch_size: int) -> tuple:
        return ()

    def forward(
        self,
        frame: torch.Tensor,  # [T, B, H, W, C] uint8 (or float)
        last_action: torch.Tensor,  # [T, B] int
        reward: torch.Tensor,  # [T, B] float
        done: torch.Tensor,  # [T, B] bool (read by the LSTM core only)
        core_state: tuple = (),
    ) -> Tuple[AtariNetOutput, tuple]:
        T, B = frame.shape[0], frame.shape[1]
        dt = self.dtype
        x = frame.to(dt) / 255.0
        # NHWC memory seen as NCHW: the convs run channels-last
        x = x.reshape((T * B,) + tuple(frame.shape[2:])).permute(0, 3, 1, 2)
        for conv, (_, kern, stride) in zip(self.convs, CONVS):
            top, bottom = same_padding(x.shape[2], kern, stride)
            left, right = same_padding(x.shape[3], kern, stride)
            x = F.pad(x, (left, right, top, bottom))
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride))
        x = x.permute(0, 2, 3, 1).reshape(T * B, -1)  # (h, w, c) order
        x = F.relu(F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt)))

        actions = torch.arange(self.num_actions, device=frame.device)
        one_hot_action = (last_action.reshape(T * B, 1) == actions).to(dt)
        clipped_reward = torch.clamp(reward, -1.0, 1.0).reshape(T * B, 1).to(dt)
        core_output = torch.cat([x, one_hot_action, clipped_reward], dim=-1)

        core_output = core_output.to(torch.float32)
        policy_logits = self.policy(core_output)
        baseline = self.baseline(core_output)
        return (
            AtariNetOutput(
                policy_logits=policy_logits.reshape(T, B, self.num_actions),
                baseline=baseline.reshape(T, B),
            ),
            core_state,
        )
