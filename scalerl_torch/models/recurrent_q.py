"""Recurrent Q-network for R2D2.

Port of ``scalerl_tpu/models/recurrent_q.py::RecurrentQNet``: the time-major
signature of ``AtariNet`` (``obs [T, B, ...], last_action, reward, done,
core``), a conv torso for pixel observations (``[H, W, C]`` per step, the
three SAME-padded convs of ``models/atari.py``) or none for vectors, then
``fc(hidden)``, the concat ``[fc, one-hot last action, reward clipped to
[-1, 1]]`` of width ``core_size = hidden + num_actions + 1``, the
done-masked LSTM core of ``models/atari.py`` (float32), and a dueling Q head
(``value_h``/``value`` and ``advantage_h``/``advantage`` of width ``hidden //
2``, the advantage less its mean over actions) or a plain ``q`` layer.  Only
float32 is ported: the JAX package's R2D2 agent builds the model in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.models.atari import CONVS, LSTMLayer, LSTMState, lecun_normal_, same_padding
from scalerl_torch.utils.platform import DeviceLike, resolve_device


class RecurrentQOutput(NamedTuple):
    q_values: torch.Tensor  # [T, B, num_actions]


class RecurrentQNet(nn.Module):
    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        use_lstm: bool = True,
        hidden_size: int = 512,
        lstm_layers: int = 1,
        dueling: bool = True,
        device: DeviceLike = "cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        """``obs_shape``: ``(H, W, C)`` pixels (uint8, scaled by 1/255) or
        ``(D,)`` vectors; ``generator``: a host ``torch.Generator`` for the
        initial weights (Flax's defaults, as ``AtariNet``'s)."""
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.hidden_size = hidden_size
        self.use_lstm = use_lstm
        self.dueling = dueling
        self.pixels = len(obs_shape) == 3
        convs = []
        if self.pixels:
            height, width, width_in = obs_shape
            for feat, kern, stride in CONVS:
                convs.append(nn.Conv2d(width_in, feat, kern, stride))
                width_in = feat
                height, width = -(-height // stride), -(-width // stride)
            width_in *= height * width
        else:
            width_in = obs_shape[0]
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(width_in, hidden_size)
        layers = lstm_layers if use_lstm else 0
        self.core = nn.ModuleList(LSTMLayer(self.core_size, self.core_size) for _ in range(layers))
        if dueling:
            self.value_h = nn.Linear(self.core_size, hidden_size // 2)
            self.value = nn.Linear(hidden_size // 2, 1)
            self.advantage_h = nn.Linear(self.core_size, hidden_size // 2)
            self.advantage = nn.Linear(hidden_size // 2, num_actions)
        else:
            self.q = nn.Linear(self.core_size, num_actions)
        self.reset_parameters(generator)
        self.to(device)

    @property
    def core_size(self) -> int:
        return self.hidden_size + self.num_actions + 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        heads = ("value_h", "value", "advantage_h", "advantage") if self.dueling else ("q",)
        for layer in [*self.convs, self.fc, *(getattr(self, h) for h in heads)]:
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            layer.bias.zero_()
        for cell in self.core:
            cell.reset_parameters(generator)

    def initial_state(self, batch_size: int) -> LSTMState:
        shape, device = (batch_size, self.core_size), self.fc.weight.device
        return tuple((torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                     for _ in self.core)

    def forward(
        self,
        obs: torch.Tensor,  # [T, B, H, W, C] pixels or [T, B, D] vectors
        last_action: torch.Tensor,  # [T, B] int
        reward: torch.Tensor,  # [T, B] float
        done: torch.Tensor,  # [T, B] bool
        core_state: LSTMState = (),
    ) -> Tuple[RecurrentQOutput, LSTMState]:
        T, B = obs.shape[0], obs.shape[1]
        if self.pixels:
            x = obs.to(torch.float32) / 255.0
            x = x.reshape((T * B,) + tuple(obs.shape[2:])).permute(0, 3, 1, 2)
            for conv, (_, kern, stride) in zip(self.convs, CONVS):
                top, bottom = same_padding(x.shape[2], kern, stride)
                left, right = same_padding(x.shape[3], kern, stride)
                x = F.relu(F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight,
                                    conv.bias, stride))
            x = x.permute(0, 2, 3, 1).reshape(T * B, -1)  # (h, w, c): Flax's flatten
        else:
            x = obs.to(torch.float32).reshape(T * B, -1)
        x = F.relu(self.fc(x))
        actions = torch.arange(self.num_actions, device=obs.device)
        one_hot_action = (last_action.reshape(T * B, 1) == actions).to(torch.float32)
        clipped_reward = torch.clamp(reward, -1.0, 1.0).reshape(T * B, 1).to(torch.float32)
        core_output = torch.cat([x, one_hot_action, clipped_reward], dim=-1)
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
        if self.dueling:
            value = self.value(F.relu(self.value_h(core_output)))
            adv = self.advantage(F.relu(self.advantage_h(core_output)))
            q = value + adv - adv.mean(dim=-1, keepdim=True)
        else:
            q = self.q(core_output)
        return RecurrentQOutput(q_values=q.reshape(T, B, self.num_actions)), core_state
