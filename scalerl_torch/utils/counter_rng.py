"""Random draws that are a pure function of ``(seed, step)``, made on the device.

The JAX learners fold their key out of the train state's step counter
(``jax.random.fold_in(PRNGKey(seed), state.step)``): PPO's lane shuffle,
SAC's policy noise and TD3's target smoothing.  So a resumed run repeats
the draws of the run it continues, and a step the all-finite guard skipped
is retried with the same draws.  The port keeps that contract: the draws
here are a counter-based hash of ``(seed, stream, step, index)``, computed
on the step counter's device.  A ``torch.Generator`` reseeded each step
would need the step on the host, a device-to-host copy every learn step
(and a failure inside the fused loop's sync guard).

The streams differ from ``jax.random``'s: the parity tests inject the JAX
draws through the learn functions' ``perms`` and ``noise`` arguments.  The
hash is the 32-bit "lowbias32" mixer applied twice over 32-bit words held in
int64 tensors; every product stays below 2^63.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for 32-bit words ``x`` without int64 overflow."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _host_mix32(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def random_bits(seed: int, stream: int, step: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words (int64, on ``step``'s device) for ``(seed,
    stream, step)``; ``step`` is a 0-dim integer tensor, never read on the
    host."""
    base = _host_mix32(_host_mix32(seed) ^ _host_mix32(stream + GOLDEN))
    key = _mix32((step.to(torch.int64) & MASK32) ^ base)
    idx = torch.arange(n, dtype=torch.int64, device=step.device)
    x = _mix32((_mul32(idx, GOLDEN) + key) & MASK32)
    return _mix32(x ^ key)


def normal(seed: int, stream: int, step: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard normals of ``shape``, by Box-Muller over two float32
    uniforms each in the open interval (0, 1) (a 24-bit grid)."""
    n = math.prod(shape)
    bits = random_bits(seed, stream, step, 2 * n)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    u1, u2 = u[0::2], u[1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(shape)


def permutations(seed: int, stream: int, step: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """``rows`` permutations of ``range(n)``, int64 ``[rows, n]`` (a stable
    argsort of hashed keys)."""
    keys = random_bits(seed, stream, step, rows * n).reshape(rows, n)
    return torch.argsort(keys, dim=-1, stable=True)
