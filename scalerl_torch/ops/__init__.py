"""Losses, returns, V-trace, replay sampling and attention, each with its
CUDA kernel wrapper where the JAX package has a Pallas kernel (port of
``scalerl_tpu/ops``)."""

from scalerl_torch.ops.ring_attention import (  # noqa: F401
    full_attention,
    make_ring_attention_fn,
    ring_attention,
)
