"""Quantized parameter snapshots for non-learner replicas.

Port of ``scalerl_tpu/runtime/quantize.py``.  Replicas that never take
gradients (generation and serving copies) can hold and ship a lossy
snapshot while the learner keeps full precision.  Two formats:

- ``"int8"``: per-leaf symmetric quantization, ``q = round(x / s)`` in int8
  with ONE float32 scale ``s = max|x| / 127`` per leaf (floored at 1e-12).
  Leaves with ``ndim <= 1`` (biases, LayerNorm scales) pass through
  untouched: a per-leaf scale would smear across their magnitudes, and
  they are tiny on the wire anyway;
- ``"bf16"``: a per-leaf cast.

Everything is plain tensor ops on the leaf's own device (the JAX version
is ``jnp`` outside any Pallas kernel): ``torch.round`` rounds half to even
as ``jnp.round`` does, and the scale is one float32 division, so the card
and the host give the same int8 tensor and the same scale bit for bit.
Inside a computation on shards (``parallel/sharding.py::shard_context``, a
meshed engine's push) a leaf of a dict is its rank's shard, and the max of
a sharded leaf is taken over its shards with one all-reduce: each rank
quantizes its shard with the whole leaf's scale.
Consumers dequantize ON READ (:func:`dequantize_tree`) and cache the
result per generation (``runtime/param_server.py``).

Trees are a module's ``{name: tensor}`` state dict or any nesting of
dicts, lists and tuples over tensors; non-float leaves pass through.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

QUANT_MODES = ("int8", "bf16")


class QuantizedLeaf(NamedTuple):
    """One compressed tensor: the payload and what rebuilds it.

    ``scale`` is a float32 0-dim tensor for int8 (symmetric, no zero
    point) and ``None`` for the bf16 cast; ``dtype`` is the original
    dtype, which dequantization restores."""

    q: torch.Tensor
    scale: Optional[torch.Tensor]
    dtype: torch.dtype


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, QuantizedLeaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _abs_max(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """``max|x|`` of the whole leaf ``name``: over its shards (one
    all-reduce max on the axes that shard it) inside a computation on
    shards, else of ``x`` itself."""
    from scalerl_torch.parallel.sharding import active_shard_context, axes_all_reduce, leaf_axes

    m = x.abs().max()
    axes = () if name is None else leaf_axes(name, x)
    if not axes:
        return m
    return axes_all_reduce(m.reshape(1), dist.ReduceOp.MAX, active_shard_context().mesh,
                           axes).reshape(())


def _quantize_leaf(x: Any, mode: str, name: Optional[str] = None) -> Any:
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.ndim <= 1:
        return x
    if mode == "bf16":
        return QuantizedLeaf(q=x.detach().to(torch.bfloat16), scale=None, dtype=x.dtype)
    xf = x.detach().to(torch.float32)
    scale = torch.clamp_min(_abs_max(xf, name) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedLeaf(q=q, scale=scale, dtype=x.dtype)


def _dequantize_leaf(x: Any) -> Any:
    if not isinstance(x, QuantizedLeaf):
        return x
    if x.scale is None:
        return x.q.to(x.dtype)
    return (x.q.to(torch.float32) * x.scale).to(x.dtype)


def _tree_map_named(fn: Callable[[Optional[str], Any], Any], tree: Any,
                    name: Optional[str] = None) -> Any:
    """``fn(name, leaf)`` over a tree, ``name`` the key of the dict entry
    that holds the leaf (a state dict's param name)."""
    if isinstance(tree, dict):
        return {k: _tree_map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def quantize_tree(tree: Any, mode: str) -> Any:
    """Compress every float leaf with ``ndim >= 2``; device-side ops only.
    Passthrough leaves are returned as they are (not copied)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quantize mode must be one of {QUANT_MODES}, got {mode!r}")
    return _tree_map_named(lambda name, x: _quantize_leaf(x, mode, name), tree)


def dequantize_tree(tree: Any) -> Any:
    """Rebuild a :func:`quantize_tree` snapshot in the original dtypes."""
    return _tree_map(_dequantize_leaf, tree)


def tree_wire_bytes(tree: Any) -> int:
    """Snapshot payload size in bytes (a quantized leaf counts its payload
    and 4 bytes of scale)."""
    total = 0
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, QuantizedLeaf):
            total += leaf.q.numel() * leaf.q.element_size()
            if leaf.scale is not None:
                total += 4
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
