"""Parameter-dict helpers (port of ``scalerl_tpu/utils/tree.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]


def hard_target_update(online: Params, target: Params) -> Params:
    """target <- online, as new tensors (no leaf aliases ``online``)."""
    del target
    return {k: v.clone() for k, v in online.items()}


def soft_target_update(online: Params, target: Params, tau: float) -> Params:
    """Polyak update: target <- tau * online + (1 - tau) * target."""
    return {k: tau * online[k] + (1.0 - tau) * t for k, t in target.items()}


def tree_map_with_path(fn: Callable[[Tuple[str, ...], torch.Tensor], Any], tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, tensor)`` over every tensor of a state tree (dataclasses,
    named tuples, tuples, lists and dicts of tensors), the path holding
    field names, dict keys and tuple indices; anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, x, path + (n,))
                            for n, x in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return tree


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a state tree."""
    return tree_map_with_path(lambda _, x: fn(x), tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a state tree, in :func:`tree_map`'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out
