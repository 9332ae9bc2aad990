"""The all-finite update guard and the float32 optimizer-state wrapper.

Port of ``scalerl_tpu/parallel/train_step.py::guard_nonfinite_updates`` /
``maybe_guard_nonfinite`` and ``fp32_optimizer_state``.  A learn step whose result holds NaN/Inf is
SKIPPED (the input state survives) instead of poisoning the run, and the
verdict rides the metrics as ``nonfinite_grads`` / ``skipped_steps``.

The JAX version gates with ``lax.cond``.  Here the choice is a device-side
``torch.where`` over every leaf of the state: branching on the verdict in
Python would copy it to the host and stall the device every step.  For the
same reason the check always runs; ``check_every=K`` keeps the reference's
semantics (only steps with ``step % K == 0`` can be skipped) by folding the
step test into the select, not by skipping the reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch


# A train state is a dataclass of tensors and (nested) dicts of tensors.


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of a train state (or a tuple of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    subs = tree if isinstance(tree, (tuple, list)) else tree.values()
    return [leaf for sub in subs for leaf in tensor_leaves(sub)]


def tree_select(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, a, b)`` leaf by leaf over two train states."""
    if isinstance(on_true, torch.Tensor):
        return torch.where(pred, on_true, on_false)
    if dataclasses.is_dataclass(on_true):
        return dataclasses.replace(on_true, **{
            f.name: tree_select(pred, getattr(on_true, f.name), getattr(on_false, f.name))
            for f in dataclasses.fields(on_true)
        })
    return {k: tree_select(pred, v, on_false[k]) for k, v in on_true.items()}


def all_finite(tree: Any) -> torch.Tensor:
    """0-dim bool tensor: every floating leaf of ``tree`` is finite.

    Integer and bool leaves (counters) cannot go NaN and are skipped."""
    checks = [torch.isfinite(x).all() for x in tensor_leaves(tree) if x.is_floating_point()]
    return torch.stack(checks).all()


def guard_nonfinite_updates(learn_fn: Callable, check_every: int = 1) -> Callable:
    """Wrap ``(state, *args) -> (state, metrics, *aux)`` so a non-finite
    result keeps the input state; ``state.step`` is the learner update
    count.  On a skipped step the aux tensors (e.g. the per-sample |TD|
    that feeds PER priorities) come back with their non-finite entries
    zeroed, so NaN cannot reach the replay through the feedback path."""

    def guarded(state, *args):
        out = learn_fn(state, *args)
        new_state, metrics, aux = out[0], dict(out[1]), tuple(out[2:])
        skip = ((state.step % check_every) == 0) & ~all_finite((new_state, aux))
        safe_state = tree_select(~skip, new_state, state)
        safe_aux = tuple(
            torch.where(skip, torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), x)
            if x.is_floating_point() else x
            for x in aux
        )
        bad = skip.to(torch.float32)
        metrics["nonfinite_grads"] = bad
        metrics["skipped_steps"] = bad
        return (safe_state, metrics) + safe_aux

    return guarded


def maybe_guard_nonfinite(learn_fn: Callable, args: Any) -> Callable:
    """Apply :func:`guard_nonfinite_updates` unless ``args.nonfinite_guard``
    is False, in which case ``learn_fn`` comes back untouched (no check, no
    counters in the metrics)."""
    if args.nonfinite_guard:
        return guard_nonfinite_updates(learn_fn, check_every=args.nonfinite_check_every)
    return learn_fn


def _to_float32(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() if v.is_floating_point() else v for k, v in tree.items()}


class _Fp32OptimizerState:
    """bf16 params with float32 optimizer state (JAX
    ``fp32_optimizer_state``): ``init`` builds the wrapped optimizer's state
    from a float32 view of the params; ``update`` upcasts the gradients,
    runs the wrapped update in float32 and casts each update back to its
    gradient's dtype, so a bf16 leaf stays bf16 and a float32 head stays
    float32 when the update is added.  The port's optimizers read no params
    in ``update``, so there are none to upcast there."""

    def __init__(self, optimizer: Any) -> None:
        self.optimizer = optimizer

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return self.optimizer.init(_to_float32(params))

    def update(self, grads: Dict[str, torch.Tensor],
               opt_state: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        updates, opt_state = self.optimizer.update(_to_float32(grads), opt_state)
        return {k: u.to(grads[k].dtype) for k, u in updates.items()}, opt_state


def fp32_optimizer_state(optimizer: Any) -> _Fp32OptimizerState:
    """Wrap one of the port's optimizers (``init(params)`` and ``update(grads,
    state) -> (updates, state)``) so its state lives in float32."""
    return _Fp32OptimizerState(optimizer)
