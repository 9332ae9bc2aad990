"""Proportional sampling and priority updates over a flat priority plane.

Port of ``scalerl_tpu/ops/pallas_per.py``: the plain PyTorch versions, and
the dispatch that routes ``method="pallas"`` to the hand-written CUDA
kernels of ``ops/cuda_per.py``.  The method names are the JAX package's, so
one config means the same thing to both packages; here ``"pallas"`` means
"the hand kernel".  There is no ``"auto"`` and no environment override: the
caller names the method (``Sampler(use_pallas=...)`` does).

Sampling (``targets`` are points in ``[0, sum(flat_p))``; each returns the
flat index whose cumulative-priority interval holds its target):

- ``"cumsum"``: one cumsum over the whole plane and a ``searchsorted``.
- ``"hierarchical"``: two levels.  Phase 1 (:func:`split_targets`) sums
  the plane's ``block_size``-wide blocks, takes the cumsum of those sums
  and picks each target's block; phase 2 (:func:`within_block_sample`)
  scans only the chosen blocks and counts the entries whose running sum
  lies below the residual target.
- ``"pallas"``: phase 1 as above, phase 2 through the CUDA kernel.

A ragged last block reads as if the plane were zero-padded to whole
blocks; neither phase copies a padded plane.

Priority update (:func:`update_priorities_blocks`) writes the caller's
tensors IN PLACE (the JAX package returns new arrays; its Pallas call
aliases the plane to its output).  Duplicate indices resolve last-wins in
ascending order in every method: ``"xla"`` names the plain version here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SAMPLE_METHODS = ("cumsum", "hierarchical", "pallas")
UPDATE_METHODS = ("xla", "pallas")


def num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size)


def block_sums(flat_p: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[nb]`` sums of the plane's blocks; the ragged last block is summed
    up to ``n`` (as if zero-padded), without copying the plane."""
    n = flat_p.shape[0]
    full = n // block_size
    sums = flat_p[: full * block_size].view(full, block_size).sum(dim=1)
    if n % block_size:
        sums = torch.cat([sums, flat_p[full * block_size:].sum().reshape(1)])
    return sums


def split_targets(
    flat_p: torch.Tensor, targets: torch.Tensor, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: each target's block and its residual target within it.

    Returns ``(b_idx [S] int64, within_t [S] float32)``."""
    block_cum = torch.cumsum(block_sums(flat_p, block_size), dim=0)
    nb = block_cum.shape[0]
    b_idx = torch.searchsorted(block_cum, targets.contiguous(), side="left")
    b_idx = b_idx.clamp_(0, nb - 1)
    prev = torch.where(b_idx > 0, block_cum[(b_idx - 1).clamp_(min=0)], 0.0)
    return b_idx, targets - prev


def gather_blocks(flat_p: torch.Tensor, b_idx: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[S, block_size]`` rows of the chosen blocks; lanes past ``n`` read 0."""
    n = flat_p.shape[0]
    lanes = b_idx[:, None] * block_size + torch.arange(block_size, device=flat_p.device)
    return torch.where(lanes < n, flat_p[lanes.clamp(max=n - 1)], 0.0)


def within_block_sample(
    flat_p: torch.Tensor, b_idx: torch.Tensor, within_t: torch.Tensor, block_size: int
) -> torch.Tensor:
    """Phase 2, the plain version of the sample kernel: per sample, the
    count of the chosen block's running sums below its residual target,
    clipped to the block and to the plane.  Returns int64 flat indices."""
    rows = gather_blocks(flat_p, b_idx, block_size)
    w = (torch.cumsum(rows, dim=1) < within_t[:, None]).sum(dim=1)
    w = w.clamp_(max=block_size - 1)
    return (b_idx * block_size + w).clamp_(max=flat_p.shape[0] - 1)


def hierarchical_sample(
    flat_p: torch.Tensor, targets: torch.Tensor, block_size: int = 1024
) -> torch.Tensor:
    """Two-level proportional search; one flat index per target."""
    b_idx, within_t = split_targets(flat_p, targets, block_size)
    return within_block_sample(flat_p, b_idx, within_t, block_size)


def cumsum_sample(flat_p: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Flat search: one cumsum over the plane, then ``searchsorted``."""
    cum = torch.cumsum(flat_p, dim=0)
    idx = torch.searchsorted(cum, targets.contiguous(), side="left")
    return idx.clamp_(0, flat_p.shape[0] - 1)


def proportional_sample(
    flat_p: torch.Tensor,
    targets: torch.Tensor,
    method: str = "hierarchical",
    block_size: int = 1024,
) -> torch.Tensor:
    """Dispatch: ``cumsum``, ``hierarchical`` or ``pallas`` (the CUDA kernel,
    ``ops/cuda_per.py``).  Returns int64 flat indices."""
    if method == "cumsum":
        return cumsum_sample(flat_p, targets)
    if method == "hierarchical":
        return hierarchical_sample(flat_p, targets, block_size)
    if method == "pallas":
        from scalerl_torch.ops.cuda_per import sample_kernel

        return sample_kernel(flat_p, targets, block_size)
    raise ValueError(f"unknown sampling method {method!r}; use one of {SAMPLE_METHODS}")


def update_priorities_plain(
    flat_p: torch.Tensor,
    idx: torch.Tensor,
    new_p: torch.Tensor,
    block_sums_: Optional[torch.Tensor] = None,
    block_size: int = 1024,
) -> None:
    """The plain version of the update kernel, in place.

    ``index_put_`` does not promise which of several writes to one slot
    wins, so every update first takes the value of the LAST update to its
    slot; duplicates then all write the same value and the result is the
    ascending-order last-wins of the JAX package's ordered loop.  With
    ``block_sums_``, the touched blocks are re-summed (bounded at ``n``)."""
    n = flat_p.shape[0]
    idx = idx.clamp(0, n - 1)
    order = torch.arange(idx.shape[0], device=idx.device)
    same = idx[:, None] == idx[None, :]
    last = torch.where(same, order[None, :], -1).amax(dim=1)
    flat_p[idx] = new_p[last]
    if block_sums_ is not None:
        b_idx = idx // block_size
        block_sums_[b_idx] = gather_blocks(flat_p, b_idx, block_size).sum(dim=1)


def check_update_inputs(flat_p, idx, new_p, block_sums_, block_size) -> None:
    if flat_p.dim() != 1 or flat_p.dtype != torch.float32 or not flat_p.is_contiguous():
        raise ValueError("flat_p must be a contiguous 1-D float32 tensor")
    if idx.dim() != 1 or new_p.shape != idx.shape:
        raise ValueError(f"idx and new_p must be [M], got {tuple(idx.shape)}, {tuple(new_p.shape)}")
    nb = num_blocks(flat_p.shape[0], block_size)
    if block_sums_ is not None:
        if block_sums_.shape != (nb,) or block_sums_.dtype != torch.float32:
            raise ValueError(
                f"block_sums must be float32 [{nb}] (blocks of {block_size} over "
                f"{flat_p.shape[0]} priorities), got {block_sums_.dtype} "
                f"{tuple(block_sums_.shape)}"
            )
        if not block_sums_.is_contiguous():
            raise ValueError("block_sums must be contiguous")
    for name, x in (("idx", idx), ("new_p", new_p), ("block_sums", block_sums_)):
        if x is not None and x.device != flat_p.device:
            raise ValueError(f"{name} is on {x.device}, flat_p on {flat_p.device}")


def update_priorities_blocks(
    flat_p: torch.Tensor,
    idx: torch.Tensor,
    new_p: torch.Tensor,
    block_sums: Optional[torch.Tensor] = None,
    block_size: int = 1024,
    method: str = "xla",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scatter ``new_p`` into ``flat_p`` at ``idx`` (clipped to ``[0, n-1]``),
    last-wins in ascending order, and refresh the touched blocks' entries of
    ``block_sums`` when given.  Writes both IN PLACE and returns them.

    ``method``: ``"xla"`` (the plain version) or ``"pallas"`` (the CUDA
    kernel, ``ops/cuda_per.py``)."""
    idx = idx.to(torch.int64).contiguous()
    new_p = new_p.to(torch.float32).contiguous()
    check_update_inputs(flat_p, idx, new_p, block_sums, block_size)
    if method == "xla":
        update_priorities_plain(flat_p, idx, new_p, block_sums, block_size)
    elif method == "pallas":
        from scalerl_torch.ops.cuda_per import update_kernel

        update_kernel(flat_p, idx, new_p, block_sums, block_size)
    else:
        raise ValueError(f"unknown update method {method!r}; use one of {UPDATE_METHODS}")
    return flat_p, block_sums
