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
- ``"pallas"``: both phases through the CUDA kernels (``ops/cuda_per.py``),
  which sum and scan in their own order; :func:`kernel_order_sample` is
  that order step for step in plain PyTorch.

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


# csrc/per.cu's shape of the sample: threads a CTA, lanes of a block one
# lane scans (32 lanes scan 1024 at once), block sums a CTA scans at once
KERNEL_THREADS = 256
KERNEL_LANE_RUN = 32
KERNEL_WINDOW = 8192


def _shuffle_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dim (a warp's 32 lanes) as
    ``__shfl_up_sync`` does it: at reach 1, 2, 4, 8, 16 lane l adds lane
    l - reach's value."""
    for off in (1, 2, 4, 8, 16):
        x = torch.cat([x[..., :off], x[..., off:] + x[..., :-off]], dim=-1)
    return x


def _exclusive(incl: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)


def kernel_block_sums(flat_p: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[nb]`` block sums in the CUDA kernels' order (``csrc/per.cu``'s
    ``load_segment``, ``add_segment`` and ``warp_sum``, which the block-sum
    kernel and the update's re-sum run): lane l of a warp adds the 4-lane
    chunks l, l + 32, l + 64, ... in turn, each chunk's four in order, then
    a butterfly over the 32 lanes."""
    nb = num_blocks(flat_p.shape[0], block_size)
    rounds = -(-block_size // 128)
    rows = gather_blocks(flat_p, torch.arange(nb, device=flat_p.device), block_size)
    x = torch.nn.functional.pad(rows, (0, rounds * 128 - block_size)).view(nb, rounds, 32, 4)
    acc = torch.zeros(nb, 32, dtype=torch.float32, device=flat_p.device)
    for r in range(rounds):
        for e in range(4):
            acc = acc + x[:, r, :, e]
    lanes = torch.arange(32, device=flat_p.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ off]
    return acc[:, 0].contiguous()


def _kernel_order_blocks(
    sums: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each target's block and the running sum before it, as
    ``per_search_kernel`` scans and searches the block sums: windows of
    ``KERNEL_WINDOW``; a thread's run of the window, a shuffle scan of the
    runs' totals, a scan of the 8 warps' totals, the run again from its
    prefix; then a binary search for the first running sum >= t."""
    nb, S, device = sums.shape[0], targets.shape[0], sums.device
    b = torch.full((S,), -1, dtype=torch.int64, device=device)
    prev = torch.zeros(S, dtype=torch.float32, device=device)
    carry = torch.zeros((), dtype=torch.float32, device=device)
    for w0 in range(0, nb, KERNEL_WINDOW):
        L = min(KERNEL_WINDOW, nb - w0)
        per = -(-L // KERNEL_THREADS)
        runs = torch.nn.functional.pad(sums[w0:w0 + L], (0, KERNEL_THREADS * per - L))
        runs = runs.view(KERNEL_THREADS, per)
        total = torch.zeros(KERNEL_THREADS, dtype=torch.float32, device=device)
        for j in range(per):
            total = total + runs[:, j]
        incl = _shuffle_scan(total.view(KERNEL_THREADS // 32, 32))
        warps = incl.shape[0]
        warp_pre = _exclusive(_shuffle_scan(torch.nn.functional.pad(incl[:, 31], (0, 32 - warps))))
        acc = carry + (warp_pre[:warps, None] + _exclusive(incl)).reshape(-1)
        cum = []
        for j in range(per):
            acc = acc + runs[:, j]
            cum.append(acc)
        cum = torch.stack(cum, dim=1).reshape(-1)[:L]
        lo = torch.zeros(S, dtype=torch.int64, device=device)
        hi = torch.full((S,), L, dtype=torch.int64, device=device)
        for _ in range(L.bit_length()):
            live = lo < hi
            mid = (lo + hi) // 2
            below = cum[mid.clamp(max=L - 1)] < targets
            lo = torch.where(live & below, mid + 1, lo)
            hi = torch.where(live & ~below, mid, hi)
        found = (b < 0) & (targets <= cum[L - 1])
        b = torch.where(found, w0 + lo, b)
        prev = torch.where(found, torch.where(lo > 0, cum[(lo - 1).clamp(min=0)], carry), prev)
        if w0 + L == nb:  # past the total: the last block
            rest = b < 0
            b = torch.where(rest, nb - 1, b)
            prev = torch.where(rest, cum[L - 2] if L > 1 else carry, prev)
        carry = cum[L - 1]
    return b, prev


def kernel_order_sample(
    flat_p: torch.Tensor, targets: torch.Tensor, block_size: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pallas_sample`` in the CUDA kernels' arithmetic, step for step:
    :func:`kernel_block_sums`, the search of ``per_search_kernel``, the
    residual ``t - prev`` in float32, then each block scanned as a warp scans
    it (lane l a run of ``KERNEL_LANE_RUN`` lanes of each 1024-lane segment:
    the run's total, a shuffle scan of the totals, the run again from its
    exclusive prefix) and the running sums below the residual counted.

    Returns ``(idx [S] int64, b_idx [S] int64, within_t [S] float32)``."""
    n, S = flat_p.shape[0], targets.shape[0]
    targets = targets.to(torch.float32)
    b, prev = _kernel_order_blocks(kernel_block_sums(flat_p, block_size), targets)
    within = targets - prev
    seg = 32 * KERNEL_LANE_RUN
    nseg = -(-block_size // seg)
    rows = torch.nn.functional.pad(gather_blocks(flat_p, b, block_size),
                                   (0, nseg * seg - block_size))
    x = rows.view(S, nseg, 32, KERNEL_LANE_RUN)
    counted = (torch.arange(nseg * seg, device=flat_p.device) < block_size).view(
        nseg, 32, KERNEL_LANE_RUN)
    carry = torch.zeros(S, dtype=torch.float32, device=flat_p.device)
    count = torch.zeros(S, dtype=torch.int64, device=flat_p.device)
    for s in range(nseg):
        total = torch.zeros(S, 32, dtype=torch.float32, device=flat_p.device)
        for j in range(KERNEL_LANE_RUN):
            total = total + x[:, s, :, j]
        incl = _shuffle_scan(total)
        run = carry[:, None] + _exclusive(incl)
        for j in range(KERNEL_LANE_RUN):
            run = run + x[:, s, :, j]
            count += ((run < within[:, None]) & counted[s, :, j]).sum(dim=1)
        carry = carry + incl[:, 31]
    w = count.clamp(max=block_size - 1)
    return (b * block_size + w).clamp(max=n - 1), b, within


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
    last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, idx, order, "amax")
    flat_p[idx] = new_p[last[idx]]
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
