"""PER sampling and priority update in the PyTorch port against the JAX package.

The same numpy priorities and targets go through ``scalerl_tpu.ops.
pallas_per`` (the XLA forms and the Pallas kernels, which run in interpret
mode off-TPU) and through the port's plain versions and CUDA-kernel
wrappers.  The wrappers run the plain versions on host tensors; the kernels
themselves are held against those on the card by ``chip_smoke.py``, and
there also, bit for bit, against ``ops/per.py::kernel_order_sample``, the
sample kernels' own order of sums in plain PyTorch, which is held here to
the JAX package.

Sampling uses small integer priorities, exact in float32, so every
summation order gives the same partial sums and indices must be equal; on
real priorities the kernel order must bracket each target within a float32
rounding margin of a float64 running sum.  Updates are held at the JAX
test's 1e-5 (tests/test_pallas_per.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import cuda_per
from scalerl_torch.ops import per as tper
from scalerl_tpu.ops import pallas_per as jper

torch.set_num_threads(1)


def _priorities(n, seed=0):
    return np.random.default_rng(seed).integers(1, 17, size=n).astype(np.float32)


def _targets(flat_p, s, seed=1):
    total = float(flat_p.sum())
    u = np.random.default_rng(seed).uniform(size=s)
    return ((np.arange(s) + u) / s * total).astype(np.float32)


@pytest.mark.parametrize("block_size", [64, 256, 1024])
@pytest.mark.parametrize("n", [1024, 4096, 5000])  # 5000: a ragged last block
def test_sample_matches_jax_exactly(n, block_size):
    flat_p = _priorities(n, seed=n)
    targets = _targets(flat_p, 32, seed=block_size)
    jp, jt = jnp.asarray(flat_p), jnp.asarray(targets)
    want = np.asarray(jper.hierarchical_sample(jp, jt, block_size))
    pallas = np.asarray(jper.pallas_sample(jp, jt, block_size, interpret=True))
    np.testing.assert_array_equal(want, pallas)

    tp, tt = torch.from_numpy(flat_p), torch.from_numpy(targets)
    for method in tper.SAMPLE_METHODS:
        got = tper.proportional_sample(tp, tt, method=method, block_size=block_size)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=method)


def test_split_targets_matches_jax():
    flat_p = _priorities(5000, seed=2)
    targets = _targets(flat_p, 64, seed=3)
    _, jb, jw = jper._split_targets(jnp.asarray(flat_p), jnp.asarray(targets), 256)
    b_idx, within_t = tper.split_targets(torch.from_numpy(flat_p), torch.from_numpy(targets), 256)
    np.testing.assert_array_equal(b_idx.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(within_t.numpy(), np.asarray(jw))


def test_sample_respects_zero_priorities_and_the_ragged_tail():
    flat_p = torch.zeros(1000)
    flat_p[7] = 3.0
    flat_p[999] = 1.0  # the last lane of a ragged last block
    targets = torch.from_numpy(_targets(flat_p.numpy(), 16))
    idx = tper.hierarchical_sample(flat_p, targets, block_size=256)
    assert set(idx.tolist()) == {7, 999}
    np.testing.assert_array_equal(idx.numpy(), tper.cumsum_sample(flat_p, targets).numpy())


def test_kernel_wrappers_run_the_plain_versions_on_the_host():
    flat_p = torch.from_numpy(_priorities(3000, seed=5))
    targets = torch.from_numpy(_targets(flat_p.numpy(), 40, seed=6))
    before = cuda_per.sample_launches, cuda_per.update_launches
    got = cuda_per.sample_kernel(flat_p, targets, 512)
    np.testing.assert_array_equal(got.numpy(), tper.hierarchical_sample(flat_p, targets, 512).numpy())
    np.testing.assert_array_equal(got.numpy(), per_kernel_order(flat_p, targets, 512))
    plane = flat_p.clone()
    cuda_per.update_kernel(plane, torch.tensor([3, 3, 2999]), torch.tensor([5.0, 6.0, 7.0]))
    assert plane[3] == 6.0 and plane[2999] == 7.0
    assert (cuda_per.sample_launches, cuda_per.update_launches) == before


def per_kernel_order(flat_p, targets, block_size):
    idx, _, _ = tper.kernel_order_sample(flat_p, targets, block_size)
    return idx.numpy()


def _priorities_with_zeros(n, seed):
    """Integer priorities in [1, 16] with a fifth of the slots zero, a run of
    zero slots across a block boundary, and a zero last slot."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 17, size=n).astype(np.float32)
    p[rng.uniform(size=n) < 0.2] = 0.0
    p[n // 3: n // 3 + 70] = 0.0
    p[-1] = 0.0
    return p


@pytest.mark.parametrize("block_size", [64, 256, 1024])
@pytest.mark.parametrize("n", [128, 1024, 5000, 1 << 16])  # 128 < 256: one ragged block
def test_kernel_order_sample_matches_jax_exactly(n, block_size):
    flat_p = _priorities_with_zeros(n, seed=n + block_size)
    targets = _targets(flat_p, 32, seed=block_size)
    jp, jt = jnp.asarray(flat_p), jnp.asarray(targets)
    want = np.asarray(jper.hierarchical_sample(jp, jt, block_size))
    np.testing.assert_array_equal(want, np.asarray(jper.pallas_sample(jp, jt, block_size,
                                                                      interpret=True)))
    tp, tt = torch.from_numpy(flat_p), torch.from_numpy(targets)
    idx, b_idx, within_t = tper.kernel_order_sample(tp, tt, block_size)
    np.testing.assert_array_equal(idx.numpy(), want)
    _, jb, jw = jper._split_targets(jp, jt, block_size)
    np.testing.assert_array_equal(b_idx.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(within_t.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tper.kernel_block_sums(tp, block_size).numpy(),
                                  tper.block_sums(tp, block_size).numpy())
    assert (flat_p[idx.numpy()] > 0).all()  # a zero-priority slot is never drawn


# float32 prefixes of a plane's total, summed in two orders, stay this close
# (relative to the total) to each other and to a float64 running sum: a few
# dozen roundings of 2^-24 on the path to any prefix (runs of 32, shuffle
# scans, a window scan), far below 1e-5
PREFIX_REL = 1e-5


@pytest.mark.parametrize("n,block_size", [(5000, 64), (70_000, 1024), (9000, 1), (20_000, 4096),
                                          (50_000, 1000)])
def test_kernel_order_sample_brackets_real_priorities(n, block_size):
    """On real priorities (``u**0.6``, a fifth zero) each index's float64
    running-sum interval holds its target, and a block choice differs from
    ``split_targets``' only at a block boundary.  (9000, 1) scans its 9000
    block sums in two windows; 4096 and 1000 scan a block in segments."""
    rng = np.random.default_rng(n)
    flat_p = (rng.uniform(size=n) ** 0.6).astype(np.float32)
    flat_p[rng.uniform(size=n) < 0.2] = 0.0
    targets = _targets(flat_p, 64, seed=n + 1)
    tp, tt = torch.from_numpy(flat_p), torch.from_numpy(targets)
    idx, b_idx, _ = tper.kernel_order_sample(tp, tt, block_size)
    idx = idx.numpy()
    cum = np.cumsum(flat_p.astype(np.float64))
    tol = PREFIX_REL * cum[-1]
    t = targets.astype(np.float64)
    before = np.where(idx > 0, cum[np.maximum(idx - 1, 0)], 0.0)
    assert (before <= t + tol).all() and (t <= cum[idx] + tol).all()
    assert (flat_p[idx] > 0).all()
    plain_b, _ = tper.split_targets(tp, tt, block_size)
    bounds = cum[np.minimum((np.minimum(b_idx, plain_b).numpy() + 1) * block_size, n) - 1]
    moved = (b_idx != plain_b).numpy()
    assert (np.abs(t - bounds)[moved] <= tol).all()


def test_unknown_methods_and_devices_raise():
    flat_p = torch.ones(64)
    with pytest.raises(ValueError, match="unknown sampling method"):
        tper.proportional_sample(flat_p, torch.ones(2), method="auto")
    with pytest.raises(ValueError, match="unknown update method"):
        tper.update_priorities_blocks(flat_p, torch.tensor([1]), torch.ones(1), method="auto")
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no PER sample kernel"):
        cuda_per.sample_kernel(torch.ones(64, **meta), torch.ones(2, **meta), 64)
    with pytest.raises(ValueError, match="targets is on"):
        cuda_per.sample_kernel(torch.ones(64), torch.ones(2, **meta), 64)
    with pytest.raises(ValueError, match="no PER update kernel"):
        cuda_per.update_kernel(torch.ones(64, **meta), torch.zeros(2, dtype=torch.int64, **meta),
                               torch.ones(2, **meta), block_size=64)
    with pytest.raises(ValueError, match="block_sums"):
        tper.update_priorities_blocks(flat_p, torch.tensor([1]), torch.ones(1),
                                      block_sums=torch.ones(3), block_size=16)


def _update_case(n, bs, seed):
    rng = np.random.default_rng(seed)
    flat = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
    nb = -(-n // bs)
    padded = np.zeros(nb * bs, np.float32)
    padded[:n] = flat
    sums = padded.reshape(nb, bs).sum(axis=1).astype(np.float32)
    M = 48
    idx = rng.integers(0, n, size=M)
    idx[10] = idx[3]  # a duplicate slot: the later write wins
    idx[20] = idx[3]
    idx[30] = (idx[5] // bs) * bs + (idx[5] + 1) % bs  # a same-block revisit
    idx[31] = n + 5  # out of range: clipped to n - 1
    idx[32] = -4  # clipped to 0
    new_p = rng.uniform(0.1, 9.0, size=M).astype(np.float32)
    return flat, sums, idx.astype(np.int32), new_p


@pytest.mark.parametrize("with_sums", [True, False], ids=["sums", "plane_only"])
@pytest.mark.parametrize("n,bs", [(300, 64), (4096, 1024), (5000, 1024)])
def test_update_matches_jax(n, bs, with_sums):
    flat, sums, idx, new_p = _update_case(n, bs, seed=n + bs)
    jargs = (jnp.asarray(flat), jnp.asarray(idx), jnp.asarray(new_p))
    jsums = jnp.asarray(sums) if with_sums else None
    ref_p, ref_s = jper.update_priorities_blocks(*jargs, block_sums=jsums, block_size=bs,
                                                 method="xla")
    pal_p, pal_s = jper.update_priorities_blocks(*jargs, block_sums=jsums, block_size=bs,
                                                 method="pallas", interpret=True)
    for method in tper.UPDATE_METHODS:
        plane = torch.from_numpy(flat.copy())
        tsums = torch.from_numpy(sums.copy()) if with_sums else None
        got_p, got_s = tper.update_priorities_blocks(
            plane, torch.from_numpy(idx), torch.from_numpy(new_p), block_sums=tsums,
            block_size=bs, method=method,
        )
        assert got_p is plane and got_s is tsums  # written in place
        for want in (ref_p, pal_p):
            np.testing.assert_allclose(plane.numpy(), np.asarray(want), atol=1e-5, err_msg=method)
        if with_sums:
            for want in (ref_s, pal_s):
                np.testing.assert_allclose(tsums.numpy(), np.asarray(want), atol=1e-5,
                                           rtol=1e-5, err_msg=method)
        else:
            assert ref_s is None and pal_s is None and got_s is None
    # the JAX package's ordered loop, by hand: clipped, last write wins
    want = flat.copy()
    for i, v in zip(np.clip(idx, 0, n - 1), new_p):
        want[i] = v
    np.testing.assert_array_equal(plane.numpy(), want)


@pytest.mark.parametrize("with_sums", [True, False], ids=["sums", "plane_only"])
@pytest.mark.parametrize("case", ["heavy_duplicates", "chunks"])
def test_update_duplicates_and_chunks_match_jax(case, with_sums):
    """Each of 128 slots hit four times in shuffled order (M = 512), and
    M = 3 x MAX_UPDATES updates over 3000 slots, so duplicates would fall
    within and across the card's chunks; out-of-range indices in both.
    Through the kernel wrapper (on the host: the plain version) and the
    dispatch, against the JAX package's ordered loop."""
    n, bs = 20_000, 1024
    rng = np.random.default_rng(3 if case == "chunks" else 4)
    flat = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
    if case == "chunks":
        M = 3 * cuda_per.MAX_UPDATES
        idx = rng.integers(0, 3000, size=M)
    else:
        M = 512
        idx = rng.permutation(np.repeat(rng.choice(n, M // 4, replace=False), 4))
    idx[7], idx[9] = n + 11, -5
    new_p = rng.uniform(0.1, 9.0, size=M).astype(np.float32)
    sums = tper.block_sums(torch.from_numpy(flat), bs).numpy()
    ref_p, ref_s = jper.update_priorities_blocks(
        jnp.asarray(flat), jnp.asarray(idx.astype(np.int32)), jnp.asarray(new_p),
        block_sums=jnp.asarray(sums) if with_sums else None, block_size=bs, method="xla")
    want = flat.copy()
    for i, v in zip(np.clip(idx, 0, n - 1), new_p):
        want[i] = v
    np.testing.assert_array_equal(np.asarray(ref_p), want)
    before = cuda_per.update_launches
    for update in (cuda_per.update_kernel,
                   lambda *a: tper.update_priorities_blocks(*a, method="pallas")):
        plane = torch.from_numpy(flat.copy())
        tsums = torch.from_numpy(sums.copy()) if with_sums else None
        update(plane, torch.from_numpy(idx), torch.from_numpy(new_p), tsums, bs)
        np.testing.assert_array_equal(plane.numpy(), want)
        if with_sums:
            np.testing.assert_allclose(tsums.numpy(), np.asarray(ref_s), atol=1e-5, rtol=1e-5)
    assert cuda_per.update_launches == before  # the host launches nothing
