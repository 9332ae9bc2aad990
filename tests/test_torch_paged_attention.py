"""Paged decode attention in the PyTorch port against the JAX package.

The same numpy pools, queries and tables go through ``scalerl_tpu.ops.
pallas_paged_attention`` (the XLA reference, and the Pallas kernel in
interpret mode) and through the port's plain version and its CUDA-kernel
wrapper, which runs the plain version on host tensors.  The kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
Tolerance: JAX's own pin of kernel against reference, 1e-5
(tests/test_paging.py:362).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import cuda_paged_attention
from scalerl_torch.ops.attention import full_attention
from scalerl_torch.ops.paged_attention import paged_attention_reference
from scalerl_tpu.ops import pallas_paged_attention as jpa
from scalerl_tpu.ops.ring_attention import full_attention as jax_full_attention

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def pools():
    """Pools [9, 4, 2, 8] (null page 0 included) and their twins with
    pages 1, 2 copied into 7, 8 and 6, 3, for the layout cases."""
    rng = np.random.default_rng(3)
    k = rng.normal(size=(9, 4, 2, 8)).astype(np.float32)
    v = rng.normal(size=(9, 4, 2, 8)).astype(np.float32)
    q = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    return dict(k=k, v=v, q=q)


def _both(q, k, v, table, lengths):
    """(JAX reference, JAX Pallas interpret, port plain, port wrapper)."""
    table = np.asarray(table, np.int32)
    lengths = np.asarray(lengths, np.int32)
    jargs = [jnp.asarray(x) for x in (q, k, v, table, lengths)]
    targs = [torch.from_numpy(np.asarray(x)) for x in (q, k, v, table, lengths)]
    return (
        np.asarray(jpa.paged_attention_reference(*jargs)),
        np.asarray(jpa.paged_decode_attention(*jargs, interpret=True)),
        paged_attention_reference(*targs).numpy(),
        cuda_paged_attention.paged_decode_attention(*targs).numpy(),
    )


@pytest.mark.parametrize(
    "table,lengths",
    [
        ([[1, 2, 3], [4, 5, 6]], [12, 8]),  # contiguous, full pages
        ([[7, 1, 5], [3, 8, 2]], [12, 12]),  # fragmented
        ([[5, 3, 0], [6, 0, 0]], [7, 2]),  # partial last page + null junk
        ([[4, 0, 0], [2, 6, 1]], [1, 9]),  # a length-1 lane
    ],
)
def test_plain_version_matches_jax_across_layouts(pools, table, lengths):
    ref, pallas, plain, wrapped = _both(pools["q"][:2], pools["k"], pools["v"], table, lengths)
    np.testing.assert_allclose(pallas, ref, atol=TOL)
    np.testing.assert_allclose(plain, ref, atol=TOL)
    np.testing.assert_array_equal(wrapped, plain)


def test_shared_table_layout_matches_private_copy(pools):
    """The same physical pages in several lanes' tables (a CoW-forked
    group) attend like a private-copy layout of the same content."""
    k, v = pools["k"].copy(), pools["v"].copy()
    shared = [[1, 2, 4], [1, 2, 5], [1, 2, 6]]
    lengths = [10, 11, 9]
    ref, pallas, plain, _ = _both(pools["q"], k, v, shared, lengths)
    np.testing.assert_allclose(plain, ref, atol=TOL)
    np.testing.assert_allclose(pallas, ref, atol=TOL)
    k[7], k[8], v[7], v[8] = k[1], k[2], v[1], v[2]
    private = paged_attention_reference(*(torch.from_numpy(np.asarray(x)) for x in (
        pools["q"], k, v, np.array([[1, 2, 4], [7, 8, 5], [1, 2, 6]], np.int32),
        np.array(lengths, np.int32))))
    np.testing.assert_allclose(private.numpy(), plain, atol=1e-6)


def test_fragmentation_independence(pools):
    k, v = pools["k"].copy(), pools["v"].copy()
    k[6], k[3], v[6], v[3] = k[1], k[2], v[1], v[2]
    q = pools["q"][:1]
    a = _both(q, pools["k"], pools["v"], [[1, 2]], [6])
    b = _both(q, k, v, [[6, 3]], [6])
    np.testing.assert_allclose(b[2], a[2], atol=1e-6)
    np.testing.assert_allclose(b[2], a[0], atol=TOL)


def test_bfloat16_on_the_host_matches_jax(pools):
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (pools["q"][:2], pools["k"], pools["v"]))
    table, lengths = jnp.asarray([[7, 1, 5], [3, 8, 2]], jnp.int32), jnp.asarray([12, 5], jnp.int32)
    want = np.asarray(jpa.paged_attention_reference(q, k, v, table, lengths).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = cuda_paged_attention.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(np.array(table)), torch.from_numpy(np.array(lengths)))
    assert got.dtype == torch.bfloat16
    # both accumulate in float32 and round once to bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7)


def test_wrapper_runs_the_plain_version_on_the_host_and_counts_no_launch(pools):
    before = cuda_paged_attention.launches
    args = [torch.from_numpy(np.asarray(x)) for x in (
        pools["q"][:2], pools["k"], pools["v"], np.array([[1, 2, 3], [4, 5, 6]], np.int32),
        np.array([12, 8], np.int32))]
    out = cuda_paged_attention.paged_decode_attention(*args)
    np.testing.assert_array_equal(out.numpy(), paged_attention_reference(*args).numpy())
    assert cuda_paged_attention.launches == before


def test_wrapper_refuses_grad_bad_dtypes_and_shapes(pools):
    q, k, v = (torch.from_numpy(x) for x in (pools["q"][:2], pools["k"], pools["v"]))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lengths = torch.tensor([12, 8], dtype=torch.int32)
    call = cuda_paged_attention.paged_decode_attention
    with pytest.raises(RuntimeError, match="grad-free"):
        call(q.clone().requires_grad_(True), k, v, table, lengths)
    with pytest.raises(RuntimeError, match="grad-free"):
        call(q, k.clone().requires_grad_(True), v, table, lengths)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(q.double(), k.double(), v.double(), table, lengths)
    with pytest.raises(ValueError, match="share a dtype"):
        call(q, k.bfloat16(), v, table, lengths)
    with pytest.raises(ValueError, match="one query token"):
        call(torch.cat([q, q], dim=1), k, v, table, lengths)
    with pytest.raises(ValueError, match="k_pages"):
        call(q, k[:, :, :1], v, table, lengths)
    with pytest.raises(ValueError, match="v_pages"):
        call(q, k, v[:5], table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        call(q, k, v, table[:1], lengths)
    with pytest.raises(ValueError, match="lengths"):
        call(q, k, v, table, lengths.float())


def test_make_paged_attn_fn_selects_kernel_or_plain():
    make = cuda_paged_attention.make_paged_attn_fn
    assert make("pallas") is cuda_paged_attention.paged_decode_attention
    assert make("auto") is cuda_paged_attention.paged_decode_attention
    assert make("xla") is paged_attention_reference
    with pytest.raises(ValueError, match="auto | pallas | xla"):
        make("triton")


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 5, 2, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal))
    got = full_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
