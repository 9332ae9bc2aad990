"""Paged decode attention in the PyTorch port against the JAX package.

The same numpy pools, queries and tables go through ``scalerl_tpu.ops.
pallas_paged_attention`` (the XLA reference, and the Pallas kernel in
interpret mode) and through the port's plain version and its CUDA-kernel
wrapper, which runs the plain version on host tensors.  The kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
Tolerance: JAX's own pin of kernel against reference, 1e-5
(tests/test_paging.py:362).  The CUDA kernel's summation order (each lane's
context split into 64-token blocks that walk 16-token chunks with an online
softmax, the splits' partials combined in split order) is emulated here and
held to the JAX reference and the Pallas kernel at the same tolerance.
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


def _split_kernel_emulation(q, k_pages, v_pages, table, lengths, chunk=16):
    """csrc/paged_attention.cu's arithmetic in plain torch (float32).

    Each lane's context is split into ``SPLIT_TOKENS``-token blocks; a split
    walks its tokens in chunks of 16: s = (q * scale) . k, the chunk's max
    m_c, m' = max(m, m_c), corr = exp(m - m'), p = exp(s - m') (0 past the
    length), l = l corr + sum p, acc = acc corr + sum_j p_j v_j in token
    order.  A lane whose length fits one split writes acc / max(l, 1e-30);
    otherwise its splits' (m, l, acc) combine in split order: M = max m_s,
    w_s = exp(m_s - M), l = sum l_s w_s, acc = sum acc_s w_s.  Table entries
    are clamped into [0, N)."""
    split = cuda_paged_attention.SPLIT_TOKENS
    q, k_pages, v_pages = (torch.as_tensor(np.asarray(x, np.float32)) for x in (q, k_pages, v_pages))
    table = torch.as_tensor(np.asarray(table, np.int64))
    lengths = torch.as_tensor(np.asarray(lengths, np.int64))
    B, _, H, D = q.shape
    N, ps = k_pages.shape[:2]
    M = table.shape[1]
    lens = lengths.clamp(max=M * ps)
    n_live = (lens + split - 1) // split  # [B]
    qs = q[:, 0] * (1.0 / D ** 0.5)  # [B, H, D]
    kflat = k_pages.reshape(N * ps, H, D)
    vflat = v_pages.reshape(N * ps, H, D)
    parts = []  # per split: (m [B, H], l [B, H], acc [B, H, D])
    for s0 in range(0, M * ps, split):
        m = torch.full((B, H), float("-inf"))
        l = torch.zeros(B, H)
        acc = torch.zeros(B, H, D)
        for c0 in range(s0, s0 + split, chunk):
            pos = torch.arange(c0, c0 + chunk)
            live = pos[None, :] < lens[:, None]  # [B, chunk]
            if not live.any():
                break
            pages = table[:, (pos // ps).clamp(max=M - 1)].clamp(0, N - 1)
            slots = pages * ps + pos % ps  # [B, chunk]
            kk, vv = kflat[slots], vflat[slots]  # [B, chunk, H, D]
            score = torch.einsum("bhd,bthd->bht", qs, kk)
            score = torch.where(live[:, None, :], score, float("-inf"))
            m_new = torch.maximum(m, score.amax(-1))
            m_new = torch.where(live.any(-1)[:, None], m_new, m)  # lanes done stay put
            safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - safe))
            p = torch.where(live[:, None, :], torch.exp(score - safe[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None]
            for j in range(chunk):  # p . V in token order
                acc = acc + p[:, :, j, None] * vv[:, j]
            m = m_new
        parts.append((m, l, acc))
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = max(int(n_live[b]), 1)
        if n == 1:
            m, l, acc = parts[0]
            out[b] = acc[b] / l[b].clamp(min=1e-30)[:, None]
            continue
        m_all = torch.stack([parts[s][0][b] for s in range(n)]).amax(0)
        l_all = torch.zeros(H)
        o = torch.zeros(H, D)
        for s in range(n):  # in split order
            w = torch.exp(parts[s][0][b] - m_all)
            l_all = l_all + parts[s][1][b] * w
            o = o + parts[s][2][b] * w[:, None]
        out[b] = o / l_all.clamp(min=1e-30)[:, None]
    return out[:, None].numpy()


def _split_layout(kind, rng, B, M, N, ps):
    """Lengths on and beside the 64-token splits (and 16-token chunks), a
    length of 1 and a full lane; ``shared``: lanes 1.. map lane 0's first
    pages (a forked group); ``junk``: random pages past each length."""
    full = M * ps
    lengths = np.array([1, 15, 16, 17, 63, 64, 65, 127, 128, 129, full - 1, full][:B], np.int32)
    order = rng.permutation(np.arange(1, N))
    table = np.zeros((B, M), np.int32)
    cursor = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = order[cursor:cursor + n]
        cursor += n
        if kind == "junk" and n < M:
            table[b, n:] = rng.integers(0, N, M - n)
    if kind == "shared":
        for b in range(1, B):
            n = min(-(-int(lengths[b]) // ps), 3)
            table[b, :n] = table[0, :n]
    return table, lengths


@pytest.mark.parametrize("kind", ["private", "shared", "junk"])
def test_split_kernel_order_matches_jax_reference_and_pallas(kind):
    """The CUDA kernel's split-and-combine summation order, emulated, gives
    the JAX reference's and the Pallas kernel's (interpret mode) outputs
    within 1e-5 at lengths of 1, on and beside the split and chunk
    boundaries and a full lane (160 tokens: three splits, the last ragged),
    in private, shared-prefix and junk-tailed tables."""
    rng = np.random.default_rng({"private": 40, "shared": 41, "junk": 42}[kind])
    B, H, D, ps, M = 12, 2, 8, 8, 20
    N = B * M + 2
    table, lengths = _split_layout(kind, rng, B, M, N, ps)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(N, ps, H, D)).astype(np.float32)
    v = rng.normal(size=(N, ps, H, D)).astype(np.float32)
    got = _split_kernel_emulation(q, k, v, table, lengths)
    ref, pallas, plain, _ = _both(q, k, v, table, lengths)
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL)
    np.testing.assert_allclose(got, plain, atol=TOL)


def test_split_scratch_sizes():
    """The wrapper sizes the per-call scratch by the kernel's split: (m, l,
    acc[D]) per (lane, head, split)."""
    assert cuda_paged_attention.SPLIT_TOKENS == 64
    assert cuda_paged_attention.num_splits(384) == 6
    assert cuda_paged_attention.num_splits(385) == 7
    assert cuda_paged_attention.num_splits(1) == 1
    assert cuda_paged_attention.scratch_floats(256, 8, 32, 384) == 256 * 8 * 6 * 34
