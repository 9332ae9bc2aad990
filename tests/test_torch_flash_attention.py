"""The port's flash attention against the JAX package.

The same numpy inputs go through the port's ``flash_attention`` on host
tensors (its plain version, ``ops/attention.py::flash_attention_reference``,
and autograd, through the ``torch.autograd.Function`` of
``ops/cuda_flash_attention.py``) and through the JAX package's Pallas
``flash_attention`` in interpret mode, with the layouts and tolerances of
tests/test_pallas_attention.py: causal and not at T 16 and 100 (not a block
multiple), cross lengths 24/56, gradients under a cotangent (5e-5), bf16
inputs (5e-2).  Besides: top-left causal masking with Tq != Tk against a
numpy oracle, lse against a direct log-sum-exp and against the Pallas
forward's, and the inputs the op refuses.  The CUDA kernels run only on a
card (``chip_smoke.py`` phase ``flash_attn``); their bfloat16 arithmetic
(the tensor-core forward, dq and dk/dv, which round P and dS to bfloat16
before their products) is emulated here tile by tile and held against the
Pallas kernels and the float32 reference at the card check's tolerance, and
so are the float32 kernels' summation orders (the forward's and dq's keys,
dk/dv's queries split across warps, combined in warp order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import cuda_flash_attention as cfa
from scalerl_torch.ops.attention import flash_attention_reference
from scalerl_tpu.ops import pallas_attention as jpa

torch.set_num_threads(1)

VALUE_TOL = 2e-5
GRAD_TOL = 5e-5
BF16_TOL = 5e-2
# chip_smoke.py's FLASH_BF16_REL_TOL and FLASH_LSE_TOL, the card check's
# bounds on bfloat16 o and gradients (of the largest element) and on lse
BF16_REL_TOL = 2.0 ** -6
LSE_TOL = 2e-5


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal, dtype=torch.float32):
    return cfa.flash_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)), causal=causal)


def _jax(q, k, v, causal, block, dtype=jnp.float32):
    fn = jax.jit(lambda a, b, c: jpa.flash_attention(a, b, c, causal=causal, block_q=block,
                                                     block_k=block))
    return fn(*(jnp.asarray(x, dtype) for x in (q, k, v)))


def _oracle(q, k, v, causal):
    """float64 numpy attention; causal = key j visible to query i iff j <= i."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        visible = np.arange(k.shape[1])[None, :] <= np.arange(q.shape[1])[:, None]
        s = np.where(visible, s, -np.inf)
    lse = np.log(np.sum(np.exp(s - s.max(-1, keepdims=True)), -1)) + s.max(-1)
    p = np.exp(s - lse[..., None])
    return np.einsum("bhqk,bkhd->bqhd", p, v), lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [16, 100])  # 100: not a block multiple in the Pallas kernel
def test_flash_matches_jax_flash(causal, T):
    q, k, v = _inputs(T, 2, T, T, 2, 16)
    got = _port(q, k, v, causal)
    want = _jax(q, k, v, causal, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VALUE_TOL, rtol=VALUE_TOL)


def test_flash_cross_lengths_match_jax():
    q, k, v = _inputs(1, 1, 24, 56, 2, 8)
    got = _port(q, k, v, causal=False)
    want = _jax(q, k, v, False, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VALUE_TOL, rtol=VALUE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax(causal):
    """dq, dk, dv under a cotangent: the port's autograd of the plain version
    against the Pallas dq and dk/dv kernels."""
    q, k, v = _inputs(2, 2, 48, 48, 2, 8)
    cot = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = cfa.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.tensor(cot))

    def loss(a, b, c):
        return jnp.sum(jpa.flash_attention(a, b, c, causal=causal, block_q=16, block_k=16) * cot)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_bfloat16_matches_jax():
    q, k, v = _inputs(3, 1, 32, 32, 2, 16)
    got = _port(q, k, v, causal=True, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax(q, k, v, True, block=16, dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("Tq,Tk", [(24, 56), (56, 24), (1, 9)])
def test_causal_is_top_left_aligned_with_cross_lengths(Tq, Tk):
    """Key j is visible to query i iff j <= i, also when Tq != Tk: rows past
    Tk see every key, keys past Tq are seen by none (zero dk, dv)."""
    q, k, v = _inputs(4, 2, Tq, Tk, 2, 8)
    want, _ = _oracle(q, k, v, causal=True)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = cfa.flash_attention(*leaves, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=VALUE_TOL, rtol=0)
    _, dk, dv = torch.autograd.grad(out.sum(), leaves)
    assert torch.all(dk[:, Tq:] == 0) and torch.all(dv[:, Tq:] == 0)
    if Tq > Tk:
        full, _ = _oracle(q[:, Tk:], k, v, causal=False)
        np.testing.assert_allclose(out.detach().numpy()[:, Tk:], full, atol=VALUE_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_is_the_log_sum_exp_and_matches_pallas(causal):
    q, k, v = _inputs(5, 2, 40, 40, 2, 16)
    o, lse = flash_attention_reference(*(torch.tensor(x) for x in (q, k, v)), causal)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 40)
    want_o, want_lse = _oracle(q, k, v, causal)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), want_o, atol=VALUE_TOL, rtol=0)
    # the Pallas forward's own lse (padded to its block multiple)
    _, res = jpa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, None, 16, 16, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[:, :, :40], atol=1e-5, rtol=0)


def test_causal_row_zero_sees_one_key_without_nan():
    """Causal query 0 sees key 0 alone: its output is v[0], its lse its one
    score, and its gradients are finite (the masked scores' -inf never meet
    another -inf)."""
    q, k, v = _inputs(6, 1, 5, 5, 2, 8)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = flash_attention_reference(*leaves, True)
    np.testing.assert_allclose(o[:, 0].detach().numpy(), v[:, 0], atol=1e-6, rtol=0)
    score0 = np.einsum("bhd,bhd->bh", q[:, 0], k[:, 0]) / np.sqrt(8)
    np.testing.assert_allclose(lse[:, :, 0].detach().numpy(), score0, atol=1e-6, rtol=0)
    grads = torch.autograd.grad(o.sum() + lse.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_strided_views_of_a_fused_projection():
    """q, k, v as slices of one [B, T, 3 H D] projection, as the model hands
    them over, give what contiguous copies give."""
    B, T, H, D = 2, 12, 2, 8
    qkv = torch.tensor(np.random.default_rng(7).normal(size=(B, T, 3 * H * D)).astype(np.float32))
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    got = cfa.flash_attention(q, k, v, causal=True)
    want = cfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 4, 2, 8), torch.zeros(2, 4, 3, 8), torch.zeros(2, 4, 3, 8)),
     "share B, H and D"),
    (lambda: (torch.zeros(2, 4, 2, 8), torch.zeros(2, 4, 2, 8), torch.zeros(2, 5, 2, 8)),
     r"\[B, Tk, H, D\]"),
    (lambda: (torch.zeros(4, 2, 8), torch.zeros(4, 2, 8), torch.zeros(4, 2, 8)),
     r"\[B, Tq, H, D\]"),
    (lambda: (torch.zeros(1, 4, 1, 136), torch.zeros(1, 4, 1, 136), torch.zeros(1, 4, 1, 136)),
     "head_dim 136"),
    (lambda: (torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8).bfloat16(), torch.zeros(1, 4, 1, 8)),
     "share a dtype"),
    (lambda: tuple(torch.zeros(1, 4, 1, 8, dtype=torch.float64) for _ in range(3)),
     "float32 or bfloat16"),
    (lambda: (torch.zeros(1, 4, 1, 8), torch.zeros(1, 0, 1, 8), torch.zeros(1, 0, 1, 8)),
     "empty axis"),
    (lambda: (torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8, device="meta"),
              torch.zeros(1, 4, 1, 8)), "is on meta"),
], ids=["heads", "kv_shape", "rank", "head_dim", "dtype_mix", "float64", "empty", "device_mix"])
def test_flash_refuses_what_the_kernels_do_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        cfa.flash_attention(*make())


def test_kernel_entry_points_refuse_host_tensors():
    """The kernels' own wrappers take CUDA tensors only: a host tensor there
    is an error, never a quiet fallback (the op routes host tensors to the
    plain version before any kernel wrapper)."""
    q = torch.zeros(1, 4, 1, 8)
    launches = (cfa.fwd_launches, cfa.dq_launches, cfa.dkv_launches)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        cfa.flash_forward_kernel(q, q, q, 1.0, True)
    cfa.flash_attention(q, q, q, causal=True)
    assert (cfa.fwd_launches, cfa.dq_launches, cfa.dkv_launches) == launches


LOG2E = 1.4426950408889634


def _bf16(x):
    """x rounded to bfloat16 (nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, do, causal, scale, tile=64):
    """The bfloat16 kernels' arithmetic in plain torch: o, lse, dq, dk, dv.

    Forward (csrc/flash_attention.cu, tc::flash_fwd_kernel): key tiles of
    64, S = q k^T from exact bf16 products summed in float32, an online
    softmax on exp2 with the scale (times log2 e) applied to S in float32,
    P rounded to bf16 before P v, o = acc / l rounded to bf16, lse = m ln 2
    + log l.  dq (tc::flash_bwd_dq_kernel): delta = sum do * o in float32
    from the rounded o; key tiles of 64, P = exp2(S scale log2 e - lse
    log2 e), dS = P (dP - delta) rounded to bf16 before dq += dS k, summed
    over the tiles in float32; scale times dq at the end.  dk/dv
    (tc::flash_bwd_dkv_kernel): query tiles of 64, the same P^T and dS^T,
    both rounded to bf16 before dv += P^T do and dk += dS^T q; scale times
    dk at the end.
    """
    q, k, v, do = (t.float() for t in (q, k, v, do))  # bf16 values, exactly
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    rows = torch.arange(Tq)[:, None]
    neg_inf = torch.tensor(float("-inf"))

    def visible(k0, n):
        cols = torch.arange(k0, k0 + n)[None, :]
        return (cols <= rows) if causal else torch.ones(Tq, n, dtype=torch.bool)

    m = torch.full((B, H, Tq), float("-inf"))
    l = torch.zeros(B, H, Tq)
    acc = torch.zeros(B, H, Tq, D)
    for k0 in range(0, Tk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kt) * (scale * LOG2E)
        s = torch.where(visible(k0, kt.shape[1]), s, neg_inf)
        m_new = torch.maximum(m, s.amax(-1))
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.exp2(m - safe)
        p = torch.exp2(s - safe[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vt)
        m = m_new
    o = _bf16(acc * (1.0 / l.clamp(min=1e-30))[..., None]).permute(0, 2, 1, 3)  # [B, Tq, H, D]
    lse = torch.where(l > 0, m * np.log(2.0) + torch.log(l), neg_inf)

    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    row_lse = torch.where(torch.isneginf(lse), 0.0, lse)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = visible(0, Tk)
    p = torch.where(mask, torch.exp2(s * (scale * LOG2E) - row_lse[..., None] * LOG2E), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None])
    dq = torch.zeros(B, Tq, H, D)
    for k0 in range(0, Tk, tile):
        sl = slice(k0, k0 + tile)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", _bf16(ds[..., sl]), k[:, sl])
    dq = _bf16(dq * scale)
    dk = torch.zeros(B, Tk, H, D)
    dv = torch.zeros(B, Tk, H, D)
    for i0 in range(0, Tq, tile):
        sl = slice(i0, i0 + tile)
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", _bf16(p[:, :, sl]), do[:, sl])
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", _bf16(ds[:, :, sl]), q[:, sl])
    return o, lse, dq, _bf16(dk * scale), _bf16(dv)


def _float32_reference(q, k, v, do, causal, scale):
    """o, lse and the gradients of the plain version in float32 on the same
    (bf16-valued) inputs."""
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention_reference(*leaves, causal, scale)
    return (o.detach(), lse.detach()) + torch.autograd.grad(o, leaves, do.float())


def _rel_err(got, want):
    """max |got - want| over max(max |want|, 1), as the card check holds bf16."""
    return (got.float() - want.float()).abs().max().item() / max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (8, 17, 17, 16, 64, True),  # the transformer learner's attention
    (1, 70, 150, 2, 32, True),  # ragged, cross lengths, causal top-left
    (1, 80, 80, 1, 128, True),  # D = 128: the padded head dims' widest
    (1, 100, 40, 2, 16, False),  # not causal, Tq > Tk, keys in one ragged tile
], ids=["learner_8x17x16x64", "ragged_cross_70_150", "D128_T80", "full_cross_100_40"])
def test_bf16_tensor_core_arithmetic_stays_inside_the_card_tolerance(B, Tq, Tk, H, D, causal):
    """Rounding P and dS to bf16 before their products, as the bf16 kernels
    (forward, dq, dk/dv) do, keeps o and every gradient within 2^-6 of the
    largest element of the
    float32 reference and of the Pallas kernels (interpret mode), and lse
    within 2e-5: the bounds of the card check, and well inside the 2^-4 the
    bf16 learner's gradients are held to."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.normal(size=(B, T, H, D)).astype(np.float32)).bfloat16()
               for T in (Tq, Tk, Tk))
    do = torch.tensor(rng.normal(size=(B, Tq, H, D)).astype(np.float32)).bfloat16()
    scale = 1.0 / np.sqrt(D)
    emu = _tensor_core_emulation(q, k, v, do, causal, scale)
    ref = _float32_reference(q, k, v, do, causal, scale)
    names = ("o", "lse", "dq", "dk", "dv")
    if causal:
        assert torch.equal(emu[0][:, 0], v.float()[:, 0]), "causal row 0 is v[0] exactly"
    assert (emu[1] - ref[1]).abs().max().item() <= LSE_TOL
    for name, e, r in zip(names, emu, ref):
        if name != "lse":
            assert _rel_err(e, r) <= BF16_REL_TOL, (name, _rel_err(e, r))

    def loss(a, b, c):
        out = jpa.flash_attention(a, b, c, causal=causal, block_q=16, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do.float().numpy()))

    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    jo = jax.jit(lambda a, b, c: jpa.flash_attention(a, b, c, causal=causal, block_q=16,
                                                     block_k=16))(jq, jk, jv)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    for name, e, j in zip(("o", "dq", "dk", "dv"), (emu[0],) + emu[2:], (jo,) + tuple(jgrads)):
        want = torch.tensor(np.asarray(j, np.float32))
        assert _rel_err(e, want) <= BF16_REL_TOL, (name, _rel_err(e, want))


def _micro_tile_forward(q, k, v, causal, scale, tile=64, warps=4):
    """The float32 forward's summation order in plain torch: o, lse.

    csrc/flash_attention.cu, mt::flash_fwd_kernel: key tiles of 64, warp w
    taking keys 16 w .. 16 w + 15 of each; a warp's scores q . k times
    scale, masked to -inf, and its own online softmax in natural exp (m its
    running max, l its sum, o its P v); the warps' partials combined in
    warp order at the end: M = max m_w, o = sum_w exp(m_w - M) o_w / L (a
    division per element), L = sum_w exp(m_w - M) l_w, lse = M + log L
    (-inf where L = 0).
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    per = tile // warps
    rows = torch.arange(Tq)[:, None]
    neg_inf = torch.tensor(float("-inf"))
    m = torch.full((warps, B, H, Tq), float("-inf"))
    l = torch.zeros(warps, B, H, Tq)
    acc = torch.zeros(warps, B, H, Tq, D)
    for k0 in range(0, Tk, tile):
        for w in range(warps):
            lo = k0 + per * w
            kt, vt = k[:, lo:lo + per], v[:, lo:lo + per]
            if kt.shape[1] == 0:
                continue
            s = torch.einsum("bqhd,bkhd->bhqk", q, kt) * scale
            if causal:
                s = torch.where(torch.arange(lo, lo + kt.shape[1])[None, :] <= rows, s, neg_inf)
            m_new = torch.maximum(m[w], s.amax(-1))
            safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            corr = torch.exp(m[w] - safe)
            p = torch.exp(s - safe[..., None])
            l[w] = l[w] * corr + p.sum(-1)
            acc[w] = acc[w] * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vt)
            m[w] = m_new
    mx = m.amax(0)
    safe = torch.where(torch.isneginf(mx), 0.0, mx)
    f = torch.exp(m - safe)
    total = (l * f).sum(0)
    denom = total.clamp(min=1e-30)
    o = ((acc * f[..., None]).sum(0) / denom[..., None]).permute(0, 2, 1, 3)
    lse = torch.where(total > 0, mx + torch.log(denom), neg_inf)
    return o, lse


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal,block", [
    (1, 100, 100, 2, 16, True, 32),  # ragged causal: two 64-key tiles, the last partial
    (1, 24, 150, 2, 8, False, 16),  # cross lengths: three tiles, warps past Tk idle
], ids=["ragged_causal_T100", "cross_24_150"])
def test_float32_micro_tile_forward_matches_pallas(B, Tq, Tk, H, D, causal, block):
    """The float32 forward's key split across warps and its warp-order
    combine give the Pallas kernel's o (interpret mode) within the card
    check's 2e-5, and the log-sum-exp of a float64 oracle."""
    q, k, v = _inputs(21, B, Tq, Tk, H, D)
    scale = 1.0 / np.sqrt(D)
    o, lse = _micro_tile_forward(*(torch.tensor(x) for x in (q, k, v)), causal, scale)
    want = _jax(q, k, v, causal, block=block)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=VALUE_TOL, rtol=VALUE_TOL)
    want_o, want_lse = _oracle(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), want_o, atol=VALUE_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_TOL, rtol=0)


# chip_smoke.py's FLASH_GRAD_REL_TOL: the card check's bound on float32
# gradients, relative to each gradient's largest element
FLASH_GRAD_REL_TOL = 1e-4


def _micro_tile_backward(q, k, v, do, o, lse, causal, scale, tile=64, warps=4, rows=16):
    """The float32 dq and dk/dv kernels' summation order in plain torch.

    csrc/flash_attention.cu, mt::flash_bwd_dq_kernel: delta = sum_d do * o;
    key tiles of 64, warp w taking keys 16 w .. 16 w + 15 of each; S = q . k
    times scale, P = exp(S - lse) (lse = -inf read as 0) masked to 0, dS = P
    (dP - delta); each warp sums dS k over its keys, the warps' partials
    combine in warp order, and scale multiplies dq at the end.
    mt::flash_bwd_dkv_kernel: a block owns 16 keys and walks the queries in
    tiles of 64 from its first key (from 0 without causal), warp w taking
    queries 16 w .. 16 w + 15 of each; each warp sums P^T do and dS^T q over
    its queries, the warps' partials combine in warp order, and scale
    multiplies dk at the end.  Returns dq, dk, dv and delta.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    per = tile // warps
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    safe = torch.where(torch.isneginf(lse), 0.0, lse)

    def probs(i0, i1, j0, j1):
        """P and dS [B, H, i1 - i0, j1 - j0] of queries i0..i1 and keys j0..j1."""
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i0:i1], k[:, j0:j1]) * scale
        p = torch.exp(s - safe[:, :, i0:i1, None])
        if causal:
            visible = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
            p = torch.where(visible, p, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, i0:i1], v[:, j0:j1])
        return p, p * (dp - delta[:, :, i0:i1, None])

    dq_w = torch.zeros(warps, B, Tq, H, D)
    for k0 in range(0, Tk, tile):
        for w in range(warps):
            j0, j1 = k0 + per * w, min(k0 + per * (w + 1), Tk)
            if j0 < j1:
                _, ds = probs(0, Tq, j0, j1)
                dq_w[w] += torch.einsum("bhqk,bkhd->bqhd", ds, k[:, j0:j1])
    dk_w = torch.zeros(warps, B, Tk, H, D)
    dv_w = torch.zeros(warps, B, Tk, H, D)
    for r0 in range(0, Tk, rows):
        r1 = min(r0 + rows, Tk)
        for i0 in range(r0 if causal else 0, Tq, tile):
            for w in range(warps):
                a, b = i0 + per * w, min(i0 + per * (w + 1), Tq)
                if a < b:
                    p, ds = probs(a, b, r0, r1)
                    dv_w[w, :, r0:r1] += torch.einsum("bhqk,bqhd->bkhd", p, do[:, a:b])
                    dk_w[w, :, r0:r1] += torch.einsum("bhqk,bqhd->bkhd", ds, q[:, a:b])

    def in_warp_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    return (in_warp_order(dq_w) * scale, in_warp_order(dk_w) * scale, in_warp_order(dv_w),
            delta)


def _oracle_grads(q, k, v, do, causal):
    """dq, dk, dv of the float64 oracle's attention under the cotangent do."""
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / np.sqrt(q.shape[-1])
    if causal:
        visible = torch.arange(k.shape[1])[None, :] <= torch.arange(q.shape[1])[:, None]
        s = s.masked_fill(~visible, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), leaves[2])
    return torch.autograd.grad(out, leaves, torch.tensor(do, dtype=torch.float64))


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (1, 100, 100, 2, 16, True),  # ragged causal: two key tiles, the last partial
    (1, 24, 150, 2, 8, False),  # cross lengths: three key tiles, warps past Tk idle
    (1, 200, 200, 1, 128, True),  # the widest head dim, ragged query tiles per key block
], ids=["ragged_causal_T100_D16", "cross_24_150", "causal_T200_D128"])
def test_float32_micro_tile_backward_matches_pallas(B, Tq, Tk, H, D, causal):
    """The float32 dq and dk/dv kernels' tiling (keys or queries split across
    warps, partials combined in warp order, delta from do and o, scale where
    the kernels apply it) gives the Pallas backward's dq, dk and dv
    (interpret mode) within the card check's 1e-4 of the largest gradient,
    and the float64 oracle's."""
    q, k, v = _inputs(31, B, Tq, Tk, H, D)
    do = np.random.default_rng(32).normal(size=q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = _micro_tile_forward(tq, tk, tv, causal, scale)
    dq, dk, dv, delta = _micro_tile_backward(tq, tk, tv, tdo, o, lse, causal, scale)
    np.testing.assert_allclose(delta.numpy(), np.einsum("bqhd,bqhd->bhq", do, o.numpy()),
                               atol=1e-5, rtol=0)

    def loss(a, b, c):
        return jnp.sum(jpa.flash_attention(a, b, c, causal=causal, block_q=32, block_k=32) * do)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    oracle = _oracle_grads(q, k, v, do, causal)
    for name, got, jw, ow in zip(("dq", "dk", "dv"), (dq, dk, dv), want, oracle):
        jw = torch.tensor(np.asarray(jw))
        assert _rel_err(got, jw) <= FLASH_GRAD_REL_TOL, (name, _rel_err(got, jw))
        assert _rel_err(got, ow) <= FLASH_GRAD_REL_TOL, (name, _rel_err(got, ow))
