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
card (``chip_smoke.py`` phase ``flash_attn``).
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
