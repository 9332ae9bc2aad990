"""The port's segment attention against the JAX package.

The same numpy inputs go through the port's plain version
(``scalerl_torch.ops.attention.segment_attention_reference``), the JAX
reference and the Pallas segment flash kernel in interpret mode (blocks of
8, as tests/test_pallas_attention.py runs it), over that test's layouts:
several spans per row, a row entirely pad, boundaries straddling blocks,
one full segment, and a ragged tail.  Values at 2e-5, dq, dk, dv at 1e-5.
On host tensors the wrapper (``ops/cuda_segment_attention.py``) takes the
plain version through its autograd function; the CUDA kernels run only on a
card (``chip_smoke.py`` phase ``segment_attn``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import cuda_segment_attention as csa
from scalerl_torch.ops.attention import full_attention, segment_attention_reference
from scalerl_tpu.ops.pallas_attention import segment_attention_reference as jax_reference
from scalerl_tpu.ops.pallas_attention import segment_flash_attention as jax_flash

torch.set_num_threads(1)

VALUE_TOL = 2e-5
GRAD_TOL = 1e-5

LAYOUTS = {
    "multi_segment_pad_tails": (24, [[(0, 5, 1), (5, 14, 2), (14, 18, 3)], [(0, 20, 1)]]),
    "one_row_all_pad": (24, [[(0, 24, 1)], []]),
    "straddling_blocks": (24, [[(0, 7, 1), (7, 9, 2), (9, 24, 3)], [(0, 8, 1), (8, 16, 2)]]),
    "ragged_tail": (19, [[(0, 7, 1)], [(0, 11, 1), (11, 19, 2)]]),
}


def _layout(T, spans):
    seg = np.zeros((len(spans), T), np.int32)
    for b, row in enumerate(spans):
        for s, e, i in row:
            seg[b, s:e] = i
    return seg


def _inputs(seed, B, T, H=2, D=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))


def _torch_value_and_grads(fn, q, k, v, seg):
    """sum(sin(out)) and its gradients, the JAX gradient test's loss."""
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*leaves, torch.tensor(seg))
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_value_and_grads(fn, q, k, v, seg):
    seg = jnp.asarray(seg)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = fn(*args, seg)
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v, seg))), argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_version_matches_jax_reference_and_pallas_kernel(name):
    T, spans = LAYOUTS[name]
    seg = _layout(T, spans)
    q, k, v = _inputs(0, len(spans), T)
    out, grads = _torch_value_and_grads(segment_attention_reference, q, k, v, seg)
    for jax_fn in (jax_reference, lambda q, k, v, s: jax_flash(q, k, v, s, None, 8, 8, None)):
        want, want_grads = _jax_value_and_grads(jax_fn, q, k, v, seg)
        np.testing.assert_allclose(out, want, atol=VALUE_TOL, rtol=VALUE_TOL)
        for got, exp in zip(grads, want_grads):
            np.testing.assert_allclose(got, exp, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pad_queries_give_exact_zeros_and_pad_keys_zero_gradients(name):
    T, spans = LAYOUTS[name]
    seg = _layout(T, spans)
    q, k, v = _inputs(1, len(spans), T)
    out, (dq, dk, dv) = _torch_value_and_grads(csa.segment_flash_attention, q, k, v, seg)
    pad = seg == 0
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[pad], 0.0)
    for g in (dq, dk, dv):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g[pad], 0.0)
    assert np.abs(out[~pad]).max() > 0


def test_single_segment_is_causal_attention():
    q, k, v = _inputs(2, 1, 16)
    seg = torch.ones(1, 16, dtype=torch.int32)
    out = segment_attention_reference(*(torch.tensor(x) for x in (q, k, v)), seg)
    want = full_attention(*(torch.tensor(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=VALUE_TOL, rtol=VALUE_TOL)


@pytest.mark.parametrize("scale", [None, 0.5])
def test_wrapper_on_host_tensors_gives_the_plain_values_and_gradients(scale):
    """On CPU tensors the autograd function runs the plain version forward
    and backward, takes strided views, and asks for no gradient of the ids."""
    T, spans = LAYOUTS["multi_segment_pad_tails"]
    seg = torch.tensor(_layout(T, spans))
    B, H, D = 2, 2, 8
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.normal(size=(B, T, 3 * H * D)).astype(np.float32), requires_grad=True)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    launches = (csa.fwd_launches, csa.dq_launches, csa.dkv_launches)
    out = csa.segment_flash_attention(q, k, v, seg, scale)
    (grad,) = torch.autograd.grad(torch.sum(torch.sin(out)), [qkv])
    want = segment_attention_reference(q, k, v, seg, scale)
    (want_grad,) = torch.autograd.grad(torch.sum(torch.sin(want)), [qkv])
    np.testing.assert_array_equal(out.detach().numpy(), want.detach().numpy())
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), atol=1e-7, rtol=0)
    # the host path launches no kernel, so it counts none
    assert (csa.fwd_launches, csa.dq_launches, csa.dkv_launches) == launches


def test_autograd_function_returns_none_for_ids_and_scale():
    seg = torch.tensor(_layout(*LAYOUTS["straddling_blocks"]))
    leaves = [torch.tensor(x, requires_grad=True) for x in _inputs(4, 2, 24)]
    out = csa._SegmentFlash.apply(*leaves, seg, 0.25)
    grads = out.grad_fn.apply(torch.ones_like(out))
    assert len(grads) == 5 and grads[3] is None and grads[4] is None
    assert all(g.shape == leaves[0].shape for g in grads[:3])


def test_wrapper_refuses_bad_inputs():
    q, k, v = (torch.zeros(1, 4, 2, 8) for _ in range(3))
    seg = torch.ones(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="share one"):
        csa.segment_flash_attention(q, k[:, :3], v, seg)
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        csa.segment_flash_attention(q, k, v, seg[:, :3])
    with pytest.raises(ValueError, match="integer"):
        csa.segment_flash_attention(q, k, v, seg.float())
    with pytest.raises(ValueError, match="dtype"):
        csa.segment_flash_attention(q, k.double(), v, seg)
    with pytest.raises(ValueError, match="is on"):  # a host/card mix is refused, not copied
        csa.segment_flash_attention(q, k.to("meta"), v, seg)
    with pytest.raises(ValueError, match="no segment attention kernel"):
        csa.segment_forward_kernel(q, k, v, seg, 1.0)  # the kernel path never takes a host tensor


@pytest.mark.parametrize("impl,kernel", [("pallas", True), ("auto", True), ("xla", False)])
def test_make_segment_attn_fn(impl, kernel):
    fn = csa.make_segment_attn_fn(impl)
    assert (fn is csa.segment_flash_attention) if kernel else (fn is None)


def test_make_segment_attn_fn_refuses_unknown_impl():
    with pytest.raises(ValueError, match="auto | pallas | xla"):
        csa.make_segment_attn_fn("mosaic")
