"""The port's segment attention against the JAX package.

The same numpy inputs go through the port's plain version
(``scalerl_torch.ops.attention.segment_attention_reference``), the JAX
reference and the Pallas segment flash kernel in interpret mode (blocks of
8, as tests/test_pallas_attention.py runs it), over that test's layouts:
several spans per row, a row entirely pad, boundaries straddling blocks,
one full segment, and a ragged tail.  Values at 2e-5, dq, dk, dv at 1e-5.
On host tensors the wrapper (``ops/cuda_segment_attention.py``) takes the
plain version through its autograd function; the CUDA kernels run only on a
card (``chip_smoke.py`` phase ``segment_attn``).  Their summation orders --
the micro-tile forward, dq and dk/dv with their tile and warp skips and
warp-order combines -- are emulated in torch and held to the Pallas kernel
and a float64 oracle.
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



# chip_smoke.py's SEG_GRAD_REL_TOL: the card check's bound on float32
# gradients, relative to the largest gradient of the case
SEG_GRAD_REL_TOL = 1e-4


def _ranges_meet(a, b):
    """Two sets of segment ids (0 = pad) can share a live pair: the
    conservative test of csrc/segment_attention.cu on each side's (min
    nonzero, max)."""
    a, b = a[a > 0], b[b > 0]
    return a.numel() > 0 and b.numel() > 0 and bool(a.min() <= b.max() and b.min() <= a.max())


def _micro_tile_dkv(q, k, v, do, seg, lse, delta, scale, rows=16, tile=64, warps=4):
    """mt::seg_bwd_dkv_kernel's summation order in plain torch (float32).

    A block owns 16 keys of one row and walks the queries in tiles of 64
    from its first key, skipping a tile whose ids cannot meet the keys';
    warp w takes queries 16 w .. 16 w + 15 of a live tile and skips them
    when their ids cannot meet the keys'.  P^T = exp(S^T scale - lse) (lse =
    -inf read as 0) where query i sees key j (j <= i, seg[i] == seg[j] !=
    0), dS^T = P^T (dP^T - delta); each warp sums P^T do and dS^T q over its
    queries, the warps' partials add in warp order, and scale multiplies dk
    at the end.  Returns dk, dv [B, S, H, D]."""
    B, S, H, D = q.shape
    per = tile // warps
    safe = torch.where(torch.isneginf(lse), 0.0, lse)  # [B, H, S]
    pos = torch.arange(S)
    dk = torch.zeros(B, S, H, D)
    dv = torch.zeros(B, S, H, D)
    for b in range(B):
        for k0 in range(0, S, rows):
            k1 = min(k0 + rows, S)
            kid = seg[b, k0:k1]
            dk_w = torch.zeros(warps, k1 - k0, H, D)
            dv_w = torch.zeros(warps, k1 - k0, H, D)
            for i0 in range(k0, S, tile):
                if not _ranges_meet(seg[b, i0:i0 + tile], kid):
                    continue
                for w in range(warps):
                    a, z = i0 + per * w, min(i0 + per * (w + 1), S)
                    if a >= z or not _ranges_meet(seg[b, a:z], kid):
                        continue
                    sees = ((pos[k0:k1, None] <= pos[None, a:z])
                            & (kid[:, None] == seg[b, None, a:z]) & (kid[:, None] > 0))
                    st = torch.einsum("khd,qhd->hkq", k[b, k0:k1], q[b, a:z])  # S^T
                    p = torch.where(sees[None], torch.exp(st * scale - safe[b, :, None, a:z]), 0.0)
                    dpt = torch.einsum("khd,qhd->hkq", v[b, k0:k1], do[b, a:z])  # dP^T
                    ds = p * (dpt - delta[b, :, None, a:z])
                    dv_w[w] += torch.einsum("hkq,qhd->khd", p, do[b, a:z])
                    dk_w[w] += torch.einsum("hkq,qhd->khd", ds, q[b, a:z])
            dk_sum, dv_sum = dk_w[0], dv_w[0]
            for w in range(1, warps):  # warp order
                dk_sum, dv_sum = dk_sum + dk_w[w], dv_sum + dv_w[w]
            dk[b, k0:k1] = dk_sum * scale
            dv[b, k0:k1] = dv_sum
    return dk, dv


def _lse_delta(q, k, v, do, seg, scale):
    """lse [B, H, S] of the masked scores (-inf where a query sees no key)
    and delta = sum_d do * o, from the plain version in float32."""
    o = segment_attention_reference(q, k, v, seg, scale)
    S = q.shape[1]
    ar = torch.arange(S)
    mask = ((ar[None, :, None] >= ar[None, None, :]) & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, :, None] > 0))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lse = torch.logsumexp(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return lse, torch.einsum("bqhd,bqhd->bhq", do, o)


def _rel_err(got, want):
    want = torch.tensor(np.array(want), dtype=torch.float64)
    return ((got.double() - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def _oracle(q, k, v, do, seg):
    """o, lse and dq, dk, dv of the segment attention in float64 under the
    cotangent do."""
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    tseg = torch.tensor(seg)
    out = segment_attention_reference(*leaves, tseg)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do, dtype=torch.float64))
    sees = torch.stack([_sees(torch.arange(seg.shape[1]), row, torch.arange(seg.shape[1]), row)
                        for row in tseg])
    s = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]).detach() / np.sqrt(q.shape[-1])
    lse = torch.logsumexp(s.masked_fill(~sees[:, None], float("-inf")), dim=-1)
    return out.detach(), lse, grads


DKV_LAYOUTS = {
    # S = 150: three query tiles, the last ragged; one segment spans keys
    # 40..139, across the 64-key tile boundary and three 16-key blocks
    "ragged_S_crossing_segment": (150, [[(0, 40, 1), (40, 140, 2), (140, 150, 3)],
                                        [(0, 70, 1), (70, 131, 2)]]),
    # a row all pad beside a row of one long segment and a pad tail
    "all_pad_row": (130, [[], [(0, 121, 1)]]),
    # short segments: tiles and warps whose ids meet no key's and are skipped
    "many_short_segments": (140, [[(i, min(i + 9, 140), 1 + i // 9) for i in range(0, 140, 9)],
                                  [(0, 5, 1), (5, 100, 2), (100, 104, 3)]]),
}


@pytest.mark.parametrize("name", list(DKV_LAYOUTS))
def test_micro_tile_dkv_order_matches_pallas_and_float64(name):
    """The dk/dv kernel's tiling (16 keys a block, 64-query tiles from the
    first key with the range skip, 16 queries a warp with its own skip,
    warp-order combine, scale on dk at the end) gives the Pallas segment
    backward's dk and dv (interpret mode, blocks of 32) and a float64
    oracle's within the card check's 1e-4 of the largest gradient."""
    S, spans = DKV_LAYOUTS[name]
    seg = _layout(S, spans)
    B, H, D = len(spans), 2, 16
    q, k, v = _inputs(50, B, S, H, D)
    do = np.random.default_rng(51).normal(size=q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo, tseg = (torch.tensor(x) for x in (q, k, v, do, seg))
    lse, delta = _lse_delta(tq, tk, tv, tdo, tseg, scale)
    dk, dv = _micro_tile_dkv(tq, tk, tv, tdo, tseg, lse, delta, scale)

    def loss(a, b, c):
        return jnp.sum(jax_flash(a, b, c, jnp.asarray(seg), None, 32, 32, None) * do)

    _, jdk, jdv = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    _, _, (_, odk, odv) = _oracle(q, k, v, do, seg)
    for label, got, jw, ow in (("dk", dk, jdk, odk), ("dv", dv, jdv, odv)):
        assert _rel_err(got, jw) <= SEG_GRAD_REL_TOL, (label, _rel_err(got, jw))
        assert _rel_err(got, ow.numpy()) <= SEG_GRAD_REL_TOL, (label, _rel_err(got, ow.numpy()))
    pad = seg == 0
    assert (dk.numpy()[pad] == 0).all() and (dv.numpy()[pad] == 0).all()


@pytest.mark.parametrize("D", [64, 128])
def test_plain_version_matches_pallas_at_wide_heads(D):
    """Head dims 64 (the forward and dk/dv kernels' widest but one) and 128
    (dk/dv's widest): the plain version, values and gradients, against the
    Pallas segment kernel in interpret mode."""
    T, spans = LAYOUTS["straddling_blocks"]
    seg = _layout(T, spans)
    q, k, v = _inputs(60 + D, len(spans), T, H=2, D=D)
    out, grads = _torch_value_and_grads(segment_attention_reference, q, k, v, seg)
    want, want_grads = _jax_value_and_grads(
        lambda q, k, v, s: jax_flash(q, k, v, s, None, 8, 8, None), q, k, v, seg)
    np.testing.assert_allclose(out, want, atol=VALUE_TOL, rtol=VALUE_TOL)
    for got, exp in zip(grads, want_grads):
        np.testing.assert_allclose(got, exp, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_kernel_head_dim_limits():
    """What each kernel builds (DP = 32, 64 and 128), and a differentiable
    call's limit."""
    assert (csa.MAX_FWD_HEAD_DIM, csa.MAX_DQ_HEAD_DIM, csa.MAX_DKV_HEAD_DIM) == (128, 128, 128)
    assert csa.MAX_HEAD_DIM == 128


def _sees(qpos, qid, kpos, kid):
    """[queries, keys]: query i attends key j (j <= i, seg[i] == seg[j] != 0)."""
    return (kpos[None, :] <= qpos[:, None]) & (kid[None, :] == qid[:, None]) & (qid[:, None] > 0)


def _key_walk(seg_row, q0, q1, tile, warps):
    """The key rows (warp w, first a, end z) that mt::seg_fwd_kernel and
    mt::seg_bwd_dq_kernel read for the block of queries q0 .. q1 - 1: tiles
    of 64 keys from key 0 to the last query, a tile skipped when its ids
    cannot meet the queries', warp w taking keys 16 w .. 16 w + 15 of a live
    tile and skipping them past the last query or when their ids cannot
    meet the queries'."""
    S = seg_row.numel()
    per = tile // warps
    qid = seg_row[q0:q1]
    for j0 in range(0, q1, tile):
        if not _ranges_meet(seg_row[j0:j0 + tile], qid):
            continue
        for w in range(warps):
            a, z = j0 + per * w, min(j0 + per * (w + 1), S)
            if a < min(z, q1) and _ranges_meet(seg_row[a:z], qid):
                yield w, a, z


def _in_warp_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _micro_tile_forward(q, k, v, seg, scale, rows=16, tile=64, warps=4):
    """mt::seg_fwd_kernel's summation order in plain torch (float32).

    A block owns 16 queries of one row and reads the keys of ``_key_walk``.
    Each warp keeps its own online softmax (m its running max, l its sum, o
    its P v) over the scores scale * q.k where the query sees the key (-inf
    elsewhere); the warps' (m, l, o) combine in warp order: M = max m_w, L =
    sum_w exp(m_w - M) l_w, o = sum_w exp(m_w - M) o_w / L (a division per
    element), lse = M + log L (-inf where L = 0).  Returns o [B, S, H, D] and
    lse [B, H, S]."""
    B, S, H, D = q.shape
    pos = torch.arange(S)
    o = torch.zeros(B, S, H, D)
    lse = torch.full((B, H, S), float("-inf"))
    for b in range(B):
        for q0 in range(0, S, rows):
            q1 = min(q0 + rows, S)
            m = torch.full((warps, H, q1 - q0), float("-inf"))
            l = torch.zeros(warps, H, q1 - q0)
            acc = torch.zeros(warps, H, q1 - q0, D)
            for w, a, z in _key_walk(seg[b], q0, q1, tile, warps):
                sees = _sees(pos[q0:q1], seg[b, q0:q1], pos[a:z], seg[b, a:z])
                s = torch.einsum("qhd,khd->hqk", q[b, q0:q1], k[b, a:z]) * scale
                s = torch.where(sees[None], s, float("-inf"))
                m_new = torch.maximum(m[w], s.amax(-1))
                safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
                corr = torch.exp(m[w] - safe)
                p = torch.exp(s - safe[..., None])
                l[w] = l[w] * corr + p.sum(-1)
                acc[w] = acc[w] * corr[..., None] + torch.einsum("hqk,khd->hqd", p, v[b, a:z])
                m[w] = m_new
            mx = m.amax(0)
            f = torch.exp(m - torch.where(torch.isneginf(mx), 0.0, mx))
            total = _in_warp_order(l * f)
            denom = total.clamp(min=1e-30)
            o[b, q0:q1] = (_in_warp_order(acc * f[..., None]) / denom[..., None]).permute(1, 0, 2)
            lse[b, :, q0:q1] = torch.where(total > 0, mx + torch.log(denom), float("-inf"))
    return o, lse


def _micro_tile_dq(q, k, v, do, o, seg, lse, scale, rows=16, tile=64, warps=4):
    """mt::seg_bwd_dq_kernel's summation order in plain torch (float32).

    delta = sum_d do * o.  A block owns 16 queries and reads the keys of
    ``_key_walk``: P = exp(S scale - lse) (lse = -inf read as 0) where the
    query sees the key, dS = P (dP - delta); each warp sums dS k over its
    keys, the warps' partials add in warp order, and scale multiplies dq at
    the end.  Returns dq [B, S, H, D] and delta [B, H, S]."""
    B, S, H, D = q.shape
    pos = torch.arange(S)
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    safe = torch.where(torch.isneginf(lse), 0.0, lse)
    dq = torch.zeros(B, S, H, D)
    for b in range(B):
        for q0 in range(0, S, rows):
            q1 = min(q0 + rows, S)
            dq_w = torch.zeros(warps, q1 - q0, H, D)
            for w, a, z in _key_walk(seg[b], q0, q1, tile, warps):
                sees = _sees(pos[q0:q1], seg[b, q0:q1], pos[a:z], seg[b, a:z])
                s = torch.einsum("qhd,khd->hqk", q[b, q0:q1], k[b, a:z]) * scale
                p = torch.where(sees[None], torch.exp(s - safe[b, :, q0:q1, None]), 0.0)
                dp = torch.einsum("qhd,khd->hqk", do[b, q0:q1], v[b, a:z])
                ds = p * (dp - delta[b, :, q0:q1, None])
                dq_w[w] += torch.einsum("hqk,khd->qhd", ds, k[b, a:z])
            dq[b, q0:q1] = _in_warp_order(dq_w) * scale
    return dq, delta


@pytest.mark.parametrize("D", [8, 32, 64, 128])
@pytest.mark.parametrize("name", list(DKV_LAYOUTS))
def test_micro_tile_forward_dq_dkv_orders_match_pallas_and_float64(name, D):
    """The three kernels' summation orders held together: the forward's o
    and lse, then dq and delta from that o and lse, then dk and dv from that
    lse and delta (``_micro_tile_dkv``).  o against the Pallas segment
    forward (interpret mode, blocks of 32) and a float64 oracle within 1e-5,
    lse against the oracle's, delta within 1e-6 of its largest; dq, dk, dv
    against the Pallas backward and the oracle's within the card check's
    1e-4 of the largest gradient; exact zeros on pad.  D = 8 and 32 run as
    DP = 32 on the card, 64 and 128 as themselves."""
    S, spans = DKV_LAYOUTS[name]
    seg = _layout(S, spans)
    B, H = len(spans), 2
    q, k, v = _inputs(70 + D, B, S, H, D)
    do = np.random.default_rng(71 + D).normal(size=q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo, tseg = (torch.tensor(x) for x in (q, k, v, do, seg))
    o, lse = _micro_tile_forward(tq, tk, tv, tseg, scale)
    dq, delta = _micro_tile_dq(tq, tk, tv, tdo, o, tseg, lse, scale)
    dk, dv = _micro_tile_dkv(tq, tk, tv, tdo, tseg, lse, delta, scale)

    def fn(a, b, c):
        return jax_flash(a, b, c, jnp.asarray(seg), None, 32, 32, None)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    jo = np.asarray(jax.jit(fn)(*args))
    jgrads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * do), argnums=(0, 1, 2)))(*args)
    oo, olse, ograds = _oracle(q, k, v, do, seg)
    np.testing.assert_allclose(o.numpy(), jo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), oo.numpy(), atol=1e-5, rtol=0)
    live = torch.isfinite(olse)
    assert torch.equal(torch.isneginf(lse), ~live)
    np.testing.assert_allclose(lse[live].numpy(), olse[live].numpy(), atol=1e-5, rtol=0)
    # delta sums D float32 products of O(1) terms, up to ~30 at D = 128
    assert _rel_err(delta, np.einsum("bqhd,bqhd->bhq", do, oo.numpy())) <= 1e-6
    for label, got, jw, ow in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads, ograds):
        assert _rel_err(got, jw) <= SEG_GRAD_REL_TOL, (label, _rel_err(got, jw))
        assert _rel_err(got, ow.numpy()) <= SEG_GRAD_REL_TOL, (label, _rel_err(got, ow.numpy()))
    pad = seg == 0
    for got in (o, dq, dk, dv):
        assert (got.numpy()[pad] == 0).all()
