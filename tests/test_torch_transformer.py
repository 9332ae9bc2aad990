"""The PyTorch port's TransformerPolicy against the Flax model.

One Flax init (V=11, d=32, 2 heads, 2 layers, max_len=16) is converted by
``convert.transformer_to_torch`` and both models run the same numpy inputs
on every path the generation engines use: full causal, masked, packed
rows, dense-cache prefill and decode, paged prefill and decode through a
fragmented table, and the shared-table tail prefill.  Outputs and written
caches agree at 1e-5 in float32 (the pools compared without the null page
0, whose pad writes may land in either order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.models import transformer as tt
from scalerl_tpu.models import transformer as jt

torch.set_num_threads(1)

V, D_MODEL, HEADS, LAYERS, MAX_LEN = 11, 32, 2, 2, 16
HEAD_DIM = D_MODEL // HEADS
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = jt.TransformerPolicy(num_actions=V, vocab_size=V, d_model=D_MODEL, num_heads=HEADS,
                              num_layers=LAYERS, max_len=MAX_LEN)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm = tt.TransformerPolicy(num_actions=V, vocab_size=V, d_model=D_MODEL, num_heads=HEADS,
                              num_layers=LAYERS, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(convert.transformer_to_torch(np_params))
    tm.requires_grad_(False)
    rng = np.random.default_rng(0)
    # jit the Flax apply: one compile per path instead of op-by-op dispatch
    return dict(jm=jm, apply=jax.jit(jm.apply), params=params, np_params=np_params, tm=tm,
                rng=rng)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _close_out(t_out, j_out):
    _close(t_out.policy_logits.numpy(), j_out.policy_logits)
    _close(t_out.baseline.numpy(), j_out.baseline)


def test_converter_round_trip_is_exact(models):
    state = convert.transformer_to_torch(models["np_params"])
    assert set(state) == set(models["tm"].state_dict())
    back = convert.torch_to_transformer(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, models["np_params"])


def test_full_causal_forward(models):
    tokens = models["rng"].integers(0, V, size=(3, 9)).astype(np.int32)
    _close_out(models["tm"](_t(tokens)), models["apply"](models["params"], jnp.asarray(tokens)))


def test_feature_mode_forward():
    jm = jt.TransformerPolicy(num_actions=3, d_model=D_MODEL, num_heads=HEADS, num_layers=1,
                              max_len=MAX_LEN)
    obs = np.random.default_rng(1).normal(size=(2, 6, 5)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    tm = tt.TransformerPolicy(num_actions=3, d_model=D_MODEL, num_heads=HEADS, num_layers=1,
                              max_len=MAX_LEN, obs_dim=5, device="cpu")
    tm.load_state_dict(convert.transformer_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        _close_out(tm(_t(obs)), jm.apply(params, jnp.asarray(obs)))


def test_masked_and_packed_forwards(models):
    rng = models["rng"]
    tokens = rng.integers(0, V, size=(3, 10)).astype(np.int32)
    lengths = np.array([6, 4, 1], np.int32)  # left-padded into a prompt bucket of 6
    P = 6
    jmask = jt.sequence_attention_mask(jnp.asarray(lengths), P, 10)
    pos = jt.sequence_positions(jnp.asarray(lengths), P, 10)
    tmask = tt.sequence_attention_mask(_t(lengths), P, 10)
    tpos = tt.sequence_positions(_t(lengths), P, 10)
    _close_out(models["tm"](_t(tokens), positions=tpos, attn_mask=tmask),
               models["apply"](models["params"], jnp.asarray(tokens), positions=pos,
                               attn_mask=jmask))
    seg = np.array([[1, 1, 1, 2, 2, 0, 0, 0, 0, 0], [1, 2, 2, 2, 3, 3, 3, 3, 0, 0],
                    [1] * 10], np.int32)
    np.testing.assert_array_equal(tt.packed_attention_mask(_t(seg)).numpy(),
                                  np.asarray(jt.packed_attention_mask(jnp.asarray(seg))))
    _close_out(models["tm"](_t(tokens), segment_ids=_t(seg)),
               models["apply"](models["params"], jnp.asarray(tokens),
                               segment_ids=jnp.asarray(seg)))


@pytest.mark.parametrize("helper,args", [
    ("prompt_attention_mask", (7,)),
    ("prefill_attention_mask", (6, 9)),
    ("decode_attention_mask", (6, 2, 9)),
    ("sequence_attention_mask", (6, 9)),
    ("sequence_positions", (6, 9)),
])
def test_mask_helpers_match_jax(helper, args):
    lengths = np.array([6, 3, 1], np.int32)
    want = getattr(jt, helper)(jnp.asarray(lengths), *args)
    got = getattr(tt, helper)(_t(lengths), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_cache_prefill_and_decode(models):
    """The cohort engine's path: prefill a left-padded batch into the cache
    at index 0, then two single-token decode steps."""
    rng = models["rng"]
    B, P, R = 3, 6, 3
    S = P + R
    lengths = np.array([6, 3, 1], np.int32)
    tokens = rng.integers(2, V, size=(B, P)).astype(np.int32)
    jl, tl = jnp.asarray(lengths), _t(lengths)
    jcache = jt.init_kv_cache(B, S, LAYERS, HEADS, HEAD_DIM)
    tcache = tt.init_kv_cache(B, S, LAYERS, HEADS, HEAD_DIM, device="cpu")
    jo, jcache = models["apply"](models["params"], jnp.asarray(tokens),
                                 positions=jt.sequence_positions(jl, P, S)[:, :P],
                                 kv_cache=jcache, cache_index=0,
                                 attn_mask=jt.prefill_attention_mask(jl, P, S))
    to, tcache = models["tm"](_t(tokens), positions=tt.sequence_positions(tl, P, S)[:, :P],
                              kv_cache=tcache, cache_index=0,
                              attn_mask=tt.prefill_attention_mask(tl, P, S))
    _close_out(to, jo)
    for t in range(2):
        tok = rng.integers(2, V, size=(B, 1)).astype(np.int32)
        jo, jcache = models["apply"](models["params"], jnp.asarray(tok),
                                     positions=(jl + t)[:, None], kv_cache=jcache,
                                     cache_index=P + t,
                                     attn_mask=jt.decode_attention_mask(jl, P, t, S))
        to, tcache = models["tm"](_t(tok), positions=(tl + t)[:, None], kv_cache=tcache,
                                  cache_index=P + t,
                                  attn_mask=tt.decode_attention_mask(tl, P, t, S))
        _close_out(to, jo)
    for i in range(LAYERS):
        _close(tcache.k[i].numpy(), jcache.k[i])
        _close(tcache.v[i].numpy(), jcache.v[i])


def test_paged_prefill_decode_and_tail_prefill(models):
    """The continuous engine's paths through a fragmented table: local
    prefill of right-padded prompts into pool pages, decode of one token
    per lane through the table (the plain paged attention), and a tail
    prefill over a prefix already in the pool."""
    rng = models["rng"]
    A, P, ps, M, N = 3, 8, 2, 6, 20
    lengths = np.array([8, 5, 1], np.int32)
    tokens = rng.integers(2, V, size=(A, P)).astype(np.int32)
    table = np.array([[7, 3, 12, 5, 16, 0], [1, 9, 14, 0, 0, 0], [18, 0, 0, 0, 0, 0]], np.int32)
    pos = np.arange(P)
    live = pos[None] < lengths[:, None]
    page_ids = np.where(live, table[:, np.minimum(pos // ps, M - 1)], 0).astype(np.int32)
    offsets = np.where(live, pos % ps, 0).astype(np.int32)
    jpools = jt.init_paged_kv_cache(N, ps, LAYERS, HEADS, HEAD_DIM)
    tpools = tt.init_paged_kv_cache(N, ps, LAYERS, HEADS, HEAD_DIM, device="cpu")
    jo, jpools = models["apply"](
        models["params"], jnp.asarray(tokens), positions=jnp.broadcast_to(jnp.arange(P), (A, P)),
        attn_mask=jt.prompt_attention_mask(jnp.asarray(lengths), P), paged_cache=jpools,
        page_ids=jnp.asarray(page_ids), page_offsets=jnp.asarray(offsets))
    to, tpools = models["tm"](
        _t(tokens), positions=torch.arange(P).expand(A, P),
        attn_mask=tt.prompt_attention_mask(_t(lengths), P), paged_cache=tpools,
        page_ids=_t(page_ids), page_offsets=_t(offsets))
    _close_out(to, jo)
    # decode: each lane writes its next token at its cursor
    tok = rng.integers(2, V, size=(A, 1)).astype(np.int32)
    cl = lengths
    pid = table[np.arange(A), cl // ps][:, None].astype(np.int32)
    off = (cl % ps)[:, None].astype(np.int32)
    jo, jpools = models["apply"](
        models["params"], jnp.asarray(tok), positions=jnp.asarray(cl)[:, None], paged_cache=jpools,
        page_ids=jnp.asarray(pid), page_offsets=jnp.asarray(off), page_table=jnp.asarray(table),
        attn_lengths=jnp.asarray(cl + 1))
    to, tpools = models["tm"](
        _t(tok), positions=_t(cl)[:, None], paged_cache=tpools, page_ids=_t(pid),
        page_offsets=_t(off), page_table=_t(table), attn_lengths=_t(cl + 1))
    _close_out(to, jo)
    # tail prefill: 3 tokens on top of each lane's first (cursor + 1 - 3)
    T = 3
    starts = np.maximum(cl + 1 - T, 0).astype(np.int32)
    gpos = starts[:, None] + np.arange(T)[None]
    ttok = rng.integers(2, V, size=(A, T)).astype(np.int32)
    tpid = table[np.arange(A)[:, None], gpos // ps].astype(np.int32)
    toff = (gpos % ps).astype(np.int32)
    jo, jpools = models["apply"](
        models["params"], jnp.asarray(ttok), positions=jnp.asarray(gpos), paged_cache=jpools,
        page_ids=jnp.asarray(tpid), page_offsets=jnp.asarray(toff), page_table=jnp.asarray(table),
        prefix_starts=jnp.asarray(starts))
    to, tpools = models["tm"](
        _t(ttok), positions=_t(gpos), paged_cache=tpools, page_ids=_t(tpid),
        page_offsets=_t(toff), page_table=_t(table), prefix_starts=_t(starts))
    _close_out(to, jo)
    for i in range(LAYERS):
        _close(tpools.k[i][1:].numpy(), jpools.k[i][1:])
        _close(tpools.v[i][1:].numpy(), jpools.v[i][1:])


def test_unported_kernels_and_bad_shapes_raise(models):
    kw = dict(num_actions=V, vocab_size=V, d_model=D_MODEL, num_heads=HEADS, num_layers=1,
              max_len=MAX_LEN, device="cpu")
    # the flash seam (B4) is ported: use_flash=True runs the full causal
    # forward through ops/cuda_flash_attention.py (its plain version on the
    # host) and matches the default attention
    plain = tt.TransformerPolicy(**kw, generator=torch.Generator().manual_seed(0))
    flash = tt.TransformerPolicy(use_flash=True, **kw)
    flash.load_state_dict(plain.state_dict())
    tokens = torch.tensor(models["rng"].integers(0, V, size=(2, 7)))
    with torch.no_grad():
        for a, b in zip(flash(tokens), plain(tokens)):
            _close(a.numpy(), b.numpy())
    # the segment seam is ported: the model takes a segment_attn_fn and
    # routes packed rows to it in every block
    calls = []

    def seg_fn(q, k, v, seg):
        calls.append(tuple(q.shape))
        return torch.zeros_like(q)

    packed = tt.TransformerPolicy(segment_attn_fn=seg_fn, **kw)
    seg = torch.ones(2, 5, dtype=torch.int32)
    packed(torch.zeros(2, 5, dtype=torch.int32), segment_ids=seg)
    assert calls == [(2, 5, HEADS, D_MODEL // HEADS)]
    with pytest.raises(ValueError, match="obs_dim"):
        tt.TransformerPolicy(num_actions=3, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        models["tm"](torch.zeros(1, MAX_LEN + 1, dtype=torch.int32))
