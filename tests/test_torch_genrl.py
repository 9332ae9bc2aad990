"""The PyTorch port's generation engines against the JAX package.

One Flax init (V=11, d=32, 2 heads, 1 layer, max_len=16, as
tests/test_continuous.py) is converted into the port.  At temperature 0
both of the port's engines (the cohort ``GenerationEngine`` and the
continuous ``ContinuousEngine`` over the paged KV cache) must produce the
JAX cohort engine's tokens exactly, with behaviour logprobs and values at
1e-5: with the prefix cache on and off, one or two macro steps in flight,
through the CoW group fork, with EOS harvest, under page backpressure and
after a param push that flushes the cache.  The transfer discipline is
counted at the module seams.  At temperature > 0 the streams of
``jax.random`` and ``torch.Generator`` differ, so the port's sampler is
held to the softmax of the adjusted logits instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.genrl import continuous as tcont
from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
from scalerl_torch.genrl.engine import (
    GenerationConfig,
    GenerationEngine,
    adjust_logits,
    sample_tokens,
)
from scalerl_torch.models.transformer import TransformerPolicy
from scalerl_torch.runtime import telemetry, tracing
from scalerl_tpu.genrl.engine import GenerationConfig as JaxGenerationConfig
from scalerl_tpu.genrl.engine import GenerationEngine as JaxGenerationEngine
from scalerl_tpu.models.transformer import TransformerPolicy as JaxTransformerPolicy

torch.set_num_threads(1)

V = 11
P_MAX, R_MAX = 6, 4
TOL = 1e-5


def _port_model():
    return TransformerPolicy(num_actions=V, vocab_size=V, d_model=32, num_heads=2,
                             num_layers=1, max_len=16, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """The converted params, the prompts of tests/test_continuous.py and
    the JAX cohort engine's greedy rounds without and with an EOS id."""
    jm = JaxTransformerPolicy(num_actions=V, vocab_size=V, d_model=32, num_heads=2,
                              num_layers=1, max_len=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    state = convert.transformer_to_torch(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(1)
    prompts = rng.integers(2, V, size=(5, P_MAX)).astype(np.int32)
    lengths = np.array([6, 4, 3, 2, 1], np.int32)
    base = dict(vocab_size=V, max_prompt_len=P_MAX, max_new_tokens=R_MAX, temperature=0.0, seed=7)
    ref = JaxGenerationEngine(jm, params, JaxGenerationConfig(**base)).generate(prompts, lengths)
    # an EOS id that the greedy policy emits mid-response for some prompt
    eos = int(ref.response_tokens[np.argmax(ref.response_tokens[:, 1] > 1), 1])
    ref_eos = JaxGenerationEngine(jm, params, JaxGenerationConfig(**base, eos_token=eos)).generate(
        prompts, lengths)
    return dict(state=state, model=_port_model(), prompts=prompts, lengths=lengths, base=base,
                ref=ref, eos=eos, ref_eos=ref_eos, jax_model=jm, jax_params=params)


def _cont(setup, **kw):
    cfg = dict(setup["base"], lanes=4, page_size=4, steps_per_macro=3)
    cfg.update(kw)
    return ContinuousEngine(setup["model"], setup["state"], ContinuousConfig(**cfg), device="cpu")


def _by_prompt(completions):
    return {tuple(c.prompt.tolist()): c for c in completions}


def _assert_matches_ref(completions, setup, ref=None, rows=range(5)):
    ref = setup["ref"] if ref is None else ref
    done = _by_prompt(completions)
    for i in rows:
        c = done[tuple(setup["prompts"][i][: setup["lengths"][i]].tolist())]
        n = int(ref.response_len[i])
        np.testing.assert_array_equal(c.response_tokens, ref.response_tokens[i, :n])
        np.testing.assert_allclose(c.behavior_logp, ref.behavior_logp[i, :n], atol=TOL)
        np.testing.assert_allclose(c.values, ref.values[i, :n], atol=TOL)


@pytest.mark.parametrize("eos", [False, True])
def test_cohort_engine_matches_jax_at_temperature_0(setup, eos):
    ref = setup["ref_eos"] if eos else setup["ref"]
    cfg = dict(setup["base"], eos_token=setup["eos"] if eos else -1)
    eng = GenerationEngine(setup["model"], setup["state"], GenerationConfig(**cfg), device="cpu")
    got = eng.generate(setup["prompts"], setup["lengths"])
    for field in ("sequences", "response_tokens", "mask", "response_len", "prompt_len"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)
    np.testing.assert_allclose(got.behavior_logp, ref.behavior_logp, atol=TOL)
    np.testing.assert_allclose(got.values, ref.values, atol=TOL)
    assert (got.prompt_pad, got.response_pad) == (ref.prompt_pad, ref.response_pad)
    assert got.generation == 0
    if eos:
        assert got.mask.sum() < ref.mask.size  # some lane stopped on EOS


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("steps_in_flight", [1, 2])
def test_continuous_engine_matches_jax_cohort(setup, prefix_cache, steps_in_flight):
    """The acceptance pin: token-identical to the cohort path through a
    paged, right-padded cache; a second admission of a prompt hits the
    prefix cache (when on) and decodes identically."""
    eng = _cont(setup, prefix_cache=prefix_cache, steps_in_flight=steps_in_flight)
    for i in range(5):
        assert eng.submit(setup["prompts"][i], setup["lengths"][i], tag=i)
    done = eng.run_until(5, max_macro_steps=60)
    _assert_matches_ref(done, setup)
    assert sorted(c.tag for c in done) == list(range(5))
    assert all(c.generation == 0 and c.finish_time >= c.admit_time >= c.submit_time for c in done)
    prefilled = eng.prefill_tokens
    eng.submit(setup["prompts"][0], setup["lengths"][0])
    again = eng.run_until(1, max_macro_steps=40)
    _assert_matches_ref(again, setup, rows=[0])
    # prompt 0 has 6 tokens: the lookup caps at 5, one full page of 4
    assert eng.prefix_tokens_saved == (4 if prefix_cache else 0)
    assert eng.prefill_tokens - prefilled == 6 - eng.prefix_tokens_saved
    while eng._inflight:
        eng.step()
    cached = eng._prefix_cache.cached_pages if prefix_cache else 0
    assert eng.allocator.reserved == 0 and eng.allocator.allocated_pages == cached


def test_continuous_engine_matches_jax_continuous_engine(setup):
    """The same submissions (singles, a repeated prompt, a group of 3)
    through JAX's continuous engine and the port's, same config: the same
    completions in the same order, and the same host bookkeeping (macro
    steps, prefill and prefix-savings counts, occupancy)."""
    from scalerl_tpu.genrl.continuous import ContinuousConfig as JaxContinuousConfig
    from scalerl_tpu.genrl.continuous import ContinuousEngine as JaxContinuousEngine

    cfg = dict(setup["base"], lanes=4, page_size=2, steps_per_macro=2, min_free_lanes=2)
    jax_eng = JaxContinuousEngine(setup["jax_model"], setup["jax_params"],
                                  JaxContinuousConfig(**cfg))
    port_eng = ContinuousEngine(setup["model"], setup["state"], ContinuousConfig(**cfg),
                                device="cpu")
    runs = []
    for eng in (jax_eng, port_eng):
        for i in (0, 1, 2, 0, 3, 4):
            eng.submit(setup["prompts"][i], setup["lengths"][i], tag=i)
        eng.submit_group(setup["prompts"][1], 3, setup["lengths"][1], tag="grp")
        done = eng.run_until(9, max_macro_steps=100)
        while eng._inflight:
            done.extend(eng.step())
        runs.append((done, eng.macro_steps, eng.prefill_tokens, eng.prefix_tokens_saved,
                     eng.prefix_tokens_total, eng.mean_occupancy))
    (jdone, *jstats), (tdone, *tstats) = runs
    assert tstats == jstats
    assert [(c.tag, c.prompt.tolist()) for c in tdone] == [(c.tag, c.prompt.tolist())
                                                          for c in jdone]
    for t, j in zip(tdone, jdone):
        np.testing.assert_array_equal(t.response_tokens, j.response_tokens)
        np.testing.assert_allclose(t.behavior_logp, j.behavior_logp, atol=TOL)
        np.testing.assert_allclose(t.values, j.values, atol=TOL)


def test_continuous_engine_matches_port_cohort(setup):
    cohort = GenerationEngine(setup["model"], setup["state"], GenerationConfig(**setup["base"]),
                              device="cpu").generate(setup["prompts"], setup["lengths"])
    eng = _cont(setup, lanes=2, page_size=2, steps_per_macro=2)
    for i in range(5):
        eng.submit(setup["prompts"][i], setup["lengths"][i])
    _assert_matches_ref(eng.run_until(5, max_macro_steps=80), setup, ref=cohort)


def test_submit_group_cow_fork(setup):
    """submit_group(prompt, 8): the leader prefills, 7 members map its full
    prompt page copy-on-write and copy the partial page; all 8 decode to
    the reference tokens."""
    eng = _cont(setup, lanes=8)
    shared_before = telemetry.get_registry().counter("genrl.pages_shared").value
    assert eng.submit_group(setup["prompts"][0], 8, setup["lengths"][0], tag="grp")
    done = eng.run_until(8, max_macro_steps=80)
    assert len(done) == 8 and all(c.tag == "grp" for c in done)
    n = int(setup["ref"].response_len[0])
    for c in done:
        np.testing.assert_array_equal(c.response_tokens, setup["ref"].response_tokens[0, :n])
        np.testing.assert_allclose(c.behavior_logp, setup["ref"].behavior_logp[0, :n], atol=TOL)
    # 6 tokens at page size 4: 4 full-page tokens per lane, 7 lanes shared
    assert eng.prefix_tokens_total == 8 * 4 and eng.prefix_tokens_saved == 7 * 4
    assert eng.prefix_saved_ratio >= 0.8
    assert telemetry.get_registry().counter("genrl.pages_shared").value - shared_before >= 7
    assert eng.allocator.reserved == 0
    with pytest.raises(ValueError, match="group size"):
        eng.submit_group(setup["prompts"][0], 9)


def test_eos_harvest_matches_jax(setup):
    eng = _cont(setup, eos_token=setup["eos"], lanes=3, page_size=2, steps_per_macro=2)
    for i in range(5):
        eng.submit(setup["prompts"][i], setup["lengths"][i])
    done = eng.run_until(5, max_macro_steps=80)
    _assert_matches_ref(done, setup, ref=setup["ref_eos"])
    short = [c for c in done if len(c.response_tokens) < R_MAX]
    assert short and all(c.response_tokens[-1] == setup["eos"] for c in short)
    assert eng.allocator.reserved == 0


def test_page_backpressure_and_shedding(setup):
    """A pool that fits ONE worst-case sequence admits one at a time; the
    queue bound sheds; both sequences still decode to the reference."""
    # worst case = ceil((6 + 4) / 4) = 3 pages; capacity 3 -> 1 sequence
    eng = _cont(setup, lanes=2, num_pages=4, steps_per_macro=2, max_pending=2)
    assert eng.allocator.capacity == 3
    assert eng.submit(setup["prompts"][0], setup["lengths"][0])
    assert eng.submit(setup["prompts"][1], setup["lengths"][1])
    assert not eng.submit(setup["prompts"][2], setup["lengths"][2])
    assert eng._batcher.shed_total == 1
    eng.step()
    assert eng.live_lanes == 1 and eng.pending == 1  # backpressure
    done = [] + eng.run_until(2, max_macro_steps=100)
    _assert_matches_ref(done, setup, rows=[0, 1])
    assert eng.allocator.reserved == 0
    assert eng.allocator.allocated_pages == eng._prefix_cache.cached_pages


def test_push_params_flushes_prefix_cache(setup):
    eng = _cont(setup, lanes=2, page_size=2, steps_in_flight=1)
    eng.submit(setup["prompts"][0], setup["lengths"][0])
    eng.run_until(1, max_macro_steps=40)
    assert eng._prefix_cache.cached_pages > 0
    assert eng.push_params(setup["state"], learner_step=3) == 1
    assert eng._prefix_cache.cached_pages == 0 and eng.allocator.allocated_pages == 0
    saved = eng.prefix_tokens_saved
    eng.submit(setup["prompts"][0], setup["lengths"][0])
    c = eng.run_until(1, max_macro_steps=40)[0]
    assert eng.prefix_tokens_saved == saved  # recomputed, no hit
    assert c.generation == 1
    _assert_matches_ref([c], setup, rows=[0])
    # a quantized push also flushes, and the engine decodes from the
    # snapshot dequantized on read
    assert eng.push_params(setup["state"], learner_step=4, quantize="int8") == 2
    assert eng._prefix_cache.cached_pages == 0 and eng._quantized is not None
    eng.submit(setup["prompts"][0], setup["lengths"][0])
    q = eng.run_until(1, max_macro_steps=40)[0]
    assert q.generation == 2 and len(q.response_tokens) == R_MAX


@pytest.mark.parametrize("steps_in_flight", [1, 2])
def test_one_upload_and_one_read_per_macro_step(setup, monkeypatch, steps_in_flight):
    """Counted at the module seams: a steady macro step (no admission) is
    ONE upload (the page table) and ONE batched read; an admitting step
    adds one upload per prefill group; with two in flight the first
    dispatch reads nothing."""
    eng = _cont(setup, steps_per_macro=1, steps_in_flight=steps_in_flight)
    eng.submit(setup["prompts"][4], setup["lengths"][4])
    eng.run_until(1, max_macro_steps=40)
    while eng._inflight:
        eng.step()
    puts, gets = [], []
    real_put, real_get = tcont._device_put, tcont._device_get
    monkeypatch.setattr(tcont, "_device_put", lambda a, d: (puts.append(len(a)), real_put(a, d))[1])
    monkeypatch.setattr(tcont, "_device_get", lambda x: (gets.append(1), real_get(x))[1])
    eng.submit(setup["prompts"][0], setup["lengths"][0])  # P bucket 8
    eng.submit(setup["prompts"][3], setup["lengths"][3])  # P bucket 2
    eng.step()
    assert puts == [5, 5, 1]  # two prefill groups, then the table
    assert len(gets) == (1 if steps_in_flight == 1 else 0)
    done, steady = [], 0
    while eng.live_lanes:
        puts.clear()
        gets.clear()
        done.extend(eng.step())
        if eng.live_lanes:
            assert (puts, len(gets)) == ([1], 1)
            steady += 1
    assert steady >= 1


def test_sampler_frequencies_match_the_adjusted_softmax():
    """Gumbel-argmax draws from softmax(adjust_logits(logits)); top-k
    masks every other token."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -1.0]])
    gen = torch.Generator().manual_seed(0)
    n = 40_000
    for temperature, top_k in ((1.0, 0), (1.7, 4), (0.5, 0)):
        adj = adjust_logits(logits.expand(n, -1), temperature, top_k, 6)
        tokens = sample_tokens(gen, adj, temperature)
        freq = np.bincount(tokens.numpy(), minlength=6) / n
        want = torch.softmax(adj[0], dim=-1).numpy()
        np.testing.assert_allclose(freq, want, atol=0.01)
        if top_k:
            assert freq[np.argsort(want)[: 6 - top_k]].sum() == 0.0
    assert sample_tokens(gen, logits, 0.0).item() == 3


def test_continuous_at_temperature_1_is_well_formed(setup):
    """EOS at temperature 1: ragged lengths, more sequences than lanes,
    pages back after harvest, telemetry bound, one span per macro step
    when sampling is on."""
    tracing.reset(sample_rate=1.0)
    try:
        eng = _cont(setup, temperature=1.0, eos_token=1, seed=3, lanes=3, page_size=2,
                    steps_per_macro=2)
        rng = np.random.default_rng(5)
        for _ in range(8):
            n = int(rng.integers(1, P_MAX + 1))
            eng.submit(rng.integers(2, V, size=n).astype(np.int32), n)
        done = eng.run_until(8, max_macro_steps=200)
        spans = [s for s in tracing.get_tracer().finished() if s["name"] == "genrl.macro_step"]
    finally:
        tracing.reset(sample_rate=0.0)
    assert len(done) == 8 and eng.completed_total == 8
    for c in done:
        r = len(c.response_tokens)
        assert 1 <= r <= R_MAX and len(c.behavior_logp) == r == len(c.values)
        assert np.isfinite(c.behavior_logp).all() and (c.behavior_logp <= 0).all()
        if r < R_MAX:
            assert c.response_tokens[-1] == 1
    assert eng.allocator.reserved == 0
    assert 0.0 < eng.mean_occupancy <= 1.0
    assert len(spans) >= eng.macro_steps
    stats = eng.stats()
    assert stats["completed"] == 8 and stats["macro_steps"] == eng.macro_steps
    snap = telemetry.get_registry().snapshot()["genrl"]
    assert snap["continuous"]["completed"] == 8 and "allocated" in snap["pages"]


def test_engines_refuse_what_they_do_not_support(setup):
    with pytest.raises(ValueError, match="spec_ngram"):
        _cont(setup, spec_k=2, spec_ngram=0)
    features = TransformerPolicy(num_actions=3, d_model=32, num_heads=2, num_layers=1,
                                 max_len=16, obs_dim=4, device="cpu")
    for engine in (GenerationEngine, ContinuousEngine):
        cfg = (GenerationConfig if engine is GenerationEngine else ContinuousConfig)(
            **setup["base"])
        with pytest.raises(ValueError, match="token-mode"):
            engine(features, features.state_dict(), cfg, device="cpu")
    small = TransformerPolicy(num_actions=V, vocab_size=V, d_model=32, num_heads=2, num_layers=1,
                              max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ContinuousEngine(small, small.state_dict(), ContinuousConfig(**setup["base"]), device="cpu")
    for bad in (dict(lanes=0), dict(min_free_lanes=9), dict(page_size=0), dict(steps_in_flight=0),
                dict(steps_per_macro=0), dict(num_pages=-1), dict(temperature=-1.0),
                dict(paged_attn="triton")):
        with pytest.raises(ValueError):
            _cont(setup, **bad)
    eng = _cont(setup, num_pages=4)
    with pytest.raises(ValueError, match="worst-case"):
        eng.submit_group(setup["prompts"][0], 2)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(np.arange(9, dtype=np.int32))
