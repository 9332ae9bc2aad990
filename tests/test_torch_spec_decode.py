"""Speculative decoding on the port's continuous engine against the JAX
engine (``scalerl_tpu/genrl/continuous.py``, ``spec_k > 0``).

One Flax init (V=11, d=32, 2 heads, 1 layer, max_len=40, the model of
tests/test_continuous.py's spec fixture) is converted into the port.  The
two engines take the same submissions (singles and a CoW group) and are
stepped in lockstep; after every pass they must agree on the completions
(tokens exactly, behaviour logp and values at 1e-5), the verify width the
pass took from the ladder, the banned-token carry, the allocator's pages,
and the proposed / accepted / rolled-back counters.  At temperature 0 the
port's speculating engine also matches its own engine with speculation
off.  At temperature > 0 the port's two draws of a pass (the bonus token
and the accept test's uniforms) are JAX's, injected through
``ContinuousEngine._verify_draws`` from the JAX engine's own key chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.genrl import continuous as tcont
from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
from scalerl_torch.models.transformer import TransformerPolicy
from scalerl_torch.runtime import telemetry, tracing
from scalerl_tpu.genrl.continuous import ContinuousConfig as JaxContinuousConfig
from scalerl_tpu.genrl.continuous import ContinuousEngine as JaxContinuousEngine
from scalerl_tpu.models.transformer import TransformerPolicy as JaxTransformerPolicy

torch.set_num_threads(1)

V, P_MAX = 11, 6
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jm = JaxTransformerPolicy(num_actions=V, vocab_size=V, d_model=32, num_heads=2,
                              num_layers=1, max_len=40)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    state = convert.transformer_to_torch(jax.tree_util.tree_map(np.asarray, params))
    model = TransformerPolicy(num_actions=V, vocab_size=V, d_model=32, num_heads=2,
                              num_layers=1, max_len=40, device="cpu")
    rng = np.random.default_rng(2)
    prompts = rng.integers(2, V, size=(5, P_MAX)).astype(np.int32)
    lengths = np.array([6, 5, 3, 2, 4], np.int32)
    return dict(jax_model=jm, jax_params=params, state=state, model=model, prompts=prompts,
                lengths=lengths)


def _base(**kw):
    cfg = dict(vocab_size=V, max_prompt_len=P_MAX, max_new_tokens=12, temperature=0.0, seed=7,
               lanes=4, page_size=4, steps_per_macro=4, prompt_buckets=(P_MAX,))
    cfg.update(kw)
    return cfg


def _submit(eng, s):
    for i in range(5):
        eng.submit(s["prompts"][i], s["lengths"][i], tag=i)
    eng.submit_group(s["prompts"][1][: s["lengths"][1]], 2, tag="grp")


class _JaxDraws:
    """The JAX engine's draws of each spec pass, from its own key chain
    (``_spec_step`` splits the engine key, the verify program splits that
    into the bonus-token and the accept-test keys)."""

    def __init__(self, seed: int, lanes: int) -> None:
        self.key = jax.random.PRNGKey(seed)
        self.lanes = lanes

    def __call__(self, samp0, k):
        self.key, sub = jax.random.split(self.key)
        k0, kacc = jax.random.split(sub)
        t0 = jax.random.categorical(k0, jnp.asarray(samp0.numpy()), axis=-1)
        u = jax.random.uniform(kacc, (self.lanes, k), minval=1e-20, maxval=1.0)
        return torch.from_numpy(np.asarray(t0)).long(), torch.from_numpy(np.array(u))


def _record_buckets(jeng, teng):
    """Per-pass verify widths: the JAX engine's ``_verify_fns`` lookups and
    the port's ``_verify`` calls."""
    jk, tk = [], []

    class Lookups(dict):
        def get(self, key, default=None):
            jk.append(key)
            return super().get(key, default)

    jeng._verify_fns = Lookups(jeng._verify_fns)
    real = teng._verify

    def verify(params, gen, k, *rest):
        tk.append(k)
        return real(params, gen, k, *rest)

    teng._verify = verify
    return jk, tk


def _assert_same_completion(t, j):
    assert (t.tag, t.prompt.tolist()) == (j.tag, j.prompt.tolist())
    np.testing.assert_array_equal(t.response_tokens, j.response_tokens)
    np.testing.assert_allclose(t.behavior_logp, j.behavior_logp, atol=TOL)
    np.testing.assert_allclose(t.values, j.values, atol=TOL)
    assert t.generation == j.generation


def _lockstep(s, cfg, n_done=7, inject=False):
    jeng = JaxContinuousEngine(s["jax_model"], s["jax_params"], JaxContinuousConfig(**cfg))
    teng = ContinuousEngine(s["model"], s["state"], ContinuousConfig(**cfg), device="cpu")
    if inject:
        teng._verify_draws = _JaxDraws(cfg["seed"], cfg["lanes"])
    jk, tk = _record_buckets(jeng, teng)
    _submit(jeng, s)
    _submit(teng, s)
    tdone, jdone = [], []
    for _ in range(200):
        if len(jdone) >= n_done:
            break
        jnew, tnew = jeng.step(), teng.step()
        assert len(tnew) == len(jnew)
        for t, j in zip(tnew, jnew):
            _assert_same_completion(t, j)
        tdone += tnew
        jdone += jnew
        assert tk == jk  # the same ladder bucket, pass by pass
        np.testing.assert_array_equal(teng._banned, jeng._banned)
        assert teng.allocator.allocated_pages == jeng.allocator.allocated_pages
        assert teng.allocator.reserved == jeng.allocator.reserved
        for name in ("spec_proposed_total", "spec_accepted_total", "spec_rollback_pages_total",
                     "macro_steps", "live_lanes"):
            assert getattr(teng, name) == getattr(jeng, name), name
    assert len(jdone) == n_done
    assert jeng.allocator.reserved == teng.allocator.reserved == 0
    return teng, jeng, tdone, tk


@pytest.mark.parametrize("eos", [-1, 3])
def test_greedy_spec_engine_matches_jax_pass_by_pass(setup, eos):
    cfg = _base(spec_k=4, spec_ngram=2, eos_token=eos)
    teng, jeng, done, buckets = _lockstep(setup, cfg)
    assert teng._spec_buckets == jeng._spec_buckets == (0, 1, 2, 4)
    assert teng.spec_proposed_total > 0 and teng.spec_accepted_total > 0
    assert set(buckets) > {0}
    assert (teng._banned == -1).all()  # greedy: nothing is ever banned
    st, js = teng.stats(), jeng.stats()
    for key in ("spec_k", "spec_proposed", "spec_accepted", "spec_rollback_pages",
                "spec_acceptance_rate", "macro_steps", "completed", "prefill_tokens",
                "mean_occupancy"):
        assert st[key] == js[key], key


def test_greedy_spec_engine_matches_the_engine_without_speculation(setup):
    plain = ContinuousEngine(setup["model"], setup["state"], ContinuousConfig(**_base()),
                             device="cpu")
    spec = ContinuousEngine(setup["model"], setup["state"],
                            ContinuousConfig(**_base(spec_k=4, spec_ngram=2)), device="cpu")
    runs = []
    for eng in (plain, spec):
        _submit(eng, setup)
        done = eng.run_until(7, max_macro_steps=200)
        runs.append(sorted(done, key=lambda c: (str(c.tag), c.response_tokens.tobytes())))
    for p, s in zip(*runs):
        assert p.tag == s.tag
        np.testing.assert_array_equal(s.response_tokens, p.response_tokens)
        np.testing.assert_allclose(s.behavior_logp, p.behavior_logp, atol=TOL)
        np.testing.assert_allclose(s.values, p.values, atol=TOL)
    assert spec.spec_accepted_total > 0 and spec.spec_timers() is not None
    assert plain.spec_timers() is None


@pytest.mark.parametrize("top_k,eos", [(0, -1), (5, 3)])
def test_temperature_1_accept_and_residual_match_jax_with_its_draws(setup, top_k, eos):
    """Given JAX's bonus draws and uniforms, the port's accept test, accepted
    prefix and banned-token residual are JAX's, pass by pass."""
    cfg = _base(spec_k=4, spec_ngram=1, temperature=1.0, top_k=top_k, eos_token=eos, seed=11)
    teng, jeng, done, _ = _lockstep(setup, cfg, inject=True)
    assert teng.spec_proposed_total > teng.spec_accepted_total > 0


def test_banned_token_is_masked_from_the_next_bonus_draw_only(setup, monkeypatch):
    """The residual rule: a lane whose draft was rejected at temperature > 0
    draws its next bonus token with that token masked out, while the
    stored logp comes from the unmasked distribution."""
    cfg = _base(spec_k=4, spec_ngram=1, temperature=1.0, seed=5)
    eng = ContinuousEngine(setup["model"], setup["state"], ContinuousConfig(**cfg), device="cpu")
    seen = []
    real = eng._verify_draws

    def draws(samp0, k):
        seen.append((samp0.clone(), eng._banned.copy()))
        return real(samp0, k)

    eng._verify_draws = draws
    _submit(eng, setup)
    eng.run_until(7, max_macro_steps=200)
    banned_passes = [(s, b) for s, b in seen if (b >= 0).any()]
    assert banned_passes, "no accept-test rejection in the run"
    for samp0, banned in banned_passes:
        for lane in np.flatnonzero(banned >= 0):
            assert samp0[lane, banned[lane]] < -1e8
            others = np.delete(np.arange(V), banned[lane])
            assert (samp0[lane, others] > -1e8).all()


def test_one_upload_and_one_read_per_spec_pass(setup, monkeypatch):
    eng = ContinuousEngine(setup["model"], setup["state"],
                           ContinuousConfig(**_base(spec_k=4, spec_ngram=2)), device="cpu")
    puts, gets = [], []
    real_put, real_get = tcont._device_put, tcont._device_get
    monkeypatch.setattr(tcont, "_device_put", lambda a, d: (puts.append(len(a)), real_put(a, d))[1])
    monkeypatch.setattr(tcont, "_device_get", lambda x: (gets.append(1), real_get(x))[1])
    eng.submit(setup["prompts"][0], setup["lengths"][0])
    eng.step()  # the admission pass: the prefill upload, then the verify pair
    assert puts == [5, 6] and len(gets) == 1
    while eng.live_lanes or eng.pending:
        puts.clear()
        gets.clear()
        eng.step()
        assert (puts, len(gets)) == ([6], 1)


def test_spec_pass_launches_no_paged_decode(setup):
    """The verify forward attends through the tail-prefill path: the model's
    paged decode seam is never called in spec mode (on the card: no launch
    of the paged kernel)."""
    eng = ContinuousEngine(setup["model"], setup["state"],
                           ContinuousConfig(**_base(spec_k=4, spec_ngram=2)), device="cpu")
    calls = []
    net = eng._run.net
    real = net.paged_attn_fn
    net.paged_attn_fn = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    _submit(eng, setup)
    eng.run_until(7, max_macro_steps=200)
    assert calls == []
    plain = ContinuousEngine(setup["model"], setup["state"], ContinuousConfig(**_base()),
                             device="cpu")
    real_plain = plain._run.net.paged_attn_fn
    plain._run.net.paged_attn_fn = lambda *a, **k: (calls.append(1), real_plain(*a, **k))[1]
    _submit(plain, setup)
    plain.run_until(7, max_macro_steps=200)
    assert len(calls) == plain.macro_steps * 4  # one call a substep (one layer)


def test_spec_telemetry_spans_and_validation(setup):
    tracing.reset(sample_rate=1.0)
    try:
        eng = ContinuousEngine(setup["model"], setup["state"],
                               ContinuousConfig(**_base(spec_k=4, spec_ngram=2)), device="cpu")
        _submit(eng, setup)
        eng.run_until(7, max_macro_steps=200)
        spans = tracing.get_tracer().finished()
    finally:
        tracing.reset(sample_rate=0.0)
    kinds = {s["name"] for s in spans if s.get("kind") == "genrl-spec"}
    assert {"genrl.macro_step", "seq.draft", "seq.verify"} <= kinds
    reg = telemetry.get_registry()
    assert reg.counter("genrl.spec_proposed").value >= eng.spec_proposed_total
    assert reg.counter("genrl.spec_accepted").value >= eng.spec_accepted_total
    assert reg.gauge("genrl.spec_acceptance_rate").value == pytest.approx(eng.spec_acceptance_rate)
    assert telemetry.get_registry().snapshot()["genrl"]["continuous"]["spec_k"] == 4
    for bad in (dict(spec_k=-1), dict(spec_ngram=0)):
        with pytest.raises(ValueError, match="spec_"):
            ContinuousConfig(**_base(**bad)).validate()
