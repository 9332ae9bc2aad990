"""The port's ``genrl/rollout.py`` and ``genrl/task.py`` against the JAX
package's: the same seeded host inputs must give array-equal outputs from
both (the modules are host numpy in both packages)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scalerl_torch.genrl import rollout as trollout
from scalerl_torch.genrl import task as ttask
from scalerl_torch.genrl.engine import GenerationResult
from scalerl_torch.runtime import telemetry
from scalerl_tpu.genrl import rollout as jrollout
from scalerl_tpu.genrl import task as jtask
from scalerl_tpu.genrl.engine import GenerationResult as JaxGenerationResult

torch.set_num_threads(1)


def _sequences(seed, B=9, P=6, R=5, V=13):
    rng = np.random.default_rng(seed)
    plens = rng.integers(1, P + 1, B)
    rlens = rng.integers(1, R + 1, B)
    return dict(
        prompts=[rng.integers(1, V, n).astype(np.int32) for n in plens],
        responses=[rng.integers(1, V, n).astype(np.int32) for n in rlens],
        behavior_logp=[np.log(rng.uniform(0.05, 0.5, n)).astype(np.float32) for n in rlens],
        values=[rng.normal(0, 0.1, n).astype(np.float32) for n in rlens],
        rewards=rng.uniform(0, 1, B).astype(np.float32),
        generations=rng.integers(0, 3, B).astype(np.int32),
    )


def _assert_same_batch(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _result(seed, B=7, P=8, R=4, V=13, cls=GenerationResult):
    rng = np.random.default_rng(seed)
    plen = rng.integers(1, P + 1, B).astype(np.int32)
    rlen = rng.integers(1, R + 1, B).astype(np.int32)
    seqs = rng.integers(1, V, (B, P + R)).astype(np.int32)
    mask = (np.arange(R)[None] < rlen[:, None]).astype(np.float32)
    return cls(
        sequences=seqs, response_tokens=seqs[:, P:].copy(),
        behavior_logp=rng.normal(size=(B, R)).astype(np.float32),
        values=rng.normal(size=(B, R)).astype(np.float32), mask=mask, response_len=rlen,
        prompt_len=plen, prompt_pad=P, response_pad=R, generation=3,
    )


@pytest.mark.parametrize("lengths,pack_len", [
    ([3, 5, 2, 4, 1], 8), ([9, 3, 3, 9, 2], 8), ([], 8), ([4, 4, 4, 4], 8), ([1] * 20, 7),
])
def test_greedy_pack_equals_jax(lengths, pack_len):
    assert trollout.greedy_pack(lengths, pack_len) == jrollout.greedy_pack(lengths, pack_len)


def test_greedy_pack_first_fit_decreasing():
    rows, shed = trollout.greedy_pack([3, 5, 2, 4, 1], pack_len=8)
    assert rows == [[1, 0], [3, 2, 4]] and shed == []
    rows, shed = trollout.greedy_pack([9, 3, 3, 9, 2], pack_len=8)
    assert shed == [0, 3] and sorted(i for r in rows for i in r) == [1, 2, 4]


@pytest.mark.parametrize("seed,pack_len,with_prio", [(0, 11, False), (1, 16, True), (2, 24, False)])
def test_pack_learner_batch_equals_jax(seed, pack_len, with_prio):
    s = _sequences(seed)
    prio = np.random.default_rng(seed).uniform(0, 2, len(s["prompts"])) if with_prio else None
    args = (s["prompts"], s["responses"], s["behavior_logp"], s["values"], s["rewards"],
            s["generations"], pack_len)
    got = trollout.pack_learner_batch(*args, priorities=prio)
    want = jrollout.pack_learner_batch(*args, priorities=prio)
    _assert_same_batch(got, want)
    for prop in ("rows", "pack_len", "real_tokens", "decode_tokens", "pad_ratio"):
        assert getattr(got, prop) == getattr(want, prop)
    gf, gp = got.fields()
    assert list(gf) == list(trollout.packed_field_shapes(pack_len))
    np.testing.assert_array_equal(gp, want.fields()[1])
    _assert_same_batch(got.bucketed(16), want.bucketed(16))


def test_pack_learner_batch_row_layout():
    pk = trollout.pack_learner_batch(
        [np.array([7, 8], np.int32), np.array([5], np.int32)],
        [np.array([1, 2], np.int32), np.array([3], np.int32)],
        [np.array([-0.5, -0.7], np.float32), np.array([-0.2], np.float32)],
        [np.array([0.1, 0.2], np.float32), np.array([0.3], np.float32)],
        rewards=np.array([1.0, 0.5], np.float32), generations=np.array([4, 6], np.int32),
        pack_len=8,
    )
    assert pk.rows == 1 and pk.sequences_packed == 2
    np.testing.assert_array_equal(pk.tokens[0], [7, 8, 1, 2, 5, 3, 0, 0])
    np.testing.assert_array_equal(pk.segment_ids[0], [1, 1, 1, 1, 2, 2, 0, 0])
    np.testing.assert_array_equal(pk.positions[0], [0, 1, 2, 3, 0, 1, 0, 0])
    np.testing.assert_array_equal(pk.mask[0], [0, 0, 1, 1, 0, 1, 0, 0])
    np.testing.assert_allclose(pk.reward[0], [0, 0, 1.0, 1.0, 0, 0.5, 0, 0])
    np.testing.assert_array_equal(pk.generation[0], [4, 4, 4, 4, 6, 6, 0, 0])
    assert pk.pad_ratio == pytest.approx(2 / 8)


def test_pack_learner_batch_zero_rows_and_bucketed():
    pk = trollout.pack_learner_batch([], [], [], [], np.zeros(0, np.float32),
                                     np.zeros(0, np.int32), pack_len=8)
    assert pk.rows == 0 and pk.tokens.shape == (0, 8)
    assert pk.pad_ratio == 0.0 and pk.decode_tokens == 0
    one = trollout.pack_learner_batch(
        [np.array([1], np.int32)], [np.array([2], np.int32)], [np.array([-0.1], np.float32)],
        [np.array([0.0], np.float32)], np.array([1.0], np.float32), np.array([0], np.int32), 8)
    b = one.bucketed(4)
    assert b.rows == 4
    np.testing.assert_array_equal(b.segment_ids[1:], 0)
    np.testing.assert_array_equal(b.priorities, [1.0, 0.0, 0.0, 0.0])  # pad rows: never sampled
    with pytest.raises(ValueError, match="row bucket"):
        one.bucketed(0)


def test_pack_learner_batch_sheds_oversize_and_counts_it():
    telemetry.reset()
    pk = trollout.pack_learner_batch(
        [np.arange(6, dtype=np.int32), np.array([1], np.int32)],
        [np.arange(6, dtype=np.int32), np.array([2], np.int32)],
        [np.zeros(6, np.float32), np.zeros(1, np.float32)],
        [np.zeros(6, np.float32), np.zeros(1, np.float32)],
        np.array([1.0, 0.5], np.float32), np.zeros(2, np.int32), pack_len=8,
    )
    assert pk.sequences_shed == 1 and pk.sequences_packed == 1
    assert telemetry.get_registry().counter("genrl.pack_oversize_shed").value == 1
    assert pk.reward[pk.mask > 0].max() == pytest.approx(0.5)
    with pytest.raises(ValueError, match="rewards"):
        trollout.pack_learner_batch([], [], [], [], np.zeros(2, np.float32), np.zeros(0), 8)


@pytest.mark.parametrize("with_prio", [False, True])
def test_pack_sequences_equals_jax(with_prio):
    rewards = np.linspace(0, 1, 7).astype(np.float32)
    prio = np.linspace(0, 2, 7) if with_prio else None
    gf, gp = trollout.pack_sequences(_result(4), rewards, prio)
    wf, wp = jrollout.pack_sequences(_result(4, cls=JaxGenerationResult), rewards, prio)
    assert list(gf) == list(wf) == list(trollout.sequence_field_shapes(8, 4))
    for k in wf:
        assert gf[k].dtype == wf[k].dtype
        np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    np.testing.assert_array_equal(gp, wp)
    with pytest.raises(ValueError, match="rewards"):
        trollout.pack_sequences(_result(4), rewards[:3])


def test_field_tables_equal_jax():
    for got, want in ((trollout.sequence_field_shapes(8, 4), jrollout.sequence_field_shapes(8, 4)),
                      (trollout.packed_field_shapes(24), jrollout.packed_field_shapes(24))):
        assert list(got) == list(want)
        for k in want:
            assert got[k][0] == want[k][0] and np.dtype(got[k][1]) == np.dtype(want[k][1])


def _completions(seed, n=8, P=6, R=5, V=13):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m, r = int(rng.integers(1, P + 1)), int(rng.integers(1, R + 1))
        out.append(SimpleNamespace(
            prompt=rng.integers(1, V, m).astype(np.int32), prompt_len=m,
            response_tokens=rng.integers(1, V, r).astype(np.int32),
            behavior_logp=rng.normal(size=r).astype(np.float32),
            values=rng.normal(size=r).astype(np.float32), generation=int(rng.integers(0, 4)),
        ))
    return out


def test_pack_completions_equals_jax_and_sheds_oversize():
    telemetry.reset()
    comps = _completions(5)
    comps.append(SimpleNamespace(prompt=np.ones(9, np.int32), prompt_len=9,
                                 response_tokens=np.ones(2, np.int32),
                                 behavior_logp=np.zeros(2, np.float32),
                                 values=np.zeros(2, np.float32), generation=0))
    got = trollout.pack_completions(comps, 6, 5)
    want = jrollout.pack_completions(comps, 6, 5)
    _assert_same_batch(got, want)
    assert got.sequences.shape[0] == 8  # the 9-token prompt was shed
    assert telemetry.get_registry().counter("genrl.oversize_shed").value == 1
    assert got.decode_tokens == want.decode_tokens
    rewards = np.linspace(0, 1, 8).astype(np.float32)
    (gf, gp), (wf, wp) = got.fields(rewards), want.fields(rewards)
    for k in wf:
        np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    np.testing.assert_array_equal(gp, wp)
    empty = trollout.pack_completions([], 6, 5)
    assert empty.sequences.shape == (0, 11) and empty.decode_tokens == 0


@pytest.mark.parametrize("pack_len", [12, 24])
def test_packed_rows_from_result_equals_jax(pack_len):
    rewards = np.linspace(0, 1, 7).astype(np.float32)
    got = trollout.packed_rows_from_result(_result(6), rewards, pack_len)
    want = jrollout.packed_rows_from_result(_result(6, cls=JaxGenerationResult), rewards, pack_len)
    _assert_same_batch(got, want)
    res = _result(6)
    assert got.decode_tokens == res.decode_tokens
    assert got.real_tokens == int(res.prompt_len.sum()) + res.decode_tokens


@pytest.mark.parametrize("pack_len", [11, 22])
def test_packed_rows_from_completions_equals_jax(pack_len):
    comps = _completions(7)
    rewards = np.linspace(1, 0, 8).astype(np.float32)
    got = trollout.packed_rows_from_completions(
        trollout.pack_completions(comps, 6, 5), rewards, pack_len)
    want = jrollout.packed_rows_from_completions(
        jrollout.pack_completions(comps, 6, 5), rewards, pack_len)
    _assert_same_batch(got, want)
    assert got.sequences_packed == 8


@pytest.mark.parametrize("mode,prompt_len", [("recall", 4), ("recall", (2, 6)), ("copy", (1, 5))])
def test_token_task_equals_jax(mode, prompt_len):
    t = ttask.TokenRecallTask(vocab_size=11, prompt_len=prompt_len, response_len=5, mode=mode)
    j = jtask.TokenRecallTask(vocab_size=11, prompt_len=prompt_len, response_len=5, mode=mode)
    assert t.max_prompt_len == j.max_prompt_len
    tp, tl = t.sample_prompts(6, np.random.default_rng(3))
    jp, jl = j.sample_prompts(6, np.random.default_rng(3))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    rng = np.random.default_rng(4)
    resp = np.where(rng.random((6, 5)) < 0.5, tp[:, :1], rng.integers(2, 11, (6, 5))).astype(np.int32)
    rlen = rng.integers(0, 6, 6).astype(np.int32)
    np.testing.assert_array_equal(t.score(tp, tl, resp, rlen), j.score(jp, jl, resp, rlen))
    with pytest.raises(ValueError):
        ttask.TokenRecallTask(vocab_size=3)
