"""The training slice as a whole: the port's ``SequenceRLTrainer`` on the
host against the JAX trainer.

Both trainers start from one Flax init (converted into the port) and draw
the same prompts (the same numpy seed).  The replay's stratification
uniforms are injected, because ``jax.random`` and ``torch.Generator`` give
different numbers from one seed.  With the JAX engine's generation result
injected into the port's cohort round, the packed fields must be array-equal
and the learn metrics within 1e-5; at temperature 0 without injection both
engines of the port produce the JAX trainer's tokens, so the integer fields
are equal and the float fields within 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from scalerl_torch.agents.token_ppo import TokenPPOAgent
from scalerl_torch.config import GenRLArguments
from scalerl_torch.genrl.engine import GenerationResult
from scalerl_torch.genrl.task import TokenRecallTask
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.trainer import sequence_rl as tseq
from scalerl_tpu.config import GenRLArguments as JaxGenRLArguments
from scalerl_tpu.trainer import sequence_rl as jseq

torch.set_num_threads(1)

TOL = 1e-5
INT_FIELDS = ("tokens", "segment_ids", "positions", "generation")
FLOAT_FIELDS = ("behavior_logp", "value", "mask", "reward")


@pytest.fixture(autouse=True)
def _fresh_registries():
    telemetry.reset()
    tracing.reset(0.0)
    yield
    telemetry.reset()
    tracing.reset()


def _trainer_pair(**kw):
    """A JAX trainer and a port trainer that starts from its state, both
    over ragged prompts so rows hold several segments and a pad tail."""
    fields = dict(vocab_size=12, prompt_len=6, max_new_tokens=4, d_model=32, n_layers=1,
                  n_heads=2, genrl_batch=8, genrl_sample_batch=8, genrl_buffer_sequences=16,
                  learner_packing=True, learner_pack_len=24, learning_rate=1e-4, seed=3)
    fields.update(kw)
    jargs, targs = H.genrl_args_pair(**fields)
    task = dict(vocab_size=fields["vocab_size"], prompt_len=(1, fields["prompt_len"]),
                response_len=fields["max_new_tokens"])
    from scalerl_tpu.genrl.task import TokenRecallTask as JaxTask

    jt = jseq.SequenceRLTrainer(jargs, task=JaxTask(**task))
    agent = TokenPPOAgent(targs, tseq.build_genrl_model(targs, device="cpu"))
    agent.state = H.token_ppo_state_to_torch(jt.agent.state)
    tt = tseq.SequenceRLTrainer(targs, task=TokenRecallTask(**task), agent=agent, device="cpu")
    return jt, tt


def _share_uniforms(monkeypatch, jt):
    """Make the port's ``seq_sample`` use the uniforms the JAX trainer draws
    (its key split, then ``jax.random.uniform``).  Returns ``advance()``, to
    call before each pair of rounds."""
    box = {}
    real = tseq.seq_sample
    monkeypatch.setattr(tseq, "seq_sample",
                        lambda state, gen, n, **kw: real(state, gen, n, u=box["u"], **kw))

    def advance():
        _, sub = jax.random.split(jt._sample_key)
        u = jax.random.uniform(sub, (jt.args.genrl_sample_batch,))
        box["u"] = torch.tensor(np.asarray(u))

    return advance


def _capture(monkeypatch, module, name):
    """Record what ``module.name`` (the replay insert) is called with."""
    calls = []
    real = getattr(module, name)

    def wrapper(state, fields, core, priorities):
        calls.append(({k: np.asarray(v) for k, v in fields.items()}, np.asarray(priorities)))
        return real(state, fields, core, priorities)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _assert_metrics_close(tm, jm, tol=TOL):
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, atol=tol, rtol=tol, err_msg=k)


def test_cohort_round_with_injected_generation_matches_jax(monkeypatch):
    jt, tt = _trainer_pair()
    results = []
    real_generate = jt.engine.generate
    monkeypatch.setattr(jt.engine, "generate",
                        lambda *a, **k: (results.append(real_generate(*a, **k)), results[-1])[1])
    monkeypatch.setattr(tt.engine, "generate",
                        lambda *a, **k: GenerationResult(**results[-1]._asdict()))
    jadds = _capture(monkeypatch, jseq, "seq_add")
    tadds = _capture(monkeypatch, tseq, "seq_add")
    advance = _share_uniforms(monkeypatch, jt)
    for _ in range(3):  # the third insert wraps the 16-row ring
        advance()
        jm = jt.train_round()
        tm = tt.train_round()
        (jf, jp), (tf, tp) = jadds[-1], tadds[-1]
        assert set(tf) == set(jf)
        for k in jf:
            assert tf[k].dtype == jf[k].dtype, k
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        np.testing.assert_array_equal(tp, jp)
        _assert_metrics_close(tm, jm)
        assert tm["real_token_frac"] < 1.0 and tf["segment_ids"].max() >= 2
    assert tt.replay.pos == int(jt.replay.pos) and tt.replay.size == int(jt.replay.size)
    np.testing.assert_array_equal(tt.replay.priorities.numpy(), np.asarray(jt.replay.priorities))
    assert tt.learn_steps == 3 and tt.reward_history == pytest.approx(jt.reward_history)


@pytest.mark.parametrize("engine", ["cohort", "continuous"])
def test_first_round_at_temperature_zero_matches_jax(monkeypatch, engine):
    jt, tt = _trainer_pair(temperature=0.0, genrl_engine=engine, genrl_page_size=4,
                           genrl_macro_steps=2)
    jadds = _capture(monkeypatch, jseq, "seq_add")
    tadds = _capture(monkeypatch, tseq, "seq_add")
    _share_uniforms(monkeypatch, jt)()
    jm = jt.train_round()
    tm = tt.train_round()
    (jf, jp), (tf, tp) = jadds[-1], tadds[-1]
    for k in INT_FIELDS:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(tf[k], jf[k], atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tp, jp)
    _assert_metrics_close(tm, jm)
    assert tm["staleness"] == jm["staleness"] and tm["decode_tokens"] == jm["decode_tokens"]


def _learning_args(**kw):
    base = dict(vocab_size=8, prompt_len=4, max_new_tokens=4, d_model=32, n_layers=2, n_heads=2,
                genrl_batch=64, genrl_sample_batch=64, genrl_buffer_sequences=128,
                learner_packing=True, learning_rate=3e-3, seed=3)
    base.update(kw)
    return GenRLArguments(**base)


def test_short_packed_run_raises_the_recall_reward():
    """The bar tests/test_packed_learner.py sets for the JAX trainer: 40
    rounds lift recall well off chance (1/8), with packed replay fields,
    staleness plumbed and the pad-ratio gauge published."""
    t = tseq.SequenceRLTrainer(_learning_args(learner_packed_attn="pallas"), device="cpu")
    assert "segment_ids" in t.replay.storage
    assert t.agent.model.segment_attn_fn is not None
    m = t.train_round()
    assert np.isfinite(m["total_loss"]) and m["staleness"] >= 0
    assert 0.0 <= telemetry.get_registry().gauge("genrl.pad_ratio").value < 1.0
    summary = t.train(39)
    h = t.reward_history
    first, last = float(np.mean(h[:10])), float(np.mean(h[-10:]))
    assert last >= 0.4, (first, last)
    assert last > first + 0.2, (first, last)
    assert summary["rounds"] == 40.0 and summary["final_reward_mean"] == pytest.approx(last)
    assert summary["skipped_steps"] == 0.0


@pytest.mark.parametrize("kw", [
    dict(genrl_engine="continuous", genrl_lanes=8, genrl_page_size=4, genrl_macro_steps=2),
    dict(genrl_engine="continuous", samples_per_prompt=4, genrl_page_size=4),
    dict(samples_per_prompt=2),
    dict(learner_packing=False),
    dict(learner_packing=False, genrl_engine="continuous", genrl_page_size=4),
    dict(kl_cost=0.05, learner_packed_attn="xla", genrl_push_every=2),
], ids=["continuous", "continuous_groups", "cohort_groups", "padded", "padded_continuous",
        "kl_dense_push2"])
def test_rounds_run_in_every_configuration(kw):
    args = _learning_args(genrl_batch=8, genrl_sample_batch=8, genrl_buffer_sequences=16,
                          n_layers=1, **kw)
    t = tseq.SequenceRLTrainer(args, device="cpu")
    for _ in range(4):
        m = t.train_round()
        assert np.isfinite(m["total_loss"]) and m["skipped_steps"] == 0.0
    assert ("segment_ids" in t.replay.storage) == args.learner_packing
    assert ("kl_ref" in m) == (args.kl_cost > 0)
    assert t.engine.generation == 4 // args.genrl_push_every
    assert m["staleness"] >= 0 and t.learn_steps == 4
    if args.genrl_engine == "continuous":
        assert len(t._completion_backlog) < args.genrl_batch + t.engine.config.lanes


def test_learning_does_not_reach_the_engines_snapshot():
    """The weights handed to ``push_params`` are copied by the engine: a
    learn step after a push leaves the engine's snapshot as it was."""
    t = tseq.SequenceRLTrainer(_learning_args(genrl_batch=8, genrl_sample_batch=8,
                                              genrl_buffer_sequences=16), device="cpu")
    t.train_round()  # learn, then push generation 1
    snapshot, gen = t.engine._snapshot_params()
    frozen = {k: v.clone() for k, v in snapshot.items()}
    live = t.agent.get_weights()
    for k, v in snapshot.items():
        assert v.data_ptr() != live[k].data_ptr(), k
        assert torch.equal(v, live[k]), k
    args = dataclasses.replace(t.args, genrl_push_every=100)
    t.args = args
    t.train_round()  # learns, does not push
    after, gen_after = t.engine._snapshot_params()
    assert gen_after == gen == 1
    for k, v in frozen.items():
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(t.agent.get_weights()[k], v) for k, v in frozen.items())


def test_round_outside_the_bucket_pair_and_wrong_device_are_refused(monkeypatch):
    t = tseq.SequenceRLTrainer(_learning_args(genrl_batch=8, genrl_sample_batch=8,
                                              genrl_buffer_sequences=16), device="cpu")
    real = t.engine.generate
    monkeypatch.setattr(t.engine, "generate",
                        lambda *a, **k: real(*a, **k)._replace(response_pad=8))
    with pytest.raises(ValueError, match="bucket pair"):
        t.train_round()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tseq.SequenceRLTrainer(_learning_args())
    with pytest.raises(RuntimeError, match="cuda"):
        tseq.build_genrl_model(_learning_args())


def test_traced_round_records_its_spans():
    tracing.reset(1.0)
    t = tseq.SequenceRLTrainer(_learning_args(genrl_batch=8, genrl_sample_batch=8,
                                              genrl_buffer_sequences=16), device="cpu")
    t.train_round()
    names = [s["name"] for s in tracing.get_tracer().finished()]
    for want in ("genrl.round", "round.generate", "round.seq_add", "round.learn"):
        assert want in names


def test_upload_units_is_one_copy(monkeypatch):
    calls = []
    real = tseq._device_put
    monkeypatch.setattr(tseq, "_device_put", lambda a, d: (calls.append(len(a)), real(a, d))[1])
    t = tseq.SequenceRLTrainer(_learning_args(genrl_batch=8, genrl_sample_batch=8,
                                              genrl_buffer_sequences=16), device="cpu")
    t.train_round()
    assert calls == [9]  # eight packed fields and the priorities, in one upload
    fields = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b": np.linspace(0, 1, 4, dtype=np.float32).reshape(2, 2)}
    dev, prio = tseq.upload_units(fields, np.array([1.0, 0.0], np.float32), torch.device("cpu"))
    np.testing.assert_array_equal(dev["a"].numpy(), fields["a"])
    np.testing.assert_array_equal(dev["b"].numpy(), fields["b"])
    assert dev["b"].dtype == torch.float32 and prio.tolist() == [1.0, 0.0]
    with pytest.raises(TypeError, match="int32 or float32"):
        tseq.upload_units({"a": np.zeros(2, np.int64)}, np.zeros(2, np.float32), torch.device("cpu"))


def test_genrl_arguments_defaults_equal_the_jax_ones():
    jdefaults = {f.name: f.default for f in dataclasses.fields(JaxGenRLArguments)}
    ported = dataclasses.fields(GenRLArguments)
    assert len(ported) > 50
    for f in ported:
        assert f.name in jdefaults, f.name
        assert f.default == jdefaults[f.name], f.name
    GenRLArguments().validate()


@pytest.mark.parametrize("kw,match", [
    # the mesh fields validate; resolved in one process they are refused
    (dict(dp_size=2), "init_process_group"),
    (dict(mp_size=2), "does not divide"),
    (dict(resume="ckpt"), "disagg_ledger_dir"),
])
def test_unported_fields_are_refused(kw, match):
    from scalerl_torch.parallel import make_mesh, mesh_spec_from_args

    args = GenRLArguments(**kw)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        args.validate()
        make_mesh(mesh_spec_from_args(args))


@pytest.mark.parametrize("kw,match", [
    (dict(spec_enable=True), "genrl_engine"),
    (dict(spec_enable=True, genrl_engine="continuous", spec_k=0), "spec_k"),
    (dict(spec_ngram=0), "spec_ngram"),
    (dict(disagg_hosts=0), "disagg_hosts"),
    (dict(disagg_upload_batch=0), "disagg_upload_batch"),
    (dict(disagg_quantize="fp8"), "disagg_quantize"),
    (dict(disagg_round_timeout_s=0.0), "disagg_round_timeout_s"),
])
def test_lifted_switches_validate_like_jax(kw, match):
    """Speculation, bf16 params and the disaggregated fields are no longer
    refused; their checks are JAX's (the JAX arguments refuse the same)."""
    with pytest.raises(ValueError, match=match):
        GenRLArguments(**kw).validate()
    with pytest.raises(ValueError):
        JaxGenRLArguments(**kw).validate()
    GenRLArguments(spec_enable=True, genrl_engine="continuous", bf16_params=True,
                   disagg_hosts=4, disagg_ledger_dir="/tmp/x").validate()


@pytest.mark.parametrize("kw,match", [
    (dict(vocab_size=3), "vocab_size"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(temperature=-1.0), "temperature"),
    (dict(clip_range=1.0), "clip_range"),
    (dict(kl_cost=-0.1), "kl_cost"),
    (dict(genrl_sample_batch=0), "genrl_sample_batch"),
    (dict(genrl_buffer_sequences=8), "genrl_buffer_sequences"),
    (dict(genrl_push_every=0), "genrl_push_every"),
    (dict(genrl_iter_mode="jit"), "genrl_iter_mode"),
    (dict(genrl_engine="disagg"), "genrl_engine"),
    (dict(genrl_page_size=0), "genrl_page_size"),
    (dict(genrl_macro_steps=0), "genrl_macro_steps"),
    (dict(genrl_paged_attn="mosaic"), "genrl_paged_attn"),
    (dict(samples_per_prompt=3), "multiple"),
    (dict(genrl_steps_in_flight=0), "genrl_steps_in_flight"),
    (dict(learner_packed_attn="mosaic"), "learner_packed_attn"),
    (dict(learner_pack_len=-1), "learner_pack_len"),
    (dict(learner_pack_len=4), "fit one"),
])
def test_arguments_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        GenRLArguments(**kw).validate()
    with pytest.raises(ValueError, match=match):
        JaxGenRLArguments(**kw).validate()
