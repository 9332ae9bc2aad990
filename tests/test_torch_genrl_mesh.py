"""Sequence RL across ranks: the port's engines, ``make_parallel_act_fn``
and ``SequenceRLTrainer`` on a four-rank gloo world (``dp=2,mp=2``),
against the JAX package's unmeshed engines, act function and trainer.

One world of 4 spawned ranks serves the module
(``tests/torch_genrl_mesh_helpers.py``, jax-free).  Every case starts from
one JAX token-PPO agent (2 layers, d=32, 4 heads) converted through
``convert.py``.  Each ``dp`` group's two ``mp`` ranks decode on their own 2
of the 4 heads, from the same prompts:

- the cohort and the continuous engine (prompts repeated so the prefix
  cache hits, and fed one a step so each waits out a 2 ms admission
  deadline while other lanes decode, the second rank of each pair polling
  on a clock 1 s ahead) at temperature 0 give the JAX cohort engine's
  tokens, logp and values within 1e-5;
- at temperature 1 (and with speculation) the tokens are the same on every
  rank and the same as the port's one-rank engine with the same seed; the
  carried logits are bit-equal across ranks, and so are the page tables,
  the allocator and the prefix cache after every step; each rank's pools
  hold 2 heads;
- an int8 push scales an mp-sharded leaf by the whole leaf's max.

``make_parallel_act_fn`` at ``dp=2,tp=2`` and at ``dp=2,mp=2`` matches the
JAX function on its 8 host devices within 1e-5 and gathers no param.
``SequenceRLTrainer`` at ``dp=2,mp=2`` takes two rounds with every rank's
inserts, replay and metrics bit-equal; its first round's generation at
temperature 0 is the JAX one-process trainer's, its first loss within 1e-5
of the port's one-rank trainer and its params after two rounds at the JAX
mesh tests' ``rtol=2e-5, atol=2e-6``.  A save resumes bit for bit, the
time window and a preemption stop every rank alike, and the disaggregated
trainer refuses several ranks naming what it lacks.
"""

import dataclasses
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_genrl_mesh_helpers
import torch_port_helpers as H

from scalerl_torch.agents.token_ppo import TokenPPOAgent
from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine
from scalerl_torch.genrl.task import TokenRecallTask
from scalerl_torch.trainer import sequence_rl as tseq
from scalerl_tpu.genrl.engine import GenerationConfig as JaxGenerationConfig
from scalerl_tpu.genrl.engine import GenerationEngine as JaxGenerationEngine
from scalerl_tpu.genrl.task import TokenRecallTask as JaxTask
from scalerl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from scalerl_tpu.parallel.train_step import make_parallel_act_fn as jax_make_parallel_act_fn
from scalerl_tpu.trainer import sequence_rl as jseq

torch.set_num_threads(1)

WORLD = 4
SPEC = "dp=2,mp=2"
JOIN_TIMEOUT_S = 150
TOL = 1e-5
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
V, P_MAX, R_MAX = 12, 6, 4
FIELDS = dict(vocab_size=V, prompt_len=P_MAX, max_new_tokens=R_MAX, d_model=32, n_layers=2,
              n_heads=4, genrl_batch=8, genrl_sample_batch=8, genrl_buffer_sequences=16,
              learner_packing=True, learner_pack_len=24, learning_rate=1e-4, seed=3)
TASK = dict(vocab_size=V, prompt_len=(1, P_MAX), response_len=R_MAX)
COHORT = dict(vocab_size=V, max_prompt_len=P_MAX, max_new_tokens=R_MAX, seed=7)
ENGINE = dict(COHORT, lanes=3, page_size=2, steps_per_macro=2, admit_max_wait_s=0.002,
              prefix_cache=True)
INT_FIELDS = ("tokens", "segment_ids", "positions", "generation")
FLOAT_FIELDS = ("behavior_logp", "value", "mask", "reward")


def _prompts():
    """Five ragged prompts, then the first two again (prefix-cache hits)."""
    rng = np.random.default_rng(1)
    prompts = rng.integers(2, V, size=(5, P_MAX)).astype(np.int32)
    lengths = np.array([6, 4, 3, 2, 1], np.int32)
    return np.concatenate([prompts, prompts[:2]]), np.concatenate([lengths, lengths[:2]])


def _one_rank_continuous(agent, prompts, lengths, **kw):
    eng = ContinuousEngine(agent.model, agent.engine_weights(),
                           ContinuousConfig(**{**ENGINE, **kw}), device="cpu")
    for i, (p, n) in enumerate(zip(prompts, lengths)):
        assert eng.submit(p, n, tag=i)
    return {c.tag: c.response_tokens for c in eng.run_until(len(prompts), max_macro_steps=200)}


def _cases_and_references():
    """The rank cases, and what the test process computes to hold them to:
    the JAX engine, act function and trainer round, the port's one-rank
    engines and trainer."""
    jargs, targs = H.genrl_args_pair(**FIELDS, temperature=0.0)
    jt = jseq.SequenceRLTrainer(jargs, task=JaxTask(**TASK))
    state = H.token_ppo_state_to_torch(jt.agent.state)
    meshed = dataclasses.replace(targs, mesh_shape=SPEC)
    prompts, lengths = _prompts()
    tokens = np.random.default_rng(2).integers(1, V, size=(8, P_MAX)).astype(np.int32)
    base = dict(state=state, prompts=prompts, lengths=lengths)
    cases = {
        "engines": dict(base, kind="engines", args=targs, spec=SPEC, cohort=COHORT,
                        engine=ENGINE),
        "act_tp": dict(base, kind="act", args=targs, spec="dp=2,tp=2", rules="heuristic",
                       tokens=torch.tensor(tokens)),
        "act_mp": dict(base, kind="act", args=targs, spec=SPEC, rules="mp",
                       tokens=torch.tensor(tokens)),
        "train": dict(base, kind="train", args=meshed, task=TASK),
        "resume": dict(base, kind="resume", task=TASK,
                       args=dataclasses.replace(meshed, temperature=1.0)),
        "stops": dict(base, kind="stops", args=meshed, task=TASK),
        "disagg": dict(base, kind="disagg", args=meshed),
    }

    def references():
        ref = {}
        ref["jax_cohort_t0"] = JaxGenerationEngine(
            jt.agent.model, jt.agent.get_weights(),
            JaxGenerationConfig(**COHORT, temperature=0.0)).generate(prompts, lengths)

        def jax_act(params, x):
            out = jt.agent.model.apply(params, x)
            return out.policy_logits, out.baseline

        for name, spec in (("act_tp", "dp=4,tp=2"), ("act_mp", "dp=4,mp=2")):
            act = jax_make_parallel_act_fn(jax_act, jax_make_mesh(spec), jt.agent.get_weights())
            logits, values = act(act.shard_params(jt.agent.get_weights()),
                                 act.shard_batch(jnp.asarray(tokens)))
            ref[name] = (np.asarray(logits), np.asarray(values))
        # the JAX one-process trainer's first round, as its replay insert
        ref["jax_round1"] = jt._round_cohort()[:2]
        # the port on one rank, from the same state
        agent = TokenPPOAgent(targs, tseq.build_genrl_model(targs, device="cpu"))
        agent.state = state
        cohort = GenerationEngine(agent.model, agent.engine_weights(),
                                  GenerationConfig(**COHORT, temperature=1.0), device="cpu")
        ref["cohort_t1"] = cohort.generate(prompts, lengths).response_tokens
        ref["continuous_t1"] = _one_rank_continuous(agent, prompts, lengths, temperature=1.0)
        ref["spec_t1"] = _one_rank_continuous(agent, prompts, lengths, temperature=1.0,
                                              spec_k=2, steps_in_flight=1)
        one = TokenPPOAgent(targs, tseq.build_genrl_model(targs, device="cpu"))
        one.state = state
        tt = tseq.SequenceRLTrainer(targs, task=TokenRecallTask(**TASK), agent=one, device="cpu")
        ref["one_rank_metrics"] = [tt.train_round() for _ in range(2)]
        ref["one_rank_params"] = {k: v.clone() for k, v in tt.agent.state.params.items()}
        return ref

    return cases, references


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of ``WORLD`` ranks; the references
    are computed here while the ranks run.  Returns (references, the
    ranks' results)."""
    workdir = str(tmp_path_factory.mktemp("genrl_mesh"))
    cases, references = _cases_and_references()
    torch.save(cases, f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_genrl_mesh_helpers.run_rank,
                             args=(WORLD, _free_port(), workdir), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        ref = references()
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return ref, [torch.load(f"{workdir}/rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _ranks(world, name):
    _, ranks = world
    for r, got in enumerate(ranks):
        assert "error" not in got[name], f"rank {r}: {got[name]['error']}"
    return [got[name] for got in ranks]


def _assert_matches_jax_cohort(done, ref):
    """Completions by prompt index against the JAX cohort round's rows."""
    assert sorted(done) == list(range(len(ref.response_len)))
    for i, c in done.items():
        n = int(ref.response_len[i])
        np.testing.assert_array_equal(c["tokens"], ref.response_tokens[i, :n], err_msg=str(i))
        np.testing.assert_allclose(c["logp"], ref.behavior_logp[i, :n], atol=TOL, rtol=0)
        np.testing.assert_allclose(c["values"], ref.values[i, :n], atol=TOL, rtol=0)


def test_cohort_engine_on_heads_matches_jax_at_temperature_0(world):
    ref = world[0]["jax_cohort_t0"]
    for got in _ranks(world, "engines"):
        res = got["cohort_t0"]
        for field in ("sequences", "response_tokens", "mask", "response_len"):
            np.testing.assert_array_equal(res[field], getattr(ref, field), err_msg=field)
        np.testing.assert_allclose(res["behavior_logp"], ref.behavior_logp, atol=TOL, rtol=0)
        np.testing.assert_allclose(res["values"], ref.values, atol=TOL, rtol=0)


def test_continuous_engine_on_heads_matches_jax_at_temperature_0(world):
    ref = world[0]["jax_cohort_t0"]
    for got in _ranks(world, "engines"):
        run = got["continuous_t0"]
        _assert_matches_jax_cohort(run["done"], ref)
        assert run["prefix_saved"] > 0  # the repeated prompts hit the cache
        assert run["trace"][-1]["prefix"]["hits"] > 0


@pytest.mark.parametrize("run", ["cohort_t1", "continuous_t1", "spec_t1"])
def test_sampled_tokens_agree_across_ranks_and_with_one_rank(world, run):
    """At temperature 1 every rank draws the same tokens from its identically
    seeded generator, which are the one-rank engine's with that seed."""
    want = world[0][run]
    for got in _ranks(world, "engines"):
        if run == "cohort_t1":
            np.testing.assert_array_equal(got[run]["response_tokens"], want)
            continue
        done = got[run]["done"]
        assert sorted(done) == sorted(want)
        for i, w in want.items():
            np.testing.assert_array_equal(done[i]["tokens"], w, err_msg=f"{run} {i}")
    if run == "spec_t1":
        assert _ranks(world, "engines")[0][run]["proposed"] > 0  # the drafter proposed


@pytest.mark.parametrize("run", ["continuous_t0", "continuous_t1", "spec_t1"])
def test_logits_and_bookkeeping_are_bit_equal_across_ranks(world, run):
    """After every step: the carried logits bit for bit, the page table, the
    allocator and the prefix cache, on all four ranks; each rank's pools
    hold n_heads / mp = 2 heads."""
    ranks = [got[run] for got in _ranks(world, "engines")]
    first = ranks[0]
    assert first["pool_shape"][2] == 2 and first["pool_shape"][3] == 8
    for other in ranks[1:]:
        assert other["pool_shape"] == first["pool_shape"]
        assert len(other["trace"]) == len(first["trace"])
        for a, b in zip(first["trace"], other["trace"]):
            assert torch.equal(a["logits"], b["logits"])
            np.testing.assert_array_equal(a["table"], b["table"])
            assert a["pages"] == b["pages"] and a["prefix"] == b["prefix"]


def test_int8_scale_of_a_sharded_leaf_is_the_whole_leaf_scale(world):
    for got in _ranks(world, "engines"):
        scales = got["int8"]
        sharded = [k for k, (_, _, local, whole) in scales.items() if local != whole]
        assert "blocks.0.qkv.weight" in sharded and "policy_head.weight" in sharded
        for k, (scale, whole_scale, _, _) in scales.items():
            assert scale == np.float32(whole_scale), k


@pytest.mark.parametrize("name", ["act_tp", "act_mp"])
def test_parallel_act_fn_computes_on_shards_and_matches_jax(world, name):
    want_logits, want_values = world[0][name]
    for got in _ranks(world, name):
        assert got["dtensor_gathers"] == 0  # no gather_tree in the call
        assert got["sharded"] > 0 and got["rows"] == 4  # dp=2 halves the 8 rows
        np.testing.assert_allclose(got["logits"].numpy(), want_logits, atol=TOL, rtol=0)
        np.testing.assert_allclose(got["values"].numpy(), want_values, atol=TOL, rtol=0)


def test_meshed_trainer_generates_the_jax_trainers_first_round(world):
    (jf, jp) = world[0]["jax_round1"]
    for got in _ranks(world, "train"):
        fields, priorities = got["inserts"][0]
        for k in INT_FIELDS:
            np.testing.assert_array_equal(fields[k].numpy(), jf[k], err_msg=k)
        for k in FLOAT_FIELDS:
            np.testing.assert_allclose(fields[k].numpy(), jf[k], atol=TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(priorities.numpy(), jp, atol=TOL, rtol=0)


def test_meshed_trainer_rounds_are_bit_equal_across_ranks(world):
    ranks = _ranks(world, "train")
    first = ranks[0]
    assert first["shape"]["dp"] == 2 and first["shape"]["mp"] == 2
    assert first["pool_heads"] == 2 and first["guard"] is False
    assert first["batch_mode"] == "split"
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for (fa, pa), (fb, pb) in zip(first["inserts"], other["inserts"]):
            assert all(torch.equal(fa[k], fb[k]) for k in fa) and torch.equal(pa, pb)
        assert all(torch.equal(first["replay"][k], other["replay"][k]) for k in first["replay"])
        assert torch.equal(first["priorities"], other["priorities"])
        for pa, pb in zip(first["params"], other["params"]):
            assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_meshed_trainer_matches_the_one_rank_trainer(world):
    ref = world[0]
    got = _ranks(world, "train")[0]
    want = ref["one_rank_metrics"]
    np.testing.assert_allclose(got["metrics"][0]["total_loss"], want[0]["total_loss"],
                               atol=TOL, rtol=TOL)
    assert got["metrics"][1]["mean_generation"] == want[1]["mean_generation"]
    for k, v in ref["one_rank_params"].items():
        np.testing.assert_allclose(got["params"][1][k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)


def test_meshed_trainer_resumes_bit_for_bit(world):
    for got in _ranks(world, "resume"):
        assert got["equal"]
        assert got["metrics"][0] == got["metrics"][1]
        assert got["steps"] == (2, 2) and got["generation"][0] == got["generation"][1]


def test_stop_and_preemption_are_agreed_across_ranks(world):
    for got in _ranks(world, "stops"):
        assert got["rounds"] == (0.0, 0.0) and got["steps"] == 0
    assert _ranks(world, "stops")[0]["saved"]


def test_disaggregated_trainer_refuses_several_ranks(world):
    for got in _ranks(world, "disagg"):
        assert got["refusal"] is not None
        assert "fleet, leases and ledger" in got["refusal"] and "rank 0" in got["refusal"]
