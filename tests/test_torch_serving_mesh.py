"""The inference server beside an mp learner: the port's ``InferenceServer``
on a four-rank gloo world (``dp=2,mp=2``) against the JAX server at
``dp=4,mp=2`` on its 8 host devices (``tests/test_serving.py:569-611``).

One world of 4 spawned ranks serves the module
(``tests/torch_serving_mesh_helpers.py``, jax-free).  Every case starts
from one JAX transformer IMPALA agent (2 layers, d=32, 2 heads) converted
through ``convert.py``:

- each rank holds 1/mp of every mp leaf after construction, after a push of
  whole host numpy weights and after a push of the live state, and neither
  push issues a collective; beside a pure-dp learner no leaf is sharded;
- three flushes driven tick by tick, in which one rank of a pair at a time
  has no request of its own, pool the pair's lanes: the replies' logits are
  within 1e-5 of the JAX server's on the same pooled requests, and the
  actions equal with the JAX server's Gumbel draws injected through
  ``_gumbel``; the pooled logits and actions are bit-equal across the pair;
- with the flush threads running, a rank whose queue stays empty flushes in
  step with its peer, and a stop on that rank alone ends both loops;
- requests no offer can carry are refused at admission with no collective,
  a batch that fails to pack on one rank is answered with its error while
  its peer's lanes flush, observations of different shapes on the two ranks
  are answered with errors on both, and the pair stays in step throughout;
- a failure inside one rank's pooled section ends its loop, and its peer's
  after the server groups' timeout;
- a few learn steps of the serving trainer at ``dp=2,mp=2``: every rank's
  server holds its shards of the newest push, and no client fell back.
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_port_helpers as H
import torch_serving_mesh_helpers

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.utils.buckets import bucket_for, default_buckets
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.serving import InferenceServer as JServer
from scalerl_tpu.serving import ServingConfig as JConfig
from scalerl_tpu.serving import ServingRequest as JRequest
from scalerl_tpu.serving import local_pair as jlocal_pair

torch.set_num_threads(1)

WORLD = 4
SPEC = "dp=2,mp=2"
JOIN_TIMEOUT_S = 150
TOL = 1e-5
OBS, A = (4,), 2
SERVING = dict(max_batch=4, max_wait_s=0.002, seed=3)
FIELDS = dict(policy_arch="transformer", d_model=32, n_heads=2, n_layers=2, use_lstm=False,
              rollout_length=8, batch_size=4, max_timesteps=0)
# lanes of each request a flush, per mp rank of a pair: each rank has no
# request of its own in one flush (the second before it ever admitted one)
LANES = ([[2], []], [[1], [1, 2]], [[], [3]])


def _requests(group):
    """Each flush's requests of dp group ``group``, per mp rank: (id,
    payload) pairs."""
    rng = np.random.default_rng(10 + group)
    flushes = []
    for f, per_rank in enumerate(LANES):
        flush = []
        for c, lanes in enumerate(per_rank):
            reqs = []
            for i, n in enumerate(lanes):
                reqs.append((100 * f + 10 * c + i, {
                    "obs": rng.normal(size=(n,) + OBS).astype(np.float32),
                    "last_action": rng.integers(0, A, n).astype(np.int32),
                    "reward": rng.normal(size=n).astype(np.float32),
                    "done": rng.uniform(size=n) < 0.3,
                    "core": ()}))
            flush.append(reqs)
        flushes.append(flush)
    return flushes


def _jax_draws():
    """The JAX server's Gumbel draws: its key split once a flush, a draw
    over the bucket of the flush's pooled lanes."""
    key, draws = jax.random.PRNGKey(SERVING["seed"]), []
    buckets = default_buckets(SERVING["max_batch"])
    for per_rank in LANES:
        key, sub = jax.random.split(key)
        bucket = bucket_for(sum(sum(lanes) for lanes in per_rank), buckets)
        draws.append(np.asarray(jax.random.gumbel(sub, (bucket, A), jnp.float32)))
    return draws


def _cases_and_references():
    jargs = jconfig.ImpalaArguments(**FIELDS)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=OBS, num_actions=A, obs_dtype=jnp.float32,
                                 key=jax.random.PRNGKey(4))
    targs = tconfig.ImpalaArguments(**FIELDS)
    state = H.state_to_torch(jagent.state, convert.transformer_policy_net_to_torch)
    requests = [_requests(g) for g in range(2)]
    base = dict(args=targs, state=state, obs_shape=OBS, num_actions=A, serving=SERVING,
                spec=SPEC)
    trainer_args = tconfig.ImpalaArguments(
        **FIELDS, env_id="CartPole-v1", num_actors=2, num_buffers=8,
        logger_backend="none", logger_frequency=10**9, telemetry_interval_s=0.0,
        save_model=False, actor_mode="serving", serve_max_batch=8, serve_max_wait_ms=2.0,
        mesh_shape=SPEC)
    cases = {
        "layout": dict(base, kind="layout"),
        "flushes": dict(base, kind="flushes", requests=requests, draws=[_jax_draws()] * 2),
        "loop": dict(base, kind="loop", loop_requests=6),
        "faults": dict(base, kind="faults"),
        "failed_flush": dict(base, kind="failed_flush", group_timeout_s=3.0),
        "trainer": dict(base, kind="trainer", trainer_args=trainer_args, total_frames=384),
    }

    def references():
        """The JAX server on the learner's mesh: each dp group's flushes
        on the pooled requests (the pair's first rank's, then its
        second's), replies by request id."""
        jagent.enable_mesh("dp=4,mp=2")
        out = []
        for group in range(2):
            jserver = JServer(jagent, JConfig(**SERVING))
            jc, js = jlocal_pair()
            jserver.hub.add_connection(js)
            replies = {}
            try:
                for flush in requests[group]:
                    jreqs = [JRequest(conn=js, req_id=i, lanes=p["obs"].shape[0], payload=p)
                             for per_rank in flush for i, p in per_rank]
                    jserver._flush(jreqs)
                    for _ in jreqs:
                        r = jc.recv(timeout=20.0)
                        replies[r["req"]] = r
            finally:
                jserver.hub.close()
            out.append(replies)
        return out

    return cases, references


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of ``WORLD`` ranks; the JAX
    references are computed here while the ranks run."""
    workdir = str(tmp_path_factory.mktemp("serving_mesh"))
    cases, references = _cases_and_references()
    torch.save(cases, f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_serving_mesh_helpers.run_rank,
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


# ranks (dp * 2 + mp) of each mp pair
PAIRS = ((0, 1), (2, 3))


def test_server_holds_the_rank_shards_of_each_mp_leaf(world):
    for got in _ranks(world, "layout"):
        for shapes in (got["built"], *(p["shapes"] for p in got["pushes"].values())):
            sharded = {k: (local, full) for k, (local, full) in shapes.items() if local != full}
            assert len(sharded) >= 4 and "transformer.blocks.0.qkv.weight" in sharded
            for k, (local, full) in sharded.items():
                assert 2 * int(np.prod(local)) == int(np.prod(full)), k
        assert got["built_equal"]
        for name, push in got["pushes"].items():
            # the host weights' cut is the live state's shard, bit for bit,
            # and neither push issued a collective
            assert push["equal"] and push["collectives"] == 0 and push["dtensor_gathers"] == 0
        assert [got["pushes"][n]["gen"] for n in ("host", "live")] == [1, 2]
        assert "whole" in got["bad_push"]


def test_no_leaf_is_sharded_beside_a_pure_dp_learner(world):
    for got in _ranks(world, "layout"):
        dp_only = got["dp_only"]
        assert dp_only["specs"] is None and dp_only["mesh"] is None
        assert dp_only["shapes"] == {k: full for k, (_, full) in got["built"].items()}


def test_pooled_flushes_match_the_jax_server_with_injected_draws(world):
    ref, _ = world
    for rank, got in enumerate(_ranks(world, "flushes")):
        want = ref[rank // 2]
        mine = [i for flush in _requests(rank // 2) for i, _ in flush[rank % 2]]
        assert [r["req"] for r in got["replies"]] == mine
        for r in got["replies"]:
            jr = want[r["req"]]
            assert r["gen"] == jr["gen"] == 0
            np.testing.assert_allclose(r["logits"], jr["logits"], atol=TOL, rtol=TOL)
            np.testing.assert_array_equal(r["action"], np.asarray(jr["action"]))
            assert r["action"].dtype == np.int32
        assert got["accounting"]["balanced"]


def test_pooled_flushes_are_bit_equal_across_the_mp_pair(world):
    ranks = _ranks(world, "flushes")
    for a, b in PAIRS:
        # every rank flushed every time, its own queue empty or not
        assert ranks[a]["flushes"] == ranks[b]["flushes"] == [1, 2, 3]
        assert ranks[a]["puts"] == ranks[a]["gets"] == 3
        assert ranks[a]["buckets"] == ranks[b]["buckets"] == [2, 4]
        assert len(ranks[a]["pooled"]) == len(ranks[b]["pooled"]) == 3
        for (la, aa), (lb, ab) in zip(ranks[a]["pooled"], ranks[b]["pooled"]):
            assert torch.equal(la, lb) and torch.equal(aa, ab)


def test_a_rank_with_an_empty_queue_flushes_in_step_with_its_peer(world):
    ranks = _ranks(world, "loop")
    for a, b in PAIRS:
        assert len(ranks[a]["actions"]) == 6 and not ranks[b]["actions"]
        assert ranks[a]["flushes"] == ranks[b]["flushes"] >= 6
        assert len(ranks[a]["pooled"]) == len(ranks[b]["pooled"])
        for (la, aa), (lb, ab) in zip(ranks[a]["pooled"], ranks[b]["pooled"]):
            assert torch.equal(la, lb) and torch.equal(aa, ab)


def test_a_stop_on_one_rank_ends_both_loops(world):
    for got in _ranks(world, "loop"):
        assert got["ended"] and not any(got["threads_alive"])
        assert got["stop_s"] < 10.0
        assert got["accounting"]["balanced"] and got["accounting"]["pending"] == 0


def test_requests_no_offer_can_carry_are_refused_at_admission(world):
    for rank, got in enumerate(_ranks(world, "faults")):
        if rank % 2 == 0:
            assert got["refused"] == 2 and got["replies"][1] == got["replies"][2] == "error"
        else:
            assert got["refused"] == 0 and got["replies"][11] == (2,)
        # admission, refusals included, issued no collective
        assert got["admit_collectives"] == 0


def test_failed_packing_and_specs_apart_keep_the_pair_in_step(world):
    ranks = _ranks(world, "faults")
    for a, b in PAIRS:
        for got in (ranks[a], ranks[b]):
            assert got["verdicts"] == ["flushed"] * 4
            assert got["accounting"]["balanced"] and got["accounting"]["pending"] == 0
        # the rank whose batch failed to pack answered it with its error, and
        # its peer's lanes flushed; specs apart: errors on both ranks
        assert ranks[a]["replies"][3] == "error" and ranks[b]["replies"][13] == (2,)
        assert ranks[a]["replies"][5] == ranks[b]["replies"][15] == "error"
        assert ranks[a]["replies"][7] == ranks[b]["replies"][17] == (2,)
        # three pooled flushes (ticks 1, 2 and 4), bit-equal across the pair
        assert ranks[a]["flushes"] == ranks[b]["flushes"] == 3
        for (la, aa), (lb, ab) in zip(ranks[a]["pooled"], ranks[b]["pooled"]):
            assert torch.equal(la, lb) and torch.equal(aa, ab)


def test_a_failed_pooled_flush_ends_both_loops(world):
    ranks = _ranks(world, "failed_flush")
    for a, b in PAIRS:
        assert "injected failure" in ranks[b]["group_error"]
        assert ranks[a]["group_error"] != "None" and ranks[a]["reply_error"]
        for got in (ranks[a], ranks[b]):
            assert got["ended"] and got["ended_s"] < 15.0
            assert got["accounting"]["balanced"]


def test_serving_trainer_serves_the_learner_shards(world):
    ranks = _ranks(world, "trainer")
    assert len({g["learn_steps"] for g in ranks}) == 1 and ranks[0]["learn_steps"] > 0
    for got in ranks:
        assert got["generation"] == got["learn_steps"] and got["shards_are_live"]
        assert got["sharded"] >= 4 and got["flushes"] > 0 and got["fallbacks"] == 0
        assert np.isfinite(got["loss"]) and got["accounting"]["balanced"]
        assert not got["threads_alive"]
