"""The port's sharded replay (``data/sharded_replay.py``) on a four-rank gloo
world, against the JAX package's sharded buffers.

One world of 4 spawned ranks serves the module
(``tests/torch_replay_mesh_helpers.py``, jax-free).  The JAX buffers run on
a 4-device mesh here (``dp=2,fsdp=2``; ``dp=2`` for the mp case) while the
ranks run; each rank feeds its buffer the same global inserts and
write-backs, and samples with its shard's uniforms from the JAX draws
(``jax.random.uniform(fold_in(key, shard), (B / S,))``).

- The transition and sequence states, gathered over the shards, equal the
  JAX sharded buffers' leaf for leaf, after inserts and a write-back at
  global indices; the trainers' shard forms of the insert and write-back
  give the same state.
- A sample gives the JAX sample's indices exactly, its rows bit for bit and
  its weights at ``rtol=1e-5`` (the JAX transition test holds its weights
  to ``1e-4``), the zero weights of a partial fill included.
- At ``dp=2,mp=2`` the two ranks of a replay shard hold the same block and
  draw the same rows, and the weights equal JAX's two-shard buffer's: the
  sum and max span the replay shards, not the mp ranks.
- Both buffers save gathered and restore bit for bit.

Without a world: the validation errors, raised with the JAX buffers' own
messages, and the one-shard buffers against the unsharded ones.
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_replay_mesh_helpers

from scalerl_torch.data import prioritized as tprio
from scalerl_torch.data import sequence_replay as tseq
from scalerl_torch.data.sharded_replay import (
    ShardedPrioritizedReplay,
    ShardedSequenceReplay,
    replay_shard_axes,
)
from scalerl_torch.parallel.mesh import AXIS_NAMES, Mesh
from scalerl_tpu.data import sharded_replay as jsr
from scalerl_tpu.parallel import make_mesh as jax_make_mesh

torch.set_num_threads(1)

WORLD = 4
JOIN_TIMEOUT_S = 120
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-7)


def _jmesh(spec):
    n = int(np.prod([int(part.split("=")[1]) for part in spec.split(",")]))
    return jax_make_mesh(spec, devices=jax.devices()[:n])


def _step(i, num_envs, obs_dim=3):
    return {
        "obs": np.full((num_envs, obs_dim), i, np.float32) + np.arange(num_envs)[:, None],
        "next_obs": np.full((num_envs, obs_dim), i + 1, np.float32),
        "action": np.full((num_envs,), i % 2, np.int32),
        "reward": np.full((num_envs,), float(i), np.float32) + np.arange(num_envs),
        "done": (np.arange(num_envs) + i) % 5 == 0,
    }


def _uniforms(key, batch_size, n_shards):
    """Each shard's uniforms, as the JAX sample draws them."""
    b = batch_size // n_shards
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, s), (b,)))
                     for s in range(n_shards)])


def _transition_case(spec, jax_spec, seed, update_method="xla"):
    cap, num_envs, alpha = 16, 8, 0.6
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(20):  # wraps the 16-row ring
        prio = None if i % 3 == 0 else rng.uniform(0.1, 5.0, num_envs).astype(np.float32)
        steps.append((_step(i, num_envs), prio))
    idx = rng.integers(0, cap * num_envs, size=24)
    idx[5] = idx[1]  # duplicates resolve last-wins
    update = (idx, rng.uniform(0.0, 6.0, size=24).astype(np.float32))
    keys = [jax.random.PRNGKey(seed * 10 + r) for r in range(3)]
    n_shards = 4 if "fsdp" in spec else 2
    samples = [(16, 0.4, _uniforms(k, 16, n_shards)) for k in keys[:2]]
    samples.append((8, 0.7, _uniforms(keys[2], 8, n_shards)))

    def want():
        jbuf = jsr.ShardedPrioritizedReplay((3,), cap, _jmesh(jax_spec), num_envs=num_envs,
                                            alpha=alpha)
        for step, prio in steps:
            if prio is None:
                jbuf.save_to_memory(**step)
            else:
                jbuf.add_with_priorities(dict(step), prio)
        jbuf.update_priorities(jnp.asarray(idx, jnp.int32), jnp.asarray(update[1]))
        got = [jax.tree_util.tree_map(np.asarray, jbuf.sample(b, beta=beta, key=k))
               for (b, beta, _), k in zip(samples, keys)]
        return {"want_state": jax.tree_util.tree_map(np.asarray, jbuf.state),
                "want_samples": got}

    return dict(kind="transitions", spec=spec, capacity=cap, num_envs=num_envs, alpha=alpha,
                update_method=update_method, steps=steps, update=update, samples=samples,
                want=want)


def _seq_shapes(T1=5, obs_dim=3):
    fields = {"obs": ((T1, obs_dim), np.float32), "action": ((T1,), np.int32),
              "reward": ((T1,), np.float32), "done": ((T1,), bool)}
    return fields, ((4,),)


def _seq_batch(i, B, T1=5, obs_dim=3):
    rng = np.random.default_rng(100 + i)
    batch = {"obs": rng.normal(size=(B, T1, obs_dim)).astype(np.float32),
             "action": rng.integers(0, 3, size=(B, T1)).astype(np.int32),
             "reward": np.full((B, T1), float(i), np.float32),
             "done": rng.uniform(size=(B, T1)) < 0.2}
    core = ((rng.normal(size=(B, 4)).astype(np.float32),
             rng.normal(size=(B, 4)).astype(np.float32)),)
    return batch, core, rng.uniform(0.2, 3.0, size=B).astype(np.float32)


def _sequence_case(n_inserts, with_update=True):
    cap, alpha, beta = 16, 0.8, 0.4
    fields, cores = _seq_shapes()
    inserts = [_seq_batch(i, 6) for i in range(n_inserts)]  # 6 a time: crosses blocks
    keys = [jax.random.PRNGKey(40 + r) for r in range(2)]
    samples = [(8, _uniforms(k, 8, 4)) for k in keys]
    update = None
    if with_update:
        update = (np.array([0, 3, 9, 15, 9, 4]), np.array([5.0, 0.1, 2.0, 7.0, 3.0, 0.0],
                                                          np.float32))

    def want():
        jfields = {k: (s, jnp.dtype(d)) for k, (s, d) in fields.items()}
        jbuf = jsr.ShardedSequenceReplay(jfields, cores, cap, _jmesh("dp=2,fsdp=2"),
                                         alpha=alpha, beta=beta)
        for batch, core, prio in inserts:
            jbuf.add({k: jnp.asarray(v) for k, v in batch.items()},
                     tuple((jnp.asarray(c), jnp.asarray(h)) for c, h in core), prio)
        got = [jax.tree_util.tree_map(np.asarray, jbuf.sample(b, key=k))
               for (b, _), k in zip(samples, keys)]
        if update is not None:
            jbuf.update_priorities(jnp.asarray(update[0], jnp.int32), jnp.asarray(update[1]))
        return {"want_state": jax.tree_util.tree_map(np.asarray, jbuf.state),
                "want_samples": got}

    return dict(kind="sequences", spec="dp=2,fsdp=2", fields=fields, cores=cores, capacity=cap,
                alpha=alpha, beta=beta, inserts=inserts, samples=samples, update=update,
                want=want)


def _cases():
    per = _transition_case("dp=2,fsdp=2", "dp=2,fsdp=2", 0)
    seq = _sequence_case(3)
    return {
        "per": per,
        "per_kernel_update": _transition_case("dp=2,fsdp=2", "dp=2,fsdp=2", 1, "pallas"),
        "per_mp": _transition_case("dp=2,mp=2", "dp=2", 2),
        "seq": seq,
        "seq_partial": _sequence_case(1, with_update=False),
        "checkpoint": dict(kind="checkpoint", spec="dp=2,fsdp=2",
                           per={k: v for k, v in per.items() if k != "want"},
                           seq={k: v for k, v in seq.items() if k != "want"}),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of ``WORLD`` ranks; the JAX buffers
    run here while the ranks run."""
    workdir = str(tmp_path_factory.mktemp("replay_world"))
    cases = _cases()
    torch.save({k: {f: v for f, v in c.items() if f != "want"} for k, c in cases.items()},
               f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_replay_mesh_helpers.run_rank,
                             args=(WORLD, _free_port(), workdir), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for case in cases.values():
            if "want" in case:
                case.update(case.pop("want")())
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return cases, torch.load(f"{workdir}/results.pt", weights_only=False)


def _ranks(world, name):
    cases, results = world
    for r in results[name]:
        assert "error" not in r, r["error"]
    return cases[name], results[name]


def _assert_per_state(got, want):
    for k, v in want.replay.storage.items():
        np.testing.assert_array_equal(got["storage"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["priorities"], want.priorities)
    assert got["max_priority"] == float(want.max_priority)
    assert (got["pos"], got["size"]) == (int(want.replay.pos), int(want.replay.size))


def _assert_rows(got, want, rows, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k][rows], err_msg=k)


@pytest.mark.parametrize("name", ["per", "per_kernel_update"])
def test_sharded_transitions_state_matches_jax(world, name):
    case, ranks = _ranks(world, name)
    for r in ranks:  # every rank gathers the same whole state
        _assert_per_state(r["full"], case["want_state"])
        _assert_per_state(r["shard_form"], case["want_state"])
    # each rank holds only its own lane block
    blocks = {r["shard"]: r["block"] for r in ranks}
    assert sorted(blocks) == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.concatenate([blocks[s] for s in range(4)], axis=1),
                                  case["want_state"].priorities)


def test_sharded_transitions_sample_matches_jax(world):
    case, ranks = _ranks(world, "per")
    keys = ("obs", "next_obs", "action", "reward", "done", "n_steps", "indices")
    for i, ((b, _, _), want) in enumerate(zip(case["samples"], case["want_samples"])):
        b_local = b // 4
        for r in ranks:
            got = r["samples"][i]
            rows = slice(r["shard"] * b_local, (r["shard"] + 1) * b_local)
            _assert_rows(got, want, rows, keys)
            np.testing.assert_allclose(got["weights"], want["weights"][rows], **WEIGHT_TOL)
        assert np.isclose(max(r["samples"][i]["weights"].max() for r in ranks), 1.0)


def test_sharded_sequences_state_and_samples_match_jax(world):
    case, ranks = _ranks(world, "seq")
    want = case["want_state"]
    for r in ranks:
        full = r["full"]
        for k, v in want.storage.items():
            np.testing.assert_array_equal(full["storage"][k], v, err_msg=k)
        for (c, h), (jc, jh) in zip(full["core"], want.core):
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(h, jh)
        np.testing.assert_array_equal(full["priorities"], want.priorities)
        assert (full["pos"], full["size"]) == (int(want.pos), int(want.size))
    for i, (jf, jc, jidx, jw) in enumerate(case["want_samples"]):
        b_local = case["samples"][i][0] // 4
        for r in ranks:
            f, c, idx, w = r["samples"][i]
            rows = slice(r["shard"] * b_local, (r["shard"] + 1) * b_local)
            np.testing.assert_array_equal(idx, jidx[rows])
            for k in jf:
                np.testing.assert_array_equal(f[k], jf[k][rows], err_msg=k)
            np.testing.assert_array_equal(c[0][0], jc[0][0][rows])
            np.testing.assert_allclose(w, jw[rows], **WEIGHT_TOL)


def test_sharded_sequences_partial_fill_zero_weights(world):
    """One insert of 6 reaches shard blocks 0-1 only: the other shards'
    draws carry zero weight, as JAX's, and the real ones are not crushed."""
    case, ranks = _ranks(world, "seq_partial")
    _, _, jidx, jw = case["want_samples"][0]
    for r in ranks:
        _, _, idx, w = r["samples"][0]
        rows = slice(r["shard"] * 2, (r["shard"] + 1) * 2)
        np.testing.assert_array_equal(idx, jidx[rows])
        np.testing.assert_allclose(w, jw[rows], **WEIGHT_TOL)
        if r["shard"] >= 2:
            assert (w == 0).all()
        else:
            assert (w > 0.01).all()


def test_sharded_replay_mp_ranks_hold_and_draw_alike(world):
    """dp=2,mp=2: two replay shards; a shard's two ranks hold one block and
    draw one set of rows, seeded or injected, and the weights equal the
    two-shard JAX buffer's (no mp double count in the sum or the max)."""
    case, ranks = _ranks(world, "per_mp")
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r["shard"], []).append(r)
        _assert_per_state(r["full"], case["want_state"])
    assert sorted(by_shard) == [0, 1] and all(len(v) == 2 for v in by_shard.values())
    for pair in by_shard.values():
        a, b = pair
        np.testing.assert_array_equal(a["block"], b["block"])
        for k in a["seeded"]:
            np.testing.assert_array_equal(a["seeded"][k], b["seeded"][k], err_msg=k)
    for i, want in enumerate(case["want_samples"]):
        b_local = case["samples"][i][0] // 2
        for r in ranks:
            rows = slice(r["shard"] * b_local, (r["shard"] + 1) * b_local)
            np.testing.assert_array_equal(r["samples"][i]["indices"], want["indices"][rows])
            np.testing.assert_allclose(r["samples"][i]["weights"], want["weights"][rows],
                                       **WEIGHT_TOL)


def test_sharded_buffers_save_and_restore_bit_for_bit(world):
    _, ranks = _ranks(world, "checkpoint")
    for r in ranks:
        for name in ("per", "seq"):
            assert r[name]["equal"] and r[name]["leaves"] > 4, name
            assert r[name]["cursors"][0] == r[name]["cursors"][1]


# ---------------------------------------------------------------------------
# without a world


def _spec_mesh(**sizes) -> Mesh:
    """A mesh of several shards with no process group: enough for the
    checks a buffer makes before it touches a collective."""
    return Mesh(shape={a: sizes.get(a, 1) for a in AXIS_NAMES}, device_type="cpu")


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_errors_match_jax():
    jmesh = _jmesh("dp=2,fsdp=2")
    mesh = _spec_mesh(dp=2, fsdp=2)
    fields, cores = _seq_shapes()
    jfields = {k: (s, jnp.dtype(d)) for k, (s, d) in fields.items()}
    checks = [
        (lambda: ShardedPrioritizedReplay((3,), 8, mesh, num_envs=6, device="cpu"),
         lambda: jsr.ShardedPrioritizedReplay((3,), 8, jmesh, num_envs=6)),
        (lambda: ShardedPrioritizedReplay((3,), 8, mesh, num_envs=8, device="cpu").sample(6),
         lambda: jsr.ShardedPrioritizedReplay((3,), 8, jmesh, num_envs=8).sample(6)),
        (lambda: ShardedSequenceReplay(fields, cores, 6, mesh, device="cpu"),
         lambda: jsr.ShardedSequenceReplay(jfields, cores, 6, jmesh)),
        (lambda: ShardedSequenceReplay(fields, cores, 16, mesh, device="cpu").sample(6),
         lambda: jsr.ShardedSequenceReplay(jfields, cores, 16, jmesh).sample(6)),
    ]
    for port, ref in checks:
        assert _jax_error(port) == _jax_error(ref)
    assert replay_shard_axes(mesh) == jsr.replay_shard_axes(jmesh) == ("dp", "fsdp")


@pytest.mark.parametrize("method", ["hierarchical", "pallas"])
def test_one_shard_transitions_equal_the_unsharded_buffer(method):
    """dp=1: the sharded buffer is the unsharded one, draw for draw."""
    mesh = _spec_mesh()
    kw = dict(alpha=0.6, n_step=1, sample_method=method,
              update_method="pallas" if method == "pallas" else "xla", device="cpu")
    sharded = ShardedPrioritizedReplay((3,), 16, mesh, num_envs=4, seed=5, **kw)
    plain = tprio.PrioritizedReplayBuffer((3,), 16, num_envs=4, **kw)
    rng = np.random.default_rng(3)
    for i in range(20):
        p = rng.uniform(0.1, 4.0, 4).astype(np.float32)
        sharded.add_with_priorities(_step(i, 4), p)
        plain.add_with_priorities(_step(i, 4), p)
    gen = torch.Generator().manual_seed(5)
    want = plain.sample(12, beta=0.5, generator=gen)
    got = sharded.sample(12, beta=0.5)  # the shard-0 generator: seeded from 5 as well
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    idx = got["indices"]
    sharded.update_priorities(idx, torch.linspace(0.5, 2.0, 12))
    plain.update_priorities(idx, torch.linspace(0.5, 2.0, 12))
    assert torch.equal(sharded.state.priorities, plain.state.priorities)
    assert torch.equal(sharded.state.max_priority, plain.state.max_priority)


def test_one_shard_sequences_equal_the_unsharded_ring():
    mesh = _spec_mesh()
    fields, cores = _seq_shapes()
    sharded = ShardedSequenceReplay(fields, cores, 16, mesh, alpha=0.7, beta=0.5, seed=9,
                                    device="cpu")
    plain = tseq.seq_init(fields, cores, 16, "cpu")
    for i in range(4):
        batch, core, prio = _seq_batch(i, 6)
        sharded.add(batch, core, torch.as_tensor(prio))
        plain = tseq.seq_add(plain, batch, core, prio)
    assert (sharded.state.pos, sharded.state.size) == (plain.pos, plain.size)
    want = tseq.seq_sample(plain, torch.Generator().manual_seed(9), 8, alpha=0.7, beta=0.5)
    got = sharded.sample(8)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    sharded.update_priorities(got[2], got[3] + 0.5)
    tseq.seq_update_priorities_keep_empty(plain, want[2], want[3] + 0.5)
    assert torch.equal(sharded.state.priorities, plain.priorities)
