"""The port's ``data/sequence_replay.py`` against the JAX module.

The same numpy units and priorities go into both buffers; sampling injects
the same uniforms (``jax.random`` and ``torch.Generator`` give different
numbers from one seed), so the JAX side is its own ``seq_sample`` body with
``u`` given.  Indices must be equal, weights within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.data import sequence_replay as tsr
from scalerl_torch.genrl.rollout import packed_field_shapes
from scalerl_tpu.data import sequence_replay as jsr
from scalerl_tpu.genrl.rollout import packed_field_shapes as jax_packed_field_shapes
from scalerl_tpu.ops.pallas_per import proportional_sample as jax_proportional_sample

torch.set_num_threads(1)

S = 6
CAPACITY = 10


def _units(seed, B):
    rng = np.random.default_rng(seed)
    fields = {}
    for name, (shape, dtype) in packed_field_shapes(S).items():
        if np.dtype(dtype) == np.int32:
            fields[name] = rng.integers(0, 9, (B,) + shape).astype(np.int32)
        else:
            fields[name] = rng.normal(size=(B,) + shape).astype(np.float32)
    prio = rng.uniform(0.1, 2.0, B).astype(np.float32)
    prio[rng.random(B) < 0.3] = 0.0  # all-pad rows ride priority 0
    prio[0] = 1.0
    return fields, prio


def _pair():
    return (tsr.seq_init(packed_field_shapes(S), (), CAPACITY, device="cpu"),
            jsr.seq_init(jax_packed_field_shapes(S), (), CAPACITY))


def _add(ts, js, seed, B):
    fields, prio = _units(seed, B)
    ts = tsr.seq_add(ts, {k: torch.tensor(v) for k, v in fields.items()}, (), torch.tensor(prio))
    js = jsr.seq_add(js, {k: jnp.asarray(v) for k, v in fields.items()}, (), jnp.asarray(prio))
    return ts, js


def _assert_same_state(ts, js):
    assert ts.pos == int(js.pos) and ts.size == int(js.size)
    np.testing.assert_array_equal(ts.priorities.numpy(), np.asarray(js.priorities))
    assert set(ts.storage) == set(js.storage)  # a jitted JAX dict comes back key-sorted
    for k in js.storage:
        assert ts.storage[k].numpy().dtype == np.asarray(js.storage[k]).dtype
        np.testing.assert_array_equal(ts.storage[k].numpy(), np.asarray(js.storage[k]), err_msg=k)


def _jax_sample(js, u, batch_size, alpha=0.6, beta=0.4, method="hierarchical"):
    """``seq_sample``'s body with the uniforms given."""
    scaled = jnp.power(js.priorities, alpha)
    total = jnp.sum(scaled)
    targets = (jnp.arange(batch_size) + jnp.asarray(u)) / batch_size * total
    idx = jax_proportional_sample(scaled, targets, method=method)
    probs = scaled[idx] / jnp.maximum(total, 1e-9)
    n = jnp.maximum(js.size.astype(jnp.float32), 1.0)
    weights = jnp.power(n * jnp.maximum(probs, 1e-9), -beta)
    weights = weights / jnp.maximum(jnp.max(weights), 1e-9)
    return {k: v[idx] for k, v in js.storage.items()}, idx, weights


def test_init_matches_jax():
    ts, js = _pair()
    _assert_same_state(ts, js)
    assert ts.core == () and ts.priorities.dtype == torch.float32


@pytest.mark.parametrize("sizes", [(4,), (4, 4), (4, 4, 4), (7, 7), (10, 3), (1, 2, 8, 5)])
def test_add_with_ring_wrap_matches_jax(sizes):
    ts, js = _pair()
    for i, B in enumerate(sizes):
        ts, js = _add(ts, js, seed=10 + i, B=B)
        _assert_same_state(ts, js)


def test_add_is_in_place_and_refuses_more_than_capacity():
    ts, _ = _pair()
    storage = ts.storage["tokens"]
    fields, prio = _units(0, 4)
    ts2 = tsr.seq_add(ts, fields, (), prio)  # host numpy goes in too
    assert ts2.storage["tokens"] is storage and ts2.pos == 4 and ts2.size == 4
    big, big_prio = _units(1, CAPACITY + 1)
    with pytest.raises(ValueError, match="capacity"):
        tsr.seq_add(ts2, big, (), big_prio)


@pytest.mark.parametrize("method", ["cumsum", "hierarchical", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_with_injected_uniforms_matches_jax(seed, method):
    ts, js = _pair()
    for i, B in enumerate((4, 4, 4)):  # wrapped: pad rows sit at arbitrary slots
        ts, js = _add(ts, js, seed=20 + 3 * seed + i, B=B)
    u = np.random.default_rng(seed).uniform(size=8).astype(np.float32)
    fields, core, idx, weights = tsr.seq_sample(ts, None, 8, method=method, u=torch.tensor(u))
    # on the host "pallas" is the two-level plain version
    jmethod = "hierarchical" if method == "pallas" else method
    jfields, jidx, jweights = _jax_sample(js, u, 8, method=jmethod)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights), atol=1e-6, rtol=0)
    for k in jfields:
        np.testing.assert_array_equal(fields[k].numpy(), np.asarray(jfields[k]), err_msg=k)
    assert core == ()
    # priority-0 rows (pad, empty) are never drawn
    assert (ts.priorities[idx] > 0).all()


def test_sample_draws_from_the_generator_and_skips_empty_slots():
    ts, _ = _pair()
    fields, prio = _units(3, 4)
    ts = tsr.seq_add(ts, fields, (), prio)
    g = torch.Generator().manual_seed(5)
    _, _, idx1, w1 = tsr.seq_sample(ts, g, 16, method="pallas")
    _, _, idx2, _ = tsr.seq_sample(ts, torch.Generator().manual_seed(5), 16, method="pallas")
    assert torch.equal(idx1, idx2) and idx1.dtype == torch.int64
    assert (ts.priorities[idx1] > 0).all() and idx1.max() < 4
    assert w1.max() == pytest.approx(1.0) and (w1 > 0).all()


def test_update_priorities_matches_jax():
    ts, js = _pair()
    ts, js = _add(ts, js, seed=30, B=8)
    idx = np.array([1, 5, 3, 5], np.int64)  # a duplicate: the last write wins
    new = np.array([0.5, 2.0, 0.0, 3.0], np.float32)
    ts = tsr.seq_update_priorities(ts, torch.tensor(idx), torch.tensor(new))
    js = jsr.seq_update_priorities(js, jnp.asarray(idx), jnp.asarray(new))
    _assert_same_state(ts, js)
    assert ts.priorities[3] == pytest.approx(1e-6) and ts.priorities[5] == 3.0


def test_update_priorities_keep_empty_matches_jax():
    ts, js = _pair()
    ts, js = _add(ts, js, seed=31, B=6)
    empty = int(np.flatnonzero(ts.priorities.numpy() == 0)[0])
    live = int(np.flatnonzero(ts.priorities.numpy() > 0)[0])
    idx = np.array([empty, live], np.int64)
    new = np.array([4.0, 0.0], np.float32)
    ts = tsr.seq_update_priorities_keep_empty(ts, torch.tensor(idx), torch.tensor(new))
    js = jsr.seq_update_priorities_keep_empty(js, jnp.asarray(idx), jnp.asarray(new))
    _assert_same_state(ts, js)
    assert ts.priorities[empty] == 0.0 and ts.priorities[live] == pytest.approx(1e-6)


def test_export_import_round_trip_matches_jax():
    ts, js = _pair()
    for i, B in enumerate((7, 7)):
        ts, js = _add(ts, js, seed=40 + i, B=B)
    host, jhost = tsr.seq_export(ts), jsr.seq_export(js)
    assert host["pos"] == jhost["pos"] and host["size"] == jhost["size"]
    np.testing.assert_array_equal(host["priorities"], jhost["priorities"])
    for k in jhost["storage"]:
        np.testing.assert_array_equal(host["storage"][k], jhost["storage"][k], err_msg=k)
    back = tsr.seq_import(jhost, device="cpu")  # the JAX export loads into the port
    _assert_same_state(back, js)
    u = torch.tensor(np.random.default_rng(0).uniform(size=6).astype(np.float32))
    _, _, a, wa = tsr.seq_sample(ts, None, 6, u=u)
    _, _, b, wb = tsr.seq_sample(back, None, 6, u=u)
    assert torch.equal(a, b) and torch.equal(wa, wb)


def test_core_state_rides_along():
    ts = tsr.seq_init({"x": ((2,), np.float32)}, ((3,),), 4, device="cpu")
    c, h = torch.ones(2, 3), 2 * torch.ones(2, 3)
    ts = tsr.seq_add(ts, {"x": torch.zeros(2, 2)}, ((c, h),), torch.ones(2))
    _, core, idx, _ = tsr.seq_sample(ts, None, 2, u=torch.tensor([0.1, 0.9]))
    assert idx.tolist() == [0, 1]
    assert torch.equal(core[0][0], c) and torch.equal(core[0][1], h)
