"""Replay, prioritized replay and the sampler in the PyTorch port against JAX.

The same numpy transitions go into ``scalerl_tpu.data`` and into the port's
buffers; both then gather, fold and sample from the same logical rows and
the same uniform draws (the JAX side's ``jax.random.uniform`` output, fed to
the port's ``per_sample_from_uniforms``).  Gathers, n-step folds, sampled
indices and updated priority planes must be equal; importance weights
agree to 1e-6 (``p ** alpha`` and the sums round differently in XLA and
PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.data import prioritized as tprio
from scalerl_torch.data import replay as treplay
from scalerl_torch.data.sampler import Sampler
from scalerl_tpu.data import prioritized as jprio
from scalerl_tpu.data import replay as jreplay

torch.set_num_threads(1)

CAP, E, OBS = 16, 3, (4,)


def _steps(count, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        done = rng.uniform(size=E) < 0.2
        yield dict(
            obs=rng.normal(size=(E,) + OBS).astype(np.float32),
            next_obs=rng.normal(size=(E,) + OBS).astype(np.float32),
            action=rng.integers(0, 2, size=E).astype(np.int32),
            reward=rng.normal(size=E).astype(np.float32),
            done=done,
            boundary=done | (rng.uniform(size=E) < 0.1),
        )


def _filled(n_step, inserts, seed=0):
    jbuf = jreplay.ReplayBuffer(OBS, CAP, num_envs=E, n_step=n_step, gamma=0.99)
    tbuf = treplay.ReplayBuffer(OBS, CAP, num_envs=E, n_step=n_step, gamma=0.99, device="cpu")
    for step in _steps(inserts, seed):
        jbuf.save_to_memory(**step)
        tbuf.save_to_memory(**step)
    return jbuf, tbuf


def _assert_batches_equal(tbatch, jbatch, skip=()):
    assert set(tbatch) == set(jbatch)
    for k, v in jbatch.items():
        if k not in skip:
            np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("inserts", [7, 40], ids=["partial", "wrapped"])
def test_add_and_gather_match_jax_exactly(n_step, inserts):
    jbuf, tbuf = _filled(n_step, inserts, seed=inserts)
    assert len(tbuf) == len(jbuf)
    assert (tbuf.state.pos, tbuf.state.size) == (int(jbuf.state.pos), int(jbuf.state.size))
    for name, arr in jbuf.state.storage.items():
        np.testing.assert_array_equal(tbuf.state.storage[name].numpy(), np.asarray(arr), err_msg=name)
    rows = max(int(jbuf.state.size) - n_step + 1, 1)
    logical = np.repeat(np.arange(rows), E)
    envs = np.tile(np.arange(E), rows)
    want = jreplay.gather_transitions(jbuf.state, jnp.asarray(logical), jnp.asarray(envs), n_step, 0.99)
    got = treplay.gather_transitions(tbuf.state, torch.from_numpy(logical), torch.from_numpy(envs),
                                     n_step, 0.99)
    _assert_batches_equal(got, want)


def test_n_step_fold_matches_jax_exactly():
    rng = np.random.default_rng(4)
    B, n = 64, 5
    rewards = rng.normal(size=(B, n)).astype(np.float32)
    dones = rng.uniform(size=(B, n)) < 0.15
    bounds = rng.uniform(size=(B, n)) < 0.15
    for boundaries in (None, bounds):
        want = jreplay.n_step_fold(jnp.asarray(rewards), jnp.asarray(dones), 0.97,
                                   None if boundaries is None else jnp.asarray(boundaries))
        got = treplay.n_step_fold(torch.from_numpy(rewards), torch.from_numpy(dones), 0.97,
                                  None if boundaries is None else torch.from_numpy(boundaries))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uniform_sample_is_in_range_and_seeded():
    _, tbuf = _filled(3, 40)
    a = tbuf.sample(32, generator=torch.Generator().manual_seed(0))
    b = tbuf.sample(32, generator=torch.Generator().manual_seed(0))
    _assert_batches_equal(a, {k: v.numpy() for k, v in b.items()})
    assert a["obs"].shape == (32, 4) and a["n_steps"].dtype == torch.int32
    assert bool(((a["indices"] >= 0) & (a["indices"] < CAP * E)).all())


def _per_pair(n_step, inserts, seed=0, **kw):
    jbuf = jprio.PrioritizedReplayBuffer(OBS, CAP, num_envs=E, alpha=0.6, n_step=n_step,
                                         sample_method="hierarchical", update_method="xla")
    tbuf = tprio.PrioritizedReplayBuffer(OBS, CAP, num_envs=E, alpha=0.6, n_step=n_step,
                                         device="cpu", **kw)
    rng = np.random.default_rng(seed + 100)
    for i, step in enumerate(_steps(inserts, seed)):
        jbuf.save_to_memory(**step)
        tbuf.save_to_memory(**step)
        if i % 4 == 3:  # interleave priority updates, duplicates included
            idx = rng.integers(0, CAP * E, size=6)
            idx[5] = idx[0]
            pr = rng.uniform(0.01, 3.0, size=6).astype(np.float32)
            jbuf.update_priorities(idx.astype(np.int32), pr)
            tbuf.update_priorities(torch.from_numpy(idx), torch.from_numpy(pr))
    np.testing.assert_array_equal(tbuf.state.priorities.numpy(), np.asarray(jbuf.state.priorities))
    assert float(tbuf.state.max_priority) == float(jbuf.state.max_priority)
    return jbuf, tbuf


@pytest.mark.parametrize("jax_method", ["cumsum", "hierarchical", "pallas"])
@pytest.mark.parametrize("inserts", [9, 40], ids=["partial", "wrapped"])
def test_per_sample_from_the_same_uniforms_matches_jax(inserts, jax_method):
    jbuf, tbuf = _per_pair(3, inserts, seed=inserts)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (24,))))
        want = jprio.per_sample(jbuf.state, key, 24, jnp.float32(0.6), jnp.float32(0.4),
                                n_step=3, gamma=0.99, method=jax_method)
        for method in ("hierarchical", "pallas", "cumsum"):
            got = tprio.per_sample_from_uniforms(tbuf.state, u, 0.6, 0.4, n_step=3, gamma=0.99,
                                                 method=method)
            _assert_batches_equal(got, want, skip=("weights",))
            np.testing.assert_allclose(got["weights"].numpy(), np.asarray(want["weights"]),
                                       rtol=1e-6, atol=1e-6, err_msg=method)


@pytest.mark.parametrize("jax_method,method", [("xla", "xla"), ("pallas", "pallas")])
def test_per_update_priorities_matches_jax(jax_method, method):
    jbuf, tbuf = _per_pair(3, 40, seed=1)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, CAP * E, size=20)
    idx[7] = idx[2]  # duplicates resolve last-wins in both
    idx[15] = idx[2]
    pr = rng.uniform(0.0, 5.0, size=20).astype(np.float32)
    pr[3] = 0.0  # floored at 1e-6
    want = jprio.per_update_priorities(jbuf.state, jnp.asarray(idx, jnp.int32), jnp.asarray(pr),
                                       method=jax_method)
    got = tprio.per_update_priorities(tbuf.state, torch.from_numpy(idx), torch.from_numpy(pr),
                                      method=method)
    assert got.priorities is tbuf.state.priorities  # written in place
    np.testing.assert_array_equal(got.priorities.numpy(), np.asarray(want.priorities))
    assert float(got.max_priority) == float(want.max_priority)


def test_per_add_gives_new_rows_the_max_priority():
    _, tbuf = _per_pair(1, 5)
    tbuf.state = dataclasses.replace(tbuf.state, max_priority=torch.tensor(7.5))
    pos = tbuf.state.replay.pos
    tbuf.save_to_memory(**next(_steps(1, seed=3)))
    assert bool((tbuf.state.priorities[pos] == 7.5).all())


def test_sampler_pins_the_methods_and_validates():
    kw = dict(obs_shape=OBS, capacity=CAP, num_envs=E, use_per=True, n_step=3, device="cpu")
    assert (Sampler(**kw, use_pallas=True).buffer.sample_method,
            Sampler(**kw, use_pallas=True).buffer.update_method) == ("pallas", "pallas")
    plain = Sampler(**kw)
    assert (plain.buffer.sample_method, plain.buffer.update_method) == ("hierarchical", "xla")
    uniform = Sampler(OBS, CAP, num_envs=E, n_step=3, device="cpu")
    for sampler in (plain, uniform):
        for step in _steps(10):
            sampler.add(step["obs"], step["next_obs"], step["action"], step["reward"],
                        step["done"], boundary=step["boundary"])
        assert len(sampler) == 10 * E
        batch = sampler.sample(8, beta=0.5, generator=torch.Generator().manual_seed(1))
        assert batch["obs"].shape == (8, 4) and ("weights" in batch) == sampler.use_per
        sampler.update_priorities(batch["indices"], torch.ones(8))
    with pytest.raises(ValueError, match="sample_method"):
        tprio.PrioritizedReplayBuffer(OBS, CAP, sample_method="auto", device="cpu")
