"""The port's ``SyntheticPixelEnv`` against the JAX env, exactly.

The random streams of ``jax.random`` and ``torch.Generator`` differ, so the
test repeats the JAX env's own draws (``split`` into teleport/reset/sticky
keys, then ``randint``/``bernoulli``, synthetic.py:116-131) on the same
per-lane keys and feeds them to the port's pure transition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.envs.tensor_envs import SyntheticDraws, SyntheticPixelEnv, SyntheticState
from scalerl_tpu.envs.jax_envs.base import JaxVecEnv
from scalerl_tpu.envs.jax_envs.synthetic import SyntheticPixelEnv as JaxSyntheticPixelEnv

torch.set_num_threads(1)


def test_render_is_bit_exact_for_every_cell():
    jenv = JaxSyntheticPixelEnv()
    env = SyntheticPixelEnv(num_envs=jenv.num_states, device="cpu")
    cells = np.arange(jenv.num_states)
    want = np.stack([np.asarray(jenv._render(jnp.int32(c))) for c in cells])
    got = env._render(torch.from_numpy(cells)).numpy()
    assert got.dtype == np.uint8 and got.shape == (16, 84, 84, 4)
    np.testing.assert_array_equal(got, want)


def _jax_draws(keys, num_states, sticky_prob):
    """The draws JAX's step makes from each lane's key."""

    def one(key):
        k_teleport, k_reset, k_sticky = jax.random.split(key, 3)
        return (
            jax.random.randint(k_teleport, (), 0, num_states),
            jax.random.randint(k_reset, (), 0, num_states),
            jax.random.bernoulli(k_sticky, sticky_prob),
        )

    return jax.vmap(one)(keys)


@pytest.mark.parametrize("sticky_prob", [0.0, 0.25])
def test_transition_matches_jax_step_exactly(sticky_prob):
    B, steps = 8, 300
    jenv = JaxSyntheticPixelEnv(sticky_prob=sticky_prob, episode_length=37)
    venv = JaxVecEnv(jenv, num_envs=B)
    env = SyntheticPixelEnv(
        num_envs=B, sticky_prob=sticky_prob, episode_length=37, device="cpu"
    )
    draws_fn = jax.jit(lambda keys: _jax_draws(keys, jenv.num_states, sticky_prob))
    step_fn = jax.jit(venv._step)
    rng = np.random.default_rng(0)

    jstate, _ = venv.reset(jax.random.PRNGKey(0))
    state = SyntheticState(*(torch.tensor(np.asarray(x)).long() for x in jstate))
    key = jax.random.PRNGKey(1)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        actions = rng.integers(0, jenv.num_actions, size=B).astype(np.int32)
        jstate, jobs, jrew, jdone = step_fn(jstate, jnp.asarray(actions), keys)
        teleport, reset_cell, sticky = (np.array(x) for x in draws_fn(keys))
        draws = SyntheticDraws(
            torch.from_numpy(teleport).long(),
            torch.from_numpy(reset_cell).long(),
            torch.from_numpy(sticky) if sticky_prob > 0 else None,
        )
        state, obs, rew, done = env.transition(state, torch.from_numpy(actions), draws)
        for name, got, want in zip(SyntheticState._fields, state, jstate):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_step_draws_from_the_generator_and_auto_resets():
    env = SyntheticPixelEnv(num_envs=5, episode_length=3, sticky_prob=0.5, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    assert obs.shape == (5, 84, 84, 4) and obs.dtype == torch.uint8
    for t in range(1, 7):
        state, obs, rew, done = env.step(state, torch.zeros(5, dtype=torch.long), gen)
        assert bool((done == (t % 3 == 0)).all())
        assert bool((state.t == t % 3).all())
        assert bool(((state.cell >= 0) & (state.cell < env.num_states)).all())
