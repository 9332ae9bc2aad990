"""The port's device envs against the JAX envs.

The random streams of ``jax.random`` and ``torch.Generator`` differ, so the
tests repeat the JAX env's own draws on the same per-lane keys and feed them
to the port's pure transition: for ``SyntheticPixelEnv`` the teleport,
reset and sticky draws (``split``, then ``randint``/``bernoulli``,
synthetic.py:116-131), exactly; for ``TensorCartPole`` the reset values
(cartpole.py:56), on injected states, with the physics at 1e-6 (XLA's and
PyTorch's sin and cos may differ in the last bit) and ``done`` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.envs.tensor_envs import (
    CartPoleState,
    SyntheticDraws,
    SyntheticPixelEnv,
    SyntheticState,
    TensorCartPole,
)
from scalerl_tpu.envs.jax_envs.base import JaxVecEnv
from scalerl_tpu.envs.jax_envs.cartpole import CartPoleState as JaxCartPoleState
from scalerl_tpu.envs.jax_envs.cartpole import JaxCartPole
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


def _jax_cartpole_step(env):
    def one(state, action, key):
        reset_vals = jax.random.uniform(key, (4,), minval=-0.05, maxval=0.05)
        return env.step(state, action, key), reset_vals

    return jax.jit(jax.vmap(one))


def _cartpole_states(B, rng):
    """Random states across the whole range, many near a limit."""
    return JaxCartPoleState(
        x=jnp.asarray(rng.uniform(-2.5, 2.5, B), jnp.float32),
        x_dot=jnp.asarray(rng.normal(0, 1.5, B), jnp.float32),
        theta=jnp.asarray(rng.uniform(-0.22, 0.22, B), jnp.float32),
        theta_dot=jnp.asarray(rng.normal(0, 2.0, B), jnp.float32),
        t=jnp.asarray(rng.integers(0, 500, B), jnp.int32),
    )


def _to_port(jstate):
    return CartPoleState(*(torch.from_numpy(np.array(x)) for x in jstate[:4]),
                         torch.from_numpy(np.array(jstate.t)).long())


def _assert_cartpole_close(got, want):
    state, obs, reward, done = got
    (jstate, jobs, jrew, jdone) = want
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for name, a, b in zip(CartPoleState._fields, state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jrew))


def test_cartpole_step_matches_jax_on_injected_states():
    B = 512
    jenv, env = JaxCartPole(), TensorCartPole(num_envs=B, device="cpu")
    step = _jax_cartpole_step(jenv)
    rng = np.random.default_rng(0)
    jstate = _cartpole_states(B, rng)
    actions = rng.integers(0, 2, B).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want, reset_vals = step(jstate, jnp.asarray(actions), keys)
    got = env.transition(_to_port(jstate), torch.from_numpy(actions),
                         torch.from_numpy(np.array(reset_vals)))
    _assert_cartpole_close(got, want)
    assert 0 < int(np.asarray(want[3]).sum()) < B  # some lanes ended, some did not


def test_cartpole_rollout_matches_jax_step_by_step():
    B, steps = 16, 300
    jenv, env = JaxCartPole(max_steps=120), TensorCartPole(num_envs=B, max_steps=120, device="cpu")
    step = _jax_cartpole_step(jenv)
    rng = np.random.default_rng(1)
    jstate = _cartpole_states(B, rng)._replace(t=jnp.zeros(B, jnp.int32))
    key = jax.random.PRNGKey(2)
    ends = 0
    for _ in range(steps):
        key, sub = jax.random.split(key)
        actions = rng.integers(0, 2, B).astype(np.int32)
        want, reset_vals = step(jstate, jnp.asarray(actions), jax.random.split(sub, B))
        got = env.transition(_to_port(jstate), torch.from_numpy(actions),
                             torch.from_numpy(np.array(reset_vals)))
        _assert_cartpole_close(got, want)
        ends += int(np.asarray(want[3]).sum())
        jstate = want[0]  # inject: each step starts from the JAX state
    assert ends > 0


def test_cartpole_draws_from_the_generator_and_auto_resets():
    env = TensorCartPole(num_envs=6, max_steps=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen)
    assert obs.shape == (6, 4) and obs.dtype == torch.float32
    assert bool((obs.abs() <= 0.05).all())
    for t in range(1, 9):
        state, obs, reward, done = env.step(state, torch.ones(6, dtype=torch.long), gen)
        assert bool((reward == 1.0).all())
        assert bool(done[state.t == 0].all()) and not bool(done[state.t != 0].any())
        assert bool((state.t <= 3).all())
