"""The port's Catch, Recall and Breakout against the JAX envs, bit for bit.

``jax.random`` and ``torch.Generator`` give different streams, so the
tests repeat each JAX step's own draws on the same per-lane keys
(catch.py:77, recall.py:73, breakout.py:128-138) and feed them to the
port's pure transition.  States are injected (random ball positions,
velocities and brick walls, one brick from a cleared wall), and state,
obs, reward and done must agree exactly over a rollout that crosses
episode ends.  The draws themselves come from the generator, in range,
and a step at an episode's end resets the lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.envs.tensor_envs import (
    BreakoutDraws,
    BreakoutState,
    CatchDraws,
    CatchState,
    RecallDraws,
    RecallState,
    TensorBreakout,
    TensorCatch,
    TensorRecall,
    make_tensor_vec_env,
)
from scalerl_tpu.envs.jax_envs.base import JaxVecEnv, make_jax_vec_env
from scalerl_tpu.envs.jax_envs.breakout import BreakoutState as JaxBreakoutState
from scalerl_tpu.envs.jax_envs.breakout import JaxBreakout
from scalerl_tpu.envs.jax_envs.catch import CatchState as JaxCatchState
from scalerl_tpu.envs.jax_envs.catch import JaxCatch
from scalerl_tpu.envs.jax_envs.recall import JaxRecall
from scalerl_tpu.envs.jax_envs.recall import RecallState as JaxRecallState

torch.set_num_threads(1)

B = 16


def _catch_draws(env):
    return lambda key: (jax.random.randint(key, (), 0, env.size),)


def _recall_draws(env):
    return lambda key: (jax.random.randint(key, (), 0, env.num_cues),)


def _breakout_draws(env):
    def one(key):
        k_x, k_dx = jax.random.split(key)
        return (jax.random.randint(k_x, (), 0, env.size),
                jnp.where(jax.random.bernoulli(k_dx), 1, -1))
    return one


def _to_torch(tree):
    return [torch.from_numpy(np.array(x)).long() if np.asarray(x).dtype != bool
            else torch.from_numpy(np.array(x)) for x in tree]


def _assert_state_equal(port_state, jax_state):
    for name, got, want in zip(jax_state._fields, port_state, jax_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def _rollout(jenv, env, draws_fn, draws_cls, state_cls, jstate, steps, policy, seed=0):
    """Step both envs from the same state with the same actions and keys;
    every output must agree exactly.  Returns the number of episode ends
    and of non-zero rewards."""
    venv = JaxVecEnv(jenv, num_envs=B)
    step_fn = jax.jit(venv._step)
    draw = jax.jit(jax.vmap(draws_fn))
    rng = np.random.default_rng(seed)
    state = state_cls(*_to_torch(jstate))
    key = jax.random.PRNGKey(seed + 1)
    ends = paid = 0
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        actions = policy(rng, state).astype(np.int32)
        jstate, jobs, jrew, jdone = step_fn(jstate, jnp.asarray(actions), keys)
        draws = draws_cls(*_to_torch(draw(keys)))
        state, obs, rew, done = env.transition(state, torch.from_numpy(actions), draws)
        _assert_state_equal(state, jstate)
        assert obs.dtype == torch.uint8 and obs.shape == (B,) + env.observation_shape
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        ends += int(done.sum())
        paid += int((rew != 0).sum())
    return ends, paid


def _random_actions(n):
    return lambda rng, state: rng.integers(0, n, size=B)


@pytest.mark.parametrize("paddle_width", [1, 3, 5])
def test_catch_matches_jax_exactly(paddle_width):
    size = 12
    jenv = JaxCatch(size=size, stack=2, paddle_width=paddle_width)
    env = TensorCatch(B, size=size, stack=2, paddle_width=paddle_width, device="cpu")
    rng = np.random.default_rng(paddle_width)
    jstate = JaxCatchState(  # injected mid-episode lanes
        ball_row=jnp.asarray(rng.integers(0, size - 1, B), jnp.int32),
        ball_col=jnp.asarray(rng.integers(0, size, B), jnp.int32),
        paddle_col=jnp.asarray(rng.integers(0, size, B), jnp.int32),
        t=jnp.asarray(rng.integers(0, size - 1, B), jnp.int32),
    )
    ends, paid = _rollout(jenv, env, _catch_draws(jenv), CatchDraws, CatchState, jstate, 40,
                          _random_actions(3), seed=paddle_width)
    assert ends >= 2 * B and paid == ends


@pytest.mark.parametrize("num_cues,size", [(4, 16), (2, 9)])
def test_recall_matches_jax_exactly(num_cues, size):
    jenv = JaxRecall(size=size, delay=3, num_cues=num_cues)
    env = TensorRecall(B, size=size, delay=3, num_cues=num_cues, device="cpu")
    rng = np.random.default_rng(num_cues)
    jstate = JaxRecallState(cue=jnp.asarray(rng.integers(0, num_cues, B), jnp.int32),
                            t=jnp.asarray(rng.integers(0, 4, B), jnp.int32))
    ends, paid = _rollout(jenv, env, _recall_draws(jenv), RecallDraws, RecallState, jstate,
                          20, _random_actions(num_cues), seed=size)
    assert ends >= 4 * B and paid == ends


def _breakout_state(rng, jenv):
    """Random lanes: positions, velocities and walls; lane 0 has one brick
    left, right where the ball is heading."""
    size, rows = jenv.size, jenv.brick_rows
    bricks = rng.uniform(size=(B, rows, size)) < 0.6
    ball_y = rng.integers(0, size - 1, B)
    ball_x = rng.integers(0, size, B)
    dx, dy = rng.choice([-1, 1], B), rng.choice([-1, 1], B)
    bricks[0] = False
    ball_x[0], ball_y[0], dx[0], dy[0] = 3, jenv.brick_top + rows, 1, -1
    bricks[0, rows - 1, 4] = True
    return JaxBreakoutState(
        ball_x=jnp.asarray(ball_x, jnp.int32), ball_y=jnp.asarray(ball_y, jnp.int32),
        dx=jnp.asarray(dx, jnp.int32), dy=jnp.asarray(dy, jnp.int32),
        paddle_x=jnp.asarray(rng.integers(1, size - 1, B), jnp.int32),
        bricks=jnp.asarray(bricks), t=jnp.asarray(rng.integers(0, 30, B), jnp.int32),
    )


def _tracker_or_random(rng, state):
    """Half the lanes follow the ball (they hit bricks and rally), half
    play at random (they miss)."""
    track = (torch.sign(state.ball_x - state.paddle_x) + 1).numpy()
    return np.where(np.arange(B) % 2 == 0, track, rng.integers(0, 3, size=B))


@pytest.mark.parametrize("render_size,stack", [(None, 1), (84, 4), (23, 2)])
def test_breakout_matches_jax_exactly(render_size, stack):
    kw = dict(size=10, stack=stack, max_steps=60, render_size=render_size)
    jenv = JaxBreakout(**kw)
    env = TensorBreakout(B, **kw, device="cpu")
    jstate = _breakout_state(np.random.default_rng(stack), jenv)
    venv = JaxVecEnv(jenv, num_envs=B)
    ends, hits = _rollout(jenv, env, _breakout_draws(jenv), BreakoutDraws, BreakoutState,
                          jstate, 120 if render_size is None else 40, _tracker_or_random,
                          seed=stack)
    assert ends >= B // 2 and hits >= B
    # lane 0's first step clears the wall, which comes back full
    state = BreakoutState(*_to_torch(jstate))
    draws = BreakoutDraws(*_to_torch(jax.vmap(_breakout_draws(jenv))(
        jax.random.split(jax.random.PRNGKey(9), B))))
    new, _, rew, _ = env.transition(state, torch.ones(B, dtype=torch.long), draws)
    jnew, _, jrew, _ = jax.jit(venv._step)(jstate, jnp.ones(B, jnp.int32),
                                            jax.random.split(jax.random.PRNGKey(9), B))
    assert float(rew[0]) == 1.0 and bool(new.bricks[0].all())
    _assert_state_equal(new, jnew)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))


def test_breakout_render_upscale_is_bit_exact():
    jenv = JaxBreakout(size=10, stack=4, render_size=84)
    env = TensorBreakout(B, size=10, stack=4, render_size=84, device="cpu")
    jstate = _breakout_state(np.random.default_rng(5), jenv)
    want = jax.vmap(jenv._render)(jstate)
    got = env._render(BreakoutState(*_to_torch(jstate)))
    assert got.shape == (B, 84, 84, 4) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0, 128, 255}


ENVS = {
    "catch": lambda: TensorCatch(B, size=8, device="cpu"),
    "recall": lambda: TensorRecall(B, size=8, delay=2, device="cpu"),
    "breakout": lambda: TensorBreakout(B, size=10, max_steps=12, device="cpu"),
}


@pytest.mark.parametrize("name", list(ENVS))
def test_draws_come_from_the_generator_and_episodes_reset(name):
    env = ENVS[name]()
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(g)
    assert obs.shape == (B,) + env.observation_shape and obs.dtype == torch.uint8
    d1, d2 = env.draw(torch.Generator().manual_seed(1)), env.draw(torch.Generator().manual_seed(1))
    for a, b in zip(d1, d2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # the same seed, the same draws
    for field in d1:
        assert field.shape == (B,) and field.dtype == torch.int64
    if name == "breakout":
        assert set(d1.dx.tolist()) <= {-1, 1}
    high = env.num_cues if name == "recall" else env.size
    assert 0 <= int(d1[0].min()) and int(d1[0].max()) < high
    ends = torch.zeros(B, dtype=torch.long)
    for _ in range(30):
        action = torch.randint(0, env.num_actions, (B,), generator=g)
        state, obs, rew, done = env.step(state, action, g)
        ends += done.long()
        # a lane that ended this step already holds the new episode's start
        assert bool((state.t[done] == 0).all())
    assert bool((ends > 0).all())


def test_make_tensor_vec_env_matches_the_jax_registry():
    cases = {"CartPole-v1": {}, "CartPole-v0": {}, "SyntheticPixel-v0": dict(size=24),
             "Catch-v0": dict(size=12), "Recall-v0": dict(delay=3),
             "Breakout-v0": dict(size=10, render_size=84, stack=4)}
    for env_id, kw in cases.items():
        env = make_tensor_vec_env(env_id, 3, device="cpu", **kw)
        jenv = make_jax_vec_env(env_id, 3, **({} if env_id.startswith("CartPole") else kw))
        assert env.num_envs == 3 and env.device == torch.device("cpu")
        assert env.observation_shape == jenv.observation_shape, env_id
        assert env.num_actions == jenv.num_actions, env_id
    assert make_tensor_vec_env("CartPole-v0", 2, device="cpu").max_steps == 200
    with pytest.raises(KeyError) as want:
        make_jax_vec_env("Pong-v5", 2)
    with pytest.raises(KeyError) as got:
        make_tensor_vec_env("Pong-v5", 2, device="cpu")
    assert str(got.value) == str(want.value)
