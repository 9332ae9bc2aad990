"""Parity of the port's host envs (``scalerl_torch/envs/synthetic_gym.py``,
``envs/gym_env.py``) with the JAX package's numpy twins.

- ``PixelRingEnv``, ``RecallGymEnv`` and ``BreakoutGymEnv`` give bit-equal
  observations, rewards and end flags on the same seeds and actions, as do
  their gymnasium registrations;
- ``make_vect_envs`` has the same SAME_STEP ``final_obs`` semantics, and the
  port's ``SyncVectorView`` (no gymnasium) steps like gymnasium's pool.

(``tests/test_torch_isolation.py`` checks that a spawned env worker of the
port loads nothing of JAX.)
"""

import gymnasium as gym
import numpy as np
import pytest

from scalerl_torch.envs import gym_env as tgym
from scalerl_torch.envs import synthetic_gym as tsyn
from scalerl_tpu.envs import gym_env as jgym
from scalerl_tpu.envs import synthetic_gym as jsyn

CASES = [
    ("PixelRingEnv", dict()),
    ("PixelRingEnv", dict(size=24, stack=2, num_actions=4, num_states=5, episode_length=17)),
    ("RecallGymEnv", dict(size=12, delay=3, num_cues=2)),
    ("RecallGymEnv", dict()),
    ("BreakoutGymEnv", dict(size=10, max_steps=60)),
    ("BreakoutGymEnv", dict(size=8, stack=2, brick_rows=2, max_steps=500)),
]


def _assert_same_step(a, b):
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("name,kw", CASES)
def test_numpy_twins_are_bit_equal_to_jax(name, kw):
    tenv, jenv = getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)
    assert tenv.observation_space.shape == jenv.observation_space.shape
    assert tenv.action_space.n == jenv.action_space.n
    rng = np.random.default_rng(len(kw))
    for seed in (0, 11):
        to, _ = tenv.reset(seed=seed)
        jo, _ = jenv.reset(seed=seed)
        np.testing.assert_array_equal(to, jo)
        ends = 0
        for _ in range(400):
            a = int(rng.integers(tenv.action_space.n))
            t, j = tenv.step(a), jenv.step(a)
            _assert_same_step(t, j)
            ends += bool(t[2] or t[3])
        assert ends > 0


@pytest.mark.parametrize("env_id", ["PixelRing-v0", "RecallGym-v0", "BreakoutGym-v0"])
def test_registered_envs_match_jax(env_id):
    tsyn.register_synthetic_envs()
    tmake, jmake = tgym.make_gym_env(env_id, seed=3), jgym.make_gym_env(env_id, seed=3)
    tenv, jenv = tmake(), jmake()
    assert isinstance(tenv.unwrapped, gym.Env)
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    np.testing.assert_array_equal(tenv.reset(seed=5)[0], jenv.reset(seed=5)[0])
    for a in np.random.default_rng(0).integers(0, tenv.action_space.n, 300):
        _assert_same_step(tenv.step(int(a)), jenv.step(int(a)))


@pytest.mark.parametrize("env_id", ["CartPole-v1", "RecallGym-v0"])
def test_vector_envs_keep_same_step_final_obs(env_id):
    tv = tgym.make_vect_envs(env_id, num_envs=3, seed=1, async_envs=False)
    jv = jgym.make_vect_envs(env_id, num_envs=3, seed=1, async_envs=False)
    np.testing.assert_array_equal(tv.reset(seed=4)[0], jv.reset(seed=4)[0])
    rng = np.random.default_rng(2)
    finals = 0
    for _ in range(300):
        a = rng.integers(0, tv.single_action_space.n, 3)
        t, j = tv.step(a), jv.step(a)
        _assert_same_step(t, j)
        assert ("final_obs" in t[4]) == ("final_obs" in j[4])
        if "final_obs" in t[4]:
            finals += 1
            np.testing.assert_array_equal(t[4]["_final_obs"], j[4]["_final_obs"])
            for i in np.nonzero(t[4]["_final_obs"])[0]:
                np.testing.assert_array_equal(t[4]["final_obs"][i], j[4]["final_obs"][i])
    assert finals > 0
    tv.close()
    jv.close()


def test_sync_vector_view_steps_like_gymnasium():
    kw = dict(size=12, delay=3, num_cues=2)
    view = tgym.SyncVectorView([lambda: tsyn.RecallGymEnv(**kw) for _ in range(3)])
    ref = gym.vector.SyncVectorEnv([lambda: jsyn.RecallGymEnv(**kw) for _ in range(3)],
                                   autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    np.testing.assert_array_equal(view.reset(seed=2)[0], ref.reset(seed=2)[0])
    assert view.single_action_space.n == ref.single_action_space.n == 2
    rng = np.random.default_rng(5)
    for _ in range(50):
        a = rng.integers(0, 2, 3)
        t, j = view.step(a), ref.step(a)
        _assert_same_step(t, j)
        if "final_obs" in j[4]:
            np.testing.assert_array_equal(t[4]["_final_obs"], j[4]["_final_obs"])
            for i in np.nonzero(j[4]["_final_obs"])[0]:
                np.testing.assert_array_equal(t[4]["final_obs"][i], j[4]["final_obs"][i])


def test_atari_ids_name_the_missing_module():
    """``envs/atari.py`` is ported, so ``atari=True`` no longer refuses:
    the thunk builds, and calling it names what is still missing here, the
    ALE namespace of ``ale_py`` (the wrappers' own parity is in
    ``tests/test_torch_atari_wrappers.py``)."""
    thunk = tgym.make_gym_env("ALE/Pong-v5", atari=True)
    with pytest.raises(gym.error.Error, match="ALE"):
        thunk()
