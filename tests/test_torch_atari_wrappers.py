"""The port's DeepMind Atari wrappers (``scalerl_torch/envs/atari.py``)
against the JAX package's (``scalerl_tpu/envs/atari.py``).

Neither machine has ``ale_py`` or the ROMs, so the stacks run over a
synthetic Atari-like gymnasium env (``tests/torch_fake_atari.py``: RGB
frames, the ALE's action meanings, a lives counter).  The same seeds and
actions go through both packages' wrappers, which must give bit-equal
observations, rewards and end flags: each frame wrapper alone, the full
``wrap_deepmind`` stack (with and without FIRE, scaled, the A3C 42x42
variant) and ``NormalizedEnv`` (float32, exact).  ``make_gym_env`` applies
the stack and ``normalize_obs`` as the JAX factory does; importing the port's
module loads neither gymnasium nor OpenCV.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from scalerl_torch.envs import atari as tatari
from scalerl_torch.envs import gym_env as tgym
from scalerl_tpu.envs import atari as jatari
from scalerl_tpu.envs import gym_env as jgym

from torch_fake_atari import FakeAtariEnv

REPO = Path(__file__).resolve().parent.parent


def _run_pair(make_t, make_j, steps=120, seed=3):
    envs = [make_t(), make_j()]
    outs = [env.reset(seed=seed) for env in envs]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = int(rng.integers(envs[0].action_space.n))
        (o1, r1, te1, tr1, _), (o2, r2, te2, tr2, _) = (env.step(a) for env in envs)
        np.testing.assert_array_equal(o1, o2)
        assert o1.dtype == o2.dtype and (r1, te1, tr1) == (r2, te2, tr2)
        if te1 or tr1:
            o1, _ = envs[0].reset()
            o2, _ = envs[1].reset()
            np.testing.assert_array_equal(o1, o2)
    assert envs[0].observation_space == envs[1].observation_space


WRAPPERS = [
    ("NoopResetEnv", dict(noop_max=5)),
    ("MaxAndSkipEnv", dict(skip=4)),
    ("EpisodicLifeEnv", {}),
    ("FireResetEnv", {}),
    ("WarpFrame", dict(size=84)),
    ("ScaledFloatFrame", {}),
    ("ClipRewardEnv", {}),
    ("NormalizedEnv", dict(alpha=0.99)),
]


@pytest.mark.parametrize("name,kw", WRAPPERS)
def test_each_wrapper_matches_jax(name, kw):
    _run_pair(lambda: getattr(tatari, name)(FakeAtariEnv(), **kw),
              lambda: getattr(jatari, name)(FakeAtariEnv(), **kw))


def test_frame_stack_matches_jax():
    _run_pair(lambda: tatari.FrameStack(tatari.WarpFrame(FakeAtariEnv()), 4),
              lambda: jatari.FrameStack(jatari.WarpFrame(FakeAtariEnv()), 4))


@pytest.mark.parametrize("fire,kw", [
    (True, {}),
    (False, {}),
    (True, dict(scale=True, episode_life=False)),
    (True, dict(episode_life=False, clip_rewards=False, frame_stack=1, warp_size=42)),
])
def test_wrap_deepmind_matches_jax(fire, kw):
    _run_pair(lambda: tatari.wrap_deepmind(FakeAtariEnv(fire=fire), **kw),
              lambda: jatari.wrap_deepmind(FakeAtariEnv(fire=fire), **kw), steps=80)
    env = tatari.wrap_deepmind(FakeAtariEnv(fire=fire), **kw)
    size, stack = kw.get("warp_size", 84), kw.get("frame_stack", 4)
    assert env.observation_space.shape == (size, size, stack)


def test_normalized_stack_matches_jax():
    _run_pair(lambda: tatari.NormalizedEnv(tatari.wrap_deepmind(FakeAtariEnv(), frame_stack=1)),
              lambda: jatari.NormalizedEnv(jatari.wrap_deepmind(FakeAtariEnv(), frame_stack=1)),
              steps=60)


def test_make_gym_env_applies_the_stack_and_normalize_obs():
    env_id = "torch_fake_atari:FakeAtariEnv"
    for kw in (dict(atari=True), dict(normalize_obs=True), dict(atari=True, normalize_obs=True)):
        _run_pair(tgym.make_gym_env(env_id, seed=1, **kw), jgym.make_gym_env(env_id, seed=1, **kw),
                  steps=40)


def test_importing_the_module_loads_neither_gymnasium_nor_opencv():
    code = ("import sys; import scalerl_torch.envs.atari as a; "
            "print(sorted({'gymnasium', 'cv2'} & set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
