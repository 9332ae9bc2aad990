"""DeepMind-style Atari preprocessing (gymnasium's 5-tuple API).

Port of ``scalerl_tpu/envs/atari.py``: ``NoopResetEnv`` (up to 30 no-ops),
``MaxAndSkipEnv`` (4), ``EpisodicLifeEnv``, ``FireResetEnv``, ``WarpFrame``
(84x84 gray; 42 for the A3C variant), ``ScaledFloatFrame``, ``ClipRewardEnv``
(sign), ``FrameStack`` (4, channel-last), ``NormalizedEnv`` (running mean
and std) and the stacks ``wrap_deepmind``, ``make_atari_env`` and
``create_atari_env``.  Frames stay channel-last uint8 ``[H, W, stack]``;
the model scales them on the device.

Like the JAX module, this one needs gymnasium and, for ``WarpFrame``,
OpenCV, but imports them only when a wrapper is first asked for (an
attribute of the module, or a call of a stack): the wrapper classes
subclass gymnasium's and are built then, so importing the port needs
neither.  OpenCV stays optional: without it ``WarpFrame`` raises.
Actual Atari games also need ``ale_py`` and its ROMs.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict

import numpy as np

WRAPPERS = ("NoopResetEnv", "MaxAndSkipEnv", "EpisodicLifeEnv", "FireResetEnv", "WarpFrame",
            "ScaledFloatFrame", "ClipRewardEnv", "FrameStack", "NormalizedEnv")
_built: Dict[str, Any] = {}


def _cv2():
    try:
        import cv2
    except ImportError:  # OpenCV is optional
        return None
    cv2.ocl.setUseOpenCL(False)
    return cv2


def _build() -> Dict[str, Any]:
    """Define the wrapper classes over gymnasium's (once)."""
    if _built:
        return _built
    import gymnasium as gym

    class NoopResetEnv(gym.Wrapper):
        """Take 1..noop_max no-op steps at reset."""

        def __init__(self, env, noop_max: int = 30) -> None:
            super().__init__(env)
            self.noop_max = noop_max
            self.noop_action = 0
            assert env.unwrapped.get_action_meanings()[0] == "NOOP"

        def reset(self, **kwargs):
            obs, info = self.env.reset(**kwargs)
            noops = self.unwrapped.np_random.integers(1, self.noop_max + 1)
            for _ in range(noops):
                obs, _, terminated, truncated, info = self.env.step(self.noop_action)
                if terminated or truncated:
                    obs, info = self.env.reset(**kwargs)
            return obs, info

    class MaxAndSkipEnv(gym.Wrapper):
        """Repeat the action ``skip`` times; observe the max of the last
        two frames."""

        def __init__(self, env, skip: int = 4) -> None:
            super().__init__(env)
            self._obs_buffer = np.zeros((2,) + env.observation_space.shape, dtype=np.uint8)
            self._skip = skip

        def step(self, action):
            total_reward = 0.0
            terminated = truncated = False
            info = {}
            for i in range(self._skip):
                obs, reward, terminated, truncated, info = self.env.step(action)
                if i == self._skip - 2:
                    self._obs_buffer[0] = obs
                if i == self._skip - 1:
                    self._obs_buffer[1] = obs
                total_reward += float(reward)
                if terminated or truncated:
                    break
            max_frame = self._obs_buffer.max(axis=0)
            return max_frame, total_reward, terminated, truncated, info

    class EpisodicLifeEnv(gym.Wrapper):
        """End the episode on a life lost; reset for real only at game over."""

        def __init__(self, env) -> None:
            super().__init__(env)
            self.lives = 0
            self.was_real_done = True

        def step(self, action):
            obs, reward, terminated, truncated, info = self.env.step(action)
            self.was_real_done = terminated or truncated
            lives = self.env.unwrapped.ale.lives()
            if 0 < lives < self.lives:
                terminated = True
            self.lives = lives
            return obs, reward, terminated, truncated, info

        def reset(self, **kwargs):
            if self.was_real_done:
                obs, info = self.env.reset(**kwargs)
            else:
                obs, _, terminated, truncated, info = self.env.step(0)
                if terminated or truncated:
                    obs, info = self.env.reset(**kwargs)
            self.lives = self.env.unwrapped.ale.lives()
            return obs, info

    class FireResetEnv(gym.Wrapper):
        """Press FIRE at reset, for games that need it to start."""

        def __init__(self, env) -> None:
            super().__init__(env)
            assert env.unwrapped.get_action_meanings()[1] == "FIRE"
            assert len(env.unwrapped.get_action_meanings()) >= 3

        def reset(self, **kwargs):
            self.env.reset(**kwargs)
            obs, _, terminated, truncated, _ = self.env.step(1)
            if terminated or truncated:
                self.env.reset(**kwargs)
            obs, _, terminated, truncated, _ = self.env.step(2)
            if terminated or truncated:
                self.env.reset(**kwargs)
            return obs, {}

    class WarpFrame(gym.ObservationWrapper):
        """Grayscale and resize to ``size`` x ``size`` (84 DeepMind, 42 A3C)."""

        def __init__(self, env, size: int = 84) -> None:
            super().__init__(env)
            self.cv2 = _cv2()
            if self.cv2 is None:
                raise ImportError("WarpFrame requires opencv-python")
            self.size = size
            self.observation_space = gym.spaces.Box(low=0, high=255, shape=(size, size, 1),
                                                    dtype=np.uint8)

        def observation(self, frame):
            cv2 = self.cv2
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            frame = cv2.resize(frame, (self.size, self.size), interpolation=cv2.INTER_AREA)
            return frame[:, :, None]

    class ScaledFloatFrame(gym.ObservationWrapper):
        """uint8 -> [0, 1] float32 (not in the default stack: the model
        scales on the device)."""

        def __init__(self, env) -> None:
            super().__init__(env)
            self.observation_space = gym.spaces.Box(
                low=0.0, high=1.0, shape=env.observation_space.shape, dtype=np.float32)

        def observation(self, obs):
            return np.asarray(obs, dtype=np.float32) / 255.0

    class ClipRewardEnv(gym.RewardWrapper):
        """Reward -> sign(reward)."""

        def reward(self, reward):
            return float(np.sign(reward))

    class FrameStack(gym.Wrapper):
        """Stack the last ``k`` frames on the channel axis (channel-last)."""

        def __init__(self, env, k: int = 4) -> None:
            super().__init__(env)
            self.k = k
            self.frames: deque = deque([], maxlen=k)
            shp = env.observation_space.shape
            assert len(shp) == 3, "FrameStack expects [H, W, C] observations"
            self.observation_space = gym.spaces.Box(
                low=0, high=255, shape=(shp[0], shp[1], shp[2] * k),
                dtype=env.observation_space.dtype)

        def reset(self, **kwargs):
            obs, info = self.env.reset(**kwargs)
            for _ in range(self.k):
                self.frames.append(obs)
            return self._get_obs(), info

        def step(self, action):
            obs, reward, terminated, truncated, info = self.env.step(action)
            self.frames.append(obs)
            return self._get_obs(), reward, terminated, truncated, info

        def _get_obs(self):
            assert len(self.frames) == self.k
            return np.concatenate(list(self.frames), axis=-1)

    class NormalizedEnv(gym.ObservationWrapper):
        """Running mean and std normalisation with EMA bias correction: a
        scalar mean and std over whole observations, decay ``alpha``,
        divided by ``1 - alpha^t`` to unbias the early steps."""

        def __init__(self, env, alpha: float = 0.9999) -> None:
            super().__init__(env)
            self.alpha = alpha
            self.state_mean = 0.0
            self.state_std = 0.0
            self.num_steps = 0
            self.observation_space = gym.spaces.Box(
                low=-np.inf, high=np.inf, shape=env.observation_space.shape, dtype=np.float32)

        def observation(self, observation):
            obs = np.asarray(observation, np.float32)
            self.num_steps += 1
            self.state_mean = self.alpha * self.state_mean + (1 - self.alpha) * obs.mean()
            self.state_std = self.alpha * self.state_std + (1 - self.alpha) * obs.std()
            correction = 1 - self.alpha**self.num_steps
            unbiased_mean = self.state_mean / correction
            unbiased_std = self.state_std / correction
            return (obs - unbiased_mean) / (unbiased_std + 1e-8)

    for cls in (NoopResetEnv, MaxAndSkipEnv, EpisodicLifeEnv, FireResetEnv, WarpFrame,
                ScaledFloatFrame, ClipRewardEnv, FrameStack, NormalizedEnv):
        cls.__module__ = __name__
        cls.__qualname__ = cls.__name__
        _built[cls.__name__] = cls
    globals().update(_built)
    return _built


def __getattr__(name: str) -> Any:
    if name in WRAPPERS:
        return _build()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def wrap_deepmind(
    env,
    episode_life: bool = True,
    clip_rewards: bool = True,
    frame_stack: int = 4,
    scale: bool = False,
    warp_size: int = 84,
    noop_max: int = 30,
    skip: int = 4,
):
    """The full DeepMind stack."""
    w = _build()
    env = w["NoopResetEnv"](env, noop_max=noop_max)
    env = w["MaxAndSkipEnv"](env, skip=skip)
    if episode_life:
        env = w["EpisodicLifeEnv"](env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = w["FireResetEnv"](env)
    env = w["WarpFrame"](env, size=warp_size)
    if scale:
        env = w["ScaledFloatFrame"](env)
    if clip_rewards:
        env = w["ClipRewardEnv"](env)
    if frame_stack > 1:
        env = w["FrameStack"](env, frame_stack)
    return env


def create_atari_env(env_id: str, seed: int = 42, warp_size: int = 42, normalize: bool = True):
    """The A3C 42x42 variant: rescale and running normalisation."""
    import gymnasium as gym

    env = gym.make(env_id)
    env = wrap_deepmind(env, episode_life=False, clip_rewards=False, frame_stack=1,
                        warp_size=warp_size)
    if normalize:
        env = _build()["NormalizedEnv"](env)
    env.action_space.seed(seed)
    return env


def make_atari_env(env_id: str, seed: int = 42, **wrap_kwargs):
    """``gym.make`` and the full DeepMind stack (needs ``ale_py``)."""
    import gymnasium as gym

    env = gym.make(env_id)
    env = wrap_deepmind(env, **wrap_kwargs)
    env.action_space.seed(seed)
    return env
