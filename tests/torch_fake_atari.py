"""A synthetic Atari-like gymnasium env for the wrapper tests: RGB frames of
210x160x3 that depend on the seed, the step and the action, the ALE's action
meanings and a lives counter (``unwrapped.ale.lives()``).  Imports gymnasium
and numpy only."""

import gymnasium as gym
import numpy as np


class _Ale:
    def __init__(self, env):
        self.env = env

    def lives(self):
        return self.env.lives


class FakeAtariEnv(gym.Env):
    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, render_mode=None, fire=True, episode_steps=40, lives=3):
        self.render_mode = render_mode
        self.meanings = ["NOOP", "FIRE", "RIGHT", "LEFT"] if fire else ["NOOP", "RIGHT", "LEFT"]
        self.action_space = gym.spaces.Discrete(len(self.meanings))
        self.observation_space = gym.spaces.Box(0, 255, (210, 160, 3), np.uint8)
        self.episode_steps, self.start_lives = episode_steps, lives
        self.ale = _Ale(self)

    def get_action_meanings(self):
        return list(self.meanings)

    def _frame(self):
        return self.np_random.integers(0, 256, (210, 160, 3), dtype=np.uint8)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self.t, self.lives = 0, self.start_lives
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        if self.np_random.uniform() < 0.08:
            self.lives -= 1
        reward = float(self.np_random.integers(-3, 4)) * (1 + int(action))
        terminated = self.lives <= 0 or self.t >= self.episode_steps
        return self._frame(), reward, terminated, False, {}
