"""Gym-API synthetic envs in numpy (twins of the port's tensor envs).

The port's own copy of ``scalerl_tpu/envs/synthetic_gym.py``:
``PixelRingEnv`` (84x84x4 uint8 frames, pre-rendered with the numpy twin of
``SyntheticPixelEnv``'s renderer), ``RecallGymEnv`` and ``BreakoutGymEnv``,
step for step the JAX package's classes on the same seeds and actions.

The classes import without gymnasium (the card's machine may have none):
they speak gym's ``reset``/``step`` API with the small ``Box`` and
``Discrete`` spaces below.  :func:`register_synthetic_envs` imports
gymnasium and registers ``PixelRing-v0``, ``RecallGym-v0`` and
``BreakoutGym-v0``, whose entry points (:func:`make_pixel_ring`, ...) build
``gymnasium.Env`` subclasses of these classes with gymnasium's spaces, as
``gym.make`` requires.  The module imports numpy only, so spawned env
workers load neither torch's CUDA nor anything of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Type

import numpy as np


class Box:
    """gymnasium's ``Box`` as far as the trainers read it."""

    def __init__(self, low: float, high: float, shape: Tuple[int, ...], dtype: Any) -> None:
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def to_gym(self):
        import gymnasium as gym

        return gym.spaces.Box(self.low, self.high, self.shape, self.dtype)


class Discrete:
    """gymnasium's ``Discrete`` as far as the trainers read it."""

    def __init__(self, n: int) -> None:
        self.n = int(n)
        self.shape: Tuple[int, ...] = ()
        self.dtype = np.dtype(np.int64)

    def seed(self, seed=None) -> None:
        pass

    def to_gym(self):
        import gymnasium as gym

        return gym.spaces.Discrete(self.n)



def render_ring_frame(
    cell: int, size: int, stack: int, num_states: int
) -> np.ndarray:
    """Numpy twin of ``SyntheticPixelEnv._render``: a bright stripe at the
    cell's column block over a fixed dim texture (held bit-equal to the
    JAX package's renderer in the tests)."""
    rows = np.arange(size)[:, None, None]
    cols = np.arange(size)[None, :, None]
    chans = np.arange(stack)[None, None, :]
    texture = (rows * 2 + cols * 5 + chans * 17) % 128
    stripe_w = max(size // num_states, 1)
    in_stripe = (cols // stripe_w) == cell
    return np.where(in_stripe, 255, texture).astype(np.uint8)


class PixelRingEnv:
    """Deterministic-dynamics pixel env: N pre-rendered ring cells; the
    "correct" action advances the ring, anything else teleports randomly.

    ``gym.make("PixelRing-v0")`` builds its ``gymnasium.Env`` subclass
    (:func:`make_pixel_ring`).
    """

    metadata: dict = {"render_modes": []}

    def __init__(self, size: int = 84, stack: int = 4, num_actions: int = 6,
                 num_states: int = 16, episode_length: int = 128,
                 render_mode=None) -> None:
        # gym.make forwards render_mode to the ctor even when None
        self.render_mode = render_mode
        self.observation_space = Box(0, 255, (size, size, stack), np.uint8)
        self.action_space = Discrete(num_actions)
        self.num_states = num_states
        self.num_actions = num_actions
        self.episode_length = episode_length
        self._frames = np.stack(
            [render_ring_frame(c, size, stack, num_states) for c in range(num_states)]
        )
        self._rng = np.random.default_rng(0)
        self._cell = 0
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cell = int(self._rng.integers(self.num_states))
        self._t = 0
        return self._frames[self._cell], {}

    def step(self, action):
        correct = int(action) == (self._cell % self.num_actions)
        reward = float(correct)
        if correct:
            self._cell = (self._cell + 1) % self.num_states
        else:
            self._cell = int(self._rng.integers(self.num_states))
        self._t += 1
        done = self._t >= self.episode_length
        if done:
            self._cell = int(self._rng.integers(self.num_states))
            self._t = 0
        return self._frames[self._cell], reward, done, False, {}

    def close(self):
        pass


class RecallGymEnv:
    """Numpy twin of the recall task (``TensorRecall``): flash a
    quadrant cue, wait ``delay`` blank steps, demand recall (+1 / -1 at
    the final step).  A memoryless policy is pinned at expected return
    ``(2 - num_cues) / num_cues``; any positive mean return is proof of
    recurrent memory."""

    metadata: dict = {"render_modes": []}

    def __init__(self, size: int = 16, delay: int = 6, num_cues: int = 4,
                 render_mode=None) -> None:
        if num_cues not in (2, 4):
            raise ValueError("num_cues must be 2 or 4 (quadrant patterns)")
        self.render_mode = render_mode
        self.size = size
        self.delay = delay
        self.num_cues = num_cues
        self.observation_space = Box(0, 255, (size, size, 1), np.uint8)
        self.action_space = Discrete(num_cues)
        self._rng = np.random.default_rng(0)
        self._cue = 0
        self._t = 0

    def _render_frame(self) -> np.ndarray:
        # the device env's render (cue visible only at t=0)
        half = self.size // 2
        rows = np.arange(self.size)[:, None]
        cols = np.arange(self.size)[None, :]
        if self.num_cues == 4:
            in_q = ((rows >= half) == (self._cue // 2)) & (
                (cols >= half) == (self._cue % 2)
            )
        else:
            # broadcast against rows explicitly: the half-plane mask
            # alone is [1, size]
            in_q = np.broadcast_to(
                (cols >= half) == (self._cue % 2), (self.size, self.size)
            )
        frame = np.where((self._t == 0) & in_q, 255, 0).astype(np.uint8)
        return frame[:, :, None]

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cue = int(self._rng.integers(self.num_cues))
        self._t = 0
        return self._render_frame(), {}

    def step(self, action):
        self._t += 1
        done = self._t > self.delay
        reward = (
            (1.0 if int(action) == self._cue else -1.0) if done else 0.0
        )
        if done:
            self._cue = int(self._rng.integers(self.num_cues))
            self._t = 0
        return self._render_frame(), reward, done, False, {}

    def close(self):
        pass


class BreakoutGymEnv:
    """Numpy twin of ``TensorBreakout``: the
    flagship pixel-control task for the HOST actor plane (CPU envs feeding
    central batched inference), dynamics formula-identical to the device
    env: diagonal unit-velocity ball, 3-wide paddle, +1 per brick, miss
    terminates, cleared wall respawns, time cap truncates."""

    metadata: dict = {"render_modes": []}

    def __init__(
        self,
        size: int = 10,
        stack: int = 1,
        brick_rows: int = 3,
        brick_top: int = 2,
        max_steps: int = 500,
        render_mode=None,
    ) -> None:
        self.render_mode = render_mode
        self.size = size
        self.stack = stack
        self.brick_rows = brick_rows
        self.brick_top = brick_top
        self.max_steps = max_steps
        self.observation_space = Box(0, 255, (size, size, stack), np.uint8)
        self.action_space = Discrete(3)
        self._rng = np.random.default_rng(0)
        self._spawn()

    def _spawn(self) -> None:
        self._ball_x = int(self._rng.integers(self.size))
        self._ball_y = self.brick_top + self.brick_rows
        self._dx = 1 if self._rng.random() < 0.5 else -1
        self._dy = 1
        self._paddle_x = self.size // 2
        self._bricks = np.ones((self.brick_rows, self.size), bool)
        self._t = 0

    def _render_frame(self) -> np.ndarray:
        frame = np.zeros((self.size, self.size), np.uint8)
        band = slice(self.brick_top, self.brick_top + self.brick_rows)
        frame[band][self._bricks] = 128
        frame[self.size - 1, max(self._paddle_x - 1, 0) : self._paddle_x + 2] = 255
        frame[self._ball_y, self._ball_x] = 255
        return np.broadcast_to(
            frame[:, :, None], (self.size, self.size, self.stack)
        ).copy()

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._spawn()
        return self._render_frame(), {}

    def step(self, action):
        W = self.size
        self._paddle_x = int(np.clip(self._paddle_x + int(action) - 1, 1, W - 2))

        nx = self._ball_x + self._dx
        if nx < 0 or nx >= W:
            self._dx = -self._dx
            nx = int(np.clip(nx, 0, W - 1))
        ny = self._ball_y + self._dy
        if ny < 0:
            self._dy = 1
            ny = 1

        reward = 0.0
        brow = ny - self.brick_top
        if 0 <= brow < self.brick_rows and self._bricks[brow, nx]:
            self._bricks[brow, nx] = False
            reward = 1.0
            ny = self._ball_y  # reflect back to the previous row
            self._dy = -self._dy

        term = False
        if ny >= W - 1:
            if abs(nx - self._paddle_x) <= 1:
                ny = W - 2
                self._dy = -1
            else:
                term = True
        if not self._bricks.any():
            self._bricks[:] = True

        self._ball_x, self._ball_y = nx, ny
        self._t += 1
        trunc = not term and self._t >= self.max_steps
        if term or trunc:
            self._spawn()
        return self._render_frame(), reward, term, trunc, {}

    def close(self):
        pass


_GYM_CLASSES: Dict[type, type] = {}


def gym_env_class(cls: Type) -> type:
    """The ``gymnasium.Env`` subclass of one of these classes (built once):
    the same dynamics, with gymnasium's spaces."""
    import gymnasium as gym

    made = _GYM_CLASSES.get(cls)
    if made is None:
        def __init__(self, *args, **kwargs):
            cls.__init__(self, *args, **kwargs)
            self.observation_space = self.observation_space.to_gym()
            self.action_space = self.action_space.to_gym()

        made = type(cls.__name__, (cls, gym.Env), {"__init__": __init__,
                                                   "__module__": __name__})
        _GYM_CLASSES[cls] = made
    return made


def make_pixel_ring(**kwargs):
    return gym_env_class(PixelRingEnv)(**kwargs)


def make_recall(**kwargs):
    return gym_env_class(RecallGymEnv)(**kwargs)


def make_breakout(**kwargs):
    return gym_env_class(BreakoutGymEnv)(**kwargs)


def register_synthetic_envs() -> None:
    """Register ``PixelRing-v0``, ``RecallGym-v0`` and ``BreakoutGym-v0``
    with gymnasium (idempotent)."""
    import gymnasium as gym

    for env_id, fn in (("PixelRing-v0", "make_pixel_ring"), ("RecallGym-v0", "make_recall"),
                       ("BreakoutGym-v0", "make_breakout")):
        if env_id not in gym.registry:
            gym.register(id=env_id, entry_point=f"{__name__}:{fn}", disable_env_checker=True)
