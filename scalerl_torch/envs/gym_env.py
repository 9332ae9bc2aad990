"""Host environments behind gym's vector API.

Port of ``scalerl_tpu/envs/gym_env.py``: :func:`make_gym_env` (a thunk
building one gymnasium env, by registry id or ``"pkg.module:ClassName"``),
:func:`make_vect_envs` (a pool with SAME_STEP autoreset: on an episode's
end ``step`` returns the reset observation and puts the true last one in
``infos["final_obs"]``; async pools run one spawned worker a env); both
import gymnasium when called.  :func:`make_multi_agent_vect_envs` pools
PettingZoo parallel envs.

Two views give the same vector API without gymnasium, for machines that
have none: :class:`SyncVectorView` steps a list of the port's numpy envs
(``envs/synthetic_gym.py``) in the calling thread, with the same SAME_STEP
semantics, and :class:`TensorVectorView` wraps one of the port's tensor
envs (``envs/tensor_envs``) and hands numpy in and out.  Nothing here picks
an env stack by what is installed: the caller names one
(:func:`make_host_envs` by ``env_backend`` and id).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def make_gym_env(
    env_id: str,
    seed: int = 42,
    idx: int = 0,
    capture_video: bool = False,
    video_dir: Optional[str] = None,
    atari: bool = False,
    normalize_obs: bool = False,
    wrappers: Optional[Sequence[Callable[[Any], Any]]] = None,
    **env_kwargs,
) -> Callable[[], Any]:
    """A thunk building one gymnasium env (what vector constructors take).

    ``env_id`` is a gymnasium registry id or a ``"pkg.module:ClassName"``
    path, constructed with ``env_kwargs``.  ``atari`` applies the DeepMind
    stack (``envs/atari.py::wrap_deepmind``), ``normalize_obs`` the running
    mean and std (``NormalizedEnv``), then ``wrappers``, outermost last
    (picklable ones, for async pools)."""

    def thunk():
        import gymnasium as gym

        # inside the thunk: spawned workers start with a fresh registry
        from scalerl_torch.envs.synthetic_gym import register_synthetic_envs

        register_synthetic_envs()
        render_mode = "rgb_array" if (capture_video and idx == 0) else None
        mod_name, _, cls_name = env_id.partition(":")
        if cls_name.isidentifier():
            import importlib

            env_cls = getattr(importlib.import_module(mod_name), cls_name)
            env = env_cls(render_mode=render_mode, **env_kwargs)
        else:
            env = gym.make(env_id, render_mode=render_mode, **env_kwargs)
        if capture_video and idx == 0 and video_dir is not None:
            env = gym.wrappers.RecordVideo(env, video_dir)
        env = gym.wrappers.RecordEpisodeStatistics(env)
        if atari:
            from scalerl_torch.envs.atari import wrap_deepmind

            env = wrap_deepmind(env)
        if normalize_obs:
            from scalerl_torch.envs.atari import NormalizedEnv

            env = NormalizedEnv(env)
        for wrap in wrappers or ():
            env = wrap(env)
        env.action_space.seed(seed + idx)
        return env

    return thunk


def make_vect_envs(
    env_id: str,
    num_envs: int = 1,
    seed: int = 42,
    async_envs: bool = True,
    capture_video: bool = False,
    video_dir: Optional[str] = None,
    atari: bool = False,
    **env_kwargs,
):
    """A gymnasium vector env with SAME_STEP autoreset; ``async_envs`` with
    more than one env runs one spawned worker each over shared memory
    (spawn, not fork: the parent holds threads and, on a card, a CUDA
    context, which a forked child must not inherit)."""
    import gymnasium as gym

    thunks = [
        make_gym_env(env_id, seed=seed, idx=i, capture_video=capture_video,
                     video_dir=video_dir, atari=atari, **env_kwargs)
        for i in range(num_envs)
    ]
    mode = gym.vector.AutoresetMode.SAME_STEP
    if async_envs and num_envs > 1:
        return gym.vector.AsyncVectorEnv(thunks, shared_memory=True, autoreset_mode=mode,
                                         context="spawn")
    return gym.vector.SyncVectorEnv(thunks, autoreset_mode=mode)


def make_multi_agent_vect_envs(env_fn: Callable, num_envs: int = 1, **env_kwargs):
    """A pool of ``num_envs`` PettingZoo parallel envs, one spawned worker
    each (``envs/vector/async_vec.py::AsyncMultiAgentVecEnv``), each built
    by ``env_fn(**env_kwargs)``."""
    from functools import partial

    from scalerl_torch.envs.vector import AsyncMultiAgentVecEnv

    return AsyncMultiAgentVecEnv([partial(env_fn, **env_kwargs) for _ in range(num_envs)])


class SyncVectorView:
    """gym's vector API over numpy envs with gym's single-env API, stepped
    one after another in the calling thread, with SAME_STEP autoreset:
    ``reset(seed)`` seeds env ``i`` with ``seed + i``; where ``step`` ends
    an episode it resets that env, returns the reset observation, and puts
    the last one in ``infos["final_obs"]`` (mask ``infos["_final_obs"]``)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]) -> None:
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def reset(self, seed: Optional[int] = None):
        obs = [env.reset(seed=None if seed is None else seed + i)[0]
               for i, env in enumerate(self.envs)]
        return np.stack(obs), {}

    def step(self, actions):
        obs, rewards, terms, truncs = [], [], [], []
        final_obs: List[Any] = [None] * self.num_envs
        ended = np.zeros(self.num_envs, bool)
        for i, (env, a) in enumerate(zip(self.envs, np.asarray(actions))):
            o, r, term, trunc, _ = env.step(a)
            if term or trunc:
                final_obs[i], ended[i] = o, True
                o, _ = env.reset()
            obs.append(o)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
        infos: Dict[str, Any] = {}
        if ended.any():
            infos = {"final_obs": np.array(final_obs, dtype=object), "_final_obs": ended}
        return (np.stack(obs), np.asarray(rewards, np.float64), np.asarray(terms, bool),
                np.asarray(truncs, bool), infos)

    def close(self) -> None:
        for env in self.envs:
            env.close()


class TensorVectorView:
    """gym's vector API over one of the port's tensor envs (on the device it
    was built for), numpy in and out.  The env resets a finished lane
    itself, so ``obs`` is already the reset observation and every end is
    reported as ``terminated``; ``reset(seed)`` seeds the env's generator."""

    def __init__(self, env) -> None:
        import torch

        from scalerl_torch.envs.synthetic_gym import Box, Discrete

        self.env = env
        self.num_envs = env.num_envs
        self._torch = torch
        obs_dtype = np.uint8 if len(env.observation_shape) == 3 else np.float32
        self.single_observation_space = Box(0, 255, env.observation_shape, obs_dtype)
        self.single_action_space = Discrete(env.num_actions)
        self.generator = torch.Generator(device=env.device).manual_seed(0)
        self.state = None

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self.generator.manual_seed(seed)
        self.state, obs = self.env.reset(self.generator)
        return obs.cpu().numpy(), {}

    def step(self, actions):
        a = self._torch.as_tensor(np.asarray(actions), device=self.env.device).long()
        self.state, obs, reward, done = self.env.step(self.state, a, self.generator)
        done = done.cpu().numpy()
        return (obs.cpu().numpy(), reward.cpu().numpy().astype(np.float64), done,
                np.zeros_like(done), {})

    def close(self) -> None:
        pass


# the port's own host envs, by the ids register_synthetic_envs gives them
NUMPY_ENVS = {"PixelRing-v0": "PixelRingEnv", "RecallGym-v0": "RecallGymEnv",
              "BreakoutGym-v0": "BreakoutGymEnv"}


def make_host_envs(env_id: str, num_envs: int, seed: int = 42, env_backend: str = "gym",
                   async_envs: bool = False, **env_kwargs):
    """A host vector env for the host-plane trainers (DQN, Ape-X, R2D2), by
    ``env_backend``: ``"jax"`` is the port's tensor env of that id stepped on
    the CPU behind :class:`TensorVectorView`; ``"gym"`` is the port's numpy
    env behind :class:`SyncVectorView` for its own ids (``NUMPY_ENVS``), any
    other id through gymnasium (:func:`make_vect_envs`).  ``env_kwargs`` go
    to the env's constructor."""
    if env_backend == "jax":
        from scalerl_torch.envs.tensor_envs import make_tensor_vec_env

        return TensorVectorView(make_tensor_vec_env(env_id, num_envs, device="cpu",
                                                    **env_kwargs))
    if env_backend != "gym":
        raise ValueError(f"env_backend must be gym | jax, got {env_backend!r}")
    if env_id in NUMPY_ENVS:
        import functools

        from scalerl_torch.envs import synthetic_gym

        cls = getattr(synthetic_gym, NUMPY_ENVS[env_id])
        return SyncVectorView([functools.partial(cls, **env_kwargs)] * num_envs)
    return make_vect_envs(env_id, num_envs=num_envs, seed=seed, async_envs=async_envs,
                          **env_kwargs)
