"""An env for the port's spawned-worker isolation check: it reports which
top-level packages its worker process has loaded.  Imports numpy only."""

import sys

import numpy as np

from scalerl_torch.envs.synthetic_gym import PixelRingEnv, gym_env_class


class ModulesEnv(gym_env_class(PixelRingEnv)):
    def __init__(self, render_mode=None):
        super().__init__(size=8, stack=1, num_states=4, render_mode=render_mode)

    @property
    def loaded_roots(self):
        return sorted({m.split(".")[0] for m in sys.modules})

    @property
    def cuda_initialized(self):
        torch = sys.modules.get("torch")
        return bool(torch is not None and torch.cuda.is_initialized())


__all__ = ["ModulesEnv", "np"]
