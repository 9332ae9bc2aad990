"""Fleet runners, task sources and env factories for the fleet and vector-env
tests (tests/test_torch_fleet*.py, tests/test_torch_autoscaler.py,
tests/test_torch_vector_env.py).

Imports nothing of JAX and no test module, so a spawned gather unpickles its
runner cheaply; the same runners drive both packages' clusters.
"""

import threading
import time

import numpy as np


def bandit_runner(task, weights, worker_id):
    """A deterministic episode: the reward is the sum of the published
    ``w``, the payload the task's seed."""
    w = weights["w"] if weights is not None else np.zeros(2, np.float32)
    seed = int(task.get("seed", 0))
    return {"role": task.get("role", "rollout"), "seed": seed,
            "reward": float(np.asarray(w).sum()), "frames": np.full((4, 2), seed, np.float32)}


def slow_bandit_runner(task, weights, worker_id):
    """:func:`bandit_runner` at 50 ms an episode, so a fleet holds tasks in
    flight when a test cuts it."""
    time.sleep(0.05)
    return bandit_runner(task, weights, worker_id)


def report_runner(task, weights, worker_id):
    """:func:`bandit_runner` and what the worker process loaded: its CUDA
    state and top-level modules."""
    import sys

    import torch

    return {**bandit_runner(task, weights, worker_id),
            "cuda_initialized": torch.cuda.is_initialized(),
            "modules": sorted({m.split(".")[0] for m in list(sys.modules)})}


def make_task_source(n, version=lambda: 0):
    counter = {"i": 0}
    lock = threading.Lock()

    def source():
        with lock:
            if counter["i"] >= n:
                return None
            counter["i"] += 1
            return {"role": "rollout", "seed": counter["i"], "param_version": version()}

    return source


def drain(server, n, timeout=120.0):
    """Up to ``n`` results from ``server``, waiting at most ``timeout``."""
    results = []
    deadline = time.monotonic() + timeout
    while len(results) < n and time.monotonic() < deadline:
        r = server.get_result(timeout=0.2)
        if r is not None:
            results.append(r)
    return results


# --- env factories for spawned env workers (tests/test_torch_vector_env.py)


def plane_writer_child(plane, idx):
    plane.write_env(idx, {"x": np.array([3.0, 4.0], np.float32)})


def crashing_pursuit():
    """A ``PursuitToyEnv`` whose step raises."""
    from scalerl_torch.envs.multi_agent import PursuitToyEnv

    class CrashingEnv(PursuitToyEnv):
        def step(self, actions):
            raise RuntimeError("boom at step")

    return CrashingEnv()


class _Box:
    shape = (3,)
    dtype = np.float32


class _Discrete:
    n = 2


class CountEnv:
    """A single-agent gym-style env without gymnasium."""

    observation_space = _Box()
    action_space = _Discrete()

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.full(3, float(seed or 0), np.float32), {}

    def step(self, action):
        self.t += 1
        return (np.full(3, float(self.t), np.float32), float(action), self.t >= 3, False,
                {"t": self.t})

    def close(self):
        pass


def make_pursuit():
    from pettingzoo.sisl import pursuit_v4

    return pursuit_v4.parallel_env(n_pursuers=2, n_evaders=2, max_cycles=8, x_size=8,
                                   y_size=8)


class ReportingScriptedFactory:
    """The port's scripted generation-host engine
    (``genrl/disagg.py::ScriptedEngineFactory``) whose payloads also carry
    what the host process loaded: its CUDA state and top-level modules."""

    def __init__(self, **kw):
        self.kw = kw

    def __call__(self, params, generation):
        from scalerl_torch.genrl.disagg import ScriptedEngineFactory

        engine = ScriptedEngineFactory(**self.kw)(params, generation)
        step = engine.step

        def reporting_step():
            import sys

            import torch

            out = step()
            for payload in out:
                payload["cuda_initialized"] = torch.cuda.is_initialized()
                payload["modules"] = sorted({m.split(".")[0] for m in list(sys.modules)})
            return out

        engine.step = reporting_step
        return engine
