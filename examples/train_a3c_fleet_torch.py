"""Async A3C over the actor fleet on PyTorch: the twin of ``examples/train_a3c_fleet.py``.

Parity target: ``scalerl/algorithms/a3c/ray_a3c.py:27-127``, the reference's
cluster-wide A3C: remote actors roll out under the newest weights they have
and compute *gradients* locally; a central driver applies them as they
arrive and republishes the weights.  Here that protocol runs over the
port's fleet (``scalerl_torch/fleet``):

- **workers** (fleet worker processes on the host, one torch thread each,
  never touching the card) pull a task and the newest published weights,
  unroll ``T`` steps of their ``TensorCartPole`` lanes on the CPU, compute
  the A2C gradient of that rollout with ``agents/a3c.py::a3c_loss``, and
  upload it as numpy;
- **the learner** applies each arriving gradient on the card with the A3C
  optimizer (clip by global norm, then Adam, in optax's form) the moment it
  arrives, with no barrier (gradients computed on slightly stale weights
  apply as they are: the Hogwild/Ray-A3C semantics, race-free by message
  passing), then republishes a new weight version as numpy.

The learner runs on the card and raises without one (``--device cpu`` runs
it on the host).  Guard ``if __name__ == "__main__":`` in scripts that call
:func:`train_a3c_fleet`: the gathers start by spawn.

Run: ``python examples/train_a3c_fleet_torch.py [--num-workers 2]
[--total-frames 100000]``
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

# worker-process state: one env, model and generator a worker, built at its
# first task and kept for the process's life
_WORKER_STATE: Dict[str, Any] = {}


def a3c_args_from_task(task: Dict[str, Any]):
    from scalerl_torch.config import A3CArguments

    return A3CArguments(
        hidden_sizes=str(task["hidden_sizes"]), gamma=float(task["gamma"]),
        gae_lambda=float(task["gae_lambda"]), value_loss_coef=float(task["value_loss_coef"]),
        entropy_coef=float(task["entropy_coef"]))


def a3c_fleet_grads(params: Dict[str, Any], model, traj, args) -> Tuple[float, Dict[str, np.ndarray]]:
    """``(loss, numpy gradients)`` of ``a3c_loss`` at ``params`` on one
    ``[T+1, B]`` chunk: what a fleet worker uploads."""
    import torch

    from scalerl_torch.agents.a3c import a3c_loss

    leaves = {k: torch.as_tensor(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
    loss, _ = a3c_loss(leaves, model, traj, gamma=args.gamma, gae_lambda=args.gae_lambda,
                       value_loss_coef=args.value_loss_coef, entropy_coef=args.entropy_coef)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(leaves, grads)}


def rollout(params, model, venv, carry, unroll: int, generator):
    """``unroll`` steps of the worker's lanes under ``params``: ``(carry,
    traj, return_sum, episode_count)``.  Row 0 of the ``[T+1, B]`` chunk is
    the carried boundary state (the previous chunk's bootstrap row), the
    on-policy trainer's overlap, so frames = T * B exactly."""
    import torch
    from torch.func import functional_call

    from scalerl_torch.agents.policy_value import sample_categorical
    from scalerl_torch.data.trajectory import Trajectory

    env_state, obs, last_action, reward, done, ep_ret = carry
    rows = [(obs, last_action, reward, done)]
    ret_sum = torch.zeros(())
    ep_count = torch.zeros(())
    with torch.no_grad():
        for _ in range(unroll):
            out, _ = functional_call(model, params, (obs[None], last_action[None],
                                                     reward[None], done[None], ()))
            action = sample_categorical(out.policy_logits[0], generator)
            env_state, obs, reward, done = venv.step(env_state, action, generator)
            reward = reward.to(torch.float32)
            ep_ret = ep_ret + reward
            ret_sum += torch.where(done, ep_ret, 0.0).sum()
            ep_count += done.sum()
            ep_ret = torch.where(done, 0.0, ep_ret)
            last_action = action
            rows.append((obs, action, reward, done))
    traj = Trajectory(
        obs=torch.stack([r[0] for r in rows]), action=torch.stack([r[1] for r in rows]).long(),
        reward=torch.stack([r[2] for r in rows]), done=torch.stack([r[3] for r in rows]),
        logits=torch.zeros((unroll + 1, obs.shape[0], venv.num_actions)),  # unused by a3c_loss
    )
    return ((env_state, obs, last_action, reward, done, ep_ret), traj, float(ret_sum),
            float(ep_count))


def _a3c_grad_runner(task: Dict[str, Any], weights: Any, worker_id: int) -> Dict[str, Any]:
    """Fleet runner: a rollout under ``weights``, then its A2C gradient."""
    import torch

    if "model" not in _WORKER_STATE:
        from scalerl_torch.agents.a3c import build_model
        from scalerl_torch.envs.tensor_envs import make_tensor_vec_env

        args = a3c_args_from_task(task)
        venv = make_tensor_vec_env(task["env_id"], int(task["num_envs"]), device="cpu")
        B = int(task["num_envs"])
        generator = torch.Generator().manual_seed(int(task["seed"]) * 4096 + 1000 + worker_id)
        env_state, obs = venv.reset(generator)
        _WORKER_STATE.update(
            args=args, venv=venv, generator=generator,
            model=build_model(args, venv.observation_shape, venv.num_actions, device="cpu"),
            carry=(env_state, obs, torch.zeros(B, dtype=torch.int64), torch.zeros(B),
                   torch.ones(B, dtype=torch.bool), torch.zeros(B)))
    st = _WORKER_STATE
    params = {k: torch.as_tensor(np.asarray(v)) for k, v in weights.items()}
    T, B = int(task["unroll"]), int(task["num_envs"])
    st["carry"], traj, ret_sum, ep_count = rollout(params, st["model"], st["venv"],
                                                   st["carry"], T, st["generator"])
    loss, grads = a3c_fleet_grads(params, st["model"], traj, st["args"])
    return {"role": "rollout", "grads": grads, "loss": loss, "frames": T * B,
            "return_sum": ret_sum, "episode_count": ep_count}


def apply_fleet_grads(optimizer, params: Dict[str, Any], opt_state: Dict[str, Any],
                      grads: Dict[str, np.ndarray]):
    """One optimizer step of a worker's numpy gradients on the learner's
    device: ``(params, opt_state)``."""
    import torch

    device = next(iter(params.values())).device
    g = {k: torch.as_tensor(grads[k], device=device) for k in params}
    updates, opt_state = optimizer.update(g, opt_state)
    return {k: params[k] + updates[k] for k in params}, opt_state


def train_a3c_fleet(
    num_workers: int = 2,
    total_frames: int = 100_000,
    num_envs: int = 4,
    unroll: int = 32,
    learning_rate: float = 3e-3,
    hidden_sizes: str = "128,128",
    entropy_coef: float = 0.01,
    seed: int = 0,
    on_window=None,
    device: str = "cuda",
    max_seconds: float = 0.0,
) -> Dict[str, Any]:
    """Drive the async-gradient A3C fleet on CartPole; return its summary.

    ``on_window(frames, windowed_return)`` fires every 20 applied gradients.
    ``max_seconds > 0`` stops issuing tasks that long after the first
    gradient arrives; ``applied_per_s`` and ``env_frames_per_s`` count from
    it to the last."""
    import torch

    from scalerl_torch.agents.a3c import build_model, make_a3c_optimizer
    from scalerl_torch.config import A3CArguments
    from scalerl_torch.fleet import FleetConfig, LocalCluster, WorkerServer
    from scalerl_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    args = A3CArguments(hidden_sizes=hidden_sizes, learning_rate=learning_rate,
                        entropy_coef=entropy_coef, seed=seed)
    model = build_model(args, obs_shape=(4,), num_actions=2, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    optimizer = make_a3c_optimizer(args)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt_state = optimizer.init(params)

    frames_per_task = unroll * num_envs
    n_tasks = max(total_frames // frames_per_task, 1)
    task_template = {
        "role": "rollout", "env_id": "CartPole-v1", "num_envs": num_envs, "unroll": unroll,
        "hidden_sizes": hidden_sizes, "seed": seed, "gamma": args.gamma,
        "gae_lambda": args.gae_lambda, "value_loss_coef": args.value_loss_coef,
        "entropy_coef": entropy_coef,
    }
    issued = {"n": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def task_source():
        with lock:
            if stop.is_set() or issued["n"] >= n_tasks:
                return None
            issued["n"] += 1
        return dict(task_template, param_version=server.params.version)

    config = FleetConfig(num_workers=num_workers, workers_per_gather=2, upload_batch=1)
    server = WorkerServer(config, task_source)
    server.publish(params)
    server.start(listen=False)
    cluster = LocalCluster(server, config, _a3c_grad_runner, mp_context="spawn")
    cluster.start()

    t0 = time.time()
    deadline = None  # max_seconds counts from the first gradient: the fleet is up
    frames = applied = idle = 0
    ret_sum = ep_count = 0.0
    prev_sum = prev_cnt = 0.0
    windowed = 0.0
    t_first = t_last = None
    try:
        while applied < n_tasks:
            if deadline is not None and time.time() >= deadline:
                stop.set()
            r = server.get_result(timeout=1.0)
            if r is None:
                if not server.worker_errors.empty():
                    err = server.worker_errors.get()
                    raise RuntimeError(f"fleet worker failed: {err.get('error')}")
                idle += 1
                if idle >= (5 if stop.is_set() else 120):
                    break  # the workers went quiet: report what there is
                continue
            idle = 0
            if t_first is None:
                t_first = time.time()
                deadline = t_first + max_seconds if max_seconds > 0 else None
            params, opt_state = apply_fleet_grads(optimizer, params, opt_state, r["grads"])
            applied += 1
            t_last = time.time()
            frames += r["frames"]
            ret_sum += r["return_sum"]
            ep_count += r["episode_count"]
            # async republish: workers see the new version at their next task
            server.publish(params)
            if applied % 20 == 0:
                if ep_count > prev_cnt:
                    windowed = (ret_sum - prev_sum) / (ep_count - prev_cnt)
                    prev_sum, prev_cnt = ret_sum, ep_count
                if on_window is not None:
                    on_window(frames, windowed)
            with lock:
                if stop.is_set() and applied >= issued["n"]:
                    break  # every issued task's gradient is applied
    finally:
        stop.set()
        cluster.join()
        server.stop()
    # the last window: episodes since the last tick count too
    if ep_count > prev_cnt:
        windowed = (ret_sum - prev_sum) / (ep_count - prev_cnt)
        if on_window is not None:
            on_window(frames, windowed)
    wall = time.time() - t0
    return {
        "applied_updates": applied,
        "env_frames": frames,
        "windowed_return": round(windowed, 2),
        "weight_version": server.params.version,
        "wall_s": round(wall, 1),
        "fps": round(frames / max(wall, 1e-9), 1),
        # from the first gradient to the last, the fleet's start-up left out
        "applied_per_s": applied / max(t_last - t_first, 1e-9) if t_first else 0.0,
        "env_frames_per_s": frames / max(t_last - t_first, 1e-9) if t_first else 0.0,
        "params": params,
    }


def main(argv=None) -> Dict[str, Any]:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--total-frames", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    summary = train_a3c_fleet(
        num_workers=args.num_workers, total_frames=args.total_frames, seed=args.seed,
        device=args.device,
        on_window=lambda f, w: print(f"frames {f} | return {w:.1f}", flush=True),
    )
    print("summary:", {k: v for k, v in summary.items() if k != "params"})
    return summary


if __name__ == "__main__":
    main()
