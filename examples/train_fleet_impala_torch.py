"""IMPALA over the actor fleet on PyTorch: the twin of ``examples/train_fleet_impala.py``.

Host CPU actors, central V-trace learner on the card.  A worker fleet
(gathers spawned as local processes over pipes; ``RemoteCluster`` joins the
same protocol from other hosts over TCP) runs env lanes with numpy policy
inference on versioned weight snapshots and streams fixed-shape ``[T+1, B]``
trajectory chunks back; the learner applies V-trace, which corrects the
policy lag this topology creates, and republishes the weights as numpy.

Workers keep *persistent* env lanes across tasks: each task advances the
lanes ``rollout_length`` steps from where they stopped, so chunks are
continuous trajectories with carried last-action, reward and done rows, the
``data/trajectory.py`` layout of every other IMPALA path.  The lanes are
CartPole as the port's ``TensorCartPole`` stepped on the CPU
(``envs/gym_env.py::make_host_envs(..., env_backend="jax")``; the card's
machine has no gymnasium), which resets a finished lane in the same step, so
no terminal-to-reset transition reaches V-trace.

The learner runs on the card and raises without one (``--device cpu`` runs
it on the host); ``--use-pallas`` routes V-trace through the CUDA kernel, one
launch a learn step.  Scripts that call :func:`train_fleet_impala` must
guard ``if __name__ == "__main__":``: the gathers start by spawn and
re-import ``__main__``.

Usage::

    python examples/train_fleet_impala_torch.py --total-frames 100000 --num-workers 4
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ENV_ID = "CartPole-v1"
OBS_DIM, NUM_ACTIONS = 4, 2
CHUNK_KEYS = ("obs", "action", "reward", "done", "logits")
# seconds the spawned fleet gets to send its first answer
BOOT_TIMEOUT_S = 180.0
# seconds the fleet gets, once the window closes, to hand back every issued
# task before the run reports the rest as unanswered
DRAIN_TIMEOUT_S = 60.0


class ChunkRunner:
    """A worker's rollout: persistent env lanes and a numpy policy.

    Picklable (config only); the envs and the carried state are built in the
    worker process at its first task.  ``_live`` holds ``[envs, obs,
    last_action, reward, done, ep_ret, rng]``, as the JAX example's runner
    does; the softmax draw comes from the lane's seeded numpy ``Generator``.
    """

    def __init__(self, num_lanes: int = 2, rollout_length: int = 16) -> None:
        self.num_lanes = num_lanes
        self.rollout_length = rollout_length
        self._live = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_live"] = None
        return state

    def _ensure(self, seed: int):
        if self._live is None:
            from scalerl_torch.envs.gym_env import make_host_envs

            envs = make_host_envs(ENV_ID, self.num_lanes, seed, env_backend="jax")
            obs, _ = envs.reset(seed=seed)
            B = self.num_lanes
            self._live = [envs, obs, np.zeros(B, np.int32), np.zeros(B, np.float32),
                          np.ones(B, bool), np.zeros(B, np.float64),
                          np.random.default_rng(seed)]
        return self._live

    def __call__(self, task: Dict[str, Any], weights: Any, worker_id: int) -> Dict[str, Any]:
        if task.get("role") == "noop":
            # the learner is behind its off-policy window: idle briefly
            time.sleep(0.05)
            return {"noop": True}
        from scalerl_torch.models.np_forward import mlp_policy_forward

        live = self._ensure(int(task["seed"]) + 104729 * worker_id)
        envs, obs, last_action, reward, done, ep_ret, rng = live
        T, B = self.rollout_length, self.num_lanes
        chunk = {
            "obs": np.zeros((T + 1, B, OBS_DIM), np.float32),
            "action": np.zeros((T + 1, B), np.int32),
            "reward": np.zeros((T + 1, B), np.float32),
            "done": np.ones((T + 1, B), bool),
            "logits": np.zeros((T + 1, B, NUM_ACTIONS), np.float32),
        }
        returns = []
        for t in range(T + 1):
            chunk["obs"][t] = obs
            chunk["action"][t] = last_action
            chunk["reward"][t] = reward
            chunk["done"][t] = done
            if t == T:
                break  # row T is model input only (the learner reads logits[:-1])
            if weights is None:
                logits = np.zeros((B, NUM_ACTIONS), np.float32)
            else:
                logits = mlp_policy_forward(weights, obs)
            chunk["logits"][t] = logits
            # softmax draw: the behaviour policy is the current snapshot
            z = logits - logits.max(axis=-1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(axis=-1, keepdims=True)
            action = np.array([rng.choice(NUM_ACTIONS, p=p[b]) for b in range(B)], np.int32)
            obs, reward, term, trunc, _ = envs.step(action)
            done = np.logical_or(term, trunc)
            reward = np.asarray(reward, np.float32)
            last_action = action
            ep_ret += reward
            for b in np.nonzero(done)[0]:
                returns.append(float(ep_ret[b]))
                ep_ret[b] = 0.0
        live[1:6] = [obs, last_action, reward, done, ep_ret]
        chunk["returns"] = returns
        chunk["seed"] = int(task["seed"])
        return chunk


def fleet_batch(chunks) -> Dict[str, np.ndarray]:
    """Worker chunks side by side on the batch axis: ``[T+1, n_chunks *
    lanes]``."""
    return {k: np.concatenate([c[k] for c in chunks], axis=1) for k in CHUNK_KEYS}


def fleet_impala_args(rollout_length: int = 16, batch_size: int = 8, num_lanes: int = 2,
                      num_workers: int = 4, learning_rate: float = 2e-3,
                      total_frames: int = 100_000, use_pallas: bool = False):
    """The learner's ``ImpalaArguments`` at the JAX example's own width: an
    MLP of hidden 64, no LSTM, T=16, 8 lanes a batch."""
    from scalerl_torch.config import ImpalaArguments

    return ImpalaArguments(
        env_id=ENV_ID, use_lstm=False, hidden_size=64, rollout_length=rollout_length,
        batch_size=batch_size,
        # slot-aware floor: a slot is one worker's lanes; queue depth is the
        # worst-case policy lag
        num_buffers=max(2 * max(batch_size // num_lanes, 1), num_workers),
        learning_rate=learning_rate, entropy_cost=0.01, max_timesteps=total_frames,
        use_pallas=use_pallas)


def train_fleet_impala(
    total_frames: int = 100_000,
    num_workers: int = 4,
    num_lanes: int = 2,
    rollout_length: int = 16,
    batch_size: int = 8,
    publish_every: int = 1,
    learning_rate: float = 2e-3,
    use_pallas: bool = False,
    device: str = "cuda",
    autoscale: bool = False,
    autoscale_max_workers: int = 0,
    autoscale_config: Optional[Dict[str, Any]] = None,
    workers_per_gather: int = 4,
    max_seconds: float = 0.0,
    log_every: int = 50,
) -> Dict[str, Any]:
    """Run the fleet to ``total_frames`` consumed frames (or for
    ``max_seconds`` from its first answer, when positive), then stop issuing
    tasks and drain every answer still in flight.  ``wall_s`` and the rates
    count from the first answer (``boot_s`` is the fleet's start-up before
    it).  Returns rates, policy lag, the task accounting
    (every issued rollout answered exactly once), the server's requeue and
    dedup counters, the ``fleet.*`` telemetry tree and the agent.
    ``autoscale_config`` overrides fields of the autoscaler's
    ``AutoscalerConfig``; ``workers_at_end`` is the fleet's spawned worker
    count when the window closed."""
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.data.trajectory import TrajectorySpec, batch_to_trajectory
    from scalerl_torch.fleet import FleetConfig, LocalCluster, WorkerServer
    from scalerl_torch.runtime import telemetry

    iargs = fleet_impala_args(rollout_length, batch_size, num_lanes, num_workers,
                              learning_rate, total_frames, use_pallas)
    agent = ImpalaAgent(iargs, obs_shape=(OBS_DIM,), num_actions=NUM_ACTIONS, device=device)

    n_chunks = max(batch_size // num_lanes, 1)
    lock = threading.Lock()
    frames_per_task = rollout_length * num_lanes
    # off-policy window: never hand out tasks more than a few batches ahead
    # of what the learner consumed, or queued chunks age into large lag
    window = 4 * n_chunks * frames_per_task
    frames = {"sent": 0, "consumed": 0}
    issued: list = []
    stop = threading.Event()
    server_box: Dict[str, Any] = {}

    def task_source():
        with lock:
            if stop.is_set() or frames["sent"] >= total_frames:
                return None
            if frames["sent"] - frames["consumed"] >= window:
                return {"role": "noop"}  # the fleet idles briefly and retries
            frames["sent"] += frames_per_task
            task_seed = frames["sent"] // frames_per_task
            issued.append(task_seed)
            return {"role": "rollout", "seed": task_seed,
                    "param_version": server_box["s"].params.version}

    # the learn step's first call builds the V-trace kernel: make it before
    # the actors produce, on zeros, and keep the state from before it so
    # the warm-up's update never reaches the workers
    warm_spec = TrajectorySpec(unroll_length=rollout_length, batch_size=n_chunks * num_lanes,
                               obs_shape=(OBS_DIM,), num_actions=NUM_ACTIONS,
                               obs_dtype=np.float32)
    state_before = agent.state
    agent.learn(batch_to_trajectory(warm_spec.host_zeros(), agent.device))
    agent.state = state_before

    config = FleetConfig(num_workers=num_workers, workers_per_gather=workers_per_gather,
                         upload_batch=2)
    # the queue outsizes the off-policy window plus in-flight noops: at
    # capacity the server evicts the stalest result, whose frames would be
    # sent but never consumed
    server = WorkerServer(config, task_source,
                          result_maxsize=4 * n_chunks + 2 * num_workers + 8)
    server_box["s"] = server
    server.publish(agent.get_weights())
    server.start()
    runner = ChunkRunner(num_lanes=num_lanes, rollout_length=rollout_length)
    # spawn: this process holds the card's CUDA context
    cluster = LocalCluster(server, config, runner, mp_context="spawn")
    cluster.start()
    autoscaler = None
    if autoscale:
        from scalerl_torch.fleet import ClusterExecutor
        from scalerl_torch.runtime.autoscaler import (
            Autoscaler,
            AutoscalerConfig,
            fleet_signal_source,
        )

        autoscaler = Autoscaler(
            AutoscalerConfig(**{"min_workers": num_workers,
                                "max_workers": autoscale_max_workers or 2 * num_workers,
                                "interval_s": 1.0, "cooldown_s": 10.0,
                                **(autoscale_config or {})}),
            executor=ClusterExecutor(server, cluster),
            signal_source=fleet_signal_source(server),
        ).start()
    learn_meter = telemetry.get_registry().meter("rates.learn_steps_per_s")
    chunks: list = []
    returns: list = []
    answered: list = []
    lags: list = []
    learn_steps = env_frames = drained_frames = idle_polls = 0
    metrics: Dict[str, float] = {}
    t0 = time.time()
    t_first = None  # the first answer: the window starts once the fleet is up
    deadline = None

    def take(result) -> bool:
        """Account one rollout answer; True when it is a rollout chunk."""
        if result.get("noop"):
            return False
        nonlocal t_first, deadline
        if t_first is None:
            t_first = time.time()
            deadline = t_first + max_seconds if max_seconds > 0 else None
        answered.append(int(result["seed"]))
        returns.extend(result.pop("returns", []))
        lags.append(server.params.version - int(result.get("param_version", 0)))
        return True

    try:
        while env_frames < total_frames and (deadline is None or time.time() < deadline):
            result = server.get_result(timeout=1.0)
            if result is None:
                while not server.worker_errors.empty():
                    err = server.worker_errors.get()
                    # a lost gather or link (no worker id) is the autoscaler's
                    # to backfill; a failed episode is an error
                    if autoscaler is None or err.get("worker_id") is not None:
                        raise RuntimeError(f"fleet worker failed: {err.get('error')}")
                if t_first is None and time.time() - t0 > BOOT_TIMEOUT_S:
                    raise RuntimeError(f"no fleet answer within {BOOT_TIMEOUT_S:.0f} s")
                with lock:
                    exhausted = frames["sent"] >= total_frames
                idle_polls += 1
                if exhausted and idle_polls >= 5:
                    break  # tasks done and the pipeline drained
                continue
            idle_polls = 0
            if not take(result):
                continue
            chunks.append(result)
            env_frames += frames_per_task
            with lock:
                frames["consumed"] = env_frames
            if len(chunks) < n_chunks:
                continue
            batch = fleet_batch(chunks)
            chunks.clear()
            metrics = agent.learn(batch_to_trajectory(batch, agent.device))
            learn_steps += 1
            learn_meter.mark()
            if learn_steps % publish_every == 0:
                server.publish(agent.get_weights())
            if log_every and learn_steps % log_every == 0:
                sps = env_frames / max(time.time() - t0, 1e-8)
                recent = float(np.mean(returns[-50:])) if returns else float("nan")
                print(f"frames {env_frames} | sps {sps:.0f} | return(50) {recent:.1f} "
                      f"| lag {lags[-1]} | loss {metrics.get('total_loss', float('nan')):.2f} "
                      f"| weights v{server.params.version}", flush=True)
        wall = time.time() - (t_first or t0)
        workers_at_end = cluster.spawned_worker_count()
        # stop issuing, then take every answer still in flight: each issued
        # rollout must come back exactly once
        stop.set()
        drain_deadline = time.time() + DRAIN_TIMEOUT_S
        while len(answered) < len(issued) and time.time() < drain_deadline:
            result = server.get_result(timeout=0.2)
            if result is not None and take(result):
                drained_frames += frames_per_task
    finally:
        stop.set()
        if autoscaler is not None:
            autoscaler.stop()
        cluster.join()
        server.stop()
    first = float(np.mean(returns[:50])) if returns else float("nan")
    last = float(np.mean(returns[-50:])) if returns else float("nan")
    counts = np.bincount(np.asarray(answered, np.int64)) if answered else np.zeros(0)
    tree = server.telemetry.tree()
    return {
        "env_frames": env_frames,
        "learn_steps": learn_steps,
        "learn_calls": learn_steps + 1,  # and the warm-up
        "wall_s": wall,
        "env_frames_per_s": env_frames / max(wall, 1e-9),
        "learn_steps_per_s": learn_steps / max(wall, 1e-9),
        "boot_s": (t_first or t0) - t0,
        "lag_mean": float(np.mean(lags)) if lags else float("nan"),
        "lag_max": int(max(lags)) if lags else 0,
        "return_first50": first,
        "return_last50": last,
        "episodes": len(returns),
        "issued": len(issued),
        "answered": len(answered),
        "answered_unique": int((counts > 0).sum()),
        "answered_twice": int((counts > 1).sum()),
        "unanswered": len(set(issued) - set(answered)),
        "drained_frames": drained_frames,
        "requeued_tasks": server.requeued_tasks,
        "duplicate_results": server.duplicate_results,
        "duplicate_tasks": server.duplicate_tasks,
        "dropped_results": server.dropped_results,
        "worker_errors_total": server.worker_errors_total,
        "weight_version": server.params.version,
        "workers_at_end": workers_at_end,
        "fleet_telemetry": {"sources": tree["sources"],
                            "frames_absorbed": tree["frames_absorbed"],
                            "aggregate": tree["aggregate"]},
        "autoscaler": None if autoscaler is None else {
            "decisions": autoscaler.decisions, "scale_ups": autoscaler.scale_ups,
            "scale_downs": autoscaler.scale_downs},
        "metrics": metrics,
        "agent": agent,
    }


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--total-frames", type=int, default=100_000)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--num-lanes", type=int, default=2, help="env lanes per worker")
    parser.add_argument("--rollout-length", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=8, help="lanes per learn batch")
    parser.add_argument("--publish-every", type=int, default=1)
    parser.add_argument("--learning-rate", type=float, default=2e-3)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--use-pallas", action="store_true",
                        help="V-trace through the CUDA kernel (ops/cuda_vtrace.py)")
    parser.add_argument("--max-seconds", type=float, default=0.0,
                        help="stop this long after the first answer (0: run to "
                             "--total-frames)")
    parser.add_argument(
        "--autoscale", action="store_true",
        help="run the autoscaler over the fleet (runtime/autoscaler.py): it backfills "
             "lost gathers to --num-workers and scales on the fps/queue/shed signals")
    parser.add_argument("--autoscale-max-workers", type=int, default=0,
                        help="scale-up ceiling (0 = 2x --num-workers)")
    a = parser.parse_args(argv)
    out = train_fleet_impala(
        total_frames=a.total_frames, num_workers=a.num_workers, num_lanes=a.num_lanes,
        rollout_length=a.rollout_length, batch_size=a.batch_size,
        publish_every=a.publish_every, learning_rate=a.learning_rate,
        use_pallas=a.use_pallas, device=a.device, autoscale=a.autoscale,
        autoscale_max_workers=a.autoscale_max_workers, max_seconds=a.max_seconds)
    print(f"done: {out['env_frames']} frames, {out['learn_steps']} learn steps in "
          f"{out['wall_s']:.1f}s | return(50) first {out['return_first50']:.1f} -> last "
          f"{out['return_last50']:.1f} | tasks {out['issued']} issued, {out['answered']} "
          f"answered, {out['requeued_tasks']} requeued", flush=True)
    return out


if __name__ == "__main__":
    main()
