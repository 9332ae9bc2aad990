"""The ranks of the gloo world behind tests/test_torch_mesh_loops.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group and runs every case of ``cases.pt`` (written by the test
module): the learn functions on the rank's own rows inside a batch
reduction over ``dp``, the fused device loop and the mesh-fused device R2D2 over ``dp``,
and the meshed Ape-X, host R2D2 and serving-mode IMPALA trainers, each a
few steps and a resume.  Rank 0 writes every rank's results to
``results.pt``.
"""

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from scalerl_torch.parallel.mesh import make_mesh
from scalerl_torch.parallel.sharding import batch_reduction, gather_tree, shard_batch
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.tree import tree_leaves, tree_map


def _full(tree):
    return tree_map(lambda x: x.detach().clone(), gather_tree(tree))


def _ranks_agree(tree) -> bool:
    """Every rank holds the same full tree, bit for bit."""
    flat = torch.cat([x.reshape(-1).double() for x in tree_leaves(_full(tree))
                      if x.is_floating_point()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(parts[0], p) for p in parts)


def _everyone(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


# -- the learn functions over the gradient axis -------------------------------


def _axis_learn(case):
    """The rank's rows through the agent's learn function inside a batch
    reduction over ``dp``, as the data-parallel loops run it."""
    from scalerl_torch.agents.impact import ImpactAgent
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.agents.r2d2 import R2D2Agent, make_r2d2_learn_fn

    mesh = make_mesh(case["spec"])
    algo = case["algo"]
    if algo == "r2d2":
        agent = R2D2Agent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
        learn = make_r2d2_learn_fn(agent.model, agent.optimizer, case["args"])
        batch = shard_batch(case["batch"], mesh, batch_dim=0)
        with batch_reduction(mesh, ("dp",)):
            state, metrics, prio = learn(case["state"], *batch)
        aux = [p.numpy() for p in _everyone(prio)]
        out = {"aux": np.concatenate(aux)}
    else:
        cls = ImpalaAgent if algo == "impala" else ImpactAgent
        agent = cls(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
        learn = agent.make_learn_fn()
        with batch_reduction(mesh, ("dp",)):
            state, metrics = learn(case["state"], shard_batch(case["batch"], mesh,
                                                               time_major=True))
        out = {}
    out.update(state=_full(state), metrics=get_metrics(metrics), agree=_ranks_agree(state))
    return out


# -- the fused device loop ----------------------------------------------------


def _impala_loop(case, mesh):
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    agent = ImpalaAgent(case["args"], (4,), 2, device="cpu")
    learn = agent.make_learn_fn()
    loop = DeviceActorLearnerLoop(agent.model, TensorCartPole(case["num_envs"], device="cpu"),
                                  learn, case["T"], iters_per_call=1, seed=case["seed"],
                                  device="cpu", mesh=mesh)
    return agent, loop


def _device_loop(case):
    mesh = make_mesh(case["spec"])
    agent, loop = _impala_loop(case, mesh)
    carry = loop.init_carry()
    state = agent.state
    chunks = []
    for _ in range(case["chunks"]):
        state, carry, m = loop.train_chunk(state, carry)
        chunks.append(get_metrics(m))
    local = [float(carry.episode_count.sum()), float(carry.return_sum.sum())]
    out = {"step": int(state.step), "env_frames": int(state.env_frames), "metrics": chunks,
           "local_sums": _everyone(local), "lanes": loop.local_venv.num_envs,
           "agree": _ranks_agree(state.params), "first_obs": carry.obs[0].tolist()}
    # the same loop from the same state through run(): one state on every rank
    _, loop2 = _impala_loop(case, mesh)
    state2, _, _ = loop2.run(agent.state, loop2.init_carry(), case["chunks"],
                             instrument=False)
    out["run_agree"] = _ranks_agree(state2.params)
    out["run_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(state2.params),
                                                             tree_leaves(state.params)))
    try:
        loop.run_anakin(state, carry, 2, instrument=False)
        out["anakin_error"] = None
    except NotImplementedError as e:
        out["anakin_error"] = str(e)
    return out


# -- the mesh-fused device R2D2 -----------------------------------------------


def _r2d2_device(case, workdir):
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.envs.tensor_envs import TensorRecall
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

    rank = dist.get_rank()
    # a seed of each rank's own: the trainer starts every rank from rank 0's state
    args = dataclasses.replace(case["args"], work_dir=workdir, seed=case["args"].seed + rank)
    env = TensorRecall(case["num_envs"], size=8, delay=2, num_cues=2, device="cpu")
    agent = R2D2Agent(args, env.observation_shape, env.num_actions, device="cpu")
    trainer = DeviceR2D2Trainer(args, agent, env, mesh=make_mesh(case["spec"]),
                                run_name="r2d2_device")
    result = trainer.train(total_frames=case["total_frames"])
    trainer.close()
    return {"learn_steps": result["learn_steps"], "env_frames": result["env_frames"],
            "loss": result["total_loss"], "episodes": result["episodes"],
            "agree": _ranks_agree(agent.state),
            "ring_live": int((trainer.replay.priorities > 0).sum()),
            "ring_size": trainer.replay.size,
            "local_capacity": trainer.replay.priorities.shape[0]}


# -- meshed Ape-X -------------------------------------------------------------


def _apex(case, workdir):
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.apex import ApexTrainer

    rank = dist.get_rank()

    def make_envs(actor_id):
        return TensorVectorView(TensorCartPole(case["args"].num_envs, device="cpu"))

    args = dataclasses.replace(case["args"], work_dir=workdir, seed=case["args"].seed + rank)
    agent = DQNAgent(args, (4,), 2, device="cpu")
    agent.enable_mesh(case["spec"])
    trainer = ApexTrainer(args, agent, make_envs, run_name="apex_mesh")
    out = {"sharded": isinstance(trainer.buffer, ShardedPrioritizedReplay),
           "n_shards": trainer.buffer.n_shards, "lanes": trainer.buffer.local_envs}
    trainer.run()
    counts = _everyone([trainer.learn_steps, trainer.global_step, len(trainer.buffer)])
    out.update(learn_steps=[c[0] for c in counts], steps=[c[1] for c in counts],
               sizes=[c[2] for c in counts], agree=_ranks_agree(agent.state))
    trainer.save_resume()
    dist.barrier()  # rank 0's write lands before any rank reads it
    full = trainer.buffer.full_state()
    params = _full(agent.state.params)
    run_dir = trainer.work_dir
    trainer.close()

    args_b = dataclasses.replace(args, resume=run_dir)
    agent_b = DQNAgent(args_b, (4,), 2, device="cpu")
    agent_b.enable_mesh(case["spec"])
    trainer_b = ApexTrainer(args_b, agent_b, make_envs)
    out["resumed"] = trainer_b.try_resume()
    restored = trainer_b.buffer.full_state()
    out["prio_equal"] = torch.equal(restored.priorities, full.priorities)
    out["storage_equal"] = all(torch.equal(restored.replay.storage[k], v)
                               for k, v in full.replay.storage.items())
    out["size_equal"] = restored.replay.size == full.replay.size
    out["params_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(_full(agent_b.state.params)), tree_leaves(params)))
    out["learn_steps_restored"] = trainer_b.learn_steps
    trainer_b.close()
    return out


# -- meshed host R2D2 ---------------------------------------------------------


def _r2d2_host(case, workdir):
    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.data.sharded_replay import ShardedSequenceReplay
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.r2d2 import R2D2Trainer

    rank = dist.get_rank()
    args = dataclasses.replace(case["args"], work_dir=workdir, seed=case["args"].seed + rank)
    fns = [(lambda i=i: make_host_envs("RecallGym-v0", 4, 10 * rank + i, size=8, delay=2,
                                       num_cues=2)) for i in range(2)]
    agent = R2D2Agent(args, (8, 8, 1), 2, device="cpu")
    agent.enable_mesh(case["spec"])
    trainer = R2D2Trainer(args, agent, fns, run_name="r2d2_mesh")
    out = {"sharded": isinstance(trainer.sharded_replay, ShardedSequenceReplay),
           "n_shards": trainer.sharded_replay.n_shards}
    result = trainer.train(total_frames=case["total_frames"])  # ends with a resume save
    dist.barrier()  # rank 0's write lands before any rank reads it
    steps = _everyone([trainer.learn_steps, trainer.env_frames])
    out.update(learn_steps=[s[0] for s in steps], frames=[s[1] for s in steps],
               loss=result["total_loss"], agree=_ranks_agree(agent.state),
               block=trainer.sharded_replay.state.priorities.clone())
    full = trainer.sharded_replay.full_state()
    max_prio = trainer.max_priority
    params = _full(agent.state.params)
    run_dir = trainer.work_dir
    trainer.close()

    args_b = dataclasses.replace(args, resume=run_dir)
    agent_b = R2D2Agent(args_b, (8, 8, 1), 2, device="cpu")
    agent_b.enable_mesh(case["spec"])
    trainer_b = R2D2Trainer(args_b, agent_b, fns)
    out["resumed"] = trainer_b.try_resume()
    restored = trainer_b.sharded_replay.full_state()
    out["ring_equal"] = (torch.equal(restored.priorities, full.priorities)
                         and all(torch.equal(restored.storage[k], v)
                                 for k, v in full.storage.items())
                         and (restored.pos, restored.size) == (full.pos, full.size))
    out["max_prio_equal"] = trainer_b.max_priority == max_prio
    out["params_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(_full(agent_b.state.params)), tree_leaves(params)))
    trainer_b.close()
    return out


# -- serving-mode IMPALA ------------------------------------------------------


def _serving(case, workdir):
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    rank = dist.get_rank()
    args = dataclasses.replace(case["args"], work_dir=workdir, seed=rank)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    fns = [(lambda: TensorVectorView(TensorCartPole(2, device="cpu"))) for _ in range(2)]
    trainer = HostActorLearnerTrainer(args, agent, fns, run_name="serving_mesh")
    server = trainer.inference_server
    result = trainer.train(total_frames=case["total_frames"])
    trainer.close()
    steps = _everyone([trainer.learn_steps, trainer.env_frames])
    return {"learn_steps": [s[0] for s in steps], "frames": [s[1] for s in steps],
            "loss": result["total_loss"], "agree": _ranks_agree(agent.state),
            "flushes": server.flushes, "generation": server.generation,
            "fallen_back": any(c.fallen_back for c in trainer._serving_clients),
            "shape": dict(agent.mesh.shape)}


RUNNERS = {"axis_learn": _axis_learn, "device_loop": _device_loop}
TRAINERS = {"r2d2_device": _r2d2_device, "apex": _apex, "r2d2_host": _r2d2_host,
            "serving": _serving}


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    mine = {}
    for name, case in cases.items():
        try:
            if case["kind"] in TRAINERS:
                mine[name] = TRAINERS[case["kind"]](case, os.path.join(workdir, name))
            else:
                mine[name] = RUNNERS[case["kind"]](case)
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            mine[name] = {"error": traceback.format_exc()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank == 0:
        torch.save({name: [r[name] for r in every] for name in cases},
                   os.path.join(workdir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()
