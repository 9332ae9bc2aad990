"""The ranks of the gloo world behind tests/test_torch_sharded_learner.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group, runs every case of ``cases.pt`` (written by the test
module: the port's starting states, the global batches and each case's
mesh) through the port's meshed learn steps, and rank 0 writes what the
ranks computed, gathered to full tensors, to ``results.pt``.
"""

import os
import traceback

import torch
import torch.distributed as dist

from scalerl_torch.parallel.sharding import gather_tree
from scalerl_torch.runtime.dispatch import get_metrics
from scalerl_torch.utils.tree import tree_leaves, tree_map


def _ranks_agree(tree) -> bool:
    """Every rank holds the same full tree, bit for bit (a replicated leaf
    gathers to the rank's own copy, so ranks that drifted apart differ)."""
    flat = torch.cat([x.reshape(-1).double() for x in tree_leaves(_full(tree))
                      if x.is_floating_point()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(parts[0], p) for p in parts)


def _own_lanes(batch):
    """This rank's lanes of a global batch: the batch a trainer's actors
    would have collected on it."""
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.parallel.sharding import shard_batch

    return shard_batch(batch, make_mesh(f"dp={dist.get_world_size()}"), time_major=True)


def _layout(state, mesh) -> dict:
    """How many leaves some mesh dim splits, and how many the mp dim does."""
    from torch.distributed.tensor import DTensor, Shard

    mp_dim = list(mesh.device_mesh.mesh_dim_names).index("mp")
    placed = [x.placements for x in tree_leaves(state) if isinstance(x, DTensor)]
    return {"sharded": sum(any(isinstance(p, Shard) for p in ps) for ps in placed),
            "mp": sum(isinstance(ps[mp_dim], Shard) for ps in placed)}


def _spec(x):
    from scalerl_torch.parallel.sharding import spec_of

    return spec_of(x) or (None,) * x.ndim


def _full(tree):
    return tree_map(lambda x: x.detach().clone(), gather_tree(tree))


def _instrumented_step(agent, batch):
    """One meshed learn step, the learn function called directly (the acting
    copy gathers outside it), with what the step did counted: DTensor
    leaves gathered, full weights the layers gathered (count and most bytes
    alive at once), each column layer's local output (its width, the full
    width, the extent), the heads each attention call saw, and the
    expert-parallel calls."""
    from scalerl_torch.models import transformer
    from scalerl_torch.parallel import expert, shard_compute, sharding

    seen = {"columns": [], "heads": [], "experts": 0}
    real_gather, real_experts = shard_compute.GatherShards, expert.expert_parallel_outputs
    real_full, real_masked = transformer.full_attention, transformer._masked_attention

    class RecordingGather:
        @staticmethod
        def apply(x, dim, group, size, index, reduce):
            out = real_gather.apply(x, dim, group, size, index, reduce)
            seen["columns"].append((x.shape[dim], out.shape[dim], size))
            return out

    def full(q, k, v, **kw):
        seen["heads"].append(q.shape[2])
        return real_full(q, k, v, **kw)

    def masked(q, k, v, *args):
        seen["heads"].append(q.shape[2])
        return real_masked(q, k, v, *args)

    def experts(*args, **kw):
        seen["experts"] += 1
        return real_experts(*args, **kw)

    shard_compute.GatherShards, expert.expert_parallel_outputs = RecordingGather, experts
    transformer.full_attention, transformer._masked_attention = full, masked
    before = sharding.GATHER_STATS["dtensor_gathers"]
    shard_compute.reset_gather_stats()
    try:
        out = agent._learn(agent.state, *(agent._shard_batch(b) for b in batch))
    finally:
        shard_compute.GatherShards, expert.expert_parallel_outputs = real_gather, real_experts
        transformer.full_attention, transformer._masked_attention = real_full, real_masked
    seen.update(dtensor_gathers=sharding.GATHER_STATS["dtensor_gathers"] - before,
                weight_gathers=shard_compute.GATHER_STATS["gathers"],
                peak_gathered_bytes=shard_compute.GATHER_STATS["peak_live_bytes"])
    agent.state = out[0]
    return out[1], seen


def _impala(case):
    from scalerl_torch.agents.impala import ImpalaAgent

    agent = ImpalaAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    layout = _layout(agent.state, agent.mesh)
    placed = _placement_checks(agent, case["state"])
    metrics, seen = _instrumented_step(agent, (case["batch"],))
    full = _full(agent.state)
    sizes = sorted(x.numel() * x.element_size() for x in full.params.values())
    return {"state": full, "metrics": get_metrics(metrics), "layout": layout, "seen": seen,
            "two_largest_bytes": sum(sizes[-2:]), **placed}


def _placement_checks(agent, state):
    """The placed state gathers back to the converted one bit for bit, and
    each qkv leaf over mp holds this rank's heads' q, k and v rows."""
    from scalerl_torch.parallel.sharding import to_local

    roundtrip = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(agent._learn.gather_state(agent.state)), tree_leaves(state)))
    mesh, aligned = agent.mesh, []
    for name, x in agent.state.params.items():
        if name.endswith("qkv.weight") and _spec(x)[0] == "mp":
            size, r = mesh.shape["mp"], mesh.coordinate("mp")
            n = x.shape[0] // 3 // size
            rows = [state.params[name][g * n * size + r * n:g * n * size + (r + 1) * n]
                    for g in range(3)]
            aligned.append(torch.equal(to_local(x), torch.cat(rows)))
    return {"roundtrip": roundtrip, "head_aligned": aligned}


def _nan_shard(case):
    """A NaN in one rank's shard of a sharded optimizer moment: the step
    must be skipped on every rank, which keep their params."""
    from scalerl_torch.agents.impala import ImpalaAgent

    agent = ImpalaAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    name = case["leaf"]
    nu = agent.state.opt_state["nu"][name]
    if dist.get_rank() == case["nan_rank"]:
        nu.to_local().view(-1)[0] = float("nan")
    before = _full(agent.state.params)
    metrics = agent.learn(case["batch"])
    after = _full(agent.state.params)
    skipped = torch.tensor([metrics["skipped_steps"]])
    every = [torch.empty_like(skipped) for _ in range(dist.get_world_size())]
    dist.all_gather(every, skipped)
    kept = all(torch.equal(before[k], after[k]) for k in before)
    return {"skipped": [float(s) for s in every], "kept": kept,
            "sharded": len(nu.to_local().shape) == 2 and nu.to_local().shape != nu.shape}


def _local(case):
    """A trainer's meshed step: each rank brings only its own lanes, and the
    step must be the one-process step on the lanes of every rank."""
    import dataclasses

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.parallel.train_step import maybe_enable_mesh_from_args

    cls = PPOAgent if case["agent"] == "ppo" else ImpalaAgent
    # a seed of each rank's own: the draws of the step must still agree
    args = dataclasses.replace(case["args"], mesh_shape=case["spec"],
                               seed=case["args"].seed + dist.get_rank())
    agent = cls(args, case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    maybe_enable_mesh_from_args(agent, args)
    metrics = agent.learn(_own_lanes(case["batch"]))
    return {"state": _full(agent.state), "metrics": metrics,
            "agree": _ranks_agree(agent.state)}


def _host_trainer(case, workdir):
    """The threaded actor-learner trainer under a mesh of every rank: each
    rank's actors act on the published copy, its learner feeds the rank's
    own batches, and the ranks stop on the same step."""
    import dataclasses

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.gym_env import make_vect_envs
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    rank = dist.get_rank()
    args = dataclasses.replace(case["args"], work_dir=workdir, seed=rank)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    env_fns = [(lambda i=i: make_vect_envs("CartPole-v1", num_envs=2, seed=10 * rank + i,
                                           async_envs=False))
               for i in range(2)]
    trainer = HostActorLearnerTrainer(args, agent, env_fns, run_name="mesh")
    result = trainer.train(total_frames=case["total_frames"])
    trainer.close()
    steps = torch.tensor([trainer.learn_steps, trainer.env_frames])
    all_steps = [torch.empty_like(steps) for _ in range(dist.get_world_size())]
    dist.all_gather(all_steps, steps)
    published = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(agent.acting_params()), tree_leaves(gather_tree(agent.state.params))))
    return {"agree": _ranks_agree(agent.state), "shape": dict(agent.mesh.shape),
            "learn_steps": [int(s[0]) for s in all_steps],
            "frames": [int(s[1]) for s in all_steps], "loss": result["total_loss"],
            "published": published, "local": agent._learn.batch_mode == "local",
            "layout": _layout(agent.state, agent.mesh)}


def _constraint(case):
    """activation_constraint redistributes a DTensor activation to rows
    over dp, replicated over mp, and keeps its values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from scalerl_torch.parallel.logical import activation_constraint
    from scalerl_torch.parallel.mesh import AXIS_NAMES, make_mesh

    mesh = make_mesh(case["spec"])
    x = case["x"]
    cols = [Replicate() for _ in AXIS_NAMES]
    cols[AXIS_NAMES.index("mp")] = Shard(1)  # a column-parallel layer's output
    dx = distribute_tensor(x, mesh.device_mesh, cols)
    out = activation_constraint(mesh)(dx)
    plain = activation_constraint(mesh)(x)
    return {"placements": [repr(p) for p in out.placements], "names": list(AXIS_NAMES),
            "local_shape": tuple(out.to_local().shape), "dtensor": isinstance(out, DTensor),
            "equal": torch.equal(out.full_tensor(), x), "plain_passes": plain is x}


def _dqn(case):
    from scalerl_torch.agents.dqn import DQNAgent

    agent = DQNAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    layout = _layout(agent.state, agent.mesh)
    metrics, td = agent.learn_device(case["batch"])
    return {"state": _full(agent.state), "metrics": get_metrics(metrics), "aux": td,
            "layout": layout}


def _continuous(case):
    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.agents.td3 import TD3Agent

    cls = SACAgent if case["kind"] == "sac" else TD3Agent
    agent = cls(case["args"], case["obs_shape"], case["low"], case["high"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    layout = _layout(agent.state, agent.mesh)
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    agent.state, metrics, td = agent._learn(agent.state, agent._shard_batch(batch),
                                            agent._shard_batch(case["noise"]))
    return {"state": _full(agent.state), "metrics": get_metrics(metrics), "aux": td,
            "layout": layout}


def _r2d2(case):
    from scalerl_torch.agents.r2d2 import R2D2Agent

    agent = R2D2Agent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    layout = _layout(agent.state, agent.mesh)
    metrics, prio = agent.learn_sequences(*case["batch"])
    return {"state": _full(agent.state), "metrics": get_metrics(metrics), "aux": prio,
            "layout": layout}


def _token_ppo(case):
    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    agent = TokenPPOAgent(case["args"], build_genrl_model(case["args"], device="cpu"))
    agent.state = case["state"]
    agent.enable_mesh(case["spec"])
    layout = _layout(agent.state, agent.mesh)
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    metrics, seen = _instrumented_step(agent, (batch,))
    return {"state": _full(agent.state), "metrics": get_metrics(metrics), "layout": layout,
            "constrained": agent.model.constrain is not None, "seen": seen,
            "vocab_sharded": _spec(agent.state.params["policy_head.weight"])[0] == "mp"}


def _refusal(case):
    from scalerl_torch.agents.impala import ImpalaAgent

    agent = ImpalaAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    try:
        agent.enable_mesh(case["spec"])
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def _checkpoint(case, workdir):
    """learn, save, learn against a fresh agent's load and one learn: the
    two second steps must be bit-equal, and the restored state sharded."""
    import dataclasses

    from scalerl_torch.agents.impala import ImpalaAgent

    first, second = case["batch"]
    agent = ImpalaAgent(case["args"], case["obs_shape"], case["num_actions"], device="cpu")
    agent.enable_mesh(case["spec"])
    agent.learn(first)
    path = os.path.join(workdir, "ckpt")
    agent.save_checkpoint(path)
    agent.learn(second)
    unbroken = _full(agent.state)
    other = ImpalaAgent(dataclasses.replace(case["args"], seed=case["args"].seed + 7),
                        case["obs_shape"], case["num_actions"], device="cpu")
    other.enable_mesh(case["spec"])
    other.load_checkpoint(path)
    layout = _layout(other.state, other.mesh)
    restored_step = int(gather_tree(other.state).step)
    other.learn(second)
    resumed = _full(other.state)
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(unbroken), tree_leaves(resumed)))
    return {"equal": equal, "layout": layout, "restored_step": restored_step,
            "steps": int(resumed.step)}


def _trainer(case, workdir):
    """The on-policy trainer resolves dp_size x mp_size from the args."""
    import dataclasses

    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.trainer.on_policy import OnPolicyTrainer

    args = dataclasses.replace(case["args"], work_dir=workdir)
    agent = PPOAgent(args, (4,), 2, device="cpu")
    trainer = OnPolicyTrainer(args, agent, TensorVectorView(TensorCartPole(4, device="cpu")))
    out = {"shape": dict(agent.mesh.shape), "layout": _layout(agent.state, agent.mesh)}
    # then a short run: every rank takes the same steps and ends on one state
    trainer.run()
    trainer.close()
    out.update(agree=_ranks_agree(agent.state), learn_steps=trainer.learn_steps,
               global_step=trainer.global_step)
    return out


RUNNERS = {"impala": _impala, "nan_shard": _nan_shard, "dqn": _dqn, "sac": _continuous, "td3": _continuous,
           "r2d2": _r2d2, "token_ppo": _token_ppo, "refusal": _refusal, "local": _local,
           "constraint": _constraint}


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    results = {}
    for name, case in cases.items():
        try:
            if case["kind"] == "checkpoint":
                results[name] = _checkpoint(case, workdir)
            elif case["kind"] == "trainer":
                results[name] = _trainer(case, os.path.join(workdir, "run"))
            elif case["kind"] == "host_trainer":
                results[name] = _host_trainer(case, os.path.join(workdir, "host"))
            else:
                results[name] = RUNNERS[case["kind"]](case)
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()
