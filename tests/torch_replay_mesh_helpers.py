"""The ranks of the gloo world behind tests/test_torch_sharded_replay.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group, runs every case of ``cases.pt`` (written by the test
module: the inserts, write-backs and each shard's uniforms, all as numpy)
through the port's sharded buffers, and rank 0 writes every rank's results
to ``results.pt``.
"""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay, ShardedSequenceReplay
from scalerl_torch.parallel.mesh import make_mesh
from scalerl_torch.utils.tree import tree_map


def _numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)


def _per_state(state):
    return {"storage": _numpy(state.replay.storage), "priorities": _numpy(state.priorities),
            "max_priority": float(state.max_priority), "pos": state.replay.pos,
            "size": state.replay.size}


def _seq_state(state):
    return {"storage": _numpy(state.storage), "core": _numpy(state.core),
            "priorities": _numpy(state.priorities), "pos": state.pos, "size": state.size}


def _transition_buffer(case, mesh):
    return ShardedPrioritizedReplay((3,), case["capacity"], mesh, num_envs=case["num_envs"],
                                    alpha=case["alpha"], update_method=case["update_method"],
                                    device="cpu")


def _transitions(case):
    """The JAX methods' global inserts and write-back, a second buffer fed
    the same through the trainers' shard forms, and the samples."""
    mesh = make_mesh(case["spec"])
    buf = _transition_buffer(case, mesh)
    shard_form = _transition_buffer(case, mesh)
    for step, prio in case["steps"]:
        if prio is None:
            buf.save_to_memory(**step)
            shard_form.save_to_memory(**step)
        else:
            buf.add_with_priorities(dict(step), prio)
            lanes = shard_form.lanes
            shard_form.add_shard_with_priorities({k: v[lanes] for k, v in step.items()},
                                                 prio[lanes])
    idx, newp = case["update"]
    owned = (idx % buf.num_envs) // buf.local_envs == buf.shard
    buf.update_priorities(idx, newp)
    shard_form.update_shard_priorities(torch.as_tensor(idx[owned]),
                                       torch.as_tensor(newp[owned]))
    out = {"full": _per_state(buf.full_state()), "shard_form": _per_state(shard_form.full_state()),
           "shard": buf.shard, "block": _numpy(buf.state.priorities), "samples": []}
    for batch_size, beta, u in case["samples"]:
        out["samples"].append(_numpy(buf.sample(batch_size, beta, u=torch.as_tensor(u[buf.shard]))))
    out["seeded"] = _numpy(buf.sample(case["samples"][0][0], 0.4))
    return out


def _sequence_buffer(case, mesh):
    return ShardedSequenceReplay(case["fields"], case["cores"], case["capacity"], mesh,
                                 alpha=case["alpha"], beta=case["beta"], device="cpu")


def _sequences(case):
    mesh = make_mesh(case["spec"])
    buf = _sequence_buffer(case, mesh)
    for batch, core, prio in case["inserts"]:
        buf.add(batch, core, torch.as_tensor(prio))
    out = {"shard": buf.shard, "samples": []}
    for batch_size, u in case["samples"]:
        f, c, idx, w = buf.sample(batch_size, u=torch.as_tensor(u[buf.shard]))
        out["samples"].append(_numpy((f, c, idx, w)))
    if case.get("update") is not None:
        buf.update_priorities(*case["update"])
    out["full"] = _seq_state(buf.full_state())
    return out


def _checkpoint(case, workdir):
    """Both sharded buffers saved gathered and restored into fresh ones."""
    from scalerl_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    mesh = make_mesh(case["spec"])
    per, seq = _transition_buffer(case["per"], mesh), _sequence_buffer(case["seq"], mesh)
    for step, prio in case["per"]["steps"]:
        if prio is None:
            per.save_to_memory(**step)
        else:
            per.add_with_priorities(dict(step), prio)
    for batch, core, prio in case["seq"]["inserts"]:
        seq.add(batch, core, torch.as_tensor(prio))
    out = {}
    for name, buf, fresh in (("per", per, _transition_buffer(case["per"], mesh)),
                             ("seq", seq, _sequence_buffer(case["seq"], mesh))):
        path = os.path.join(workdir, f"ckpt_{name}")
        full = buf.full_state()
        if dist.get_rank() == 0:
            save_checkpoint(path, full)
        dist.barrier()
        fresh.load_full_state(load_checkpoint(path, fresh.full_state()))
        leaves = [(a, b) for a, b in zip(_leaves(buf.state), _leaves(fresh.state))]
        out[name] = {"equal": all(np.array_equal(a, b) for a, b in leaves),
                     "leaves": len(leaves),
                     "cursors": (_cursor(fresh.state), _cursor(buf.state))}
    return out


def _leaves(state):
    from scalerl_torch.utils.checkpoint import flatten_tree

    return [np.asarray(v.cpu()) if isinstance(v, torch.Tensor) else np.asarray(v)
            for _, v in flatten_tree(state)]


def _cursor(state):
    replay = getattr(state, "replay", state)
    return replay.pos, replay.size


RUNNERS = {"transitions": _transitions, "sequences": _sequences}


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    mine = {}
    for name, case in cases.items():
        try:
            if case["kind"] == "checkpoint":
                mine[name] = _checkpoint(case, workdir)
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
