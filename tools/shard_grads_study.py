#!/usr/bin/env python3
"""IMPALA's gradients computed on tp shards against one rank's, leaf by
leaf, on one GPU.

    python3 tools/shard_grads_study.py

Builds the kernels, then takes ``chip_smoke.py``'s ``impala_tp2``
configuration (feed-forward ``AtariNet`` 512, B = 512, T = 20, random
frames, the V-trace kernel) from its seed and computes the loss and every
parameter's gradient three ways under each of three cuDNN settings
(cuDNN's default algorithms, ``cudnn.deterministic``, cuDNN off):

- on one rank, twice (the run-to-run floor);
- at ``tp = 2`` on two gloo ranks that share ``cuda:0``, the learn step's
  layers on their shards (column- and row-parallel convs and dense
  layers), each sharded gradient gathered to its whole;
- and, on one rank, cuDNN's default against cuDNN off.

Each line is a leaf's largest difference over its largest element.  The
question it answers: whether the sharded step's distance from the one-rank
step is more than the one-rank step's own distance between two sets of
convolution kernels.  About a minute and a half on an H100.
"""

import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

MODES = ("default", "deterministic", "no_cudnn")


def set_mode(mode: str) -> None:
    torch.backends.cudnn.enabled = mode != "no_cudnn"
    torch.backends.cudnn.deterministic = mode == "deterministic"


def loss_and_grads(agent, sharded: bool = False):
    from scalerl_torch.agents.impala import impala_loss
    from scalerl_torch.parallel.sharding import shard_context, to_local

    params = {k: to_local(v).detach().requires_grad_(True) for k, v in agent.state.params.items()}
    with shard_context(agent._learn.shard_ctx if sharded else None):
        loss, _ = impala_loss(params, agent.model, agent._sc_batch[0], 0.99, 0.5, 0.01,
                              vtrace_impl="kernel")
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def rank_main(rank: int, world: int, port: int, out: str) -> None:
    from scalerl_torch.parallel.collectives import all_gather_dim
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.parallel.sharding import spec_of

    torch.cuda.set_device(0)
    cs.set_tf32(False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    agent, agent._sc_batch = cs._sc_agent("impala_tp2")
    agent.enable_mesh(make_mesh("tp=2", device_type="cuda"))
    res = {}
    for mode in MODES:
        set_mode(mode)
        loss, grads = loss_and_grads(agent, sharded=True)
        whole = {}
        for k, g in grads.items():
            for d, a in enumerate(spec_of(agent.state.params[k])):
                if a == "tp":
                    g = all_gather_dim(g, d, agent.mesh.group("tp"), world)
            whole[k] = g.cpu()
        res[mode] = (loss, whole)
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def main() -> None:
    report = {"launches": {}}
    cs.phase_device(report)
    cs.phase_build(report)
    cs.set_tf32(False)
    one = {}
    agent, agent._sc_batch = cs._sc_agent("impala_tp2")
    for mode in MODES:
        set_mode(mode)
        runs = [loss_and_grads(agent) for _ in range(2)]
        one[mode] = [(loss, {k: g.cpu() for k, g in grads.items()}) for loss, grads in runs]
    set_mode("default")
    del agent
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), "shard_grads_study.pt")
    mp.start_processes(rank_main, args=(2, port, out), nprocs=2, join=True, start_method="spawn")
    tp = torch.load(out)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    print(report["card"])
    for mode in MODES:
        (l1, g1), (l2, g2) = one[mode]
        lt, gt = tp[mode]
        print(f"{mode}: loss one rank {l1} (again {l2}), tp=2 {lt}")
        for k in g1:
            print(f"  {k:18s} repeat {rel(g2[k], g1[k]):.2e}  tp=2 {rel(gt[k], g1[k]):.2e}  "
                  f"one rank, cuDNN off {rel(one['no_cudnn'][0][1][k], g1[k]):.2e}")


if __name__ == "__main__":
    main()
