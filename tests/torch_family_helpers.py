"""The ranks of the gloo world behind tests/test_torch_mesh_families.py.

Jax-free, so a spawned rank boots without importing JAX.  Each rank joins
one process group and runs every case of ``cases.pt`` (ring attention over
``sp``, the sequence-parallel transformer, the GPipe pipelines over ``pp``,
expert parallelism over ``ep`` and the MoE IMPALA step over ``dp x mp``);
rank 0 writes what the ranks computed, gathered, to ``results.pt``.  The
stage functions below are functional twins of the Flax modules of
``tests/test_pipeline.py`` over the Flax param layout.
"""

import math
import os
import traceback

import torch
import torch.distributed as dist
import torch.nn.functional as F

from scalerl_torch.parallel.mesh import make_mesh


def _gather(x: torch.Tensor) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return parts


def _same_everywhere(x: torch.Tensor) -> bool:
    return all(torch.equal(p, x) for p in _gather(x))


# -- ring attention ---------------------------------------------------------


def _ring(case):
    from scalerl_torch.ops.ring_attention import make_ring_attention_fn

    mesh = make_mesh("sp=4")
    r, n = mesh.coordinate("sp"), 4
    T_local = case["q"].shape[1] // n
    blocks = [x[:, r * T_local:(r + 1) * T_local].to(case["dtype"]).clone().requires_grad_(True)
              for x in (case["q"], case["k"], case["v"])]
    out = make_ring_attention_fn(mesh, causal=case["causal"])(*blocks)
    grads = torch.autograd.grad((out.float() ** 2).sum(), blocks)
    return {"dtype": str(out.dtype), "out": torch.cat(_gather(out.detach().float()), dim=1),
            **{name: torch.cat(_gather(g.float()), dim=1)
               for name, g in zip(("dq", "dk", "dv"), grads)}}


# -- the sequence-parallel transformer --------------------------------------


def _sequence(case):
    from scalerl_torch.models.transformer import TransformerPolicy
    from scalerl_torch.parallel.sequence import make_sequence_parallel_apply

    mesh = make_mesh("sp=4")
    model = TransformerPolicy(device="cpu", **case["model"])
    model.load_state_dict(case["state"])
    apply = make_sequence_parallel_apply(model, mesh)
    params = dict(model.named_parameters())
    out = apply(params, case["obs"])
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad((out.baseline ** 2).mean(),
                                                [params[k] for k in names])))
    errors = {}
    for name, obs in case["bad_obs"].items():
        try:
            apply(params, obs)
        except ValueError as e:
            errors[name] = str(e)
    return {"policy_logits": out.policy_logits.detach(), "baseline": out.baseline.detach(),
            "grads": grads, "errors": errors,
            "replicated": all(_same_everywhere(g) for g in grads.values())
            and _same_everywhere(out.baseline.detach())}


# -- the pipelines ------------------------------------------------------------


def _layer_norm(p, x):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-6)


def _dense(p, x):
    return x @ p["kernel"] + p["bias"]


def stage_fn(p, x):
    """tests/test_pipeline.py ``_Stage``: ``x + tanh(Dense(x))``."""
    return x + torch.tanh(_dense(p["params"]["Dense_0"], x))


def embed_fn(p, x):
    """``_Embed``: ``Dense(x) + pos``."""
    return _dense(p["params"]["Dense_0"], x) + p["params"]["pos"]


def block_fn(p, x):
    """``_Block``: pre-LN causal ``nn.SelfAttention`` (2 heads) + MLP, with
    Flax's attention: ``q / sqrt(hd)``, masked scores at the dtype's
    minimum, tanh-form GELU."""
    p = p["params"]
    a = p["SelfAttention_0"]
    T = x.shape[-2]
    h = _layer_norm(p["LayerNorm_0"], x)
    q, k, v = (torch.einsum("btd,dhk->bthk", h, a[n]["kernel"]) + a[n]["bias"]
               for n in ("query", "key", "value"))
    q = q / math.sqrt(q.shape[-1])
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    w = torch.softmax(w.masked_fill(~mask, torch.finfo(w.dtype).min), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    x = x + torch.einsum("bqhd,hdm->bqm", o, a["out"]["kernel"]) + a["out"]["bias"]
    h = _layer_norm(p["LayerNorm_1"], x)
    # Flax names the outer Dense(D) first: Dense_0 is the MLP's output layer
    return x + _dense(p["Dense_0"], F.gelu(_dense(p["Dense_1"], h), approximate="tanh"))


def head_fn(p, x):
    """``_Head``: ``Dense(5)(LayerNorm(x))``."""
    return _dense(p["params"]["Dense_0"], _layer_norm(p["params"]["LayerNorm_0"], x))


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    return [leaf for k in tree for leaf in _leaves(tree[k], path + (k,))]


def _with_grad(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone().requires_grad_(True)
    return {k: _with_grad(v) for k, v in tree.items()}


def _pipeline(case):
    from scalerl_torch.parallel import pipeline

    mesh = make_mesh("pp=4")
    stage = mesh.coordinate("pp")
    M = case["M"]
    params = _with_grad(case["params"])
    if case["hetero"]:
        apply = pipeline.make_hetero_pipeline_apply(embed_fn, block_fn, head_fn, mesh, M,
                                                    _loop_steps=case.get("loop_steps"))
    else:
        apply = pipeline.make_pipeline_apply(stage_fn, mesh, M)
    out = apply(params, case["x"])
    result = {"out": out.detach(), "replicated": _same_everywhere(out.detach())}
    if case.get("grads"):
        leaves = [(path, leaf) for path, leaf in _leaves(params)]
        grads = torch.autograd.grad((out ** 2).mean(), [leaf for _, leaf in leaves],
                                    allow_unused=True)
        # each rank holds its own stage's: the block slice, embed on 0, head on the last
        own = {}
        for (path, _), g in zip(leaves, grads):
            if case["hetero"] and path[0] == "embed" and stage != 0:
                continue
            if case["hetero"] and path[0] == "head" and stage != 3:
                continue
            if g is None:
                continue
            own[path] = g[stage] if (path[0] == "block" or not case["hetero"]) else g
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, own)
        result["grads"] = gathered
    errors = {}
    for name, (bad_params, x) in case.get("bad", {}).items():
        try:
            apply(bad_params, x)
        except ValueError as e:
            errors[name] = str(e)
    result["errors"] = errors
    return result


# -- expert parallelism -------------------------------------------------------


def _expert(case):
    from scalerl_torch.models.moe import MoEMLP
    from scalerl_torch.parallel.expert import expert_param_sharding, make_expert_parallel_apply

    mesh = make_mesh("ep=4")
    model = MoEMLP(device="cpu", **case["model"])
    model.load_state_dict(case["state"])
    apply_fn, sharded = make_expert_parallel_apply(model, mesh, device="cpu")
    x = case["x"].clone().requires_grad_(True)
    out = apply_fn(sharded, x)
    names = list(sharded)
    grads = torch.autograd.grad((out.out ** 2).sum() + 0.01 * out.aux_loss,
                                [x] + [sharded[k] for k in names])
    gx, grads = grads[0], dict(zip(names, grads[1:]))
    return {"out": out.out.detach(), "aux": float(out.aux_loss.detach()),
            "dispatch_frac": float(out.dispatch_frac),
            "local_experts": sharded["w_in"].shape[0],
            "specs": {k: tuple(v) for k, v in expert_param_sharding(
                dict(model.named_parameters()), mesh).items()},
            "w_in": torch.cat(_gather(grads["w_in"])), "w_out": torch.cat(_gather(grads["w_out"])),
            "router": grads["router.weight"], "x": gx,
            "replicated": _same_everywhere(out.out.detach()) and _same_everywhere(gx)
            and _same_everywhere(grads["router.weight"])}


def _moe_impala(case):
    from torch_mesh_helpers import _impala

    return _impala(case)


RUNNERS = {"ring": _ring, "sequence": _sequence, "pipeline": _pipeline, "expert": _expert,
           "moe_impala": _moe_impala}


def run_rank(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    results = {}
    for name, case in cases.items():
        try:
            results[name] = RUNNERS[case["kind"]](case)
        except Exception:  # noqa: BLE001 - carried to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
            # the other ranks may wait on this one inside the case: leave, so
            # that they fail on the closed connection instead of hanging
            break
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    if all("error" not in r for r in results.values()):
        dist.barrier()
        dist.destroy_process_group()
