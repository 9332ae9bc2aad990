"""Expert parallelism: an MoE layer with its experts sharded over ``ep``.
Port of ``scalerl_tpu/parallel/expert.py``.

Rank ``r`` of the ``ep`` axis holds experts ``[r * E/ep, (r + 1) * E/ep)``
of each bank (``w_in``, ``w_out``); a bank shards only when ``ep`` divides
``E``, and otherwise replicates, as in JAX.  The tokens come in replicated,
so every rank computes the same routing (the router replicates).  A rank
runs its own experts on the tokens routed to them, giving its part of the
raw expert outputs ``[N, M]`` (zero rows elsewhere), and one all-reduce
over ``ep`` sums the parts; each token's gate multiplies the sum on every
rank, so the router's gradient is whole on every rank.

Communication a call: the all-reduce of ``[N, M]`` float32 in the forward
and, for the input's gradient, one of ``[N, M]`` in the backward (a ring
all-reduce sends ``2 (ep - 1) / ep`` of it a rank each time).  JAX derives
all-to-alls from the shardings instead; at top-1 routing the all-to-all
moves the same rows, and the all-reduce needs no capacity-sized buffers.

Gradients: the sum's backward passes the replicated cotangent through
unchanged (``parallel/collectives.py``), so a rank's expert banks get
exactly their slice of the single-device gradient; the input's expert-path
gradient is summed over ``ep``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from scalerl_torch.models.moe import MoEMLP, MoEOutput, capacity, expert_outputs, route_top1
from scalerl_torch.parallel.collectives import SumForward, SumGrads
from scalerl_torch.parallel.sharding import Spec
from scalerl_torch.utils.platform import DeviceLike, resolve_device

BANKS = ("w_in", "w_out")


def expert_param_sharding(params: Mapping[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """Spec of each param: the expert-leading banks (``w_in``/``w_out``,
    3-D, dim 0 = experts) over ``ep`` when its extent divides them, every
    other param replicated (``()``)."""
    ep = mesh.shape.get("ep", 1)

    def spec(name: str, p: torch.Tensor) -> Spec:
        if name.split(".")[-1] in BANKS and p.ndim == 3 and p.shape[0] % ep == 0:
            return ("ep", None, None)
        return ()

    return {name: spec(name, p) for name, p in params.items()}


def expert_parallel_outputs(x: torch.Tensor, routing, w_in: torch.Tensor, w_out: torch.Tensor,
                            C: int, group, first_expert: int) -> torch.Tensor:
    """The raw expert outputs ``[N, M]`` of the replicated tokens ``x`` with
    this rank's experts ``[first_expert, first_expert + E_local)`` (the
    banks ``w_in``/``w_out``), summed over ``group``: replicated and
    differentiable, the input's expert-path gradient summed over it too."""
    (x_e,) = SumGrads.apply(group, x)
    y = expert_outputs(x_e, routing, w_in, w_out, C, first_expert=first_expert)
    return SumForward.apply(y, group)


def make_expert_parallel_apply(model: MoEMLP, mesh, params: Optional[Mapping] = None,
                               device: DeviceLike = "cuda"
                               ) -> Tuple[object, Dict[str, torch.Tensor]]:
    """``(apply_fn, sharded_params)``: ``sharded_params`` is this rank's
    share of ``params`` (default: the model's), as new leaf tensors on
    ``device``; ``apply_fn(sharded_params, x)`` maps the replicated tokens
    ``x`` ``[N, d_model]`` to the layer's :class:`MoEOutput`, replicated and
    differentiable."""
    device = resolve_device(device)
    params = dict(model.named_parameters()) if params is None else dict(params)
    specs = expert_param_sharding(params, mesh)
    ep = mesh.shape["ep"]
    rank = mesh.coordinate("ep")
    group = mesh.group("ep")

    def share(name: str, p: torch.Tensor) -> torch.Tensor:
        if specs[name]:
            n = p.shape[0] // ep
            p = p[rank * n:(rank + 1) * n]
        return p.detach().to(device).clone().requires_grad_(p.requires_grad)

    sharded = {name: share(name, p) for name, p in params.items()}
    E = model.num_experts

    def apply_fn(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> MoEOutput:
        C = capacity(x.shape[0], E, model.capacity_factor)
        routing = route_top1(torch.softmax(F.linear(x, params["router.weight"]), dim=-1), C)
        w_in, w_out = params["w_in"], params["w_out"]
        if group is None or w_in.shape[0] == E:  # one rank, or replicated banks
            y = expert_outputs(x, routing, w_in, w_out, C)
        else:
            y = expert_parallel_outputs(x, routing, w_in, w_out, C, group,
                                        rank * w_in.shape[0])
        return MoEOutput(y * routing.gate[:, None], routing.aux, routing.dispatch_frac)

    return apply_fn, sharded
