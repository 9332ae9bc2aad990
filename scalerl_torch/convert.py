"""Convert the JAX package's parameters (as numpy arrays) to the port's and back.

The Flax tree of ``AtariNet`` is ``params/{Conv_0,Conv_1,Conv_2,Dense_0,
policy,baseline}/{kernel,bias}``.  Conv kernels are HWIO and become OIHW;
dense kernels are ``[in, out]`` and become ``[out, in]``.  ``Dense_0``'s rows
follow the NHWC flatten of the conv output, which is the order the port's
``AtariNet`` flattens in, so they need no permutation.  With the LSTM core
the tree also holds ``Scan_LSTMCore_0/lstm_{i}/{ii,if,ig,io}/kernel``
(``[in, H]``, no bias) and ``{hi,hf,hg,ho}/{kernel,bias}``; the port keeps
each cell's four input kernels as one ``core.{i}.input.weight`` ``[4H, in]``
and its four recurrent ones as ``core.{i}.hidden.{weight,bias}``, in the
gate order i, f, g, o.

``MLPPolicyNet``'s tree is ``params/{Dense_0 .. Dense_k, policy,
baseline}/{kernel,bias}``, the port's ``dense.{i}``, ``policy`` and
``baseline`` (:func:`mlp_policy_to_torch` and back).

``QNet``'s and ``C51QNet``'s tree is ``params/Dense_{i}/{kernel,bias}``,
the port's ``dense.{i}``; with noisy layers ``params/NoisyDense_{i}/{w_mu,
b_mu,w_sigma,b_sigma}``, the port's ``dense.{i}.*`` with the two weights
transposed (:func:`dense_stack_to_torch`).

The actor-critic heads of ``models/mlp.py`` (``ActorNet``, ``CriticNet``,
``ActorCriticNet``, ``TanhGaussianActor``, ``DeterministicActor``,
``TwinQNet``) keep their layers under Flax's names, ``layers.<name>``
(:func:`flax_mlp_to_torch` and back); SAC's three Adam states (actor,
critics, temperature) and TD3's two convert through
:func:`adam_state_to_torch` with that converter (a scalar tree, the
temperature's, a scalar), and :func:`sac_state_to_torch` and
:func:`td3_state_to_torch` carry whole train states across.

``RecurrentQNet``'s tree is ``Conv_{0,1,2}`` (pixels only), ``Dense_0``, the
LSTM core as in ``AtariNet``, and the heads ``value_h``, ``value``,
``advantage_h``, ``advantage`` (dueling) or ``q``: the port's ``convs.i``,
``fc``, ``core.i`` and the heads under their own names
(:func:`recurrent_q_to_torch`).

``TransformerPolicy``'s tree converts through :func:`transformer_to_torch`
and back through :func:`torch_to_transformer` (names in
:func:`_transformer_names`), keeping each leaf's dtype (float32, or
bfloat16 under ``bf16_params``).  ``TransformerPolicyNet``'s tree is the same
under ``transformer/``, the port's ``transformer.*``
(:func:`transformer_policy_net_to_torch` and back).

``MoEPolicyNet``'s tree is ``moe_policy/{embed, moe/{router, w_in, w_out},
LayerNorm_0, policy_head, value_head}``, the port's ``moe_policy.*`` with
``LayerNorm_0`` as ``norm``: dense kernels transpose, the expert banks
``w_in`` ``[E, M, H]`` and ``w_out`` ``[E, H, M]`` keep their layout
(:func:`moe_policy_net_to_torch` and back; :func:`moe_policy_to_torch` and
:func:`moe_mlp_to_torch` for the inner modules).

Any tree shaped like the params converts the same way, which covers the
optimizer moments: :func:`rmsprop_state_to_torch` pulls RMSProp's ``nu``
(the schedule's update count, and with momentum the trace) out of an optax
chain state (a float32 chain under ``fp32_optimizer_state`` has the same
layout), and
:func:`adam_state_to_torch` Adam's ``mu``, ``nu`` and ``count``.
:func:`token_ppo_state_to_torch` carries a whole token-PPO train state
across (params, the frozen reference params, Adam's moments, both counters).
This module imports neither JAX nor the JAX package; it walks nested dicts,
tuples and namedtuples of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Flax module name -> the port's module path in AtariNet's state_dict
ATARI_NAMES = {
    "Conv_0": "convs.0",
    "Conv_1": "convs.1",
    "Conv_2": "convs.2",
    "Dense_0": "fc",
    "policy": "policy",
    "baseline": "baseline",
}


def _leaf_to_torch(arr: Any, device: torch.device | str) -> torch.Tensor:
    """A numpy leaf -> a tensor of the same dtype; a bfloat16 leaf (numpy's
    ``ml_dtypes`` bfloat16, as JAX hands it over) goes through its bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`_leaf_to_torch` (bfloat16 needs ``ml_dtypes``,
    which is imported only then)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _kernel_to_torch(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    return kernel.T  # [in, out] -> [out, in]


def _kernel_to_flax(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:  # OIHW -> HWIO
        return weight.transpose(2, 3, 1, 0)
    return weight.T


LSTM_CORE = "Scan_LSTMCore_0"
LSTM_GATES = "ifgo"


def _dense_to_torch(
    tree: Mapping[str, Any], names: Mapping[str, str], device: torch.device | str
) -> Dict[str, torch.Tensor]:
    """Flax ``{kernel, bias}`` layers named by ``names`` (Flax -> port) ->
    ``{"<port>.weight", "<port>.bias"}``, float32."""
    out: Dict[str, torch.Tensor] = {}
    for flax_name, torch_name in names.items():
        layer = tree[flax_name]
        kernel = _kernel_to_torch(np.asarray(layer["kernel"], np.float32))
        out[f"{torch_name}.weight"] = torch.tensor(np.ascontiguousarray(kernel), device=device)
        out[f"{torch_name}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32),
                                                 device=device)
    return out


def _dense_to_flax(state: Mapping[str, torch.Tensor], names: Mapping[str, str]) -> Dict[str, Any]:
    """The inverse of :func:`_dense_to_torch`, as numpy arrays."""
    params: Dict[str, Any] = {}
    for flax_name, torch_name in names.items():
        weight = state[f"{torch_name}.weight"].detach().cpu().numpy()
        params[flax_name] = {
            "kernel": np.ascontiguousarray(_kernel_to_flax(weight)),
            "bias": state[f"{torch_name}.bias"].detach().cpu().numpy().copy(),
        }
    return params


def _lstm_core_to_torch(tree: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """``Scan_LSTMCore_0/lstm_{i}`` -> ``core.{i}.{input,hidden}.*``."""
    out: Dict[str, torch.Tensor] = {}
    for name, cell in tree.get(LSTM_CORE, {}).items():
        i = int(name[len("lstm_"):])

        def stacked(prefix: str, leaf: str) -> torch.Tensor:
            arr = np.concatenate(
                [np.asarray(cell[prefix + g][leaf], np.float32) for g in LSTM_GATES], axis=-1)
            return torch.tensor(np.ascontiguousarray(arr.T), device=device)

        out[f"core.{i}.input.weight"] = stacked("i", "kernel")
        out[f"core.{i}.hidden.weight"] = stacked("h", "kernel")
        out[f"core.{i}.hidden.bias"] = stacked("h", "bias")
    return out


def flax_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax ``AtariNet`` param tree (with or without the top ``params``
    level; with or without the LSTM core) -> the port's ``{name: tensor}``
    state dict, float32."""
    tree = tree.get("params", tree)
    return {**_dense_to_torch(tree, ATARI_NAMES, device), **_lstm_core_to_torch(tree, device)}


RECURRENT_Q_HEADS = ("value_h", "value", "advantage_h", "advantage", "q")


def recurrent_q_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax ``RecurrentQNet`` param tree (with or without the top
    ``params`` level; pixels or vectors, with or without the LSTM, dueling
    or not) -> the port's ``RecurrentQNet`` state dict, float32."""
    tree = tree.get("params", tree)
    names = {k: v for k, v in ATARI_NAMES.items() if k in tree and k.startswith(("Conv", "Dense"))}
    names.update({head: head for head in RECURRENT_Q_HEADS if head in tree})
    return {**_dense_to_torch(tree, names, device), **_lstm_core_to_torch(tree, device)}


def torch_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``AtariNet`` state dict -> ``{"params": {...}}`` of numpy
    arrays (the inverse of :func:`flax_to_torch`)."""
    params = _dense_to_flax(state, ATARI_NAMES)
    layers = sorted({int(k.split(".")[1]) for k in state if k.startswith("core.")})
    for i in layers:
        cell: Dict[str, Any] = {}
        for prefix, part in (("i", "input"), ("h", "hidden")):
            weights = state[f"core.{i}.{part}.weight"].detach().cpu().numpy().T
            for g, kernel in zip(LSTM_GATES, np.split(weights, 4, axis=-1)):
                cell[prefix + g] = {"kernel": np.ascontiguousarray(kernel)}
        biases = np.split(state[f"core.{i}.hidden.bias"].detach().cpu().numpy(), 4)
        for g, bias in zip(LSTM_GATES, biases):
            cell["h" + g]["bias"] = bias.copy()
        params.setdefault(LSTM_CORE, {})[f"lstm_{i}"] = cell
    return {"params": params}


def _mlp_policy_names(tree: Mapping[str, Any]) -> Dict[str, str]:
    names = {name: f"dense.{name[len('Dense_'):]}" for name in tree if name.startswith("Dense_")}
    return {**names, "policy": "policy", "baseline": "baseline"}


def mlp_policy_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax ``MLPPolicyNet`` param tree (with or without the top
    ``params`` level) -> the port's ``MLPPolicyNet`` state dict, float32."""
    tree = tree.get("params", tree)
    return _dense_to_torch(tree, _mlp_policy_names(tree), device)


def torch_to_mlp_policy(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`mlp_policy_to_torch`: ``{"params": {...}}``."""
    layers = {k.split(".")[1] for k in state if k.startswith("dense.")}
    skeleton = {f"Dense_{i}": None for i in layers}
    return {"params": _dense_to_flax(state, _mlp_policy_names(skeleton))}


NOISY_LEAVES = ("w_mu", "b_mu", "w_sigma", "b_sigma")


def dense_stack_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax tree of ``Dense_0 .. Dense_k`` or ``NoisyDense_0 ..
    NoisyDense_k`` layers (``QNet``, ``C51QNet``), with or without the top
    ``params`` level -> ``{"dense.{i}.weight": ...}`` or
    ``{"dense.{i}.w_mu": ...}``, float32."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for name, layer in tree.items():
        kind, _, i = name.rpartition("_")
        if kind == "Dense":
            out.update(_dense_to_torch(tree, {name: f"dense.{i}"}, device))
        elif kind == "NoisyDense":
            for leaf in NOISY_LEAVES:
                arr = np.asarray(layer[leaf], np.float32)
                arr = np.ascontiguousarray(arr.T if arr.ndim == 2 else arr)
                out[f"dense.{i}.{leaf}"] = torch.tensor(arr, device=device)
        else:
            raise ValueError(f"expected Dense_<i> or NoisyDense_<i> layers, got {name!r}")
    return out


def flax_mlp_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax tree of ``{kernel, bias}`` layers (``ActorNet``, ``CriticNet``,
    ``ActorCriticNet``, ``TanhGaussianActor``, ``DeterministicActor``,
    ``TwinQNet``; with or without the top ``params`` level) -> the port's
    ``DenseNet`` state dict, ``layers.<Flax name>.{weight,bias}``, float32."""
    tree = tree.get("params", tree)
    return _dense_to_torch(tree, {name: f"layers.{name}" for name in tree}, device)


def torch_to_flax_mlp(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`flax_mlp_to_torch`: ``{"params": {...}}``."""
    names = {k.split(".")[1] for k in state if k.startswith("layers.")}
    return {"params": _dense_to_flax(state, {name: f"layers.{name}" for name in names})}


def _transformer_names(tree: Mapping[str, Any]) -> Dict[Tuple[str, ...], str]:
    """Flax ``TransformerPolicy`` param path -> the port's state_dict name.

    ``block_i/LayerNorm_{0,1}/scale`` -> ``blocks.i.ln_{0,1}.weight``,
    ``block_i/{qkv,proj}/kernel`` (no bias) and ``block_i/{mlp_in,mlp_out}/
    {kernel,bias}`` -> ``blocks.i.<name>.{weight,bias}``; ``token_embed/
    embedding``, ``obs_embed/{kernel,bias}``, ``pos_embed``, ``final_norm/
    scale``, ``{policy,value}_head/{kernel,bias}`` keep their names."""
    names: Dict[Tuple[str, ...], str] = {("pos_embed",): "pos_embed",
                                         ("final_norm", "scale"): "final_norm.weight"}
    if "token_embed" in tree:
        names[("token_embed", "embedding")] = "token_embed.weight"
    if "obs_embed" in tree:
        names[("obs_embed", "kernel")] = "obs_embed.weight"
        names[("obs_embed", "bias")] = "obs_embed.bias"
    for head in ("policy_head", "value_head"):
        names[(head, "kernel")] = f"{head}.weight"
        names[(head, "bias")] = f"{head}.bias"
    blocks = sorted((k for k in tree if k.startswith("block_")), key=lambda k: int(k[6:]))
    for name in blocks:
        i = int(name[len("block_"):])
        for ln in (0, 1):
            names[(name, f"LayerNorm_{ln}", "scale")] = f"blocks.{i}.ln_{ln}.weight"
        for dense in ("qkv", "proj"):
            names[(name, dense, "kernel")] = f"blocks.{i}.{dense}.weight"
        for dense in ("mlp_in", "mlp_out"):
            names[(name, dense, "kernel")] = f"blocks.{i}.{dense}.weight"
            names[(name, dense, "bias")] = f"blocks.{i}.{dense}.bias"
    return names


def _named_to_torch(tree: Mapping[str, Any], names: Mapping[Tuple[str, ...], str],
                    device: torch.device | str) -> Dict[str, torch.Tensor]:
    """Flax leaves at ``names``' paths -> the port's state dict, each leaf
    in its own dtype; ``kernel`` leaves (dense, ``[in, out]``) become ``[out,
    in]``, every other leaf keeps its layout."""
    out: Dict[str, torch.Tensor] = {}
    for path, torch_name in names.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = arr.T
        out[torch_name] = _leaf_to_torch(arr, device)
    return out


def _named_to_flax(state: Mapping[str, torch.Tensor],
                   names: Mapping[Tuple[str, ...], str]) -> Dict[str, Any]:
    """The inverse of :func:`_named_to_torch`: ``{"params": {...}}``."""
    params: Dict[str, Any] = {}
    for path, torch_name in names.items():
        arr = _leaf_to_numpy(state[torch_name])
        if path[-1] == "kernel":
            arr = arr.T
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": params}


def transformer_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax ``TransformerPolicy`` param tree (with or without the top
    ``params`` level, leaves as numpy arrays) -> the port's
    ``TransformerPolicy`` state dict, each leaf in its own dtype.  Dense
    kernels ``[in, out]`` become ``[out, in]``; embeddings, ``pos_embed``
    and norm scales keep their layout."""
    tree = tree.get("params", tree)
    return _named_to_torch(tree, _transformer_names(tree), device)


def torch_to_transformer(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``TransformerPolicy`` state dict -> ``{"params": {...}}``
    of numpy arrays in the Flax tree's layout (the inverse of
    :func:`transformer_to_torch`)."""
    skeleton: Dict[str, Any] = {"pos_embed": None}
    blocks = {name.split(".")[1] for name in state if name.startswith("blocks.")}
    for i in blocks:
        skeleton[f"block_{i}"] = None
    for head in ("token_embed", "obs_embed"):
        if f"{head}.weight" in state:
            skeleton[head] = None
    return _named_to_flax(state, _transformer_names(skeleton))


def transformer_policy_net_to_torch(
    tree: Mapping[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A Flax ``TransformerPolicyNet`` param tree (``transformer/...``, with
    or without the top ``params`` level) -> the port's
    ``TransformerPolicyNet`` state dict (``transformer.*``), each leaf in
    its own dtype."""
    tree = tree.get("params", tree)
    return {f"transformer.{k}": v
            for k, v in transformer_to_torch(tree["transformer"], device).items()}


def torch_to_transformer_policy_net(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`transformer_policy_net_to_torch`:
    ``{"params": {"transformer": {...}}}`` of numpy arrays."""
    inner = {k[len("transformer."):]: v for k, v in state.items()}
    return {"params": {"transformer": torch_to_transformer(inner)["params"]}}


# Flax MoEMLP path -> the port's MoEMLP name; the expert banks keep the JAX
# layout ([E, M, H] and [E, H, M]), only the router's kernel transposes
MOE_MLP_NAMES: Dict[Tuple[str, ...], str] = {
    ("router", "kernel"): "router.weight", ("w_in",): "w_in", ("w_out",): "w_out"}


def _moe_policy_names() -> Dict[Tuple[str, ...], str]:
    """Flax ``MoEPolicy`` path -> the port's name: ``embed``,
    ``LayerNorm_0`` (the port's ``norm``), the two heads and ``moe/...``."""
    names = {("LayerNorm_0", "scale"): "norm.weight", ("LayerNorm_0", "bias"): "norm.bias"}
    for dense in ("embed", "policy_head", "value_head"):
        names[(dense, "kernel")] = f"{dense}.weight"
        names[(dense, "bias")] = f"{dense}.bias"
    names.update({("moe",) + path: f"moe.{name}" for path, name in MOE_MLP_NAMES.items()})
    return names


def moe_mlp_to_torch(tree: Mapping[str, Any],
                     device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """A Flax ``MoEMLP`` param tree -> the port's ``MoEMLP`` state dict."""
    return _named_to_torch(tree.get("params", tree), MOE_MLP_NAMES, device)


def moe_policy_to_torch(tree: Mapping[str, Any],
                        device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """A Flax ``MoEPolicy`` param tree -> the port's ``MoEPolicy`` state
    dict.  The embedding's rows follow ``obs.reshape(N, -1)``, the NHWC
    flatten of pixel obs, which is the port's order too."""
    return _named_to_torch(tree.get("params", tree), _moe_policy_names(), device)


def moe_policy_net_to_torch(tree: Mapping[str, Any],
                            device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """A Flax ``MoEPolicyNet`` param tree (``moe_policy/...``, with or
    without the top ``params`` level) -> the port's ``MoEPolicyNet`` state
    dict (``moe_policy.*``)."""
    tree = tree.get("params", tree)
    return {f"moe_policy.{k}": v
            for k, v in moe_policy_to_torch(tree["moe_policy"], device).items()}


def torch_to_moe_policy_net(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`moe_policy_net_to_torch`:
    ``{"params": {"moe_policy": {...}}}`` of numpy arrays."""
    inner = {k[len("moe_policy."):]: v for k, v in state.items()}
    return {"params": {"moe_policy": _named_to_flax(inner, _moe_policy_names())["params"]}}


def _find_field(state: Any, field: str) -> Optional[Any]:
    """Depth-first search of an optax state for a namedtuple with ``field``."""
    if hasattr(state, "_fields"):
        if field in state._fields:
            return getattr(state, field)
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_field(sub, field)
            if found is not None:
                return found
    return None


def rmsprop_state_to_torch(
    opt_state: Any, device: torch.device | str = "cpu",
    tree_to_torch: Callable[..., Dict[str, torch.Tensor]] = flax_to_torch,
    momentum: bool = False,
) -> Dict[str, Any]:
    """An ``optax.chain(clip_by_global_norm, rmsprop)`` state (leaves as
    numpy arrays) -> the port's RMSProp state ``{"nu": {...}, "count": t}``,
    plus ``"trace"`` with ``momentum``; ``tree_to_torch`` converts each
    tree like the params (``AtariNet``'s by default).

    ``count`` is the learning-rate schedule's update count, 0 when the chain
    has a constant learning rate (it keeps no count then).  optax keeps a
    trace even at momentum 0, where it is only the last update and is never
    read; the port keeps one only for a non-zero momentum, so ``momentum``
    says whether the chain's is wanted."""
    nu = _find_field(opt_state, "nu")
    if nu is None:
        raise ValueError("no ScaleByRmsState (field 'nu') in the optimizer state")
    count = _find_field(opt_state, "count")
    count = 0 if count is None else int(np.asarray(count))
    out = {
        "nu": tree_to_torch(nu, device),
        "count": torch.tensor(count, dtype=torch.int32, device=device),
    }
    if momentum:
        trace = _find_field(opt_state, "trace")
        if trace is None:
            raise ValueError("no TraceState (field 'trace') in the optimizer state")
        out["trace"] = tree_to_torch(trace, device)
    return out


def adam_state_to_torch(
    opt_state: Any,
    tree_to_torch: Callable[..., Dict[str, torch.Tensor]] = dense_stack_to_torch,
    device: torch.device | str = "cpu",
) -> Dict[str, Any]:
    """An optax chain state holding ``ScaleByAdamState`` (leaves as numpy
    arrays) -> the port's Adam state ``{"mu": {...}, "nu": {...}, "count":
    t}``; ``tree_to_torch`` converts each moment tree like the params."""
    mu = _find_field(opt_state, "mu")
    nu = _find_field(opt_state, "nu")
    count = _find_field(opt_state, "count")
    if mu is None or nu is None or count is None:
        raise ValueError("no ScaleByAdamState (fields mu, nu, count) in the optimizer state")
    return {
        "mu": tree_to_torch(mu, device),
        "nu": tree_to_torch(nu, device),
        "count": torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
    }


def token_ppo_state_to_torch(state: Any, device: torch.device | str = "cpu"):
    """A JAX ``TokenPPOTrainState`` (any object with ``params``,
    ``ref_params``, ``opt_state``, ``step`` and ``tokens_seen``, leaves as
    numpy arrays) -> the port's ``agents/token_ppo.py::TokenPPOTrainState``."""
    from scalerl_torch.agents.token_ppo import TokenPPOTrainState

    return TokenPPOTrainState(
        params=transformer_to_torch(state.params, device),
        ref_params=transformer_to_torch(state.ref_params, device),
        opt_state=adam_state_to_torch(state.opt_state, transformer_to_torch, device),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        tokens_seen=torch.tensor(int(np.asarray(state.tokens_seen)), dtype=torch.int32,
                                 device=device),
    )


def _log_alpha_to_torch(arr: Any, device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    """SAC's temperature (a scalar leaf) as the port's one-entry param dict."""
    return {"log_alpha": torch.tensor(np.asarray(arr, np.float32), device=device)}


def sac_state_to_torch(state: Any, device: torch.device | str = "cpu"):
    """A JAX ``SACTrainState`` (leaves as numpy arrays) -> the port's
    ``agents/sac.py::SACTrainState``: the actor's, the critics' and the
    temperature's Adam states through :func:`adam_state_to_torch`."""
    from scalerl_torch.agents.sac import SACTrainState

    return SACTrainState(
        actor_params=flax_mlp_to_torch(state.actor_params, device),
        critic_params=flax_mlp_to_torch(state.critic_params, device),
        target_critic_params=flax_mlp_to_torch(state.target_critic_params, device),
        log_alpha=_log_alpha_to_torch(state.log_alpha, device),
        actor_opt=adam_state_to_torch(state.actor_opt, flax_mlp_to_torch, device),
        critic_opt=adam_state_to_torch(state.critic_opt, flax_mlp_to_torch, device),
        alpha_opt=adam_state_to_torch(state.alpha_opt, _log_alpha_to_torch, device),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
    )


def td3_state_to_torch(state: Any, device: torch.device | str = "cpu"):
    """A JAX ``TD3TrainState`` (leaves as numpy arrays) -> the port's
    ``agents/td3.py::TD3TrainState``, both Adam states included."""
    from scalerl_torch.agents.td3 import TD3TrainState

    return TD3TrainState(
        actor_params=flax_mlp_to_torch(state.actor_params, device),
        target_actor_params=flax_mlp_to_torch(state.target_actor_params, device),
        critic_params=flax_mlp_to_torch(state.critic_params, device),
        target_critic_params=flax_mlp_to_torch(state.target_critic_params, device),
        actor_opt=adam_state_to_torch(state.actor_opt, flax_mlp_to_torch, device),
        critic_opt=adam_state_to_torch(state.critic_opt, flax_mlp_to_torch, device),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
    )
