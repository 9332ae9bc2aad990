"""Numpy forward passes for actor-process CPU inference.

Port of ``scalerl_tpu/models/np_forward.py`` over the port's numpy state
dicts (``{name: array}`` as ``ParameterServer.pull`` hands them out, with
``nn.Linear`` weights ``[out, in]``).  Process actors run epsilon-greedy
rollouts on weight snapshots without importing a device runtime; a 2x128
MLP forward is microseconds in numpy.

Covers ``models/mlp.py``'s ``QNet`` (plain and dueling) and
``models/policy.py``'s ``MLPPolicyNet``.  Noisy layers are refused: they
need device inference (factorized noise resampling).  Conv policies should
use central inference instead (``trainer/actor_learner.py``).
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np

Weights = Mapping[str, np.ndarray]


def _dense_layers(params: Weights) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``(weight [out, in], bias)`` of ``dense.0``, ``dense.1``, ... in order."""
    if any(k.startswith("dense.") and k.endswith(".w_mu") for k in params):
        raise NotImplementedError(
            "noisy nets need device inference (factorized noise resampling)"
        )
    idx = sorted({int(k.split(".")[1]) for k in params if k.startswith("dense.")})
    return [(np.asarray(params[f"dense.{i}.weight"]), np.asarray(params[f"dense.{i}.bias"]))
            for i in idx]


def _flat_obs(obs: np.ndarray) -> np.ndarray:
    x = np.asarray(obs, np.float32)
    return x.reshape(x.shape[0], -1) if x.ndim > 2 else x


def mlp_qnet_forward(params: Weights, obs: np.ndarray, dueling: bool = False) -> np.ndarray:
    """Q-values ``[B, A]`` from a ``models.mlp.QNet`` state dict.

    Layer order matches the module: the hidden ``dense`` stack with relu,
    then (plain) one head, or (dueling) the advantage head and the value
    head."""
    x = _flat_obs(obs)
    layers = _dense_layers(params)
    n_head = 2 if dueling else 1
    hidden, heads = layers[:-n_head], layers[-n_head:]
    for w, b in hidden:
        x = np.maximum(x @ w.T + b, 0.0)
    if not dueling:
        w, b = heads[0]
        return x @ w.T + b
    adv = x @ heads[0][0].T + heads[0][1]
    val = x @ heads[1][0].T + heads[1][1]
    return val + adv - adv.mean(axis=-1, keepdims=True)


def mlp_policy_forward(params: Weights, obs: np.ndarray) -> np.ndarray:
    """Policy logits ``[B, A]`` from a ``models.policy.MLPPolicyNet`` state
    dict: the ``dense`` relu torso, then the ``policy`` head (the
    ``baseline`` head is learner-only and skipped)."""
    x = _flat_obs(obs)
    for w, b in _dense_layers(params):
        x = np.maximum(x @ w.T + b, 0.0)
    return x @ np.asarray(params["policy.weight"]).T + np.asarray(params["policy.bias"])
