"""The parts the remaining learners share, on the PyTorch port against the
JAX package.

- ``ActorNet``, ``CriticNet``, ``ActorCriticNet`` (with and without the
  normalized-columns heads), ``TanhGaussianActor``, ``DeterministicActor``
  and ``TwinQNet`` (``models/mlp.py``) on the Flax modules' weights,
  converted by ``convert.flax_mlp_to_torch``: outputs at 1e-5 on the same
  inputs; ``torch_to_flax_mlp`` gives the Flax tree back exactly; the
  port's own initialisation follows Flax's law (truncated LeCun-normal
  kernels of std ``1/sqrt(fan_in)``, zero biases).
- ``A3CArguments``, ``PPOArguments``, ``SACArguments``, ``TD3Arguments``
  and ``ImpactArguments``: every field's default equal to the JAX
  package's, the same ``validate()`` errors with the same messages, and
  the options of ``parse_args`` under the JAX spelling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.models import mlp as tmlp
from scalerl_tpu import config as jconfig
from scalerl_tpu.models import mlp as jmlp

torch.set_num_threads(1)

OBS, ACT, B = 5, 3, 16

NETS = [
    ("ActorNet", dict(action_dim=ACT, hidden_sizes=(32, 16)), (OBS, ACT), {}),
    ("CriticNet", dict(hidden_sizes=(32, 16)), (OBS,), {}),
    ("ActorCriticNet", dict(action_dim=ACT, hidden_sizes=(32,)), (OBS, ACT), {}),
    ("ActorCriticNet", dict(action_dim=ACT, hidden_sizes=(32, 32), normalized_init=True),
     (OBS, ACT), dict(normalized_init=True)),
    ("TanhGaussianActor", dict(action_dim=ACT, hidden_sizes=(32, 32)), (OBS, ACT), {}),
    ("DeterministicActor", dict(action_dim=ACT, hidden_sizes=(32, 32)), (OBS, ACT), {}),
    ("TwinQNet", dict(hidden_sizes=(32, 32)), (OBS, ACT), {}),
]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name,jkw,targs,tkw", NETS)
def test_heads_match_flax_and_convert_both_ways(name, jkw, targs, tkw):
    rng = np.random.default_rng(0)
    obs = (rng.normal(size=(B, OBS)) * 3).astype(np.float32)
    act = rng.uniform(-1, 1, size=(B, ACT)).astype(np.float32)
    inputs = (obs, act) if name == "TwinQNet" else (obs,)
    jnet = getattr(jmlp, name)(**jkw)
    params = jnet.init(jax.random.PRNGKey(3), *(jnp.asarray(x) for x in inputs))
    hidden = jkw["hidden_sizes"]
    tnet = getattr(tmlp, name)(*targs, hidden_sizes=hidden, device="cpu", **tkw)
    state = convert.flax_mlp_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(tnet.state_dict())
    tnet.load_state_dict(state)
    want = _outputs(jnet.apply(params, *(jnp.asarray(x) for x in inputs)))
    with torch.no_grad():
        got = _outputs(tnet(*(torch.tensor(x) for x in inputs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    back = convert.torch_to_flax_mlp(tnet.state_dict())["params"]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])


@pytest.mark.parametrize("name,jkw,targs,tkw", NETS)
def test_init_follows_flax_law(name, jkw, targs, tkw):
    net = getattr(tmlp, name)(*targs, hidden_sizes=(256, 256), device="cpu",
                              generator=torch.Generator().manual_seed(1), **tkw)
    for key, layer in net.layers.items():
        assert torch.count_nonzero(layer.bias) == 0, key
        if tkw.get("normalized_init") and key in (net.logits_head, net.value_head):
            norm = 0.01 if key == net.logits_head else 1.0
            np.testing.assert_allclose(layer.weight.detach().norm(dim=1), norm, rtol=1e-5)
            continue
        w = layer.weight.detach()
        bound = 2.0 / np.sqrt(layer.in_features) / 0.87962566103423978  # truncation at 2 sigma
        assert w.abs().max() <= bound * 1.0001, key
        if w.numel() >= 1024:
            np.testing.assert_allclose(w.std().item(), 1 / np.sqrt(layer.in_features), rtol=0.1)


CONFIGS = ["A3CArguments", "PPOArguments", "SACArguments", "TD3Arguments", "ImpactArguments"]


@pytest.mark.parametrize("cls", CONFIGS)
def test_config_defaults_match_jax(cls):
    t, j = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    jfields = {f.name for f in dataclasses.fields(j)}
    for f in dataclasses.fields(t):
        assert f.name in jfields, f.name
        assert getattr(t, f.name) == getattr(j, f.name), (cls, f.name)


BAD = [
    ("PPOArguments", dict(num_minibatches=0)),
    ("PPOArguments", dict(num_workers=6, num_minibatches=4)),
    ("PPOArguments", dict(loss_reduction="max")),
    ("PPOArguments", dict(ppo_epochs=0)),
    ("SACArguments", dict(soft_update_tau=0.0)),
    ("SACArguments", dict(init_alpha=0.0)),
    ("SACArguments", dict(n_steps=0)),
    ("TD3Arguments", dict(policy_delay=0)),
    ("TD3Arguments", dict(soft_update_tau=1.5)),
    ("TD3Arguments", dict(n_steps=0)),
    ("ImpactArguments", dict(target_update_frequency=0)),
    ("ImpactArguments", dict(replay_times=0)),
    ("ImpactArguments", dict(surrogate_capacity=0)),
    ("ImpactArguments", dict(impact_clip=1.0)),
]


@pytest.mark.parametrize("cls,kw", BAD)
def test_validate_errors_match_jax(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jconfig, cls)(**kw).validate()
    with pytest.raises(ValueError) as got:
        getattr(tconfig, cls)(**kw).validate()
    assert str(got.value) == str(want.value)


def test_parse_args_takes_the_jax_spelling():
    args = tconfig.parse_args(tconfig.PPOArguments, [
        "--num-minibatches", "2", "--loss-reduction", "mean", "--clip-range-vf", "0.2",
        "--use-lstm", "--normalize-advantage", "false"])
    assert (args.num_minibatches, args.loss_reduction, args.clip_range_vf, args.use_lstm,
            args.normalize_advantage) == (2, "mean", 0.2, True, False)
    args = tconfig.parse_args(tconfig.ImpactArguments, ["--replay-times", "3",
                                                        "--target-update-frequency", "8"])
    assert (args.replay_times, args.target_update_frequency) == (3, 8)
    args = tconfig.parse_args(tconfig.TD3Arguments, ["--policy-delay", "3", "--use-per"])
    assert (args.policy_delay, args.use_per) == (3, True)
