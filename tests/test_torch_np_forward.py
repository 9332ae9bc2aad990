"""The port's numpy actor forwards against the JAX package's and the models.

``mlp_qnet_forward`` over the port's ``QNet`` state dict equals the JAX
package's ``mlp_qnet_forward`` over the Flax params of the same weights
(converted through ``convert.py``), the Flax ``QNet`` itself and the port's
``QNet`` module, at 1e-5, dueling on and off and for pixel observations
(flattened); ``mlp_policy_forward`` equals the JAX one and both models'
logits.  Noisy nets are refused, as in the JAX module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.models.mlp import QNet as TQNet
from scalerl_torch.models.np_forward import mlp_policy_forward, mlp_qnet_forward
from scalerl_torch.models.policy import MLPPolicyNet as TPolicy
from scalerl_tpu.models import np_forward as jnp_forward
from scalerl_tpu.models.mlp import QNet as JQNet
from scalerl_tpu.models.policy import MLPPolicyNet as JPolicy

torch.set_num_threads(1)
TOL = 1e-5


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("obs_shape", [(4,), (3, 2, 2)])
@pytest.mark.parametrize("dueling", [False, True])
def test_qnet_forward_matches_jax_and_both_models(dueling, obs_shape):
    net = JQNet(action_dim=3, hidden_sizes=(16, 16), dueling=dueling)
    obs = np.random.default_rng(0).normal(size=(5,) + obs_shape).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    want = np.asarray(net.apply(params, jnp.asarray(obs)))
    jax_np = jnp_forward.mlp_qnet_forward(_numpy(params), obs, dueling=dueling)
    state = convert.dense_stack_to_torch(_numpy(params))
    weights = {k: v.numpy() for k, v in state.items()}
    got = mlp_qnet_forward(weights, obs, dueling=dueling)
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_np, rtol=TOL, atol=TOL)
    model = TQNet(obs_shape, 3, hidden_sizes=(16, 16), dueling=dueling, device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        np.testing.assert_allclose(got, model(torch.from_numpy(obs)).numpy(), rtol=TOL, atol=TOL)


def test_qnet_forward_refuses_noisy_layers():
    model = TQNet((4,), 3, hidden_sizes=(8,), noisy=True, device="cpu")
    weights = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    with pytest.raises(NotImplementedError, match="noisy"):
        mlp_qnet_forward(weights, np.zeros((1, 4), np.float32))


def test_policy_forward_matches_jax_and_both_models():
    net = JPolicy(num_actions=4, hidden_sizes=(16, 8))
    obs = np.random.default_rng(1).normal(size=(2, 3, 6)).astype(np.float32)
    zeros = jnp.zeros((2, 3))
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(obs), zeros, zeros, zeros)
    out, _ = net.apply(params, jnp.asarray(obs), zeros, zeros, zeros)
    flat = obs.reshape(6, 6)
    jax_np = jnp_forward.mlp_policy_forward(_numpy(params), flat)
    state = convert.mlp_policy_to_torch(_numpy(params))
    got = mlp_policy_forward({k: v.numpy() for k, v in state.items()}, flat)
    np.testing.assert_allclose(got, np.asarray(out.policy_logits).reshape(6, 4), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, jax_np, rtol=TOL, atol=TOL)
    model = TPolicy(4, 6, hidden_sizes=(16, 8), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        logits = model(torch.from_numpy(flat), None, None, None)[0].policy_logits
    np.testing.assert_allclose(got, logits.numpy(), rtol=TOL, atol=TOL)
