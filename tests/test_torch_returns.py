"""The return functions of the PyTorch port (``ops/returns.py``) against the
JAX package and the numpy oracles of ``tests/test_ops.py``
(``test_discounted_returns_oracle``, ``test_n_step_returns_oracle``,
``test_gae_oracle``, rewritten here in numpy).

Same inputs from numpy seeds, float32: the port against the JAX function at
1e-6 (both run the same recursion in the same order; the n-step fold's
powers of gamma at 1e-5 relative), and against the float32 numpy oracle at
1e-5 (the JAX tests hold JAX to it at 1e-4 for n-step and GAE), over
several shapes, dones and windows, on ``[T, B]`` and ``[T]`` inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import returns as treturns
from scalerl_tpu.ops import returns as jreturns

torch.set_num_threads(1)

SHAPES = [(1, 1), (7, 3), (20, 8), (33, 5)]


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("T,B", SHAPES)
def test_discounted_returns(T, B):
    rng = np.random.default_rng(T * 100 + B)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    discounts = (0.9 * (rng.random((T, B)) > 0.2)).astype(np.float32)
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    oracle = np.zeros((T, B), np.float32)
    acc = bootstrap.copy()
    for t in reversed(range(T)):
        acc = rewards[t] + discounts[t] * acc
        oracle[t] = acc
    got = treturns.discounted_returns(_t(rewards), _t(discounts), _t(bootstrap))
    want = jreturns.discounted_returns(_j(rewards), _j(discounts), _j(bootstrap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", SHAPES)
@pytest.mark.parametrize("n", [1, 3, 5])
def test_n_step_returns(T, B, n):
    gamma = 0.9
    rng = np.random.default_rng(T * 100 + B + n)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) > 0.7
    values_tpn = rng.normal(size=(T, B)).astype(np.float32)
    # the truncated-tail contract: k_eff = min(n, T - t); the bootstrap
    # survives unless a real done falls inside the window
    oracle = np.zeros((T, B), np.float32)
    for b in range(B):
        for t in range(T):
            k_eff = min(n, T - t)
            acc, surv = 0.0, 1.0
            for k in range(k_eff):
                acc += (gamma**k) * surv * rewards[t + k, b]
                if dones[t + k, b]:
                    surv = 0.0
                    break
            oracle[t, b] = acc + (gamma**k_eff) * surv * values_tpn[t, b]
    got = treturns.n_step_returns(_t(rewards), _t(dones), _t(values_tpn), gamma, n)
    want = jreturns.n_step_returns(_j(rewards), _j(dones), _j(values_tpn), gamma, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", SHAPES)
@pytest.mark.parametrize("lam", [0.95, 1.0])
def test_gae_advantages(T, B, lam):
    rng = np.random.default_rng(T * 100 + B)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    discounts = (0.99 * (rng.random((T, B)) > 0.1)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    values_tp1 = np.concatenate([values[1:], bootstrap[None]], 0)
    deltas = rewards + discounts * values_tp1 - values
    oracle = np.zeros((T, B), np.float32)
    acc = np.zeros(B, np.float32)
    for t in reversed(range(T)):
        acc = deltas[t] + discounts[t] * np.float32(lam) * acc
        oracle[t] = acc
    adv, vs = treturns.gae_advantages(_t(rewards), _t(discounts), _t(values), _t(bootstrap), lam)
    jadv, jvs = jreturns.gae_advantages(_j(rewards), _j(discounts), _j(values), _j(bootstrap),
                                        lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vs.numpy(), oracle + values, rtol=1e-5, atol=1e-5)


def test_time_only_inputs_and_gradients():
    """``[T]`` inputs work as the JAX scans take them, and GAE carries the
    gradient of the values (the losses detach what they need)."""
    rng = np.random.default_rng(0)
    r, d = rng.normal(size=9).astype(np.float32), np.full(9, 0.9, np.float32)
    v, boot = rng.normal(size=9).astype(np.float32), np.float32(0.3)
    got = treturns.discounted_returns(_t(r), _t(d), torch.tensor(boot))
    want = jreturns.discounted_returns(_j(r), _j(d), jnp.float32(boot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    values = _t(v).requires_grad_(True)
    adv, _ = treturns.gae_advantages(_t(r), _t(d), values, torch.tensor(boot), 0.95)
    adv.sum().backward()
    assert torch.isfinite(values.grad).all() and values.grad.abs().sum() > 0
