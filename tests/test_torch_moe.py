"""The Switch MoE of ``scalerl_torch/models/moe.py`` against the JAX package.

Twins of ``tests/test_moe.py``'s single-device cases, held to the JAX
functions on the same inputs (numpy, seeded) and the same weights (carried
across by ``convert.py``): the dense ``top1_dispatch`` exactly (aux at 1e-6),
first-expert ties, the index-form ``MoEMLP`` against its dense plain twin and
JAX's ``MoEMLP.apply`` at 1e-5 with and without dropped tokens, ``MoEPolicy``'s
outputs and every gradient leaf against ``jax.grad`` at 1e-5,
``build_mp_policy("moe")``'s ``MoEPolicyNet`` on ``[T, B]`` pixel obs, and one
IMPALA learn step with ``policy_arch="moe"`` at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import state_to_torch, to_numpy

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import impala as timpala
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.models.moe import (
    MoEMLP,
    MoEPolicy,
    MoEPolicyNet,
    capacity,
    route_top1,
    top1_dispatch,
)
from scalerl_torch.models.transformer_policy import build_mp_policy
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory
from scalerl_tpu.models import moe as jmoe
from scalerl_tpu.models.transformer_policy import MoEPolicyNet as JaxMoEPolicyNet

torch.set_num_threads(1)

TOL = 1e-5
AUX_TOL = 1e-6


def _gates(N, E, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, E)).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)


def _dispatch_pair(gates: np.ndarray, C: int):
    want = [np.asarray(a) for a in jmoe.top1_dispatch(jnp.asarray(gates), C)]
    got = [a.numpy() for a in top1_dispatch(torch.tensor(gates), C)]
    return got, want


@pytest.mark.parametrize("N,E,C", [(64, 4, 8), (64, 4, 32), (37, 5, 3)],
                         ids=["drops", "ample", "ragged"])
def test_top1_dispatch_matches_jax(N, E, C):
    (d, c, aux), (jd, jc, jaux) = _dispatch_pair(_gates(N, E, N + E), C)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_TOL, atol=AUX_TOL)


def test_top1_dispatch_capacity_case_matches_jax():
    # tests/test_moe.py's case: 4 tokens preferring expert 0, capacity 2
    gates = np.array([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3], [0.6, 0.4]], np.float32)
    (d, c, aux), (jd, jc, jaux) = _dispatch_pair(gates, 2)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(aux, jaux, rtol=AUX_TOL, atol=AUX_TOL)
    np.testing.assert_array_equal(d.sum(axis=(1, 2)), [1, 1, 0, 0])
    assert d[0, 0, 0] == 1.0 and d[1, 0, 1] == 1.0
    assert c[0, 0, 0] == pytest.approx(0.9)


def test_ties_go_to_the_first_expert():
    gates = np.array([[0.4, 0.4, 0.2], [0.25, 0.25, 0.5], [0.5, 0.25, 0.25],
                      [0.3, 0.35, 0.35], [0.4, 0.4, 0.2]], np.float32)
    r = route_top1(torch.tensor(gates), 4)
    assert r.expert.tolist() == [0, 2, 0, 1, 0]
    assert r.slot.tolist() == [0, 0, 1, 0, 2]
    (d, c, _), (jd, jc, _) = _dispatch_pair(gates, 4)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)


def test_index_slots_equal_the_dense_dispatch():
    gates = _gates(200, 6, 3)
    C = 20
    r = route_top1(torch.tensor(gates), C)
    (d, _, _), _ = _dispatch_pair(gates, C)
    n, e, c = np.nonzero(d)
    kept = r.keep.numpy()
    np.testing.assert_array_equal(n, np.nonzero(kept)[0])
    np.testing.assert_array_equal(e, r.expert.numpy()[kept])
    np.testing.assert_array_equal(c, r.slot.numpy()[kept])


def _mlp_pair(E, M, H, cf, N, seed):
    jmodel = jmoe.MoEMLP(num_experts=E, d_model=M, d_hidden=H, capacity_factor=cf)
    x = np.random.default_rng(seed).normal(size=(N, M)).astype(np.float32)
    jparams = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = MoEMLP(E, M, H, cf, device="cpu")
    model.load_state_dict(convert.moe_mlp_to_torch(to_numpy(jparams)))
    return jmodel, jparams, model, x


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["ample", "drops"])
def test_index_form_matches_dense_twin_and_jax(cf):
    jmodel, jparams, model, x = _mlp_pair(4, 16, 32, cf, 64, 0)
    want = jmodel.apply(jparams, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = model(xt)
    model.dense_dispatch = True
    xd = torch.tensor(x, requires_grad=True)
    dense = model(xd)
    for out in (got, dense):
        np.testing.assert_allclose(out.out.detach().numpy(), np.asarray(want.out),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(out.aux_loss.detach()), float(want.aux_loss),
                                   rtol=TOL, atol=TOL)
        assert float(out.dispatch_frac) == pytest.approx(float(want.dispatch_frac), abs=1e-7)
    if cf < 1:
        assert float(got.dispatch_frac) < 1.0  # some tokens really dropped

    # the two forms' gradients: the same products, so equal to rounding
    def grads(form, xin):
        loss = (form.out ** 2).sum() + 0.01 * form.aux_loss
        return torch.autograd.grad(loss, [xin] + list(model.parameters()))

    for a, b in zip(grads(got, xt), grads(dense, xd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def _policy_pair(cf, seed=0, N=16, obs_dim=8):
    jmodel = jmoe.MoEPolicy(num_actions=5, d_model=32, num_experts=4, d_hidden=64,
                            capacity_factor=cf)
    obs = np.random.default_rng(seed).normal(size=(N, obs_dim)).astype(np.float32)
    jparams = jmodel.init(jax.random.PRNGKey(seed + 1), jnp.asarray(obs))
    model = MoEPolicy(5, obs_dim, d_model=32, num_experts=4, d_hidden=64, capacity_factor=cf,
                      device="cpu")
    model.load_state_dict(convert.moe_policy_to_torch(to_numpy(jparams)))
    return jmodel, jparams, model, obs


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["ample", "drops"])
def test_moe_policy_outputs_and_gradients_match_jax(cf):
    jmodel, jparams, model, obs = _policy_pair(cf)

    def jloss(p):
        logits, baseline, aux = jmodel.apply(p, jnp.asarray(obs))
        return (logits ** 2).mean() + (baseline ** 2).mean() + 0.01 * aux

    jlogits, jbaseline, jaux = jmodel.apply(jparams, jnp.asarray(obs))
    jgrads = convert.moe_policy_to_torch(to_numpy(jax.grad(jloss)(jparams)))
    logits, baseline, aux = model(torch.tensor(obs))
    for g, w in ((logits, jlogits), (baseline, jbaseline), (aux, jaux)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    loss = (logits ** 2).mean() + (baseline ** 2).mean() + 0.01 * aux
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    # the router learns through the gate values and the aux loss
    assert float(grads["moe.router.weight"].abs().sum()) > 0


def test_moe_policy_net_matches_jax_on_pixel_obs():
    T, B, obs_shape, A = 3, 4, (6, 6, 2), 3
    targs = tconfig.ImpalaArguments(policy_arch="moe", d_model=16, moe_experts=4,
                                    moe_hidden=24)
    net = build_mp_policy(targs, obs_shape, A, device="cpu")
    assert isinstance(net, MoEPolicyNet)
    jnet = JaxMoEPolicyNet(num_actions=A, d_model=16, num_experts=4, d_hidden=24)
    obs = np.random.default_rng(1).integers(0, 256, size=(T, B) + obs_shape).astype(np.uint8)
    jparams = jnet.init(jax.random.PRNGKey(2), jnp.asarray(obs), None, None, None)
    want, jcore = jnet.apply(jparams, jnp.asarray(obs), None, None, None)
    net.load_state_dict(convert.moe_policy_net_to_torch(to_numpy(jparams)))
    with torch.no_grad():
        got, core = net(torch.tensor(obs), None, None, None)
    assert core == () and jcore == ()
    assert got.policy_logits.shape == (T, B, A) and got.baseline.shape == (T, B)
    np.testing.assert_allclose(got.policy_logits.numpy(), np.asarray(want.policy_logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(want.baseline),
                               rtol=TOL, atol=TOL)
    # the converter round trip is exact
    back = convert.torch_to_moe_policy_net(net.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(to_numpy(jparams)):
        got_leaf = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        np.testing.assert_array_equal(got_leaf, leaf)


def test_capacity_is_the_jax_expression():
    for N, E, cf in ((10752, 8, 2.0), (7, 3, 1.25), (1, 8, 2.0), (512, 8, 2.0)):
        assert capacity(N, E, cf) == max(int(cf * N / E), 1)
    assert capacity(10752, 8, 2.0) == 2688


def test_impala_learn_step_with_moe_policy_matches_jax():
    T, B, obs_shape, A = 4, 4, (6, 6, 2), 3
    fields = dict(policy_arch="moe", d_model=16, moe_experts=4, moe_hidden=24, use_lstm=False,
                  rollout_length=T, batch_size=B, max_timesteps=0)
    jargs = jconfig.ImpalaArguments(**fields)
    targs = tconfig.ImpalaArguments(**fields)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=obs_shape, num_actions=A,
                                 key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(T + 1, B, A)).astype(np.float32)
    logits[-1] = 0.0
    traj = dict(obs=rng.integers(0, 256, size=(T + 1, B) + obs_shape).astype(np.uint8),
                action=rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
                reward=rng.normal(size=(T + 1, B)).astype(np.float32),
                done=rng.uniform(size=(T + 1, B)) < 0.2, logits=logits)
    agent = timpala.ImpalaAgent(targs, obs_shape, A, device="cpu")
    assert isinstance(agent.model, MoEPolicyNet)
    agent.state = state_to_torch(jagent.state, convert.moe_policy_net_to_torch)
    jstate, jm = jax.jit(jagent.make_learn_fn())(
        jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                    core_state=()))
    metrics = agent.learn(Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}))
    want = convert.moe_policy_net_to_torch(to_numpy(jstate.params))
    for name, got in agent.state.params.items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
