"""The transformer actor-critic on the IMPALA learner: port vs JAX.

``TransformerPolicyNet`` at the sharded learner test's size
(tests/test_sharded_learner.py: d=32, 2 heads, 2 layers, flat obs of 16,
``[9, 4, 16]`` chunks) is initialised by the JAX agent and carried across
by ``convert.transformer_policy_net_to_torch``.  In float32 the forward
(with the port's ``use_flash`` off and on, the latter through the flash
op's plain version on the host), the loss, the gradients and two guarded
learn steps agree at 1e-5.  Under ``bf16_params`` every leaf has JAX's
dtype, the optimizer state is float32 on both sides, and a learn step
agrees within the bf16 tolerances stated below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_numpy

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import impala as timpala
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.models.moe import MoEPolicyNet
from scalerl_torch.models.policy import MLPPolicyNet
from scalerl_torch.models.transformer_policy import TransformerPolicyNet, build_mp_policy
from scalerl_torch.parallel.train_step import fp32_optimizer_state
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory
from scalerl_tpu.models.transformer_policy import TransformerPolicyNet as JaxNet
from scalerl_tpu.parallel.train_step import fp32_optimizer_state as jax_fp32_optimizer_state

torch.set_num_threads(1)

T, B, OBS_DIM, A = 8, 4, 16, 5
OBS = (OBS_DIM,)
TOL = 1e-5
LOSS_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "mean_value",
             "mean_reward")
NEW_FIELDS = ("mp_size", "dp_size", "policy_arch", "d_model", "n_layers", "n_heads",
              "moe_experts", "moe_hidden", "bf16_params")


def _args(**kw):
    fields = dict(policy_arch="transformer", d_model=32, n_heads=2, n_layers=2,
                  rollout_length=T, batch_size=B, use_lstm=False, max_timesteps=0, **kw)
    return jconfig.ImpalaArguments(**fields), tconfig.ImpalaArguments(**fields)


def _jax_agent(jargs):
    return jimpala.ImpalaAgent(jargs, obs_shape=OBS, num_actions=A, obs_dtype=jnp.float32,
                               key=jax.random.PRNGKey(0))


def _traj(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T + 1, B, A)).astype(np.float32)
    logits[-1] = 0.0
    return dict(
        obs=rng.normal(size=(T + 1, B, OBS_DIM)).astype(np.float32),
        action=rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
        reward=(rng.normal(size=(T + 1, B)) * 1.5).astype(np.float32),
        done=rng.uniform(size=(T + 1, B)) < 0.2,
        logits=logits,
    )


def _jax_traj(fields):
    return JaxTrajectory(**{k: jnp.asarray(v) for k, v in fields.items()}, core_state=())


def _torch_traj(fields):
    return Trajectory(**{k: torch.tensor(v) for k, v in fields.items()})


def _params(jparams):
    return convert.transformer_policy_net_to_torch(to_numpy(jparams))


def _state(jstate):
    return timpala.ImpalaTrainState(
        params=_params(jstate.params),
        opt_state=convert.rmsprop_state_to_torch(
            to_numpy(jstate.opt_state), tree_to_torch=convert.transformer_policy_net_to_torch),
        step=torch.tensor(int(jstate.step), dtype=torch.int32),
        env_frames=torch.tensor(int(jstate.env_frames), dtype=torch.int64),
    )


def _close(got: dict, want: dict, atol=TOL, rtol=TOL):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().float().numpy(), w.float().numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def test_config_defaults_and_checks_match_jax():
    for cls in ("RLArguments", "ImpalaArguments", "DQNArguments"):
        jargs, targs = getattr(jconfig, cls)(), getattr(tconfig, cls)()
        for name in NEW_FIELDS:
            assert getattr(targs, name) == getattr(jargs, name), (cls, name)
    with pytest.raises(ValueError, match="policy_arch"):
        tconfig.ImpalaArguments(policy_arch="rnn").validate()
    with pytest.raises(ValueError, match="mp_size"):
        tconfig.ImpalaArguments(mp_size=0).validate()
    # the mesh fields validate and resolve as the JAX package resolves them
    from scalerl_torch.parallel import mesh_spec_from_args as tspec
    from scalerl_tpu.parallel import mesh_spec_from_args as jspec

    for kw in (dict(mp_size=2), dict(dp_size=2), dict(mp_size=2, dp_size=2)):
        tconfig.ImpalaArguments(**kw).validate()
        assert (tspec(tconfig.ImpalaArguments(**kw), n_devices=8)
                == jspec(jconfig.ImpalaArguments(**kw), n_devices=8))
    assert tspec(tconfig.ImpalaArguments(mp_size=2, dp_size=2)) == "dp=2,mp=2"
    tconfig.ImpalaArguments(policy_arch="transformer", bf16_params=True).validate()
    tconfig.GenRLArguments(bf16_params=True).validate()


def test_build_mp_policy_dispatch():
    _, targs = _args()
    net = build_mp_policy(targs, OBS, A, device="cpu")
    assert isinstance(net, TransformerPolicyNet)
    assert net.transformer.max_len == T + 1 and net.transformer.num_heads == 2
    assert build_mp_policy(dataclasses.replace(targs, policy_arch="auto"), OBS, A) is None
    moe = build_mp_policy(dataclasses.replace(targs, policy_arch="moe", moe_experts=4,
                                              moe_hidden=24), OBS, A, device="cpu")
    assert isinstance(moe, MoEPolicyNet)
    inner = moe.moe_policy
    assert (inner.moe.num_experts, inner.moe.d_hidden, inner.moe.d_model) == (4, 24, 32)
    assert inner.embed.in_features == OBS_DIM and inner.policy_head.out_features == A
    assert moe.initial_state(B) == ()
    flat = timpala.build_model(dataclasses.replace(targs, policy_arch="auto"), OBS, A,
                               device="cpu")
    assert isinstance(flat, MLPPolicyNet)
    assert [layer.out_features for layer in flat.dense] == [targs.hidden_size] * 2


@pytest.mark.parametrize("use_flash", [False, True], ids=["full_attention", "flash"])
def test_forward_matches_jax(use_flash):
    jnet = JaxNet(num_actions=A, d_model=32, num_heads=2, num_layers=2, max_len=T + 1)
    fields = _traj(1)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(fields["obs"]), None, None, None)
    want, core = jnet.apply(jparams, jnp.asarray(fields["obs"]), None, None, None)
    net = TransformerPolicyNet(A, OBS, d_model=32, num_heads=2, num_layers=2, max_len=T + 1,
                               use_flash=use_flash, device="cpu")
    net.load_state_dict(_params(jparams))
    with torch.no_grad():
        got, tcore = net(torch.tensor(fields["obs"]), None, None, None)
    assert tcore == () and core == ()
    np.testing.assert_allclose(got.policy_logits.numpy(), np.asarray(want.policy_logits),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(want.baseline), atol=TOL, rtol=0)


# bf16 compute: both sides round every block's dense outputs and residual
# stream to bfloat16 (2^-9 relative each) but not at the same places (XLA's
# CPU dot rounds before the bias add), so the float32 heads' outputs are
# held within 2^-5 of their largest magnitude
MIXED_TOL = 2.0 ** -5


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"],
                         ids=["bf16_params", "bf16_compute_f32_params"])
def test_bf16_forward_matches_jax(param_dtype):
    jnet = JaxNet(num_actions=A, d_model=32, num_heads=2, num_layers=2, max_len=T + 1,
                  dtype=jnp.bfloat16, param_dtype=getattr(jnp, param_dtype))
    fields = _traj(8)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(fields["obs"]), None, None, None)
    want, _ = jnet.apply(jparams, jnp.asarray(fields["obs"]), None, None, None)
    net = TransformerPolicyNet(A, OBS, d_model=32, num_heads=2, num_layers=2, max_len=T + 1,
                               use_flash=True, dtype=torch.bfloat16,
                               param_dtype=getattr(torch, param_dtype), device="cpu")
    state = _params(jparams)
    want_dtypes = {k: v.dtype for k, v in state.items()}
    assert {k: v.dtype for k, v in net.state_dict().items()} == want_dtypes
    net.load_state_dict(state)
    with torch.no_grad():
        got, _ = net(torch.tensor(fields["obs"]), None, None, None)
    assert got.policy_logits.dtype == torch.float32 and got.baseline.dtype == torch.float32
    for g, w in ((got.policy_logits, want.policy_logits), (got.baseline, want.baseline)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=MIXED_TOL * np.abs(w).max(), rtol=0)


def test_converter_round_trip_is_exact():
    jargs, _ = _args(bf16_params=True)
    jparams = to_numpy(_jax_agent(jargs).state.params)
    back = convert.torch_to_transformer_policy_net(_params(jparams))
    flat_want = jax.tree_util.tree_leaves_with_path(jparams)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert flat_got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_got[path], leaf)


# (JAX args, port args): the port's use_pallas routes attention through the
# flash op and V-trace through its kernel wrapper, held against JAX's plain
# path and against JAX's Pallas V-trace
LEARN_CASES = {
    "plain": ({}, {}),
    "flash": ({}, {"use_pallas": True}),
    "flash_kernel_vtrace": ({"use_pallas": True}, {"use_pallas": True}),
}


@pytest.mark.parametrize("case", list(LEARN_CASES.values()), ids=list(LEARN_CASES))
def test_learn_steps_match_jax(case):
    """Loss and gradients, then two guarded learn steps, each from the JAX
    state converted (the second with a non-zero ``nu``)."""
    jargs, _ = _args(**case[0])
    _, targs = _args(**case[1])
    jagent = _jax_agent(jargs)
    model = build_mp_policy(targs, OBS, A, device="cpu")
    assert all(b.use_flash == targs.use_pallas for b in model.transformer.blocks)
    fields = _traj(2)
    kw = dict(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)
    jgrads = jax.jit(jax.grad(lambda p, traj: jimpala.impala_loss(p, jagent.model, traj, **kw)[0]))(
        jagent.state.params, _jax_traj(fields))
    params = {k: v.requires_grad_(True) for k, v in _params(jagent.state.params).items()}
    loss, _ = timpala.impala_loss(params, model, _torch_traj(fields), **kw)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _close(grads, _params(jgrads), atol=TOL, rtol=1e-4)

    jlearn = jax.jit(jimpala.make_impala_learn_fn(jagent.model, jagent.optimizer, jargs))
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    jstate = jagent.state
    for seed in (3, 4):
        tstate = _state(jstate)
        jstate, jm = jlearn(jstate, _jax_traj(_traj(seed)))
        tstate, tm = tlearn(tstate, _torch_traj(_traj(seed)))
        _close(tstate.params, _params(jstate.params))
        for key in LOSS_KEYS + ("grad_norm", "skipped_steps"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=TOL, rtol=TOL,
                                       err_msg=key)


# bf16_params: both sides compute the blocks in bfloat16 but round in other
# places (XLA's CPU dot rounds the product before the bias add, PyTorch's
# addmm once after it).  A bf16 rounding is 2^-9 relative and a few stack up
# through two blocks, so the losses are held at 2^-6 relative.  The bf16
# gradients carry that noise into the update (measured up to ~3.5% of a
# leaf's largest update), and adding an update to a bf16 param may round to
# the neighbouring bf16 value (a step of at most 2^-7 of the value).  So
# each new param is held within 2^-4 of its leaf's largest update, plus, for
# a bf16 leaf, 2^-7 of its value.
BF16_LOSS_REL = 2.0 ** -6
BF16_UPDATE_REL = 2.0 ** -4
BF16_STEP_REL = 2.0 ** -7


def test_bf16_params_layout_and_learn_step_match_jax():
    jargs, targs = _args(bf16_params=True)
    jagent = _jax_agent(jargs)
    agent = timpala.ImpalaAgent(targs, OBS, A, device="cpu")
    want_dtypes = {k: v.dtype for k, v in _params(jagent.state.params).items()}
    got_dtypes = {k: v.dtype for k, v in agent.state.params.items()}
    assert got_dtypes == want_dtypes
    assert {str(v) for v in got_dtypes.values()} == {"torch.bfloat16", "torch.float32"}
    assert got_dtypes["transformer.policy_head.weight"] == torch.float32
    assert got_dtypes["transformer.blocks.0.ln_0.weight"] == torch.float32
    assert got_dtypes["transformer.blocks.0.qkv.weight"] == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in agent.state.opt_state["nu"].values())
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(jagent.state.opt_state))

    jlearn = jax.jit(jimpala.make_impala_learn_fn(jagent.model, jagent.optimizer, jargs))
    agent.state = _state(jagent.state)
    before = {k: v.float() for k, v in agent.state.params.items()}
    fields = _traj(5)
    jstate, jm = jlearn(jagent.state, _jax_traj(fields))
    metrics = agent.learn(_torch_traj(fields))
    assert metrics["skipped_steps"] == 0.0
    for key in ("total_loss", "pg_loss", "baseline_loss"):
        want = float(jm[key])
        assert abs(metrics[key] - want) <= BF16_LOSS_REL * max(abs(want), 1.0), key
    for k, w in _params(jstate.params).items():
        got = agent.state.params[k]
        assert got.dtype == w.dtype, k
        w = w.float()
        bound = BF16_UPDATE_REL * (w - before[k]).abs().max()
        if got.dtype == torch.bfloat16:
            bound = bound + BF16_STEP_REL * w.abs()
        assert torch.all((got.float() - w).abs() <= bound), k
    assert all(v.dtype == torch.float32 for v in agent.state.opt_state["nu"].values())


def test_fp32_optimizer_state_matches_optax():
    """The wrapper around the port's RMSProp against optax's chain under the
    JAX wrapper, on mixed bf16 / float32 leaves: updates in each leaf's own
    dtype, moments in float32, equal values."""
    import optax

    rng = np.random.default_rng(6)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=4)}
    grads = {k: rng.normal(size=v.shape) * 2 for k, v in params.items()}
    dtypes = {"w": jnp.bfloat16, "b": jnp.float32}
    jp = {k: jnp.asarray(v, dtypes[k]) for k, v in params.items()}
    jg = {k: jnp.asarray(v, dtypes[k]) for k, v in grads.items()}
    tx = jax_fp32_optimizer_state(optax.chain(optax.clip_by_global_norm(1.0),
                                              optax.rmsprop(1e-2, decay=0.99, eps=0.01)))
    jupd, jst = tx.update(jg, tx.init(jp), jp)
    tdt = {"w": torch.bfloat16, "b": torch.float32}
    tp = {k: torch.tensor(np.asarray(jp[k], np.float32)).to(tdt[k]) for k in params}
    tg = {k: torch.tensor(np.asarray(jg[k], np.float32)).to(tdt[k]) for k in grads}
    opt = fp32_optimizer_state(timpala.RMSPropOptimizer(1e-2, decay=0.99, eps=0.01, max_norm=1.0))
    state = opt.init(tp)
    assert all(v.dtype == torch.float32 for v in state["nu"].values())
    upd, state = opt.update(tg, state)
    for k in params:
        assert upd[k].dtype == tdt[k]
        np.testing.assert_allclose(upd[k].float().numpy(), np.asarray(jupd[k], np.float32),
                                   rtol=1e-5, atol=1e-7)
    nu = convert._find_field(jst, "nu")
    for k in params:
        np.testing.assert_allclose(state["nu"][k].numpy(), np.asarray(nu[k]), rtol=1e-5)


def test_agent_acts_on_flat_observations():
    _, targs = _args()
    agent = timpala.ImpalaAgent(targs, OBS, A, device="cpu")
    obs = torch.randn(B, OBS_DIM)
    actions, logits, core = agent.act(obs, torch.zeros(B, dtype=torch.long), torch.zeros(B),
                                      torch.zeros(B, dtype=torch.bool))
    assert actions.shape == (B,) and logits.shape == (B, A) and core == ()
    metrics = agent.learn(_torch_traj(_traj(7)))
    assert np.isfinite(metrics["total_loss"]) and metrics["skipped_steps"] == 0.0
