"""IMPALA's loss, gradients, optimizer and guarded learn step: port vs JAX.

Same weights (converted from the JAX agent's init), same trajectory (numpy
seed).  float32 throughout; the loss, the metrics, the gradients and one
optimizer step agree at 1e-5.  The learn step's inputs are small (24x24
frames, hidden 32) so the JAX side compiles quickly; full-width AtariNet
parity is in test_torch_models.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    args_pair,
    assert_params_close,
    jax_traj,
    random_traj,
    state_to_torch,
    to_numpy,
    torch_traj,
)

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import impala as timpala
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impala as jimpala

torch.set_num_threads(1)

T, B, A = 5, 3, 6
OBS = (24, 24, 4)
LOSS_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "mean_value", "mean_reward")


def _pair(**kw):
    jargs, targs = args_pair(rollout_length=T, batch_size=B, **kw)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=OBS, num_actions=A)
    model = timpala.build_model(targs, OBS, A, device="cpu")
    return jargs, targs, jagent, model


def _assert_metrics_close(port_m, jax_m, keys):
    for k in keys:
        np.testing.assert_allclose(
            float(port_m[k]), float(jax_m[k]), atol=1e-5, rtol=1e-5, err_msg=k
        )


def test_config_defaults_match_jax():
    jargs, targs = jconfig.ImpalaArguments(), tconfig.ImpalaArguments()
    for f in dataclasses.fields(targs):
        assert getattr(targs, f.name) == getattr(jargs, f.name), f.name
    assert targs.discounting == jargs.discounting
    assert targs.total_steps == jargs.total_steps


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_loss_and_metrics_match_jax(impl):
    jargs, targs, jagent, model = _pair()
    fields = random_traj(T, B, OBS, A)
    kw = dict(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)
    jloss, jm = jax.jit(lambda p, traj: jimpala.impala_loss(
        p, jagent.model, traj, **kw,
        vtrace_impl="pallas" if impl == "kernel" else "scan",
    ))(jagent.state.params, jax_traj(fields))
    params = convert.flax_to_torch(to_numpy(jagent.state.params))
    tloss, tm = timpala.impala_loss(params, model, torch_traj(fields), **kw, vtrace_impl=impl)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=1e-5)
    _assert_metrics_close(tm, jm, LOSS_KEYS)


def test_grads_match_jax():
    jargs, targs, jagent, model = _pair()
    fields = random_traj(T, B, OBS, A, seed=3)
    kw = dict(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)
    jgrads = jax.jit(jax.grad(lambda p, traj: jimpala.impala_loss(
        p, jagent.model, traj, **kw)[0]))(jagent.state.params, jax_traj(fields))
    params = {
        k: v.requires_grad_(True)
        for k, v in convert.flax_to_torch(to_numpy(jagent.state.params)).items()
    }
    loss, _ = timpala.impala_loss(params, model, torch_traj(fields), **kw)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert_params_close(grads, jgrads, atol=1e-5, rtol=1e-4)


LEARN_CASES = {
    "constant_lr": {},
    "lr_schedule": {"max_timesteps": 3 * T * B},
    "entropy_anneal": {"entropy_cost_end": 0.001, "entropy_anneal_frames": 4 * T * B},
    "kernel_vtrace": {"use_pallas": True},
    "momentum": {"rmsprop_momentum": 0.9},
    "momentum_lr_schedule": {"rmsprop_momentum": 0.9, "max_timesteps": 3 * T * B},
}


@pytest.mark.parametrize("case", list(LEARN_CASES.values()), ids=list(LEARN_CASES))
def test_learn_step_matches_jax(case):
    """Step 1 from a zero ``nu``; step 2 from the JAX state after step 1,
    converted (a non-zero ``nu`` and, with a schedule, a non-zero count)."""
    jargs, targs, jagent, model = _pair(**case)
    jlearn = jax.jit(jimpala.make_impala_learn_fn(jagent.model, jagent.optimizer, jargs))
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    jstate = jagent.state
    momentum = "rmsprop_momentum" in case
    for step, seed in enumerate((4, 5)):
        fields = random_traj(T, B, OBS, A, seed=seed)
        tstate = state_to_torch(jstate, momentum=momentum)
        jstate, jm = jlearn(jstate, jax_traj(fields))
        tstate, tm = tlearn(tstate, torch_traj(fields))
        assert_params_close(tstate.params, jstate.params)
        _assert_metrics_close(tm, jm, LOSS_KEYS + ("grad_norm", "skipped_steps"))
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert int(tstate.env_frames) == int(jstate.env_frames)
        want = convert.rmsprop_state_to_torch(to_numpy(jstate.opt_state), momentum=momentum)
        if "max_timesteps" in case:  # optax keeps a count only for a schedule
            assert int(tstate.opt_state["count"]) == int(want["count"]) == step + 1
        assert set(tstate.opt_state) == set(want)
        for k, v in want["nu"].items():
            np.testing.assert_allclose(
                tstate.opt_state["nu"][k].numpy(), v.numpy(), atol=1e-8, rtol=1e-4
            )
        for k, v in want.get("trace", {}).items():
            np.testing.assert_allclose(
                tstate.opt_state["trace"][k].numpy(), v.numpy(), atol=1e-9, rtol=1e-4
            )


@pytest.mark.parametrize("scale", [1e-3, 30.0], ids=["small_grads", "clipped"])
@pytest.mark.parametrize("nonzero_nu", [False, True])
def test_optimizer_step_matches_optax(scale, nonzero_nu):
    """Where ``eps`` sits shows at grads ~1e-3: with eps=0.01 inside the
    root the step is ~10x smaller than torch.optim.RMSprop's.  ``scale=30``
    pushes the global norm past max_grad_norm=40 to exercise the clip."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
    targs = tconfig.ImpalaArguments(max_timesteps=0)
    tx = jimpala.make_impala_optimizer(jconfig.ImpalaArguments(max_timesteps=0))
    jstate = tx.init(params)
    topt = timpala.make_impala_optimizer(targs)
    tstate = topt.init({k: torch.tensor(v) for k, v in params.items()})
    if nonzero_nu:
        nu = {k: rng.uniform(size=s).astype(np.float32) * 1e-4 for k, s in shapes.items()}
        jstate = (jstate[0], (jstate[1][0]._replace(nu=nu),) + jstate[1][1:])
        tstate["nu"] = {k: torch.tensor(v) for k, v in nu.items()}
    jupd, _ = jax.jit(tx.update)(grads, jstate, params)
    tupd, _ = topt.update({k: torch.tensor(v) for k, v in grads.items()}, tstate)
    for k in shapes:
        np.testing.assert_allclose(
            tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5, atol=1e-12, err_msg=k
        )
    if scale < 1 and not nonzero_nu:
        # torch.optim.RMSprop's form, g / (sqrt(nu) + eps), is ~10x larger here
        g = grads["a"]
        torch_form = -6e-4 * g / (np.sqrt(0.01 * g * g) + 0.01)
        assert np.all(np.abs(torch_form) > 5 * np.abs(np.asarray(jupd["a"])))


def _flat_tree_to_torch(tree, device="cpu"):
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in tree.items()}


def _optax_state_to_torch(state, momentum):
    return convert.rmsprop_state_to_torch(to_numpy(state), tree_to_torch=_flat_tree_to_torch,
                                          momentum=momentum)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant_lr", "lr_schedule"])
@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_optimizer_steps_with_momentum_match_optax(momentum, schedule):
    """optax 0.2.6 adds ``momentum * trace`` after the learning rate, so its
    trace holds scaled updates; the port's steps, its trace and the
    converted optax state agree over several steps, the lr falling each
    step under the schedule."""
    rng = np.random.default_rng(int(momentum * 10) + schedule)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(rmsprop_momentum=momentum, max_timesteps=4 * 80 * 8 if schedule else 0)
    tx = jimpala.make_impala_optimizer(jconfig.ImpalaArguments(**kw))
    topt = timpala.make_impala_optimizer(tconfig.ImpalaArguments(**kw))
    jstate = tx.init(params)
    tstate = topt.init({k: torch.tensor(v) for k, v in params.items()})
    assert ("trace" in tstate) == (momentum != 0.0)
    update = jax.jit(tx.update)
    for step in range(4):
        grads = {k: (rng.normal(size=s) * (30.0 if step == 1 else 1e-2)).astype(np.float32)
                 for k, s in shapes.items()}  # step 1 is clipped
        jupd, jstate = update(grads, jstate, params)
        tupd, tstate = topt.update({k: torch.tensor(v) for k, v in grads.items()}, tstate)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=f"step {step} {k}")
        want = _optax_state_to_torch(jstate, momentum != 0.0)
        assert set(want) == set(tstate)
        for name in set(want) - {"count"}:
            for k in shapes:
                np.testing.assert_allclose(tstate[name][k].numpy(), want[name][k].numpy(),
                                           rtol=1e-5, atol=1e-12, err_msg=f"{name} {k}")
    # a run resumed from the converted optax state takes the same next step
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jupd, _ = update(grads, jstate, params)
    tupd, _ = topt.update({k: torch.tensor(v) for k, v in grads.items()},
                          _optax_state_to_torch(jstate, momentum != 0.0))
    for k in shapes:
        np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5, atol=1e-12)


FLAT_OBS = (7,)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "kernel"])
def test_flat_obs_learn_step_matches_jax(use_pallas):
    """Flat observations under ``policy_arch="auto"``: both packages build
    ``MLPPolicyNet(hidden, hidden)``, and two learn steps agree."""
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=use_pallas)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=FLAT_OBS, num_actions=A,
                                 obs_dtype=np.float32)
    model = timpala.build_model(targs, FLAT_OBS, A, device="cpu")
    jlearn = jax.jit(jimpala.make_impala_learn_fn(jagent.model, jagent.optimizer, jargs))
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    jstate = jagent.state
    tstate = state_to_torch(jstate, tree_to_torch=convert.mlp_policy_to_torch)
    for seed in (6, 7):
        fields = random_traj(T, B, FLAT_OBS, A, seed=seed)
        fields["obs"] = fields["obs"].astype(np.float32) / 64.0
        jstate, jm = jlearn(jstate, jax_traj(fields))
        tstate, tm = tlearn(tstate, torch_traj(fields))
        assert_params_close(tstate.params, jstate.params, tree_to_torch=convert.mlp_policy_to_torch)
        _assert_metrics_close(tm, jm, LOSS_KEYS + ("grad_norm",))


def test_lstm_agent_acts_with_its_carry():
    _, targs = args_pair(rollout_length=T, batch_size=B, use_lstm=True)
    agent = timpala.ImpalaAgent(targs, OBS, A, device="cpu")
    fields = random_traj(T, B, OBS, A, seed=10)
    core = agent.model.initial_state(B)
    done = torch.ones(B, dtype=torch.bool)
    for t in range(2):
        action, logits, core = agent.act(torch.tensor(fields["obs"][t]),
                                         torch.zeros(B, dtype=torch.long), torch.zeros(B),
                                         done, core)
        done = torch.zeros(B, dtype=torch.bool)
        assert action.shape == (B,) and logits.shape == (B, A)
        assert len(core) == 2 and all(x.shape == (B, 32 + A + 1) for layer in core for x in layer)
    assert bool(core[1][1].abs().sum() > 0)
    metrics = agent.learn(torch_traj(fields))
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("check_every", [1, 2])
def test_nonfinite_batch_is_skipped_like_jax(check_every):
    jargs, targs, jagent, model = _pair(nonfinite_check_every=check_every)
    jlearn = jax.jit(jimpala.make_impala_learn_fn(jagent.model, jagent.optimizer, jargs))
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    good = random_traj(T, B, OBS, A, seed=8)
    bad = dict(good, reward=good["reward"].copy())
    bad["reward"][2, 1] = np.nan
    jstate, tstate = jagent.state, state_to_torch(jagent.state)
    # step 0 is always checked: the NaN batch is skipped on both sides
    jstate, jm = jlearn(jstate, jax_traj(bad))
    before = {k: v.clone() for k, v in tstate.params.items()}
    tstate, tm = tlearn(tstate, torch_traj(bad))
    assert float(tm["skipped_steps"]) == float(jm["skipped_steps"]) == 1.0
    assert float(tm["nonfinite_grads"]) == 1.0
    assert int(tstate.step) == int(jstate.step) == 0
    for k, v in before.items():
        torch.testing.assert_close(tstate.params[k], v, rtol=0, atol=0)
    # a good step, then the NaN batch at step 1: checked only when K == 1
    jstate, _ = jlearn(jstate, jax_traj(good))
    tstate, _ = tlearn(tstate, torch_traj(good))
    jstate, jm = jlearn(jstate, jax_traj(bad))
    tstate, tm = tlearn(tstate, torch_traj(bad))
    skipped = 1.0 if check_every == 1 else 0.0
    assert float(tm["skipped_steps"]) == float(jm["skipped_steps"]) == skipped
    finite = bool(all(torch.isfinite(v).all() for v in tstate.params.values()))
    assert finite == (check_every == 1)


def test_guard_off_returns_the_raw_step():
    _, targs, _, model = _pair(nonfinite_guard=False)
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    agent_state = timpala.ImpalaAgent(targs, OBS, A, device="cpu").state
    _, m = tlearn(agent_state, torch_traj(random_traj(T, B, OBS, A)))
    assert "skipped_steps" not in m and "nonfinite_grads" not in m


def test_agent_act_learn_and_weights():
    _, targs = args_pair(rollout_length=T, batch_size=B)
    agent = timpala.ImpalaAgent(targs, OBS, A, device="cpu")
    fields = random_traj(T, B, OBS, A, seed=9)
    obs = torch.tensor(fields["obs"][0])
    zeros = torch.zeros(B)
    action, logits, core = agent.act(obs, torch.zeros(B, dtype=torch.long), zeros,
                                     torch.ones(B, dtype=torch.bool))
    assert action.shape == (B,) and logits.shape == (B, A) and core == ()
    assert bool(((action >= 0) & (action < A)).all())
    w0 = {k: v.clone() for k, v in agent.get_weights().items()}
    metrics = agent.learn(torch_traj(fields))
    assert all(isinstance(v, float) and np.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(w0[k], v) for k, v in agent.get_weights().items())
    agent.set_weights(w0)
    for k, v in agent.get_weights().items():
        assert torch.equal(v, w0[k])
