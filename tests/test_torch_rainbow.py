"""C51 and NoisyNet DQN of the PyTorch port against the JAX package.

Same weights (converted from the JAX side's init), the same numpy batches,
and the same noise (the JAX layer's ``jax.random.normal`` draws replaced by
the ones the port is handed).  float32 throughout, at 1e-5:

- the C51 terms: support, expected Q, the projected target (mass on an
  exact grid point stays there), the cross-entropy;
- ``NoisyDense``, ``QNet(noisy=True)`` and ``C51QNet`` forwards with injected
  noise and at their mean weights;
- C51 and noisy dueling learn steps, and the Ape-X priority function;
- ``per_add_with_priorities``: the buffer state after adds;
- the argument schemas (defaults and refusals).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import dqn as tdqn
from scalerl_torch.data import prioritized as tprio
from scalerl_torch.models import mlp as tmlp
from scalerl_torch.ops import losses as tlosses
from scalerl_torch.parallel.train_step import maybe_guard_nonfinite
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import dqn as jdqn
from scalerl_tpu.data import prioritized as jprio
from scalerl_tpu.models import mlp as jmlp
from scalerl_tpu.ops import losses as jlosses

torch.set_num_threads(1)

OBS, A, B, N = (4,), 3, 16, 11
SMALL = dict(hidden_sizes="32,32", max_timesteps=1000, batch_size=B, buffer_size=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=1e-5, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=1e-5, err_msg=msg)


@pytest.mark.parametrize("name", ["DQNArguments", "ApexArguments", "R2D2Arguments"])
def test_argument_defaults_match_jax(name):
    targs, jargs = getattr(tconfig, name)(), getattr(jconfig, name)()
    for f in dataclasses.fields(targs):
        assert getattr(targs, f.name) == getattr(jargs, f.name), f.name


BAD_ARGUMENTS = {
    "c51_one_atom": ("DQNArguments", dict(categorical_dqn=True, num_atoms=1)),
    "c51_empty_support": ("DQNArguments", dict(categorical_dqn=True, v_min=5.0, v_max=5.0)),
    "apex_short_rollout": ("ApexArguments", dict(rollout_length=2, n_steps=3)),
    "r2d2_burn_in_past_rollout": ("R2D2Arguments", dict(burn_in=20)),
    "r2d2_no_train_row": ("R2D2Arguments", dict(burn_in=18, n_steps=3)),
    "r2d2_eta": ("R2D2Arguments", dict(priority_eta=1.5)),
}


@pytest.mark.parametrize("case", list(BAD_ARGUMENTS), ids=list(BAD_ARGUMENTS))
def test_argument_validation_matches_jax(case):
    name, kw = BAD_ARGUMENTS[case]
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            getattr(mod, name)(**kw).validate()


def _projection_inputs(seed, exact):
    rng = np.random.default_rng(seed)
    support = np.linspace(-5.0, 5.0, N).astype(np.float32)
    probs = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    if exact:  # shifts by whole atoms, clipped at both ends: b lands on the grid
        rewards = (rng.integers(-3, 4, size=B) * 1.0).astype(np.float32)
        discounts = np.where(rng.uniform(size=B) < 0.3, 0.0, 1.0).astype(np.float32)
        rewards[0], discounts[0] = 0.0, 1.0  # the identity shift
    else:
        rewards = (rng.normal(size=B) * 3).astype(np.float32)
        discounts = (0.99 * (rng.uniform(size=B) > 0.2)).astype(np.float32)
    return probs, rewards, discounts, support


@pytest.mark.parametrize("exact", [False, True], ids=["off_grid", "exact_atoms"])
def test_categorical_projection_matches_jax(exact):
    args = _projection_inputs(3, exact)
    got = tlosses.categorical_projection(*map(torch.from_numpy, args))
    want = jlosses.categorical_projection(*map(jnp.asarray, args))
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)  # no mass lost
    if exact:  # every shifted atom lands on a grid point: the identity keeps it
        _close(got[0], args[0][0])


def test_support_and_expected_q_match_jax():
    _close(tlosses.make_support(-10.0, 10.0, 51), jlosses.make_support(-10.0, 10.0, 51))
    logits = np.random.default_rng(1).normal(size=(B, A, N)).astype(np.float32) * 2
    support = np.linspace(0.0, 200.0, N).astype(np.float32)
    _close(tlosses.categorical_q_values(torch.from_numpy(logits), torch.from_numpy(support)),
           jlosses.categorical_q_values(jnp.asarray(logits), jnp.asarray(support)))


@pytest.mark.parametrize("weighted", [False, True])
def test_c51_loss_matches_jax(weighted):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(B, A, N)) * 2).astype(np.float32)
    actions = rng.integers(0, A, size=B).astype(np.int32)
    target = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=B).astype(np.float32) if weighted else None
    tl, tce = tlosses.c51_loss(torch.from_numpy(logits), torch.from_numpy(actions),
                               torch.from_numpy(target), None if w is None else torch.from_numpy(w))
    jl, jce = jlosses.c51_loss(jnp.asarray(logits), jnp.asarray(actions), jnp.asarray(target),
                               None if w is None else jnp.asarray(w))
    _close(tl, jl)
    _close(tce, jce)


def _injected_normals(monkeypatch, draws):
    """Make the JAX NoisyDense layers draw ``draws`` in order (each layer
    draws eps_in, then eps_out)."""
    queue = list(draws)

    def normal(key, shape, *a, **k):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "normal", normal)
    return queue


def _noise_for(widths, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=a).astype(np.float32), rng.normal(size=b).astype(np.float32))
            for a, b in widths]


@pytest.mark.parametrize("injected", [False, True], ids=["mean", "noise"])
def test_noisy_dense_matches_jax(monkeypatch, injected):
    x = np.random.default_rng(4).normal(size=(B, 7)).astype(np.float32)
    jlayer = jmlp.NoisyDense(5, sigma0=0.5)
    jparams = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tlayer = tmlp.NoisyDense(7, 5)
    tlayer.load_state_dict({k[len("dense.0."):]: v for k, v in convert.dense_stack_to_torch(
        {"NoisyDense_0": _np(jparams)["params"]}).items()})
    noise = _noise_for([(7, 5)], 5)
    if injected:
        _injected_normals(monkeypatch, [e for pair in noise for e in pair])
        want = jlayer.apply(jparams, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(1)})
        eps = tuple(torch.from_numpy(e) for e in noise[0])
    else:
        want, eps = jlayer.apply(jparams, jnp.asarray(x)), None
    with torch.no_grad():
        _close(tlayer(torch.from_numpy(x), eps), want)


NETS = {  # noisy networks at their mean weights and with injected noise
    "qnet_noisy_mean": dict(c51=False, dueling=False, noisy=True, injected=False),
    "qnet_noisy": dict(c51=False, dueling=False, noisy=True, injected=True),
    "qnet_noisy_dueling": dict(c51=False, dueling=True, noisy=True, injected=True),
    "c51": dict(c51=True, dueling=False, noisy=False, injected=False),
    "c51_dueling": dict(c51=True, dueling=True, noisy=False, injected=False),
    "c51_noisy_dueling_mean": dict(c51=True, dueling=True, noisy=True, injected=False),
    "c51_noisy_dueling": dict(c51=True, dueling=True, noisy=True, injected=True),
}


@pytest.mark.parametrize("case", list(NETS), ids=list(NETS))
def test_q_networks_match_jax(monkeypatch, case):
    cfg = NETS[case]
    injected = cfg["injected"]
    obs = np.random.default_rng(6).normal(size=(B, 2, 3)).astype(np.float32)
    kw = dict(hidden_sizes=(16, 8), dueling=cfg["dueling"], noisy=cfg["noisy"], noisy_std=0.4)
    if cfg["c51"]:
        jnet = jmlp.C51QNet(action_dim=A, num_atoms=N, **kw)
        tnet = tmlp.C51QNet((2, 3), A, N, **kw, device="cpu")
        heads = [A * N] + ([N] if cfg["dueling"] else [])
    else:
        jnet = jmlp.QNet(action_dim=A, **kw)
        tnet = tmlp.QNet((2, 3), A, **kw, device="cpu")
        heads = [A] + ([1] if cfg["dueling"] else [])
    jparams = jnet.init(jax.random.PRNGKey(2), jnp.asarray(obs))
    state = convert.dense_stack_to_torch(_np(jparams))
    assert set(state) == set(tnet.state_dict())
    tnet.load_state_dict(state)
    widths = [(6, 16), (16, 8)] + [(8, h) for h in heads]
    noise = None
    if injected:
        draws = _noise_for(widths, 7)
        _injected_normals(monkeypatch, [e for pair in draws for e in pair])
        want = jnet.apply(jparams, jnp.asarray(obs), rngs={"noise": jax.random.PRNGKey(3)})
        noise = [tuple(torch.from_numpy(e) for e in pair) for pair in draws]
    else:
        want = jnet.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        _close(tnet(torch.from_numpy(obs), noise), want)
    if cfg["noisy"]:  # the port's own draws: one pair a layer, of its widths
        draws = tnet.sample_noise(torch.Generator().manual_seed(0))
        assert [(a.shape[0], b.shape[0]) for a, b in draws] == widths


def _state_to_torch(jstate) -> tdqn.DQNTrainState:
    return tdqn.DQNTrainState(
        params=convert.dense_stack_to_torch(_np(jstate.params)),
        target_params=convert.dense_stack_to_torch(_np(jstate.target_params)),
        opt_state=convert.adam_state_to_torch(_np(jstate.opt_state)),
        step=torch.tensor(int(jstate.step), dtype=torch.int32),
    )


def _assert_state_close(tstate, jstate):
    want = _state_to_torch(jstate)
    for group in ("params", "target_params"):
        for k, v in getattr(want, group).items():
            _close(getattr(tstate, group)[k], v, msg=f"{group}.{k}")
    for moment in ("mu", "nu"):
        for k, v in want.opt_state[moment].items():
            _close(tstate.opt_state[moment][k], v, msg=f"{moment}.{k}")
    assert int(tstate.step) == int(jstate.step)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(B,) + OBS).astype(np.float32),
        next_obs=rng.normal(size=(B,) + OBS).astype(np.float32),
        action=rng.integers(0, A, size=B).astype(np.int32),
        reward=(rng.normal(size=B) * 5).astype(np.float32),
        done=rng.uniform(size=B) < 0.2,
        weights=rng.uniform(0.2, 1.0, size=B).astype(np.float32),
        n_steps=rng.integers(1, 4, size=B).astype(np.int32),
    )


LEARN_CASES = {
    "c51_double_soft": dict(categorical_dqn=True, num_atoms=N, v_min=-10.0, v_max=10.0),
    "c51_dueling_hard_linear_lr": dict(categorical_dqn=True, num_atoms=N, v_min=-10.0,
                                       v_max=10.0, dueling_dqn=True, double_dqn=False,
                                       use_soft_update=False, target_update_frequency=3,
                                       lr_scheduler="linear", max_grad_norm=0.5),
    "noisy_dueling_mean_weights": dict(noisy_dqn=True, dueling_dqn=True),
    "c51_noisy_mean_weights": dict(categorical_dqn=True, num_atoms=N, v_min=-10.0,
                                   v_max=10.0, noisy_dqn=True),
}


@pytest.mark.parametrize("case", list(LEARN_CASES), ids=list(LEARN_CASES))
def test_learn_step_matches_jax(case):
    """The JAX agent passes no ``noise`` rng, so its noisy layers learn at
    their mean weights: the port's learn function without noise matches it."""
    fields = {**SMALL, **LEARN_CASES[case]}
    jagent = jdqn.DQNAgent(jconfig.DQNArguments(**fields), OBS, A, donate_state=False)
    targs = tconfig.DQNArguments(**fields)
    tagent = tdqn.DQNAgent(targs, OBS, A, device="cpu")
    tlearn = maybe_guard_nonfinite(tagent.make_learn_fn(noise=False), targs)
    jlearn = jax.jit(jagent._learn_raw)
    jstate = jagent.state
    for i in range(2):  # warm the state: params != target params, moments != 0
        jstate, _, _ = jlearn(jstate, _batch(10 + i))
    tstate = _state_to_torch(jstate)
    batch = _batch(1)
    jstate, jm, jps = jlearn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm, tps = tlearn(tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for k in ("loss", "td_error_mean", "q_mean", "skipped_steps"):
        _close(tm[k], jm[k], msg=k)
    _close(tps, jps)
    _assert_state_close(tstate, jstate)


def test_noisy_agent_draws_fresh_noise_each_act_and_learn_step():
    args = tconfig.DQNArguments(**SMALL, noisy_dqn=True, eps_greedy_start=0.0)
    agent = tdqn.DQNAgent(args, OBS, A, device="cpu")
    obs = torch.from_numpy(np.random.default_rng(0).normal(size=(256,) + OBS).astype(np.float32))
    q1 = agent.q_values(agent.state.params, obs, noise=True)
    q2 = agent.q_values(agent.state.params, obs, noise=True)
    assert not torch.equal(q1, q2)
    assert torch.equal(agent.q_values(agent.state.params, obs),
                       agent.q_values(agent.state.params, obs))
    before = {k: v.clone() for k, v in agent.state.params.items()}
    agent.learn(_batch(3))
    moved = [k for k in before if not torch.equal(before[k], agent.state.params[k])]
    assert any(k.endswith("w_sigma") for k in moved)  # sigma learns only under noise


@pytest.mark.parametrize("double_dqn", [True, False])
def test_priority_fn_matches_jax(double_dqn):
    jagent = jdqn.DQNAgent(jconfig.DQNArguments(**SMALL), OBS, A, donate_state=False)
    tagent = tdqn.DQNAgent(tconfig.DQNArguments(**SMALL), OBS, A, device="cpu")
    jstate = jagent.state
    for i in range(2):
        jstate, _, _ = jax.jit(jagent._learn_raw)(jstate, _batch(20 + i))
    tstate = _state_to_torch(jstate)
    b = _batch(4)
    cols = ("obs", "action", "reward", "next_obs", "done", "n_steps")
    want = jdqn.make_dqn_priority_fn(jagent.network, 0.99, double_dqn)(
        jstate.params, jstate.target_params, *(jnp.asarray(b[k]) for k in cols))
    got = tdqn.make_dqn_priority_fn(tagent.network, 0.99, double_dqn)(
        tstate.params, tstate.target_params, *(torch.from_numpy(np.asarray(b[k])) for k in cols))
    _close(got, want)


def test_per_add_with_priorities_matches_jax():
    cap, envs = 5, 6
    extra = {"n_steps": ((), jnp.int32)}
    jbuf = jprio.PrioritizedReplayBuffer(OBS, cap, num_envs=envs, extra_fields=extra,
                                         sample_method="hierarchical", update_method="xla")
    tbuf = tprio.PrioritizedReplayBuffer(OBS, cap, num_envs=envs,
                                         extra_fields={"n_steps": ((), torch.int32)},
                                         device="cpu")
    rng = np.random.default_rng(9)
    for i in range(cap + 3):  # wraps the ring
        step = dict(obs=rng.normal(size=(envs,) + OBS).astype(np.float32),
                    next_obs=rng.normal(size=(envs,) + OBS).astype(np.float32),
                    action=rng.integers(0, A, size=envs).astype(np.int32),
                    reward=rng.normal(size=envs).astype(np.float32),
                    done=rng.uniform(size=envs) < 0.2,
                    n_steps=rng.integers(1, 4, size=envs).astype(np.int32))
        prio = np.abs(rng.normal(size=envs) * (3 if i == 2 else 1)).astype(np.float32)
        prio[0] = 0.0  # clamped to 1e-6
        jbuf.add_with_priorities(step, prio)
        tbuf.add_with_priorities(step, prio)
        np.testing.assert_array_equal(tbuf.state.priorities.numpy(),
                                      np.asarray(jbuf.state.priorities))
        assert float(tbuf.state.max_priority) == float(jbuf.state.max_priority)
        assert (tbuf.state.replay.pos, tbuf.state.replay.size) == (
            int(jbuf.state.replay.pos), int(jbuf.state.replay.size))
    for k, v in tbuf.state.replay.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbuf.state.replay.storage[k]),
                                      err_msg=k)
    key = jax.random.PRNGKey(0)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (8,))))
    jb = jprio.per_sample(jbuf.state, key, 8, jnp.float32(0.6), jnp.float32(0.4),
                          method="hierarchical")
    tb = tprio.per_sample_from_uniforms(tbuf.state, u, 0.6, 0.4)
    np.testing.assert_array_equal(tb["indices"].numpy(), np.asarray(jb["indices"]))
    np.testing.assert_array_equal(tb["n_steps"].numpy(), np.asarray(jb["n_steps"]))
    _close(tb["weights"], jb["weights"])
