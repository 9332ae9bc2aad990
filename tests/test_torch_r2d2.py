"""R2D2 on the PyTorch port against the JAX package, and its trainers on the host.

Same weights (converted from the JAX agent's init), the same numpy
sequences, stored cores and uniform draws; float32:

- ``value_rescale`` and its inverse, ``n_step_double_q_targets`` (1e-5);
- ``RecurrentQNet`` with the LSTM and feed-forward, dueling or not, on
  pixels and vectors: Q-values and the carried core (1e-5);
- a batch sampled from both packages' sequence replays (indices exact, the
  stored core and weights equal), then two learn steps on it: loss, new
  priorities, Adam's moments and the params within 1e-5.  On pixels the
  params after Adam's first steps are held at 1e-4: Adam moves each weight
  by about ``lr * g / |g|``, so conv weights whose gradient is at rounding
  level (~1e-8, where the moments still agree to 1e-8) move by amounts
  that differ by up to 5e-5 at lr 1e-3;
- greedy acting with a carried core, resets where ``done``;
- ``R2D2Trainer`` and ``DeviceR2D2Trainer`` on the CPU: learn steps, the
  resume round trip bit for bit, fused and piecewise iterations bit-equal;
  the refusals of the unported mesh paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import r2d2 as tr2d2
from scalerl_torch.data import sequence_replay as tseq
from scalerl_torch.envs.gym_env import make_host_envs
from scalerl_torch.envs.tensor_envs import TensorRecall
from scalerl_torch.models.recurrent_q import RecurrentQNet as TRecurrentQNet
from scalerl_torch.trainer.r2d2 import R2D2Trainer
from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer
from scalerl_torch.utils.checkpoint import flatten_tree
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import r2d2 as jr2d2
from scalerl_tpu.data import sequence_replay as jseq
from scalerl_tpu.models.recurrent_q import RecurrentQNet as JRecurrentQNet

torch.set_num_threads(1)

A = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=1e-5, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=1e-5, err_msg=msg)


def test_value_rescale_matches_jax():
    """h at 1e-5.  The closed-form inverse cancels in ``sqrt(1 + 4 eps (|x|
    + 1 + eps)) - 1``, so in float32 one ulp of the square root moves it by
    up to ~1e-4 relative near |x| ~ 1 and in both packages; the port is
    held to the JAX version's own error against a float64 evaluation."""
    x = np.concatenate([np.linspace(-500, 500, 201), np.random.default_rng(0).normal(size=64) * 3,
                        [0.0, 1e-6, -1e-6]]).astype(np.float32)
    for eps in (1e-3, 1e-2):
        h = tr2d2.value_rescale(torch.from_numpy(x), eps)
        _close(h, jr2d2.value_rescale(jnp.asarray(x), eps))
        hd = h.double().numpy()
        exact = np.sign(hd) * (np.square((np.sqrt(1 + 4 * eps * (np.abs(hd) + 1 + eps)) - 1)
                                         / (2 * eps)) - 1)
        port_err = np.abs(tr2d2.value_rescale_inv(h, eps).numpy() - exact).max()
        jax_err = np.abs(np.asarray(jr2d2.value_rescale_inv(jnp.asarray(h.numpy()), eps))
                         - exact).max()
        assert port_err <= 1.5 * jax_err + 1e-6, (eps, port_err, jax_err)
        _close(tr2d2.value_rescale_inv(h, eps), x, atol=2e-3)


@pytest.mark.parametrize("burn_in,n_steps", [(0, 1), (2, 3), (4, 2)])
def test_n_step_double_q_targets_match_jax(burn_in, n_steps):
    rng = np.random.default_rng(burn_in + n_steps)
    T1, B = 11, 6
    Tt = T1 - burn_in
    q_online = (rng.normal(size=(Tt, B, A)) * 5).astype(np.float32)
    q_target = (rng.normal(size=(Tt, B, A)) * 5).astype(np.float32)
    action = rng.integers(0, A, size=(T1, B)).astype(np.int32)
    reward = (rng.normal(size=(T1, B)) * 3).astype(np.float32)
    done = rng.uniform(size=(T1, B)) < 0.2
    kw = dict(burn_in=burn_in, n_steps=n_steps, gamma=0.97, rescale_eps=1e-3)
    td, qa = tr2d2.n_step_double_q_targets(*map(torch.from_numpy, (q_online, q_target, action,
                                                                    reward, done)), **kw)
    jtd, jqa = jr2d2.n_step_double_q_targets(*map(jnp.asarray, (q_online, q_target, action,
                                                                 reward, done)), **kw)
    assert td.shape == (T1 - burn_in - n_steps, B)
    _close(td, jtd)
    _close(qa, jqa)


MODELS = {
    "pixels_lstm_dueling": ((12, 12, 1), True, True),
    "pixels_lstm": ((12, 12, 1), True, False),
    "pixels_ff_dueling": ((12, 12, 1), False, True),
    "pixels_84": ((84, 84, 4), True, True),
    "vectors_lstm_dueling": ((5,), True, True),
    "vectors_lstm": ((5,), True, False),
    "vectors_ff_dueling": ((5,), False, True),
    "vectors_ff": ((5,), False, False),
}


def _sequence_inputs(obs_shape, T, B, seed):
    rng = np.random.default_rng(seed)
    if len(obs_shape) == 3:
        obs = rng.integers(0, 256, size=(T, B) + obs_shape).astype(np.uint8)
    else:
        obs = rng.normal(size=(T, B) + obs_shape).astype(np.float32)
    return (obs, rng.integers(0, A, size=(T, B)).astype(np.int32),
            (rng.normal(size=(T, B)) * 2).astype(np.float32), rng.uniform(size=(T, B)) < 0.25)


@pytest.mark.parametrize("case", list(MODELS), ids=list(MODELS))
def test_recurrent_q_net_matches_jax(case):
    obs_shape, use_lstm, dueling = MODELS[case]
    T, B, H = 5, 3, 16
    inputs = _sequence_inputs(obs_shape, T, B, 1)
    jnet = JRecurrentQNet(num_actions=A, use_lstm=use_lstm, hidden_size=H, dueling=dueling)
    rng = np.random.default_rng(2)
    core = tuple((rng.normal(size=(B, H + A + 1)).astype(np.float32),
                  rng.normal(size=(B, H + A + 1)).astype(np.float32))
                 for _ in range(1 if use_lstm else 0))
    jcore = tuple((jnp.asarray(c), jnp.asarray(h)) for c, h in core)
    jparams = jnet.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs), jcore)
    jout, jnew = jnet.apply(jparams, *map(jnp.asarray, inputs), jcore)
    tnet = TRecurrentQNet(obs_shape, A, use_lstm=use_lstm, hidden_size=H, dueling=dueling,
                          device="cpu")
    state = convert.recurrent_q_to_torch(_np(jparams))
    assert set(state) == set(tnet.state_dict())
    tnet.load_state_dict(state)
    tcore = tuple((torch.from_numpy(c), torch.from_numpy(h)) for c, h in core)
    with torch.no_grad():
        out, new = tnet(*map(torch.from_numpy, inputs), tcore)
    _close(out.q_values, jout.q_values)
    assert len(new) == len(jnew)
    for (c, h), (jc, jh) in zip(new, jnew):
        _close(c, jc)
        _close(h, jh)
    assert tnet.initial_state(4)[0][0].shape == (4, H + A + 1) if use_lstm else \
        tnet.initial_state(4) == ()


SMALL = dict(rollout_length=8, burn_in=2, n_steps=2, hidden_size=16, batch_size=4,
             replay_capacity=12, target_update_frequency=2)


def _agents(obs_shape, **kw):
    fields = {**SMALL, **kw}
    dtype = np.uint8 if len(obs_shape) == 3 else np.float32
    jagent = jr2d2.R2D2Agent(jconfig.R2D2Arguments(**fields), obs_shape, A, obs_dtype=dtype)
    tagent = tr2d2.R2D2Agent(tconfig.R2D2Arguments(**fields), obs_shape, A, device="cpu")
    tagent.state = _state_to_torch(jagent.state)
    return jagent, tagent


def _state_to_torch(jstate) -> tr2d2.R2D2TrainState:
    to = convert.recurrent_q_to_torch
    return tr2d2.R2D2TrainState(
        params=to(_np(jstate.params)), target_params=to(_np(jstate.target_params)),
        opt_state=convert.adam_state_to_torch(_np(jstate.opt_state), to),
        step=torch.tensor(int(jstate.step), dtype=torch.int32))


@pytest.mark.parametrize("obs_shape", [(5,), (12, 12, 1)], ids=["vectors", "pixels"])
def test_two_learn_steps_on_a_sampled_batch_match_jax(obs_shape):
    jagent, tagent = _agents(obs_shape)
    T1, H = SMALL["rollout_length"] + 1, SMALL["hidden_size"] + A + 1
    obs_dtype = np.uint8 if len(obs_shape) == 3 else np.float32
    shapes = {"obs": ((T1,) + obs_shape, obs_dtype), "action": ((T1,), np.int32),
              "reward": ((T1,), np.float32), "done": ((T1,), bool)}
    cap = SMALL["replay_capacity"]
    jrep = jseq.seq_init(shapes, ((H,),), cap)
    trep = tseq.seq_init(shapes, ((H,),), cap, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):  # 15 sequences into 12 slots: the ring wraps
        obs, action, reward, done = _sequence_inputs(obs_shape, T1, 5, 10 + i)
        fields = {"obs": np.moveaxis(obs, 0, 1), "action": action.T, "reward": reward.T * 2,
                  "done": done.T}
        core = ((rng.normal(size=(5, H)).astype(np.float32),
                 rng.normal(size=(5, H)).astype(np.float32)),)
        prio = rng.uniform(0.1, 2.0, size=5).astype(np.float32)
        jrep = jseq.seq_add(jrep, {k: jnp.asarray(v) for k, v in fields.items()},
                            tuple((jnp.asarray(c), jnp.asarray(h)) for c, h in core),
                            jnp.asarray(prio))
        trep = tseq.seq_add(trep, fields, core, prio)
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (SMALL["batch_size"],))))
    jf, jc, jidx, jw = jseq.seq_sample(jrep, key, SMALL["batch_size"], method="hierarchical")
    tf, tc, tidx, tw = tseq.seq_sample(trep, None, SMALL["batch_size"], method="pallas", u=u)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)
    for (c, h), (jcc, jhh) in zip(tc, jc):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jcc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jhh))

    jlearn = jax.jit(jagent._learn_raw)
    jstate = jagent.state
    for step in range(2):
        jstate, jm, jprio = jlearn(jstate, jf, jc, jw)
        tm, tprio = tagent.learn_sequences(tf, tc, tw)
        for k in ("total_loss", "mean_q", "mean_abs_td", "skipped_steps"):
            _close(tm[k], jm[k], msg=f"step {step}: {k}")
        _close(tprio, jprio, msg=f"step {step}: priorities")
    want = _state_to_torch(jstate)
    params_atol = 1e-5 if len(obs_shape) == 1 else 1e-4
    for group in ("params", "target_params"):
        for k, v in getattr(want, group).items():
            _close(getattr(tagent.state, group)[k], v, atol=params_atol, msg=f"{group}.{k}")
    for moment in ("mu", "nu"):
        for k, v in want.opt_state[moment].items():
            _close(tagent.state.opt_state[moment][k], v, msg=f"{moment}.{k}")
    assert int(tagent.state.step) == int(jstate.step) == 2
    # the target synced at step 2 (target_update_frequency 2)
    for k, v in tagent.state.params.items():
        assert torch.equal(tagent.state.target_params[k], v), k


def test_greedy_acting_with_a_carried_core_matches_jax():
    jagent, tagent = _agents((12, 12, 1))
    rng = np.random.default_rng(4)
    for t in range(6):
        obs = rng.integers(0, 256, size=(3, 12, 12, 1)).astype(np.uint8)
        done = None if t == 0 else rng.uniform(size=3) < 0.3
        np.testing.assert_array_equal(tagent.predict(obs, done=done),
                                      np.asarray(jagent.predict(obs, done=done)), err_msg=t)
    assert tagent.get_action(obs).shape == (3,)


def test_actor_views_follow_the_epsilon_ladder():
    args = tconfig.R2D2Arguments(num_actors=4, hidden_size=16)
    agent = tr2d2.R2D2Agent(args, (5,), A, device="cpu")
    eps = [agent.actor_view(i).eps for i in range(4)]
    np.testing.assert_allclose(eps, [0.4 ** (1 + i / 3 * 7.0) for i in range(4)])
    view = agent.actor_view(0)
    assert view.model is not agent.model and view.model is not agent.actor_view(1).model


def _recall_args(tmp_path, **kw):
    base = dict(env_id="RecallGym-v0", rollout_length=6, burn_in=2, n_steps=1, batch_size=8,
                num_actors=2, num_buffers=8, replay_capacity=64, warmup_sequences=8,
                train_intensity=2, hidden_size=16, logger_backend="none", logger_frequency=400,
                telemetry_interval_s=0.0, save_model=False, work_dir=str(tmp_path))
    base.update(kw)
    return tconfig.R2D2Arguments(**base)


def _recall_env_fns():
    return [(lambda i=i: make_host_envs("RecallGym-v0", 4, i, size=8, delay=2, num_cues=2))
            for i in range(2)]


def _host_leaves(tree):
    return {p: (v.detach().clone() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_tree(tree)}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_wrappers"])
def test_r2d2_trainer_runs_and_resumes_bit_equal(tmp_path, use_pallas):
    args = _recall_args(tmp_path, save_model=True, save_frequency=10**9, use_pallas=use_pallas)
    agent = tr2d2.R2D2Agent(args, (8, 8, 1), 2, device="cpu")
    trainer = R2D2Trainer(args, agent, _recall_env_fns())
    assert trainer.seq_method == ("pallas" if use_pallas else "hierarchical")
    out = trainer.train(total_frames=1500)
    trainer.close()
    assert out["env_frames"] >= 1500 and out["learn_steps"] == trainer.learn_steps > 0
    assert out["skipped_steps"] == 0.0 and np.isfinite(out["total_loss"])
    assert trainer.replay.size > 0 and trainer.max_priority >= 1.0
    assert [kind for _, kind, _ in trainer.log_history].count("train") >= 1
    # the stored cores are the actors' entering carries: some are not zero
    assert any(float(c.abs().sum()) > 0 for pair in trainer.replay.core for c in pair)
    saved = _host_leaves(trainer._resume_pytree())

    args_b = _recall_args(tmp_path, resume=trainer.work_dir)
    agent_b = tr2d2.R2D2Agent(args_b, (8, 8, 1), 2, device="cpu")
    trainer_b = R2D2Trainer(args_b, agent_b, _recall_env_fns())
    assert trainer_b.try_resume()
    restored = _host_leaves(trainer_b._resume_pytree())
    trainer_b.close()
    assert set(restored) == set(saved)
    for p, v in saved.items():
        w = restored[p]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), p
        else:
            assert np.array_equal(v, w), p
    assert trainer_b.env_frames == trainer.env_frames


def _device_trainer(tmp_path, fused, **kw):
    args = _recall_args(tmp_path, env_id="Recall-v0", use_pallas=True, **kw)
    env = TensorRecall(8, size=8, delay=2, num_cues=2, device="cpu")
    agent = tr2d2.R2D2Agent(args, env.observation_shape, env.num_actions, device="cpu")
    return DeviceR2D2Trainer(args, agent, env, fused=fused)


def test_device_r2d2_fused_and_piecewise_are_bit_equal(tmp_path):
    outs, states = [], []
    for fused in (True, False):
        trainer = _device_trainer(tmp_path, fused)
        outs.append(trainer.train(total_frames=1200))
        states.append(_host_leaves({"agent": trainer.agent.state, "replay": trainer.replay,
                                    "max_priority": trainer.max_priority}))
        trainer.close()
    assert outs[0]["learn_steps"] > 0 and np.isfinite(outs[0]["total_loss"])
    assert outs[0]["env_frames"] >= 1200 and outs[0]["episodes"] > 0
    for k in set(outs[0]) - {"sps"}:
        assert outs[0][k] == outs[1][k] or (np.isnan(outs[0][k]) and np.isnan(outs[1][k])), k
    assert set(states[0]) == set(states[1])
    for p, v in states[0].items():
        assert torch.equal(v, states[1][p]) if isinstance(v, torch.Tensor) else \
            np.array_equal(v, states[1][p]), p


def test_unported_mesh_paths_are_refused(tmp_path):
    trainer = _device_trainer(tmp_path, True)
    # one process: a two-device mesh needs a process group of two ranks
    with pytest.raises(ValueError, match="init_process_group"):
        trainer.agent.enable_mesh("dp=2")
    # the mesh-fused loop, once refused, builds on a one-device mesh
    meshed = DeviceR2D2Trainer(trainer.args, trainer.agent, trainer.venv, mesh="dp=1")
    assert meshed.mesh.shape["dp"] == 1 and meshed.local_venv.num_envs == trainer.venv.num_envs
    meshed.close()
    trainer.close()
