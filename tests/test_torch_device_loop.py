"""The fused IMPALA loop as a whole: the slice of the port, end to end.

- A trajectory collected by the JAX ``DeviceActorLearnerLoop._unroll`` goes
  through the JAX learn step and the port's, from the same converted
  weights: the next params agree at 1e-5 (float32).
- The port's loop runs a few chunks on the host and returns the JAX loop's
  metric keys, with one batched metric copy per chunk.
- The port's trajectories follow the row convention of ``Trajectory``.
- ``ImpalaArguments``' own LSTM model learns on a JAX unroll as the JAX
  step does, and the port's loop carries its state across chunks.
- ``run_until``: the windowed return against a hand-computed sequence, the
  stop at a hit with the in-flight chunks landing, ``should_stop``, and the
  same stream for one chunk in flight or more.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import args_pair, assert_params_close, state_to_torch, to_numpy

from scalerl_torch.agents import impala as timpala
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
from scalerl_torch.ops import cuda_vtrace
from scalerl_torch.runtime import dispatch
from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.envs.jax_envs.base import JaxVecEnv
from scalerl_tpu.envs.jax_envs.synthetic import SyntheticPixelEnv as JaxSyntheticPixelEnv
from scalerl_tpu.runtime.device_loop import DeviceActorLearnerLoop as JaxLoop

torch.set_num_threads(1)

T, B, ITERS = 5, 4, 2
SIZE = 24  # 24x24x4 frames, one stripe column per cell


def _jax_loop(jargs, iters_per_call=1):
    env = JaxSyntheticPixelEnv(size=SIZE)
    agent = jimpala.ImpalaAgent(jargs, obs_shape=env.observation_shape,
                                num_actions=env.num_actions)
    loop = JaxLoop(agent.model, JaxVecEnv(env, num_envs=B), agent.make_learn_fn(),
                   unroll_length=T, iters_per_call=iters_per_call)
    return agent, loop


def _port_loop(targs, seed=0):
    env = SyntheticPixelEnv(num_envs=B, size=SIZE, device="cpu")
    agent = timpala.ImpalaAgent(targs, env.observation_shape, env.num_actions, device="cpu")
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(),
                                  unroll_length=T, iters_per_call=ITERS, seed=seed,
                                  device="cpu")
    return agent, loop


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "kernel"])
def test_learn_on_a_jax_unroll_matches_jax(use_pallas):
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=use_pallas)
    jagent, jloop = _jax_loop(jargs)
    key = jax.random.PRNGKey(0)
    carry = jloop.init_carry(key)
    _, jtraj = jax.jit(jloop._unroll)(jagent.state.params, carry, jax.random.PRNGKey(1))
    model = timpala.build_model(targs, (SIZE, SIZE, 4), 6, device="cpu")
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    tstate = state_to_torch(jagent.state)
    ttraj = Trajectory(**{
        k: torch.tensor(np.asarray(v)) for k, v in vars(to_numpy(jtraj)).items()
        if k != "core_state"
    })
    jstate, jm = jax.jit(jagent.make_learn_fn())(jagent.state, jtraj)
    tstate, tm = tlearn(tstate, ttraj)
    assert_params_close(tstate.params, jstate.params)
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-5)


def test_port_loop_runs_chunks_with_the_jax_metric_keys(monkeypatch):
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=True)
    jagent, jloop = _jax_loop(jargs)
    key = jax.random.PRNGKey(0)
    _, _, jmetrics = jloop.run(jagent.state, jloop.init_carry(key), key, num_calls=1,
                               instrument=False)

    copies = []
    real_get = dispatch._device_get
    monkeypatch.setattr(dispatch, "_device_get", lambda x: copies.append(1) or real_get(x))
    monkeypatch.setattr(cuda_vtrace, "launches", 0)
    agent, loop = _port_loop(targs)
    seen = []
    state, carry, metrics = loop.run(agent.state, loop.init_carry(), num_calls=3,
                                     on_metrics=lambda i, m: seen.append(i))
    assert set(metrics) == set(jmetrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert seen == [0, 1, 2] and len(copies) == 3  # one batched copy per chunk
    assert int(state.env_frames) == 3 * T * B * ITERS
    assert int(state.step) == 3 * ITERS
    assert cuda_vtrace.launches == 0  # host tensors take the plain version


def test_trajectory_follows_the_row_convention():
    _, targs = args_pair(rollout_length=T, batch_size=B)
    agent, loop = _port_loop(targs, seed=3)
    carry = loop.init_carry()
    new_carry, traj = loop._unroll(agent.state.params, carry)
    A = loop.venv.num_actions
    assert traj.obs.shape == (T + 1, B, SIZE, SIZE, 4)
    assert traj.logits.shape == (T + 1, B, A)
    assert bool((traj.logits[-1] == 0).all())  # last row unused, left zero
    torch.testing.assert_close(traj.obs[0], carry.obs)
    torch.testing.assert_close(traj.action[0], carry.last_action)
    torch.testing.assert_close(traj.obs[-1], new_carry.obs)
    # the action taken at obs[t] is action[t+1]; it earns reward[t+1], which
    # is 1 exactly when it is the correct action of the cell shown in obs[t]
    cell = (traj.obs[:-1, :, 0, :, 0] == 255).int().argmax(-1)  # stripe column
    correct = traj.action[1:] == cell % A
    torch.testing.assert_close(traj.reward[1:], correct.float())


def _core_to_torch(core):
    return tuple(tuple(torch.tensor(np.asarray(x)) for x in layer) for layer in core)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "kernel"])
def test_lstm_learn_on_a_jax_unroll_matches_jax(use_pallas):
    """``ImpalaArguments``' own model (conv + 2-layer LSTM) learns from the
    JAX loop's second unroll: a carried, non-zero core state and episodes
    that end mid-sequence (episodes of 3 steps in a T=5 unroll)."""
    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=use_pallas,
                             use_lstm=True)
    env = JaxSyntheticPixelEnv(size=SIZE, episode_length=3)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=env.observation_shape,
                                 num_actions=env.num_actions)
    jloop = JaxLoop(jagent.model, JaxVecEnv(env, num_envs=B), jagent.make_learn_fn(),
                    unroll_length=T, iters_per_call=1)
    unroll = jax.jit(jloop._unroll)
    carry, _ = unroll(jagent.state.params, jloop.init_carry(jax.random.PRNGKey(0)),
                      jax.random.PRNGKey(1))
    _, jtraj = unroll(jagent.state.params, carry, jax.random.PRNGKey(2))
    done = np.asarray(jtraj.done)
    assert done[1:-1].any() and len(jtraj.core_state) == 2
    assert float(np.abs(np.asarray(jtraj.core_state[1][1])).sum()) > 0
    model = timpala.build_model(targs, (SIZE, SIZE, 4), env.num_actions, device="cpu")
    tlearn = timpala.make_impala_learn_fn(model, timpala.make_impala_optimizer(targs), targs)
    tstate = state_to_torch(jagent.state)
    ttraj = Trajectory(**{
        k: torch.tensor(np.asarray(v)) for k, v in vars(to_numpy(jtraj)).items()
        if k != "core_state"
    }, core_state=_core_to_torch(jtraj.core_state))
    jstate, jm = jax.jit(jagent.make_learn_fn())(jagent.state, jtraj)
    tstate, tm = tlearn(tstate, ttraj)
    assert_params_close(tstate.params, jstate.params)
    assert any(k.startswith("core.") for k in tstate.params)
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-5)


def test_port_loop_carries_the_lstm_state_across_chunks():
    _, targs = args_pair(rollout_length=T, batch_size=B, use_lstm=True)
    agent, loop = _port_loop(targs)
    carry = loop.init_carry()
    assert len(carry.core_state) == 2 and not carry.core_state[0][0].any()
    carry, traj = loop._unroll(agent.state.params, carry)
    assert traj.core_state[0][0].shape == (B, 32 + 6 + 1) and not traj.core_state[0][0].any()
    carry2, traj2 = loop._unroll(agent.state.params, carry)
    assert traj2.core_state is carry.core_state and bool(carry.core_state[1][1].any())
    state, carry3, metrics = loop.run(agent.state, carry2, num_calls=1)
    assert int(state.step) == ITERS and all(np.isfinite(v) for v in metrics.values())


# ---------------------------------------------------------------------------
# run_until


class _ScriptedLoop(DeviceActorLearnerLoop):
    """A loop whose chunks return scripted episode sums (return, count)."""

    def __init__(self, sums, **kw):
        env = SyntheticPixelEnv(num_envs=B, size=SIZE, device="cpu")
        super().__init__(torch.nn.Linear(1, 1), env, None, unroll_length=T, iters_per_call=ITERS,
                         device="cpu")
        self.sums = sums
        self.dispatched = 0

    def train_chunk(self, state, carry):
        s, c = self.sums[self.dispatched]
        self.dispatched += 1
        return state + 1, carry, {"total_loss": torch.tensor(float(self.dispatched)),
                                  "episode_return_sum": torch.tensor(float(s)),
                                  "episode_count_sum": torch.tensor(float(c))}


def _carry0():
    zeros = torch.zeros(B)
    return SimpleNamespace(return_sum=zeros, episode_count=zeros)


# cumulative (return sum, episode count) after each chunk, and the windowed
# return each must give: the mean over the episodes completed since the last
# chunk that completed any (none yet: NaN; none this chunk: unchanged)
SCRIPT = [(0, 0), (3, 2), (3, 2), (10, 4), (10, 4), (13, 7), (40, 10), (41, 11), (50, 12)]
WINDOWED = [math.nan, 1.5, 1.5, 3.5, 3.5, 1.0, 9.0, 1.0, 9.0]


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_run_until_windowed_return_and_stream(in_flight):
    loop = _ScriptedLoop(SCRIPT)
    seen = []
    state, _, summary = loop.run_until(0, _carry0(), threshold=1e9, max_calls=len(SCRIPT),
                                       on_metrics=lambda f, w, m: seen.append((f, w, m)),
                                       chunks_in_flight=in_flight)
    frames_per_call = T * B * ITERS
    assert [f for f, _, _ in seen] == [(i + 1) * frames_per_call for i in range(len(SCRIPT))]
    np.testing.assert_array_equal([w for _, w, _ in seen], WINDOWED)
    assert [m["total_loss"] for _, _, m in seen] == [float(i + 1) for i in range(len(SCRIPT))]
    assert summary == {"windowed_return": 9.0, "frames": float(len(SCRIPT) * frames_per_call),
                       "hit": False, "nonfinite_chunks": 0.0}
    assert state == len(SCRIPT)


@pytest.mark.parametrize("in_flight", [1, 2])
def test_run_until_stops_dispatch_at_a_hit(in_flight):
    """The windowed return first reaches 3.5 at chunk 3: no chunk is
    dispatched after the read that saw it, and the chunks already in
    flight land and count."""
    loop = _ScriptedLoop(SCRIPT)
    seen = []
    state, _, summary = loop.run_until(0, _carry0(), threshold=3.5, max_calls=len(SCRIPT),
                                       on_metrics=lambda f, w, m: seen.append(w),
                                       chunks_in_flight=in_flight)
    assert summary["hit"] and loop.dispatched == state == 4 + in_flight - 1
    assert summary["frames"] == loop.dispatched * T * B * ITERS
    np.testing.assert_array_equal(seen, WINDOWED[:loop.dispatched])


def test_run_until_should_stop_and_carried_counts():
    """``should_stop`` is polled before every dispatch; the window starts
    from the episodes the carry already counts."""
    loop = _ScriptedLoop(SCRIPT)
    carry = SimpleNamespace(return_sum=torch.tensor([2.0, 1.0]), episode_count=torch.ones(2))
    polls = []
    _, _, summary = loop.run_until(0, carry, threshold=1e9, max_calls=len(SCRIPT),
                                   should_stop=lambda: polls.append(1) or len(polls) > 4)
    assert loop.dispatched == 4 and len(polls) == 5
    assert summary["windowed_return"] == (10 - 3) / (4 - 2)  # from (3, 2) carried


def test_run_until_drives_the_port_loop_in_both_pipelines():
    """The real loop on the host: the same seed gives the same metric
    stream and frames with one chunk in flight or two."""
    _, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=True)
    streams, summaries = [], []
    for in_flight in (1, 2):
        agent, loop = _port_loop(targs, seed=5)
        seen = []
        state, _, summary = loop.run_until(
            agent.state, loop.init_carry(), threshold=1e9, max_calls=3,
            on_metrics=lambda f, w, m: seen.append((f, w, m["total_loss"])),
            chunks_in_flight=in_flight)
        streams.append(seen)
        summaries.append(summary)
        assert int(state.step) == 3 * ITERS and not summary["hit"]
    assert streams[0] == streams[1] and summaries[0] == summaries[1]
    assert summaries[0]["frames"] == 3 * T * B * ITERS


def test_learning_recipe_runs_on_the_host():
    """``tools/torch_learning_curves.py``'s scaffold, cut to a few chunks:
    the row the reference's recipe returns, with the loop's learner steps."""
    from tools.torch_learning_curves import run_fused_to_threshold

    from scalerl_torch.envs.tensor_envs import TensorRecall

    seen = []
    row = run_fused_to_threshold(
        lambda n: TensorRecall(n, size=8, delay=2, device="cpu"), threshold=0.8,
        max_frames=3 * 4 * 3 * 2, learning_rate=1e-3, num_envs=4, unroll=3, iters_per_call=2,
        use_lstm=True, hidden_size=16, device="cpu",
        on_chunk=lambda f, w, m: seen.append(f))
    assert seen == [24, 48, 72] and row["frames"] == 72 and row["learner_steps"] == 6
    assert set(row) >= {"threshold", "final_return", "frames_to_threshold", "seconds",
                        "frames_per_s", "passed", "seed", "nonfinite_chunks"}
    assert row["passed"] == (row["frames_to_threshold"] is not None)


def test_synthetic_probe_reads_the_policy_in_every_cell():
    from tools.torch_learning_curves import synthetic_action_probs

    _, targs = args_pair(rollout_length=T, batch_size=B)
    agent, loop = _port_loop(targs)
    params = dict(agent.state.params)
    out = synthetic_action_probs(agent.model, params, loop.venv)
    probs = torch.tensor(out["action_probs"])
    assert probs.shape == (loop.venv.num_states, loop.venv.num_actions)
    torch.testing.assert_close(probs.sum(-1), torch.ones(loop.venv.num_states))
    assert out["dead_actions"] == []
    # a policy head that never picks action 2 has it dead in every cell
    params["policy.bias"] = params["policy.bias"].clone()
    params["policy.bias"][2] = -50.0
    assert synthetic_action_probs(agent.model, params, loop.venv)["dead_actions"] == [2]


# ---------------------------------------------------------------------------
# Anakin: N chunks as one dispatch


def _clone_tree(tree):
    from scalerl_torch.utils.tree import tree_map

    return tree_map(torch.clone, tree)


def test_run_anakin_equals_run_chunk_for_chunk_bit_for_bit(monkeypatch):
    """``run_anakin(N)`` from a state, carry and generator state gives the
    params, carry and per-chunk metric stream of N ``run()`` chunks from
    the same start, bit for bit, with one batched copy for all N."""
    _, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=True)
    agent, loop = _port_loop(targs, seed=4)
    carry0 = loop.init_carry()
    state0, gen0 = _clone_tree(agent.state), loop.generator.get_state()
    n = 3
    run_stream = []
    s_run, c_run, m_run = loop.run(_clone_tree(state0), _clone_tree(carry0), num_calls=n,
                                   on_metrics=lambda i, m: run_stream.append((i, dict(m))),
                                   instrument=False)
    loop.generator.set_state(gen0)
    copies = []
    real_get = dispatch._device_get
    monkeypatch.setattr(dispatch, "_device_get", lambda x: copies.append(1) or real_get(x))
    ana_stream = []
    s_ana, c_ana, m_ana = loop.run_anakin(_clone_tree(state0), _clone_tree(carry0), num_calls=n,
                                          on_metrics=lambda i, m: ana_stream.append((i, dict(m))),
                                          instrument=False)
    assert len(copies) == 1
    assert ana_stream == run_stream
    assert m_ana == m_run and m_ana["chunks_done"] == float(n)
    for k in s_run.params:
        assert torch.equal(s_run.params[k], s_ana.params[k]), k
    from scalerl_torch.utils.tree import tree_leaves

    for a, b in zip(tree_leaves((s_run, c_run)), tree_leaves((s_ana, c_ana))):
        assert torch.equal(a, b)
    assert int(s_ana.step) == n * ITERS
    assert torch.equal(loop.generator.get_state(), _after_run_generator(targs, n))


def _after_run_generator(targs, n):
    agent, loop = _port_loop(targs, seed=4)
    loop.run(agent.state, loop.init_carry(), num_calls=n, instrument=False)
    return loop.generator.get_state()


def test_run_anakin_metric_keys_match_jax_and_meters_mark_once():
    from scalerl_torch.runtime import telemetry

    jargs, targs = args_pair(rollout_length=T, batch_size=B, use_pallas=True)
    jagent, jloop = _jax_loop(jargs)
    key = jax.random.PRNGKey(0)
    # num_calls=2: the JAX run_anakin(num_calls=1) raises TypeError, since
    # its get_metrics returns one-element arrays as floats
    _, _, jmetrics = jloop.run_anakin(jagent.state, jloop.init_carry(key), key, num_calls=2,
                                      instrument=False)
    telemetry.reset()
    agent, loop = _port_loop(targs)
    seen = []
    state, _, metrics = loop.run_anakin(agent.state, loop.init_carry(), num_calls=2,
                                        on_metrics=lambda i, m: seen.append((i, set(m))))
    assert set(metrics) == set(jmetrics)
    assert [i for i, _ in seen] == [0, 1]
    _, _, one = loop.run_anakin(state, loop.init_carry(), num_calls=1, instrument=False)
    assert set(one) == set(jmetrics) and one["chunks_done"] == 1.0
    assert all(keys == set(jmetrics) - {"chunks_done", "nonfinite_chunks"} for _, keys in seen)
    snap = telemetry.get_registry().snapshot()
    assert snap["rates"]["chunks_per_s"]["total"] == 2
    assert snap["rates"]["fps"]["total"] == 2 * T * B * ITERS
    # a second call of the same length is the warm one: under the guard
    assert 2 in loop._superchunk_warm
    telemetry.reset()


@pytest.mark.parametrize("stop_after", [None, 3, 1])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_drive_matches_jax_order_and_count(depth, stop_after):
    import jax.numpy as jnp

    from scalerl_tpu.runtime import dispatch as jdispatch

    def drive(mod, make):
        payloads = [{"v": make(float(i))} for i in range(6)]
        seen = []
        stop = None if stop_after is None else (lambda: len(seen) >= stop_after)
        n = mod.pipelined_drive(lambda i: payloads[i], num_calls=6,
                                on_ready=lambda i, m: seen.append((i, m["v"])),
                                depth=depth, stop=stop)
        return n, seen

    assert drive(dispatch, torch.tensor) == drive(jdispatch, jnp.float32)
