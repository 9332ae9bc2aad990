"""The port's multi-agent env plane against the JAX package's.

- ``PursuitToyEnv`` in process, and ``AsyncMultiAgentVecEnv`` over env
  subprocesses, in both packages: the same observations, rewards, dones,
  infos and terminal observations for the same seed and actions;
- the shared-memory plane's layout and its visibility across processes;
- the async state machine, attribute passthrough, a funneled env error, and
  a killed env worker, which raises in the caller instead of hanging;
- the auto-reset wrapper and the single-agent adapter;
- pettingzoo's ``pursuit_v4`` through the port's wrapper and vec env, where
  pettingzoo is installed.
"""

import multiprocessing as mp
import time

import numpy as np
import pytest
import torch
import torch_fleet_helpers as helpers

from scalerl_torch.envs import multi_agent as tma
from scalerl_torch.envs import vector as tvec
from scalerl_tpu.envs import multi_agent as jma
from scalerl_tpu.envs import vector as jvec

torch.set_num_threads(1)

NUM_ENVS = 3


def _actions(rng, n):
    return {"chaser": rng.integers(0, 3, n).astype(np.int64),
            "runner": rng.integers(0, 3, n).astype(np.int64)}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    return x


@pytest.mark.parametrize("episode_limit", [32, 5])
def test_pursuit_toy_env_matches_jax(episode_limit):
    rng = np.random.default_rng(episode_limit)
    envs = [mod.PursuitToyEnv(episode_limit=episode_limit) for mod in (jma, tma)]
    for seed in (0, 3):
        outs = [_plain(e.reset(seed=seed)) for e in envs]
        assert outs[1] == outs[0]
        for _ in range(3 * episode_limit):
            acts = {k: int(v[0]) for k, v in _actions(rng, 1).items()}
            outs = [_plain(e.step(acts)) for e in envs]
            assert outs[1] == outs[0]
            if any(outs[0][2].values()) or any(outs[0][3].values()):
                break
    assert (tma.PursuitToyEnv().observation_space("chaser").shape
            == jma.PursuitToyEnv().observation_space("chaser").shape)


def _vec_trace(vec_mod, ma_mod, steps=45):
    vec = vec_mod.AsyncMultiAgentVecEnv([ma_mod.PursuitToyEnv] * NUM_ENVS, context="spawn")
    rng = np.random.default_rng(0)
    try:
        trace = [_plain(vec.reset(seed=7))]
        for _ in range(steps):  # past episode_limit 32: autoreset with infos
            trace.append(_plain(vec.step(_actions(rng, NUM_ENVS))))
        trace.append(vec.get_attr("episode_limit"))
    finally:
        vec.close()
    return trace


def test_async_vec_env_matches_jax_for_the_same_seed_and_actions():
    want = _vec_trace(jvec, jma)
    got = _vec_trace(tvec, tma)
    assert got == want
    infos = [step[4] for step in got[1:-1]]
    assert any("final_observation" in i and "episode" in i for step in infos for i in step)


def test_shared_plane_layout_and_zero_copy():
    spec = tvec.ExperienceSpec({"a": ((2, 2), np.uint8), "b": ((3,), np.float32)}, num_envs=4)
    jspec = jvec.ExperienceSpec({"a": ((2, 2), np.uint8), "b": ((3,), np.float32)}, num_envs=4)
    assert spec.total_bytes() == jspec.total_bytes() and spec.agents == jspec.agents
    plane = tvec.SharedObservationPlane(spec)
    assert plane.view("a").shape == (4, 2, 2) and plane.view("a").dtype == np.uint8
    plane.write_env(2, {"a": np.full((2, 2), 7, np.uint8), "b": np.ones(3)})
    np.testing.assert_array_equal(plane.view("a")[2], 7)
    batch = plane.read_batch(copy=False)
    assert batch["b"][2, 0] == 1.0 and batch["a"][0].sum() == 0
    plane.zero_env(2, "a")
    assert plane.read_batch()["a"].sum() == 0


def test_shared_plane_visible_across_processes():
    plane = tvec.SharedObservationPlane(tvec.ExperienceSpec({"x": ((2,), np.float32)}, 2))
    p = mp.get_context("spawn").Process(target=helpers.plane_writer_child, args=(plane, 1))
    p.start()
    p.join(timeout=60.0)
    assert p.exitcode == 0
    np.testing.assert_array_equal(plane.view("x")[1], [3.0, 4.0])


@pytest.fixture(scope="module")
def vec():
    env = tvec.AsyncMultiAgentVecEnv([tma.PursuitToyEnv] * NUM_ENVS, context="spawn")
    yield env
    env.close()


def test_state_machine_guards(vec):
    vec.reset(seed=0)
    vec.step_async(_actions(np.random.default_rng(0), NUM_ENVS))
    with pytest.raises(tvec.AlreadyPendingCallError):
        vec.reset_async()
    vec.step_wait()
    with pytest.raises(tvec.NoAsyncCallError):
        vec.step_wait()


def test_call_and_attrs(vec):
    assert vec.get_attr("episode_limit") == [32] * NUM_ENVS
    vec.set_attr("episode_limit", [8, 16, 24])
    assert vec.get_attr("episode_limit") == [8, 16, 24]
    assert all(s.n == 3 for s in vec.call("action_space", "chaser"))
    vec.set_attr("episode_limit", 32)


def _spaces():
    return {"chaser": ((4,), np.float32), "runner": ((4,), np.float32)}


def test_worker_error_is_funneled_to_the_caller():
    env = tvec.AsyncMultiAgentVecEnv([tma.PursuitToyEnv, helpers.crashing_pursuit],
                                     obs_spaces=_spaces(), context="spawn")
    try:
        env.reset(seed=0)
        with pytest.raises(RuntimeError, match="boom at step"):
            env.step(_actions(np.random.default_rng(0), 2))
    finally:
        env.close(terminate=True)


@pytest.mark.parametrize("when", ["between_steps", "while_waiting"])
def test_a_killed_env_worker_raises_in_the_caller(when):
    env = tvec.AsyncMultiAgentVecEnv([tma.PursuitToyEnv] * 2, obs_spaces=_spaces(),
                                     context="spawn")
    acts = _actions(np.random.default_rng(0), 2)
    try:
        env.reset(seed=0)
        t0 = time.monotonic()
        if when == "between_steps":
            env.processes[1].kill()
            env.processes[1].join(timeout=10.0)
            with pytest.raises(RuntimeError, match="env worker 1"):
                env.step(acts, timeout=30.0)
        else:
            env.step_async(acts)
            env.step_wait()
            env.processes[0].kill()
            env.processes[0].join(timeout=10.0)
            env._state = tvec.AsyncState.WAITING_STEP  # a step already sent
            with pytest.raises(RuntimeError, match="env worker 0 died"):
                env.step_wait(timeout=30.0)
        assert time.monotonic() - t0 < 20.0
    finally:
        env.close(terminate=True)


def test_autoreset_wrapper_resets_as_jax_does():
    outs = []
    for mod in (jma, tma):
        env = mod.AutoResetParallelWrapper(mod.PursuitToyEnv(episode_limit=2))
        trace = [_plain(env.reset(seed=1))]
        for _ in range(6):
            trace.append(_plain(env.step({"chaser": 1, "runner": 1})))
        outs.append(trace)
    assert outs[1] == outs[0]


def test_single_agent_adapter_and_shared_vec_envs():
    outs = []
    for mod in (jma, tma):
        env = mod.SingleAgentAdapter(helpers.CountEnv())
        trace = [_plain(env.reset(seed=2))]
        for a in (0, 1, 1):
            trace.append(_plain(env.step({"agent_0": a})))
        outs.append(trace)
    assert outs[1] == outs[0]
    vec = tma.make_shared_vec_envs(helpers.CountEnv, num_envs=2, context="spawn")
    try:
        obs, _ = vec.reset(seed=0)
        assert obs["agent_0"].shape == (2, 3) and obs["agent_0"].dtype == np.float32
        for _ in range(3):
            obs, rew, term, trunc, infos = vec.step({"agent_0": np.ones(2, np.int64)})
        assert rew["agent_0"].tolist() == [1.0, 1.0] and term["agent_0"].all()
        assert all("final_observation" in i for i in infos)
    finally:
        vec.close()


def test_pettingzoo_pursuit_through_the_port():
    pytest.importorskip("pettingzoo")
    env = tma.AutoResetParallelWrapper(helpers.make_pursuit())
    try:
        env.reset(seed=1)
        rng = np.random.default_rng(0)
        for _ in range(19):  # past two episode ends
            obs, *_ = env.step({a: int(rng.integers(5)) for a in env.possible_agents})
            assert set(obs) == set(env.possible_agents)
    finally:
        env.close()
    vec = tvec.AsyncMultiAgentVecEnv([helpers.make_pursuit] * 2, context="spawn")
    try:
        a0 = vec.agents[0]
        obs, _ = vec.reset(seed=3)
        assert obs[a0].shape == (2, 7, 7, 3) and obs[a0].dtype == np.float32
        done_seen = False
        for _ in range(11):
            obs, rew, term, trunc, infos = vec.step(
                {a: rng.integers(0, 5, size=2).astype(np.int64) for a in vec.agents})
            done_seen |= bool(np.any(trunc[a0]) or np.any(term[a0]))
        assert done_seen and rew[a0].shape == (2,)
    finally:
        vec.close()
