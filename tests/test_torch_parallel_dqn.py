"""The port's parallel-actor DQN against the JAX package's.

- The learner's drain: the same hand-written slabs, committed into each
  trainer's ring and drained, give exactly equal replay contents, cursors,
  priorities and ``max_priority``, for uniform replay (one chunked write a
  slab, wrapping the ring) and PER (row by row at the running max);
- the epsilon ladder equals the JAX trainer's;
- end to end on the host: spawned actors on ``TensorCartPole`` through
  ``make_host_envs`` feed the learner through the ring; learn steps run,
  the actors reach a published weight version, no child initializes CUDA
  or loads JAX, every child exits and the shared segment is unlinked.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from scalerl_torch.agents.dqn import DQNAgent as TDQNAgent
from scalerl_torch.config import DQNArguments as TArgs
from scalerl_torch.trainer.parallel_dqn import ParallelDQNTrainer as TTrainer
from scalerl_tpu.agents.dqn import DQNAgent as JDQNAgent
from scalerl_tpu.config import DQNArguments as JArgs
from scalerl_tpu.trainer.parallel_dqn import ParallelDQNTrainer as JTrainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "scalerl_tpu"}


def _args(cls, tmp_path, **kw):
    base = dict(hidden_sizes="16,16", rollout_length=20, buffer_size=32, batch_size=8,
                n_steps=3, logger_backend="none", save_model=False, work_dir=str(tmp_path))
    base.update(kw)
    if cls is TArgs:
        base["telemetry_interval_s"] = 0.0
    return cls(**base)


def _slab(seed: int, T: int):
    rng = np.random.default_rng(seed)
    done = rng.random(T) < 0.15
    return {
        "obs": rng.normal(size=(T, 4)).astype(np.float32),
        "action": rng.integers(0, 2, size=T).astype(np.int32),
        "reward": rng.normal(size=T).astype(np.float32),
        "next_obs": rng.normal(size=(T, 4)).astype(np.float32),
        "done": done,
        "boundary": done | (rng.random(T) < 0.1),
        "meta": np.array([seed, 1], np.int64),
    }


def _commit(ring, slab):
    idx = ring.acquire(timeout=1.0)
    views = ring.slot(idx)
    for k, v in slab.items():
        views[k][...] = v
    views = None
    ring.commit(idx)


@pytest.mark.parametrize("use_per", [False, True])
def test_drained_replay_state_equals_the_jax_trainer(tmp_path, use_per):
    jargs = _args(JArgs, tmp_path / "jax", use_per=use_per)
    targs = _args(TArgs, tmp_path / "torch", use_per=use_per)
    jtr = JTrainer(jargs, JDQNAgent(jargs, obs_shape=(4,), action_dim=2, donate_state=False),
                   env_id="CartPole-v1", obs_shape=(4,), num_actors=2, num_slots=4)
    ttr = TTrainer(targs, TDQNAgent(targs, (4,), 2, device="cpu"), env_id="CartPole-v1",
                   obs_shape=(4,), num_actors=2, num_slots=4)
    try:
        for round_ in range(2):  # 40 rows into 32: the second drain wraps
            for tr in (jtr, ttr):
                _commit(tr.ring, _slab(round_, 20))
                assert tr._drain() == 1
        assert jtr.env_steps == ttr.env_steps == 40
        if use_per:
            jstate, tstate = jtr.replay.state.replay, ttr.replay.state.replay
            np.testing.assert_array_equal(np.asarray(jtr.replay.state.priorities),
                                          ttr.replay.state.priorities.numpy())
            assert float(jtr.replay.state.max_priority) == float(ttr.replay.state.max_priority)
        else:
            jstate, tstate = jtr.replay.state, ttr.replay.state
        assert int(jstate.pos) == tstate.pos == 8 and int(jstate.size) == tstate.size == 32
        assert set(jstate.storage) == set(tstate.storage) and "boundary" in tstate.storage
        for name, arr in tstate.storage.items():
            np.testing.assert_array_equal(np.asarray(jstate.storage[name]),
                                          arr.numpy().astype(np.asarray(jstate.storage[name]).dtype),
                                          err_msg=name)
        assert len(jtr.replay) == len(ttr.replay) == 32
    finally:
        jtr.ring.unlink()
        ttr.stop()


@pytest.mark.parametrize("num_actors", [1, 4, 8])
def test_epsilon_ladder_equals_the_jax_trainer(tmp_path, num_actors):
    jargs, targs = _args(JArgs, tmp_path / "jax"), _args(TArgs, tmp_path / "torch")
    jtr = JTrainer(jargs, JDQNAgent(jargs, obs_shape=(4,), action_dim=2, donate_state=False),
                   env_id="CartPole-v1", obs_shape=(4,), num_actors=num_actors)
    ttr = TTrainer(targs, TDQNAgent(targs, (4,), 2, device="cpu"), env_id="CartPole-v1",
                   obs_shape=(4,), num_actors=num_actors)
    try:
        assert ttr._eps == jtr._eps and len(ttr._eps) == num_actors
    finally:
        jtr.ring.unlink()
        ttr.stop()


def test_categorical_dqn_is_refused(tmp_path):
    args = _args(TArgs, tmp_path, categorical_dqn=True)
    with pytest.raises(ValueError, match="C51"):
        TTrainer(args, TDQNAgent(args, (4,), 2, device="cpu"), env_id="CartPole-v1",
                 obs_shape=(4,))


def _check_finished(tr, result, steps: int):
    assert result["env_steps"] >= steps and result["learn_steps"] > 0
    assert tr.learn_steps == result["learn_steps"] and np.isfinite(result["loss"])
    assert tr.param_server.version >= 1 and result["episodes"] > 0
    assert all(not p.is_alive() for p in tr.procs) and [p.exitcode for p in tr.procs] == [0, 0]
    assert not Path("/dev/shm", tr.ring.shm.name.lstrip("/")).exists()  # unlinked
    assert tr.child_reports, "no child reported what it loaded"
    for report in tr.child_reports.values():
        assert report["cuda_initialized"] is False
        assert not FORBIDDEN & set(report["modules"]) and "scalerl_torch" in report["modules"]


@pytest.mark.parametrize("use_per", [False, True])
def test_parallel_dqn_trains_on_tensor_cartpole(tmp_path, use_per):
    args = _args(TArgs, tmp_path, hidden_sizes="32,32", rollout_length=32, buffer_size=4096,
                 batch_size=32, warmup_learn_steps=64, n_steps=1, logger_frequency=500,
                 use_per=use_per, use_pallas=use_per, env_backend="jax")
    agent = TDQNAgent(args, (4,), 2, device="cpu")
    tr = TTrainer(args, agent, env_id="CartPole-v1", obs_shape=(4,), num_actors=2, num_slots=4)
    result = tr.train(total_steps=2000)
    _check_finished(tr, result, 2000)
    assert any(kind == "train" for _, kind, _ in tr.log_history)
    tr.close()


def test_the_entry_point_runs_on_the_host(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_parallel_dqn_torch", REPO / "examples" / "train_parallel_dqn_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu", "--env-backend", "jax", "--max-timesteps", "2000",
                        "--num-actors", "2", "--rollout-length", "25", "--warmup-learn-steps",
                        "100", "--use-per", "--use-pallas", "--hidden-sizes", "32,32",
                        "--logger-backend", "none", "--telemetry-interval-s", "0",
                        "--save-model", "false", "--work-dir", str(tmp_path)])
    assert out["agent"].device.type == "cpu" and out["trainer"].use_per
    _check_finished(out["trainer"], out["result"], 2000)


def _small_trainer(tmp_path, env_id="CartPole-v1"):
    args = _args(TArgs, tmp_path, hidden_sizes="32,32", rollout_length=16, buffer_size=1024,
                 batch_size=16, warmup_learn_steps=32, n_steps=1, env_backend="jax")
    return TTrainer(args, TDQNAgent(args, (4,), 2, device="cpu"), env_id=env_id,
                    obs_shape=(4,), num_actors=2, num_slots=4)


def _check_torn_down(tr):
    assert all(not p.is_alive() for p in tr.procs)
    assert not Path("/dev/shm", tr.ring.shm.name.lstrip("/")).exists()


def test_parallel_dqn_actor_error_funnels_to_learner(tmp_path):
    """An actor whose env cannot be built sends its traceback, exits
    nonzero, and the learner raises instead of waiting for warm-up."""
    tr = _small_trainer(tmp_path, env_id="NoSuchEnv-v99")
    with pytest.raises(RuntimeError, match="actor process failed(.|\n)*NoSuchEnv"):
        tr.train(total_steps=2000)
    _check_torn_down(tr)
    # the first failure stops the run; a later actor may see the ring closed
    assert 1 in [p.exitcode for p in tr.procs]
    tr.close()


def test_parallel_dqn_pull_timeout_fails_the_learner(tmp_path, monkeypatch):
    """A weight service that never answers: the actors' pull times out,
    which is a failure they funnel, not a quiet exit the learner waits on."""
    tr = _small_trainer(tmp_path)
    tr.pull_timeout_s = 1.0
    monkeypatch.setattr(tr, "_answer_pull", lambda conn, have: None)
    with pytest.raises(RuntimeError, match="actor process failed(.|\n)*TimeoutError"):
        tr.train(total_steps=10**6)
    _check_torn_down(tr)
    tr.close()


def test_parallel_dqn_killed_actor_fails_the_learner(tmp_path):
    """An actor killed outright (no traceback to send) is seen dead by the
    weight service; the learner raises rather than training on."""
    import os
    import signal
    import threading

    tr = _small_trainer(tmp_path)

    def kill_first_actor():
        deadline = time.monotonic() + 60
        while tr.learn_steps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        os.kill(tr.procs[0].pid, signal.SIGKILL)

    threading.Thread(target=kill_first_actor, daemon=True).start()
    with pytest.raises(RuntimeError, match="actor process failed(.|\n)*actor 0: died"):
        tr.train(total_steps=10**6)
    _check_torn_down(tr)
    assert tr.procs[0].exitcode == -signal.SIGKILL
    tr.close()
