"""The port's process-actor IMPALA (the monobeast topology over the shm
ring) against the JAX package's.

- The ring's slot layout and ``_batch_to_host`` of the same slots equal
  the JAX trainer's exactly (feed-forward and LSTM cores), weight lag too;
- end to end on the host: spawned actors with their own CPU ``ImpalaAgent``
  fill slots, the learner learns and publishes versioned weights, children
  load neither JAX nor CUDA and run one torch thread each, and teardown
  joins every child and unlinks the ring;
- a failing actor funnels its traceback to the learner, which raises; with
  an elastic budget a crashed actor is respawned and training completes;
- a killed run resumes from its checkpoint, bit for bit, through the entry
  point's ``--actor-mode process``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from scalerl_torch.agents.impala import ImpalaAgent as TAgent
from scalerl_torch.config import ImpalaArguments as TArgs
from scalerl_torch.trainer.process_actor_learner import ProcessActorLearnerTrainer as TTrainer
from scalerl_tpu.agents.impala import ImpalaAgent as JAgent
from scalerl_tpu.config import ImpalaArguments as JArgs
from scalerl_tpu.trainer.process_actor_learner import ProcessActorLearnerTrainer as JTrainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "scalerl_tpu"}


def _args(cls, tmp_path, **kw):
    base = dict(env_id="CartPole-v1", num_envs=4, rollout_length=8, batch_size=4, num_actors=2,
                num_buffers=8, use_lstm=False, hidden_size=32, logger_backend="none",
                logger_frequency=10**9, work_dir=str(tmp_path), save_model=False,
                max_timesteps=10**9)
    base.update(kw)
    if cls is TArgs:
        base["telemetry_interval_s"] = 0.0
    return cls(**base)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_batch_to_host_equals_the_jax_trainer(tmp_path, use_lstm):
    obs_shape = (6, 6, 2)  # pixel observations: the uint8 slot
    jargs = _args(JArgs, tmp_path / "jax", use_lstm=use_lstm, num_envs=6, num_actors=3,
                  batch_size=6, num_buffers=6)
    targs = _args(TArgs, tmp_path / "torch", use_lstm=use_lstm, num_envs=6, num_actors=3,
                  batch_size=6, num_buffers=6)
    jtr = JTrainer(jargs, JAgent(jargs, obs_shape=obs_shape, num_actions=3,
                                 obs_dtype=np.uint8))
    ttr = TTrainer(targs, TAgent(targs, obs_shape, 3, device="cpu"))
    try:
        assert ttr.ring.spec.fields == jtr.ring.spec.fields
        assert ttr.ring.spec.offsets == jtr.ring.spec.offsets
        rng = np.random.default_rng(0)
        payloads = []
        for _ in range(3):
            slot = {}
            for name, (shape, dtype) in ttr.ring.spec.fields.items():
                if dtype == np.uint8:
                    slot[name] = rng.integers(0, 255, size=shape).astype(dtype)
                elif dtype == np.bool_:
                    slot[name] = rng.random(shape) < 0.3
                else:
                    slot[name] = rng.normal(size=shape).astype(dtype)
            slot["meta"][:] = [1.0, float(rng.integers(0, 3))]
            payloads.append(slot)
        for tr in (jtr, ttr):
            tr.param_server.push({"w": np.zeros(1, np.float32)} if tr is jtr
                                 else {"w": torch.zeros(1)})
            idxs = []
            for slot in payloads:
                idx = tr.ring.acquire(timeout=1.0)
                views = tr.ring.slot(idx)
                for k, v in slot.items():
                    views[k][...] = v
                views = None
                idxs.append(idx)
            tr._test_idxs = [idxs[2], idxs[0], idxs[1]]
        jb, tb = jtr._batch_to_host(jtr._test_idxs), ttr._batch_to_host(ttr._test_idxs)
        assert list(jb) == list(tb)
        for name in jb:
            assert jb[name].dtype == tb[name].dtype and jb[name].shape == tb[name].shape
            np.testing.assert_array_equal(jb[name], tb[name], err_msg=name)
        assert jtr._lag == ttr._lag
        assert tb["obs"].shape == (9, 6) + obs_shape and (not use_lstm or "core_0_c" in tb)
    finally:
        jtr.ring.unlink()
        ttr.stop()


def _check_teardown(tr):
    assert all(not p.is_alive() for p in tr.procs)
    assert not Path("/dev/shm", tr.ring.shm.name.lstrip("/")).exists()


def test_process_actor_learner_smoke(tmp_path):
    """Actors in spawned processes fill shm slots with their own CPU policy;
    the learner drains, learns, and publishes versioned weights back."""
    args = _args(TArgs, tmp_path, use_pallas=True)
    agent = TAgent(args, (4,), 2, device="cpu")
    tr = TTrainer(args, agent)
    result = tr.train(total_frames=256)
    assert result["env_frames"] >= 256 and np.isfinite(result["total_loss"])
    assert int(agent.state.step) == tr.learn_steps > 0
    assert tr.param_server.version == tr.learn_steps + 1
    assert tr.child_reports, "no child reported what it loaded"
    for report in tr.child_reports.values():
        assert report["cuda_initialized"] is False and report["torch_threads"] == 1
        assert not FORBIDDEN & set(report["modules"])
    assert [p.exitcode for p in tr.procs] == [0, 0]
    _check_teardown(tr)
    tr.close()


def test_process_actor_error_funnels_to_learner(tmp_path):
    """A crashing actor surfaces in the learner instead of hanging it."""
    args = _args(TArgs, tmp_path, env_id="NoSuchEnv-v99")
    tr = TTrainer(args, TAgent(args, (4,), 2, device="cpu"))
    with pytest.raises(RuntimeError, match="actor process failed(.|\n)*NoSuchEnv"):
        tr.train(total_frames=256)
    _check_teardown(tr)
    tr.close()


def test_process_actor_pull_timeout_fails_the_learner(tmp_path, monkeypatch):
    """A weight service that never answers: each actor's pull times out and
    funnels as a failure, so the learner raises instead of waiting for
    slots that no actor will fill."""
    args = _args(TArgs, tmp_path)
    tr = TTrainer(args, TAgent(args, (4,), 2, device="cpu"))
    tr.pull_timeout_s = 1.0
    monkeypatch.setattr(tr, "_answer_pull", lambda conn, have: None)
    with pytest.raises(RuntimeError, match="actor process failed(.|\n)*TimeoutError"):
        tr.train(total_frames=256)
    _check_teardown(tr)
    # the first failure stops the run; a later actor may see the ring closed
    assert 1 in [p.exitcode for p in tr.procs]
    tr.close()


def test_process_actor_elastic_restart(tmp_path, monkeypatch):
    """An actor whose env faults once (a funneled failure) is respawned
    within the budget and training completes."""
    monkeypatch.setenv("SCALERL_CRASH_MARKER", str(tmp_path / "crash_marker"))
    args = _args(TArgs, tmp_path, env_id="tests.crash_env:CrashOnceEnv", num_actors=1,
                 num_envs=2, num_buffers=8)
    tr = TTrainer(args, TAgent(args, (4,), 2, device="cpu"), max_actor_restarts=1)
    result = tr.train(total_frames=512)
    assert result["env_frames"] >= 512
    assert tr.actor_restarts == 1 and (tmp_path / "crash_marker").exists()
    _check_teardown(tr)
    tr.close()


def _example():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_impala_torch", REPO / "examples" / "train_impala_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_process_actor_kill_and_resume_through_the_entry_point(tmp_path):
    """``--actor-mode process`` through the entry point; a second run with
    ``--resume`` restores the learner state bit for bit and the frame
    counter, then continues."""
    from scalerl_torch.utils.checkpoint import load_checkpoint

    common = ["--device", "cpu", "--actor-mode", "process", "--env-id", "CartPole-v1",
              "--num-envs", "4", "--num-actors", "2", "--num-buffers", "8",
              "--rollout-length", "8", "--batch-size", "4", "--use-lstm", "false",
              "--hidden-size", "32", "--logger-backend", "none", "--telemetry-interval-s", "0",
              "--save-frequency", "128", "--work-dir", str(tmp_path)]
    first = _example().main(common + ["--max-timesteps", "256"])
    tr_a = first["trainer"]
    assert isinstance(tr_a, TTrainer) and tr_a.env_frames >= 256
    saved = load_checkpoint(tr_a.resume_ckpt_path)
    step_a = int(first["agent"].state.step)
    assert step_a > 0 and int(saved["env_frames"]) == tr_a.env_frames

    args_b = _args(TArgs, tmp_path, save_model=True, save_frequency=128,
                   resume=tr_a.work_dir)
    agent_b = TAgent(args_b, (4,), 2, device="cpu")
    tr_b = TTrainer(args_b, agent_b)
    assert tr_b.work_dir == tr_a.work_dir
    assert tr_b.try_resume() and tr_b.env_frames == tr_a.env_frames
    assert all(torch.equal(a, b) for a, b in zip(first["agent"].state.params.values(),
                                                 agent_b.state.params.values()))
    tr_b.train(total_frames=tr_a.env_frames + 128)
    assert tr_b.env_frames >= tr_a.env_frames + 128
    assert int(agent_b.state.step) > step_a
    _check_teardown(tr_b)
    tr_b.close()
