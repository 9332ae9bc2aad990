"""The fleet's entry-point twins against the JAX examples, and end to end.

- ``examples/train_fleet_impala_torch.py``: its ``ChunkRunner`` gives the
  JAX example's chunk for the same weights (the JAX agent's, converted) and
  the same env lanes; its learn step on a fleet batch agrees with the JAX
  ``ImpalaAgent``'s to 1e-5 in float32 (V-trace's plain version on the CPU,
  with and without ``use_pallas``);
- ``examples/train_a3c_fleet_torch.py``: a worker's A2C gradient agrees
  with ``scalerl_tpu``'s ``a3c_loss`` to 1e-5, and the learner's update
  from an uploaded gradient with its optax optimizer's to 1e-5, over three
  updates;
- a short run of each twin on the CPU: fleet IMPALA (every issued task
  answered exactly once), fleet DQN, the A3C fleet and independent DQN over
  the async multi-agent plane;
- each twin defaults to the card and raises without one.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.data.trajectory import batch_to_trajectory
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import a3c as ja3c
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.data.trajectory import batch_to_trajectory as jbatch_to_trajectory

from torch_port_helpers import flat_traj, jax_traj, state_to_torch, to_numpy, torch_traj

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
if str(EXAMPLES) not in sys.path:
    sys.path.insert(0, str(EXAMPLES))  # spawned workers unpickle the runners by name

fleet_impala = importlib.import_module("train_fleet_impala_torch")
fleet_dqn = importlib.import_module("train_fleet_dqn_torch")
a3c_fleet = importlib.import_module("train_a3c_fleet_torch")
marl_dqn = importlib.import_module("train_marl_dqn_torch")
jfleet_impala = importlib.import_module("train_fleet_impala")


class _LaneEnv:
    """Deterministic numpy lanes in gym's vector API: observations follow
    the actions taken, a lane ends every ``5 + lane`` steps and reports the
    reset observation at once (same-step autoreset)."""

    def __init__(self, lanes: int = 2):
        self.lanes = lanes
        self.t = np.zeros(lanes, np.int64)
        self.x = np.zeros((lanes, 4), np.float32)

    def step(self, action):
        self.t += 1
        self.x = (self.x * 0.9 + np.stack([action, -action, self.t % 3, 1.0 * action],
                                          axis=-1)).astype(np.float32)
        done = self.t >= 5 + np.arange(self.lanes)
        self.t[done] = 0
        self.x[done] = 0.1
        return self.x.copy(), np.ones(self.lanes), done, np.zeros_like(done), {}


def _runner_pair(lanes=2, T=16):
    runners = (jfleet_impala.ChunkRunner(num_lanes=lanes, rollout_length=T),
               fleet_impala.ChunkRunner(num_lanes=lanes, rollout_length=T))
    for r in runners:
        r._live = [_LaneEnv(lanes), np.zeros((lanes, 4), np.float32), np.zeros(lanes, np.int32),
                   np.zeros(lanes, np.float32), np.ones(lanes, bool), np.zeros(lanes),
                   np.random.default_rng(3)]
    return runners


def _fleet_agents(use_pallas):
    kw = dict(env_id="CartPole-v1", use_lstm=False, hidden_size=64, rollout_length=16,
              batch_size=8, num_buffers=4, learning_rate=2e-3, entropy_cost=0.01,
              max_timesteps=10_000)
    jagent = jimpala.ImpalaAgent(jconfig.ImpalaArguments(**kw), obs_shape=(4,), num_actions=2,
                                 obs_dtype=np.float32)
    targs = fleet_impala.fleet_impala_args(total_frames=10_000, use_pallas=use_pallas)
    from scalerl_torch.agents.impala import ImpalaAgent

    tagent = ImpalaAgent(targs, (4,), 2, device="cpu")
    tagent.state = state_to_torch(jagent.state, tree_to_torch=convert.mlp_policy_to_torch)
    return jagent, tagent


def test_chunk_runner_matches_the_jax_examples_chunks():
    jagent, tagent = _fleet_agents(False)
    jweights = to_numpy(jagent.get_weights())
    tweights = {k: v.numpy() for k, v in tagent.get_weights().items()}
    jrun, trun = _runner_pair()
    for seed in (1, 2, 3):
        want = jrun({"role": "rollout", "seed": seed}, jweights, 0)
        got = trun({"role": "rollout", "seed": seed}, tweights, 0)
        for k in ("obs", "action", "reward", "done"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5, rtol=1e-5)
        assert got["returns"] == want["returns"] and got["seed"] == seed
    assert trun({"role": "noop"}, tweights, 0) == {"noop": True}


def test_chunk_runner_on_tensor_cartpole_autoresets_in_the_same_step():
    runner = fleet_impala.ChunkRunner(num_lanes=2, rollout_length=64)
    chunk = runner({"role": "rollout", "seed": 1}, None, 0)
    assert chunk["obs"].shape == (65, 2, 4) and chunk["logits"].shape == (65, 2, 2)
    ends = np.argwhere(chunk["done"][1:])
    assert len(ends) > 0 and len(chunk["returns"]) == len(ends)
    for t, b in ends:  # the row after an end is a fresh episode's first obs
        assert np.all(np.abs(chunk["obs"][t + 1, b]) <= 0.05)
    assert chunk["done"][0].all() and chunk["reward"][0].sum() == 0.0


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "kernel"])
def test_learn_step_on_a_fleet_batch_matches_jax(use_pallas):
    jagent, tagent = _fleet_agents(use_pallas)
    runner = fleet_impala.ChunkRunner(num_lanes=2, rollout_length=16)
    weights = {k: v.numpy() for k, v in tagent.get_weights().items()}
    for step in range(2):
        chunks = [runner({"role": "rollout", "seed": 4 * step + i}, weights, 0)
                  for i in range(4)]
        batch = fleet_impala.fleet_batch(chunks)
        assert batch["obs"].shape == (17, 8, 4)
        jm = jagent.learn(jbatch_to_trajectory(batch))
        tm = tagent.learn(batch_to_trajectory(batch, tagent.device))
        np.testing.assert_allclose(tm["total_loss"], float(jm["total_loss"]), rtol=1e-5,
                                   atol=1e-5)
        want = convert.mlp_policy_to_torch(to_numpy(jagent.state.params))
        for k, v in want.items():
            np.testing.assert_allclose(tagent.state.params[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_a3c_worker_gradient_and_applied_update_match_jax():
    jargs = jconfig.A3CArguments(hidden_sizes="128,128", learning_rate=3e-3,
                                 entropy_coef=0.01, seed=0)
    targs = a3c_fleet.a3c_args_from_task({
        "hidden_sizes": "128,128", "gamma": jargs.gamma, "gae_lambda": jargs.gae_lambda,
        "value_loss_coef": jargs.value_loss_coef, "entropy_coef": 0.01})
    model = ja3c.build_model(jargs, obs_shape=(4,), num_actions=2)
    obs0 = jnp.zeros((1, 4, 4), jnp.float32)
    jparams = model.init(jax.random.PRNGKey(0), obs0, jnp.zeros((1, 4), jnp.int32),
                         jnp.zeros((1, 4), jnp.float32), jnp.zeros((1, 4), bool), ())
    joptim = ja3c.make_a3c_optimizer(jargs)
    jopt = joptim.init(jparams)
    from scalerl_torch.agents.a3c import build_model, make_a3c_optimizer

    tmodel = build_model(targs, (4,), 2, device="cpu")
    toptim = make_a3c_optimizer(tconfig.A3CArguments(hidden_sizes="128,128",
                                                     learning_rate=3e-3))
    tparams = convert.mlp_policy_to_torch(to_numpy(jparams))
    topt = convert.adam_state_to_torch(to_numpy(jopt), convert.mlp_policy_to_torch)
    grad_fn = jax.jit(lambda p, traj: jax.value_and_grad(ja3c.a3c_loss, has_aux=True)(
        p, model, traj, gamma=jargs.gamma, gae_lambda=jargs.gae_lambda,
        value_loss_coef=jargs.value_loss_coef, entropy_coef=jargs.entropy_coef))
    for seed in (0, 1, 2):
        fields = flat_traj(seed, 32, 4, 2)
        (jloss, _), jgrads = grad_fn(jparams, jax_traj(fields))
        tloss, tgrads = a3c_fleet.a3c_fleet_grads(
            {k: v.numpy() for k, v in tparams.items()}, tmodel, torch_traj(fields), targs)
        assert tloss == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
        want = convert.mlp_policy_to_torch(to_numpy(jgrads))
        for k, v in want.items():
            np.testing.assert_allclose(tgrads[k], v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)
        updates, jopt = joptim.update(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        # the learner applies the uploaded gradient; both optimizers take the
        # same one (Adam's first steps turn a rounding-level gradient into
        # about lr * sign(g), ROADMAP §C, so each side's own would not do)
        uploaded = {k: v.numpy() for k, v in want.items()}
        tparams, topt = a3c_fleet.apply_fleet_grads(toptim, tparams, topt, uploaded)
        for k, v in convert.mlp_policy_to_torch(to_numpy(jparams)).items():
            np.testing.assert_allclose(tparams[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the twins end to end on the CPU


def test_fleet_impala_twin_answers_every_task_exactly_once():
    out = fleet_impala.train_fleet_impala(total_frames=2048, num_workers=2, device="cpu",
                                          use_pallas=True, log_every=0)
    assert out["env_frames"] == 2048 and out["learn_steps"] == 16
    assert out["issued"] == out["answered"] == out["answered_unique"] == 64
    assert out["answered_twice"] == 0 and out["unanswered"] == 0
    assert out["duplicate_tasks"] == 0 and out["dropped_results"] == 0
    assert np.isfinite(out["metrics"]["total_loss"])
    assert out["weight_version"] == out["learn_steps"] + 1
    assert out["fleet_telemetry"]["sources"] >= 1


def test_fleet_dqn_twin_runs():
    out = fleet_dqn.train_fleet_dqn(episodes=12, num_workers=2, batch_size=32, device="cpu",
                                    log_every=0)
    assert out["episodes"] == 12 and out["unique_episodes"] == 12
    assert out["learn_steps"] > 0 and out["transitions"] >= 12
    assert np.isfinite(out["metrics"]["loss"])


def test_a3c_fleet_twin_applies_every_gradient():
    out = a3c_fleet.train_a3c_fleet(num_workers=2, total_frames=2048, num_envs=4, unroll=16,
                                    device="cpu")
    assert out["applied_updates"] == 32 and out["env_frames"] == 2048
    assert out["weight_version"] == out["applied_updates"] + 1


def test_marl_twin_trains_both_agents_over_the_async_plane():
    out = marl_dqn.run_marl(num_envs=2, max_steps=300, warmup=50, device="cpu",
                            eval_episodes=20)
    assert out["env_frames"] == 600 and out["learn_steps"] > 0
    assert set(out["final_returns"]) == {"chaser", "runner"}
    assert 0.0 <= out["random_vs_random"]["catch_rate"] <= 1.0


def test_the_twins_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: fleet_impala.main(["--total-frames", "64"]),
        lambda: fleet_dqn.main(["--episodes", "1"]),
        lambda: a3c_fleet.main(["--total-frames", "64"]),
        lambda: marl_dqn.main(["--max-steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
