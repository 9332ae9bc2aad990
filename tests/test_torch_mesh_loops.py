"""Replay and loops under a mesh: the learn functions' gradient axis, the
fused device loop's data-parallel path, the mesh-fused device R2D2, and
the Ape-X, host R2D2 and serving-mode IMPALA trainers over a meshed
agent, on a four-rank gloo world.

One world of 4 spawned ranks serves the module
(``tests/torch_loop_mesh_helpers.py``, jax-free); the JAX steps run here
while the ranks run.

- ``make_impala_learn_fn``, IMPACT's and ``make_r2d2_learn_fn``, each rank
  on its quarter of the batch inside ``batch_reduction(mesh, ("dp",))`` (as
  the data-parallel loops run them), equal the JAX unmeshed step on the whole batch at the JAX
  test's tolerances (params ``rtol=2e-5, atol=2e-6``, the loss ``1e-5``,
  ``tests/test_parallel.py:124-151``; optimizer moments and the other
  metrics as ``tests/test_torch_sharded_learner.py`` holds them).
- The device loop at ``dp=4`` (the twin of ``tests/test_parallel.py:
  223-262``): after 2 chunks of one iteration ``step == 2`` and
  ``env_frames == 2 T B``, the episode sums are the sums over the ranks,
  the params are bit-identical on every rank, and ``run()`` lands on the
  same state; Anakin is refused.
- The mesh-fused device R2D2 at ``dp=4`` (the twin of
  ``tests/test_r2d2.py:377-415``): learn steps, one state on every rank
  (each rank built its agent from a seed of its own), every rank's ring
  received sequences.
- Ape-X at ``dp=2,fsdp=2`` (and ``dp=2,mp=2``, whose mp ranks pool their
  slabs) trains end to end on its sharded replay and resumes priorities,
  size and params (the twin of ``tests/test_apex.py:175-283``); host R2D2 at ``dp=2,mp=2`` trains alike
  on every rank and resumes its sharded ring and max priority; IMPALA with
  ``actor_mode="serving"`` at ``dp=4`` trains alike on every rank.

Without a world: the one-rank meshes against the unmeshed loops, and the
refusals (divisibility, the device R2D2's combination rules), and the
loop's learn call spanning its axis.
"""

import dataclasses
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_loop_mesh_helpers
from torch_port_helpers import random_traj, state_to_torch, to_numpy

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import impact as timpact
from scalerl_torch.agents import r2d2 as tr2d2
from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.envs.tensor_envs import TensorCartPole, TensorRecall
from scalerl_torch.parallel.mesh import AXIS_NAMES, Mesh, make_mesh
from scalerl_torch.parallel.sharding import global_batch
from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop
from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer
from scalerl_torch.utils.tree import tree_leaves
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impact as jimpact
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.agents import r2d2 as jr2d2
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory

torch.set_num_threads(1)

WORLD = 4
JOIN_TIMEOUT_S = 150
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = 1e-5
METRIC_TOL = 1e-4


def _flat_traj(T, B, obs_dim, A, seed):
    fields = random_traj(T, B, (), A, seed)
    fields["obs"] = np.random.default_rng(seed + 100).normal(
        size=(T + 1, B, obs_dim)).astype(np.float32)
    return fields


def _impala_case(seed):
    fields = dict(use_lstm=False, hidden_size=32, rollout_length=5, batch_size=8, max_timesteps=0)
    jagent = jimpala.ImpalaAgent(jconfig.ImpalaArguments(**fields), obs_shape=(8,), num_actions=4,
                                 obs_dtype=jnp.float32, key=jax.random.PRNGKey(seed))
    traj = _flat_traj(5, 8, 8, 4, seed)

    def want():
        jstate, jm = jax.jit(jagent.make_learn_fn())(
            jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                        core_state=()))
        return dict(want_state=state_to_torch(jstate, convert.mlp_policy_to_torch),
                    want_metrics=to_numpy(jm))

    return dict(kind="axis_learn", algo="impala", spec="dp=4",
                args=tconfig.ImpalaArguments(**fields), obs_shape=(8,), num_actions=4,
                state=state_to_torch(jagent.state, convert.mlp_policy_to_torch),
                batch=Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}), want=want)


def _impact_state(js):
    to = convert.mlp_policy_to_torch
    return timpact.ImpactTrainState(
        params=to(to_numpy(js.params)), target_params=to(to_numpy(js.target_params)),
        opt_state=convert.rmsprop_state_to_torch(to_numpy(js.opt_state), tree_to_torch=to),
        step=torch.tensor(int(js.step), dtype=torch.int32),
        env_frames=torch.tensor(int(js.env_frames), dtype=torch.int64))


def _impact_case(seed):
    fields = dict(rollout_length=6, batch_size=8, use_lstm=False, max_timesteps=0,
                  hidden_size=32, target_update_frequency=3)
    jagent = jimpact.ImpactAgent(jconfig.ImpactArguments(**fields), (4,), 2,
                                 obs_dtype=jnp.float32)
    traj = _flat_traj(6, 8, 4, 2, seed)
    # a target a step behind, so the clipped ratio is not 1
    jagent.learn(JaxTrajectory(**{k: jnp.asarray(v) for k, v in
                                  _flat_traj(6, 8, 4, 2, seed + 1).items()}, core_state=()))

    def want():
        jstate, jm = jax.jit(jagent.make_learn_fn())(
            jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                        core_state=()))
        return dict(want_state=_impact_state(jstate), want_metrics=to_numpy(jm))

    return dict(kind="axis_learn", algo="impact", spec="dp=4",
                args=tconfig.ImpactArguments(**fields), obs_shape=(4,), num_actions=2,
                state=_impact_state(jagent.state),
                batch=Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}), want=want)


def _r2d2_case():
    fields = dict(hidden_size=16, rollout_length=6, burn_in=2, n_steps=2, batch_size=8,
                  replay_capacity=12, target_update_frequency=2)
    A, obs, T1, B = 3, (5,), 7, 8
    jagent = jr2d2.R2D2Agent(jconfig.R2D2Arguments(**fields), obs, A, obs_dtype=np.float32)
    to = convert.recurrent_q_to_torch

    def to_torch(js):
        return tr2d2.R2D2TrainState(
            params=to(to_numpy(js.params)), target_params=to(to_numpy(js.target_params)),
            opt_state=convert.adam_state_to_torch(to_numpy(js.opt_state), to),
            step=torch.tensor(int(js.step), dtype=torch.int32))

    rng = np.random.default_rng(6)
    H = fields["hidden_size"] + A + 1
    fields_np = dict(obs=rng.normal(size=(B, T1) + obs).astype(np.float32),
                     action=rng.integers(0, A, size=(B, T1)).astype(np.int32),
                     reward=rng.normal(size=(B, T1)).astype(np.float32),
                     done=rng.uniform(size=(B, T1)) < 0.1)
    core = ((rng.normal(size=(B, H)).astype(np.float32),
             rng.normal(size=(B, H)).astype(np.float32)),)
    weights = rng.uniform(0.2, 1.0, size=B).astype(np.float32)

    def want():
        jlearn = jax.jit(jr2d2.make_r2d2_learn_fn(jagent.model, jagent.optimizer,
                                                  jconfig.R2D2Arguments(**fields)))
        jstate, jm, jprio = jlearn(
            jagent.state, {k: jnp.asarray(v) for k, v in fields_np.items()},
            tuple((jnp.asarray(c), jnp.asarray(h)) for c, h in core), jnp.asarray(weights))
        return dict(want_state=to_torch(jstate), want_metrics=to_numpy(jm),
                    want_aux=np.asarray(jprio))

    batch = ({k: torch.tensor(v) for k, v in fields_np.items()},
             tuple((torch.tensor(c), torch.tensor(h)) for c, h in core), torch.tensor(weights))
    return dict(kind="axis_learn", algo="r2d2", spec="dp=4", args=tconfig.R2D2Arguments(**fields),
                obs_shape=obs, num_actions=A, state=to_torch(jagent.state), batch=batch,
                want=want)


QUIET = dict(logger_backend="none", telemetry_interval_s=0.0)


def _apex_case(spec):
    return dict(kind="apex", spec=spec, args=tconfig.ApexArguments(
        env_id="CartPole-v1", num_actors=1, num_envs=2, rollout_length=10, n_steps=3,
        batch_size=16, buffer_size=4096, warmup_learn_steps=32, hidden_sizes="32,32",
        max_timesteps=1200, logger_frequency=10**9, eval_frequency=10**9, save_model=True,
        save_frequency=10**9, use_per=True, use_pallas=True, **QUIET))


def _cases():
    return {
        "axis_impala": _impala_case(0),
        "axis_impact": _impact_case(1),
        "axis_r2d2": _r2d2_case(),
        "device_loop": dict(kind="device_loop", spec="dp=4", T=4, num_envs=16, chunks=2, seed=0,
                            args=tconfig.ImpalaArguments(use_lstm=False, hidden_size=32,
                                                         rollout_length=4, batch_size=16,
                                                         max_timesteps=0)),
        "r2d2_device": dict(kind="r2d2_device", spec="dp=4", num_envs=8, total_frames=480,
                            args=tconfig.R2D2Arguments(
                                env_id="Recall-v0", rollout_length=6, burn_in=2, n_steps=1,
                                batch_size=8, replay_capacity=32, warmup_sequences=8,
                                train_intensity=2, hidden_size=16, logger_frequency=200,
                                save_model=False, use_pallas=True, **QUIET)),
        "apex": _apex_case("dp=2,fsdp=2"),
        "apex_mp": _apex_case("dp=2,mp=2"),
        "r2d2_host": dict(kind="r2d2_host", spec="dp=2,mp=2", total_frames=1200,
                          args=tconfig.R2D2Arguments(
                              env_id="RecallGym-v0", rollout_length=6, burn_in=2, n_steps=1,
                              batch_size=8, num_actors=2, num_buffers=8, replay_capacity=64,
                              warmup_sequences=8, train_intensity=2, hidden_size=16,
                              logger_frequency=400, save_model=True, save_frequency=10**9,
                              **QUIET)),
        "serving": dict(kind="serving", total_frames=512, args=tconfig.ImpalaArguments(
            env_id="CartPole-v1", rollout_length=8, batch_size=4, num_actors=2, num_buffers=8,
            use_lstm=False, hidden_size=32, logger_frequency=64, max_timesteps=0,
            save_model=False, actor_mode="serving", serve_max_batch=8, serve_max_wait_ms=2.0,
            mesh_shape="dp=4", **QUIET)),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of ``WORLD`` ranks; the JAX steps run
    here while the ranks run."""
    workdir = str(tmp_path_factory.mktemp("loop_world"))
    cases = _cases()
    torch.save({k: {f: v for f, v in c.items() if f != "want"} for k, c in cases.items()},
               f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_loop_mesh_helpers.run_rank,
                             args=(WORLD, _free_port(), workdir), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for case in cases.values():
            if "want" in case:
                case.update(case.pop("want")())
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return cases, torch.load(f"{workdir}/results.pt", weights_only=False)


def _ranks(world, name):
    cases, results = world
    for r in results[name]:
        assert "error" not in r, r["error"]
    return cases[name], results[name]


def _assert_state_close(got, want, param_fields):
    for f in dataclasses.fields(want):
        tol = PARAM_TOL if f.name in param_fields else STATE_TOL
        for a, b in zip(tree_leaves(getattr(got, f.name)), tree_leaves(getattr(want, f.name))):
            if a.is_floating_point():
                np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                           err_msg=f.name, **tol)
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("name,params", [("axis_impala", ("params",)),
                                         ("axis_impact", ("params", "target_params")),
                                         ("axis_r2d2", ("params", "target_params"))])
def test_axis_learn_fn_on_each_rank_rows_matches_jax_unmeshed(world, name, params):
    case, ranks = _ranks(world, name)
    for r in ranks:
        _assert_state_close(r["state"], case["want_state"], params)
        assert r["agree"], "the ranks' states drifted apart"
        for k, v in case["want_metrics"].items():
            tol = LOSS_TOL if k == "total_loss" else METRIC_TOL
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=tol, atol=tol, err_msg=k)
    if name == "axis_impala":
        assert int(ranks[0]["state"].env_frames) == 5 * 8  # every rank's lanes counted
    if name == "axis_r2d2":  # each rank's own priorities, in rank order
        np.testing.assert_allclose(ranks[0]["aux"], case["want_aux"], rtol=1e-5, atol=1e-5)


def test_device_loop_dp_mesh_trains_alike_on_every_rank(world):
    case, ranks = _ranks(world, "device_loop")
    T, B = case["T"], case["num_envs"]
    for r in ranks:
        assert r["lanes"] == B // WORLD
        assert r["step"] == 2 and r["env_frames"] == 2 * T * B
        assert r["agree"] and r["run_agree"] and r["run_equal"]
        # the episode sums span every rank's lanes
        counts, returns = zip(*r["local_sums"])
        assert r["metrics"][-1]["episode_count_sum"] == pytest.approx(sum(counts))
        assert r["metrics"][-1]["episode_return_sum"] == pytest.approx(sum(returns))
        assert np.isfinite(r["metrics"][-1]["total_loss"])
        assert "mesh" in r["anakin_error"]
    # the ranks step different lanes, from generators of their own
    assert len({tuple(r["first_obs"]) for r in ranks}) == WORLD


def test_mesh_fused_device_r2d2_trains_alike_on_every_rank(world):
    case, ranks = _ranks(world, "r2d2_device")
    for r in ranks:
        assert r["learn_steps"] > 0 and np.isfinite(r["loss"])
        assert r["env_frames"] >= case["total_frames"]
        assert r["agree"], "the ranks' states drifted apart"
        assert r["local_capacity"] == case["args"].replay_capacity // WORLD
        assert r["ring_live"] > 0  # every rank's ring received sequences
    assert len({r["learn_steps"] for r in ranks}) == 1
    assert len({r["ring_size"] for r in ranks}) == 1


@pytest.mark.parametrize("name,shards", [("apex", 4), ("apex_mp", 2)])
def test_meshed_apex_trains_on_a_sharded_replay_and_resumes(world, name, shards):
    """dp=2,fsdp=2: a shard a rank; dp=2,mp=2: the two ranks of a shard
    pool their slabs over mp, so a shard's block holds both."""
    case, ranks = _ranks(world, name)
    for r in ranks:
        assert r["sharded"] and r["n_shards"] == shards
        assert r["lanes"] == 16 * WORLD // shards  # the ranks' slabs of 16
        assert r["learn_steps"][0] > 0 and len(set(r["learn_steps"])) == 1
        assert sum(r["steps"]) >= case["args"].max_timesteps
        assert len(set(r["sizes"])) == 1 and r["sizes"][0] > 0
        assert r["agree"], "the ranks' states drifted apart"
        assert r["resumed"] and r["prio_equal"] and r["storage_equal"] and r["size_equal"]
        assert r["params_equal"] and r["learn_steps_restored"] == r["learn_steps"][0]


def test_meshed_host_r2d2_trains_alike_and_resumes_its_sharded_ring(world):
    case, ranks = _ranks(world, "r2d2_host")
    for r in ranks:
        assert r["sharded"] and r["n_shards"] == 2
        assert r["learn_steps"][0] > 0 and len(set(r["learn_steps"])) == 1
        assert sum(r["frames"]) >= case["total_frames"]
        assert r["agree"] and np.isfinite(r["loss"])
        assert r["resumed"] and r["ring_equal"] and r["max_prio_equal"] and r["params_equal"]
    # ranks 0 and 1 differ only in mp: one replay shard, one block
    torch.testing.assert_close(ranks[0]["block"], ranks[1]["block"], rtol=0, atol=0)
    torch.testing.assert_close(ranks[2]["block"], ranks[3]["block"], rtol=0, atol=0)


def test_serving_impala_trains_alike_on_every_rank(world):
    case, ranks = _ranks(world, "serving")
    for r in ranks:
        assert r["shape"]["dp"] == WORLD
        assert r["learn_steps"][0] >= 2 and len(set(r["learn_steps"])) == 1
        assert sum(r["frames"]) >= case["total_frames"]
        assert r["agree"] and np.isfinite(r["loss"])
        assert r["flushes"] > 0 and r["generation"] == r["learn_steps"][0]
        assert not r["fallen_back"]


# ---------------------------------------------------------------------------
# without a world


def _spec_mesh(**sizes) -> Mesh:
    """A mesh of several ranks with no process group: enough for the checks
    made before any collective."""
    return Mesh(shape={a: sizes.get(a, 1) for a in AXIS_NAMES}, device_type="cpu")


def _loop_pair(mesh, iters=2):
    args = tconfig.ImpalaArguments(use_lstm=False, hidden_size=32, rollout_length=5,
                                   batch_size=8, max_timesteps=0)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    loop = DeviceActorLearnerLoop(agent.model, TensorCartPole(8, device="cpu"),
                                  agent.make_learn_fn(), 5, iters_per_call=iters, seed=3, device="cpu", mesh=mesh)
    return agent, loop


def test_one_rank_meshed_loop_is_the_unmeshed_loop_bit_for_bit():
    outs = []
    for mesh in (None, make_mesh("dp=1")):
        agent, loop = _loop_pair(mesh)
        state, carry, m = loop.run(agent.state, loop.init_carry(), 3, instrument=False)
        outs.append((tree_leaves((state, carry)), m))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert outs[0][1] == outs[1][1]


def test_loop_mesh_refusals():
    agent, _ = _loop_pair(None)
    learn = agent.make_learn_fn()
    with pytest.raises(ValueError, match="divide"):
        DeviceActorLearnerLoop(agent.model, TensorCartPole(12, device="cpu"), learn, 5,
                               device="cpu", mesh=_spec_mesh(dp=8))
    # the loop runs the plain learn function inside a batch reduction over
    # its axis: on a dp=2 mesh with no process group (no collective runs),
    # a rank's 4 lanes count as the global 8
    seen = []

    def probe(state, traj):
        seen.append(global_batch(traj.reward.shape[1]))
        return learn(state, traj)

    loop = DeviceActorLearnerLoop(agent.model, TensorCartPole(8, device="cpu"), probe, 5,
                                  iters_per_call=2, device="cpu", mesh=_spec_mesh(dp=2))
    state, _, _ = loop.train_chunk(agent.state, loop.init_carry())
    assert seen == [8, 8] and int(state.env_frames) == 2 * 5 * 8
    assert global_batch(4) == 4  # and nothing outside the loop
    _, loop = _loop_pair(make_mesh("dp=1"))
    with pytest.raises(NotImplementedError, match="mesh"):
        loop.train_superchunk(agent.state, loop.init_carry(), 2)


def _r2d2_device_args(tmp_path, **kw):
    return tconfig.R2D2Arguments(
        env_id="Recall-v0", rollout_length=6, burn_in=2, n_steps=1, batch_size=8,
        replay_capacity=64, warmup_sequences=8, train_intensity=2, hidden_size=16,
        logger_frequency=400, save_model=False, use_pallas=True, work_dir=str(tmp_path),
        **QUIET, **kw)


def test_device_r2d2_mesh_combination_rules(tmp_path):
    args = _r2d2_device_args(tmp_path)
    env = TensorRecall(8, size=8, delay=2, num_cues=2, device="cpu")
    plain = tr2d2.R2D2Agent(args, env.observation_shape, env.num_actions, device="cpu")
    with pytest.raises(ValueError, match="requires fused=True"):
        DeviceR2D2Trainer(args, plain, env, mesh=make_mesh("dp=1"), fused=False)
    with pytest.raises(ValueError, match="must divide by mesh axis 'dp'"):
        DeviceR2D2Trainer(args, plain, env, mesh=_spec_mesh(dp=16))
    meshed = tr2d2.R2D2Agent(args, env.observation_shape, env.num_actions, device="cpu")
    meshed.enable_mesh("dp=1")
    with pytest.raises(ValueError, match="not both"):
        DeviceR2D2Trainer(args, meshed, env, mesh=make_mesh("dp=1"))
    with pytest.raises(ValueError, match="bypass agent.enable_mesh"):
        DeviceR2D2Trainer(args, meshed, env, fused=True)
    DeviceR2D2Trainer(args, meshed, env, fused=False).close()  # the piecewise DDP form


def test_one_rank_mesh_fused_device_r2d2_matches_the_unmeshed_trainer(tmp_path):
    """dp=1: the same draws and the same updates; the keep-empty write-back
    and the zeroed weights of empty draws change nothing while no empty
    slot is drawn."""
    outs = []
    for mesh in (None, make_mesh("dp=1")):
        args = _r2d2_device_args(tmp_path)
        env = TensorRecall(8, size=8, delay=2, num_cues=2, device="cpu")
        agent = tr2d2.R2D2Agent(args, env.observation_shape, env.num_actions, device="cpu")
        trainer = DeviceR2D2Trainer(args, agent, env, mesh=mesh)
        result = trainer.train(total_frames=900)
        outs.append((tree_leaves(agent.state), trainer.replay.priorities.clone(), result))
        trainer.close()
    (sa, pa, ra), (sb, pb, rb) = outs
    assert ra["learn_steps"] == rb["learn_steps"] > 0
    for a, b in zip(sa, sb):
        assert torch.equal(a, b)
    assert torch.equal(pa, pb)
