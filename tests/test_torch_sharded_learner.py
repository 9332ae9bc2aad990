"""The port's sharded learn steps on a four-rank gloo world, against the JAX
package's unmeshed steps.

One world of 4 spawned ranks serves the module (``tests/torch_mesh_helpers.py``,
jax-free).  Every case starts from a JAX agent's state converted through
``convert.py``; the ranks take the same global batch, split it over
``dp`` x ``fsdp`` and run the meshed step, and rank 0 hands back the state
gathered to full tensors.  The JAX package runs the same step unmeshed on
the same state and batch here, and the two are held at the JAX tests'
tolerances for the same comparison: params at ``rtol=2e-5, atol=2e-6`` and
the loss at 1e-5 (``tests/test_parallel.py:124-151``), metrics at 1e-4.

Cases: IMPALA's MLP at ``dp=4`` and ``dp=2,fsdp=2``, the transformer policy
at ``dp=2,mp=2``, DQN, SAC and TD3 through ``enable_offpolicy_mesh`` and
R2D2 at ``dp=2,tp=2``, token-PPO at ``dp=2,mp=2``; the mp mesh refused for a
model with no rules; a sharded checkpoint resumed bit for bit; and the
on-policy trainer resolving ``dp_size`` x ``mp_size`` from its args.

A trainer feeds each rank the lanes it collected itself: the meshed steps
of IMPALA, the transformer policy and PPO (whose every rank computes the
whole update) on each rank's own quarter of the batch, each rank with a
seed of its own, must equal the unmeshed step on the whole batch; the
threaded actor-learner trainer and the on-policy trainer must train a few
steps with every rank on the same steps and the same state.  And
``activation_constraint`` redistributes a DTensor activation.
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
import torch_mesh_helpers
from torch_port_helpers import (
    genrl_args_pair,
    ragged_token_batches,
    state_to_torch,
    to_jax_batch,
    to_numpy,
    to_torch_batch,
    token_ppo_state_to_torch,
)

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents import dqn as tdqn
from scalerl_torch.agents import r2d2 as tr2d2
from scalerl_torch.data.trajectory import Trajectory
from scalerl_torch.utils.tree import tree_leaves
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import dqn as jdqn
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.agents import r2d2 as jr2d2
from scalerl_tpu.agents import sac as jsac
from scalerl_tpu.agents import td3 as jtd3
from scalerl_tpu.agents import token_ppo as jppo
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory
from scalerl_tpu.trainer.sequence_rl import build_genrl_model as jax_build_genrl_model

torch.set_num_threads(1)

WORLD = 4
JOIN_TIMEOUT_S = 120
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)  # optimizer moments, as the unmeshed parity tests
LOSS_TOL = 1e-5
METRIC_TOL = 1e-4


def _traj(T, B, obs_dim, A, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T + 1, B, A)).astype(np.float32)
    logits[-1] = 0.0
    return dict(obs=rng.normal(size=(T + 1, B, obs_dim)).astype(np.float32),
                action=rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
                reward=(rng.normal(size=(T + 1, B)) * 1.5).astype(np.float32),
                done=rng.uniform(size=(T + 1, B)) < 0.2, logits=logits)


def _impala_case(spec, seed, **kw):
    """An IMPALA case: the JAX agent's state, a [T+1, B] chunk, the JAX
    unmeshed step's state and metrics."""
    fields = dict(use_lstm=False, rollout_length=5, batch_size=8, max_timesteps=0, **kw)
    transformer = kw.get("policy_arch") == "transformer"
    obs_dim, A = (4, 2) if transformer else (8, 4)
    jargs = jconfig.ImpalaArguments(**fields)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=(obs_dim,), num_actions=A,
                                 obs_dtype=jnp.float32, key=jax.random.PRNGKey(seed))
    tree = (convert.transformer_policy_net_to_torch if transformer
            else convert.mlp_policy_to_torch)
    traj = _traj(5, 8, obs_dim, A, seed)

    def want():
        jstate, jm = jax.jit(jagent.make_learn_fn())(
            jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                        core_state=()))
        return dict(want_state=state_to_torch(jstate, tree), want_metrics=to_numpy(jm))

    return dict(kind="impala", spec=spec, args=tconfig.ImpalaArguments(**fields),
                obs_shape=(obs_dim,), num_actions=A, state=state_to_torch(jagent.state, tree),
                batch=Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}), want=want)


ATARI_OBS, ATARI_A = (24, 24, 4), 6


def _atari_case(spec, seed):
    """IMPALA's feed-forward ``AtariNet`` (hidden 64) on 24x24x4 frames: at
    ``fsdp=2,tp=2`` conv1 gathers over fsdp, conv2 is row- and conv3
    column-parallel over tp (each with a weight dim over fsdp) and the
    dense layer column-parallel; at ``dp=2,tp=2`` conv1 and conv2 are
    column-, conv3 and the dense layer row-parallel."""
    from torch_port_helpers import random_traj

    fields = dict(use_lstm=False, hidden_size=64, rollout_length=5, batch_size=8,
                  max_timesteps=0)
    jagent = jimpala.ImpalaAgent(jconfig.ImpalaArguments(**fields), obs_shape=ATARI_OBS,
                                 num_actions=ATARI_A, key=jax.random.PRNGKey(seed))
    traj = random_traj(5, 8, ATARI_OBS, ATARI_A, seed=seed)

    def want():
        jstate, jm = jax.jit(jagent.make_learn_fn())(
            jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                        core_state=()))
        return dict(want_state=state_to_torch(jstate), want_metrics=to_numpy(jm))

    return dict(kind="impala", spec=spec, args=tconfig.ImpalaArguments(**fields),
                obs_shape=ATARI_OBS, num_actions=ATARI_A, state=state_to_torch(jagent.state),
                batch=Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}), want=want)


def _offpolicy_batch(B, obs, act_low=None, act_high=None, A=None, seed=0):
    rng = np.random.default_rng(seed)
    batch = dict(obs=rng.normal(size=(B, obs)).astype(np.float32),
                 next_obs=rng.normal(size=(B, obs)).astype(np.float32),
                 reward=rng.normal(size=B).astype(np.float32), done=rng.uniform(size=B) < 0.3,
                 weights=rng.uniform(0.2, 1.0, size=B).astype(np.float32))
    if A is not None:
        batch["action"] = rng.integers(0, A, size=B).astype(np.int32)
        batch["n_steps"] = rng.integers(1, 4, size=B).astype(np.int32)
    else:
        batch["action"] = rng.uniform(act_low, act_high, size=(B, len(act_low))).astype(
            np.float32)
    return batch


def _dqn_case(spec):
    fields = dict(hidden_sizes="32,32", max_timesteps=1000, batch_size=16, buffer_size=64)
    jagent = jdqn.DQNAgent(jconfig.DQNArguments(**fields), (4,), 2, donate_state=False)

    def to_torch(js):
        return tdqn.DQNTrainState(
            params=convert.dense_stack_to_torch(to_numpy(js.params)),
            target_params=convert.dense_stack_to_torch(to_numpy(js.target_params)),
            opt_state=convert.adam_state_to_torch(to_numpy(js.opt_state)),
            step=torch.tensor(int(js.step), dtype=torch.int32))

    batch = _offpolicy_batch(16, 4, A=2, seed=1)

    def want():
        jstate, jm, jtd = jax.jit(jagent._learn_raw)(
            jagent.state, {k: jnp.asarray(v) for k, v in batch.items()})
        return dict(want_state=to_torch(jstate), want_metrics=to_numpy(jm),
                    want_aux=np.asarray(jtd))

    return dict(kind="dqn", spec=spec, args=tconfig.DQNArguments(**fields), obs_shape=(4,),
                num_actions=2, state=to_torch(jagent.state), batch=batch, want=want)


LOW, HIGH = np.array([-2.0, -0.5], np.float32), np.array([1.0, 1.5], np.float32)


def _continuous_case(kind, spec):
    fields = dict(hidden_sizes="32,32", batch_size=16, buffer_size=64, max_timesteps=1000)
    jmod, jcfg, tcfg, conv, salt = (
        (jsac, jconfig.SACArguments, tconfig.SACArguments, convert.sac_state_to_torch, 0x5AC)
        if kind == "sac" else
        (jtd3, jconfig.TD3Arguments, tconfig.TD3Arguments, convert.td3_state_to_torch, 0x7D3))
    jargs = jcfg(**fields)
    jagent = (jmod.SACAgent if kind == "sac" else jmod.TD3Agent)(jargs, (3,), LOW, HIGH)
    batch = _offpolicy_batch(16, 3, LOW, HIGH, seed=2)
    key = jax.random.fold_in(jax.random.PRNGKey(jargs.seed + salt), 0)
    if kind == "sac":
        k_next, k_pi = jax.random.split(key)
        noise = {"next": torch.tensor(np.asarray(jax.random.normal(k_next, (16, 2)))),
                 "pi": torch.tensor(np.asarray(jax.random.normal(k_pi, (16, 2))))}
    else:
        noise = torch.tensor(np.asarray(jax.random.normal(key, (16, 2))))

    def want():
        jstate, jm, jtd = jagent._learn(jagent.state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        return dict(want_state=conv(to_numpy(jstate)), want_metrics=to_numpy(jm),
                    want_aux=np.asarray(jtd))

    return dict(kind=kind, spec=spec, args=tcfg(**fields), obs_shape=(3,), low=LOW, high=HIGH,
                state=conv(to_numpy(jagent.state)), batch=batch, noise=noise, want=want)


def _r2d2_case(spec):
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

    rng = np.random.default_rng(5)
    H = fields["hidden_size"] + A + 1
    fields_np = dict(obs=rng.normal(size=(B, T1) + obs).astype(np.float32),
                     action=rng.integers(0, A, size=(B, T1)).astype(np.int32),
                     reward=rng.normal(size=(B, T1)).astype(np.float32),
                     done=rng.uniform(size=(B, T1)) < 0.1)
    core = ((rng.normal(size=(B, H)).astype(np.float32),
             rng.normal(size=(B, H)).astype(np.float32)),)
    weights = rng.uniform(0.2, 1.0, size=B).astype(np.float32)

    def want():
        jstate, jm, jprio = jagent._learn(
            jagent.state, {k: jnp.asarray(v) for k, v in fields_np.items()},
            tuple((jnp.asarray(c), jnp.asarray(h)) for c, h in core), jnp.asarray(weights))
        return dict(want_state=to_torch(jstate), want_metrics=to_numpy(jm),
                    want_aux=np.asarray(jprio))

    batch = ({k: torch.tensor(v) for k, v in fields_np.items()},
             tuple((torch.tensor(c), torch.tensor(h)) for c, h in core), torch.tensor(weights))
    return dict(kind="r2d2", spec=spec, args=tconfig.R2D2Arguments(**fields), obs_shape=obs,
                num_actions=A, state=to_torch(jagent.state), batch=batch, want=want)


def _token_ppo_case(spec):
    # the unmeshed parity test's setting (tests/test_torch_token_ppo.py): Adam
    # turns a gradient element near zero into a step of up to the learning
    # rate, so float noise there moves the parameter by a fraction of it
    jargs, targs = genrl_args_pair(max_grad_norm=0.5, learning_rate=1e-4)
    jagent = jppo.TokenPPOAgent(jargs, jax_build_genrl_model(jargs))
    padded, _, _ = ragged_token_batches(3, B=8)

    def want():
        jstate, jm = jagent._learn(jagent.state, to_jax_batch(padded))
        return dict(want_state=token_ppo_state_to_torch(jstate), want_metrics=to_numpy(jm))

    return dict(kind="token_ppo", spec=spec, args=targs,
                state=token_ppo_state_to_torch(jagent.state), batch=to_torch_batch(padded),
                want=want)


def _ppo_local_case(spec):
    """PPO's step on each rank's own lanes, against the port's unmeshed PPO
    step on the whole chunk (held to the JAX step by tests/test_torch_ppo.py)
    from the same state, with rank 0's seed."""
    import copy

    from scalerl_torch.agents.ppo import PPOAgent

    args = tconfig.PPOArguments(hidden_sizes="32,32", rollout_length=5, num_minibatches=2,
                                ppo_epochs=2, seed=3)
    agent = PPOAgent(args, (8,), 4, device="cpu")
    state = copy.deepcopy(agent.state)
    batch = Trajectory(**{k: torch.tensor(v) for k, v in _traj(5, 8, 8, 4, 5).items()})

    def want():
        metrics = agent.learn(batch)
        return dict(want_state=agent.state, want_metrics=metrics)

    return dict(kind="local", agent="ppo", spec=spec, args=args, obs_shape=(8,),
                num_actions=4, state=state, batch=batch, want=want)


def _local_twin(cases, name):
    """A trainer-mode case on the state and batch of ``name``, held to the
    same unmeshed step (computed once)."""
    case = {k: v for k, v in cases[name].items() if k != "want"}
    return {**case, "kind": "local", "agent": "impala", "want_from": name}


def _cases():
    transformer = dict(policy_arch="transformer", d_model=32, n_heads=2, n_layers=2)
    ckpt_args = tconfig.ImpalaArguments(use_lstm=False, rollout_length=5, batch_size=8,
                                        max_timesteps=0, **transformer)
    cases = {
        "impala_dp4": _impala_case("dp=4", 0, hidden_size=32),
        "impala_dp2_fsdp2": _impala_case("dp=2,fsdp=2", 1, hidden_size=32),
        "transformer_dp2_mp2": _impala_case("dp=2,mp=2", 2, **transformer),
        "transformer_mp4": _impala_case("mp=4", 3, **dict(transformer, n_heads=4)),
        # 2 heads over mp=4: no whole head a rank, so qkv runs column-parallel
        # and its head-aligned output columns are put back in order
        "transformer_mp4_h2": _impala_case("mp=4", 4, **transformer),
        # the heuristic rule on the transformer: its dense weights gathered
        # where used, pos_embed gathered for the policy's own forward
        "transformer_dp2_fsdp2": _impala_case("dp=2,fsdp=2", 5, **transformer),
        "atari_fsdp2_tp2": _atari_case("fsdp=2,tp=2", 6),
        "atari_dp2_tp2": _atari_case("dp=2,tp=2", 7),
        "dqn_dp2": _dqn_case("dp=2,tp=2"),
        "sac_dp2": _continuous_case("sac", "dp=2,tp=2"),
        "td3_dp2": _continuous_case("td3", "dp=2,tp=2"),
        "r2d2_dp2": _r2d2_case("dp=2,tp=2"),
        "token_ppo_dp2_mp2": _token_ppo_case("dp=2,mp=2"),
        "refusal": dict(kind="refusal", spec="dp=2,mp=2",
                        args=tconfig.ImpalaArguments(use_lstm=False, hidden_size=32,
                                                     max_timesteps=0),
                        obs_shape=(8,), num_actions=4),
        "checkpoint": dict(kind="checkpoint", spec="dp=2,mp=2", args=ckpt_args, obs_shape=(4,),
                           num_actions=2, batch=tuple(Trajectory(**{
                               k: torch.tensor(v) for k, v in _traj(5, 8, 4, 2, seed).items()})
                               for seed in (4, 9))),
        "trainer": dict(kind="trainer", args=tconfig.PPOArguments(
            policy_arch="transformer", d_model=32, n_heads=2, n_layers=1, mp_size=2,
            dp_size=2, num_workers=4, num_minibatches=1, rollout_length=8,
            logger_backend="none", telemetry_interval_s=0.0, save_frequency=10**9,
            max_timesteps=256)),
        "local_ppo_dp4": _ppo_local_case("dp=4"),
        "host_trainer": dict(kind="host_trainer", total_frames=600,
                             args=tconfig.ImpalaArguments(
                                 use_lstm=False, hidden_size=32, rollout_length=5,
                                 batch_size=4, num_actors=2, num_buffers=4,
                                 mesh_shape="dp=2,fsdp=2",
                                 logger_backend="none", telemetry_interval_s=0.0,
                                 save_frequency=10**9, max_timesteps=0)),
        "constraint": dict(kind="constraint", spec="dp=2,mp=2",
                           x=torch.arange(32, dtype=torch.float32).reshape(4, 8)),
    }
    nan = {k: v for k, v in cases["atari_dp2_tp2"].items() if k != "want"}
    cases["nan_shard"] = {**nan, "kind": "nan_shard", "leaf": "fc.weight", "nan_rank": 0}
    cases["local_impala_dp2_fsdp2"] = _local_twin(cases, "impala_dp2_fsdp2")
    cases["local_transformer_dp2_mp2"] = _local_twin(cases, "transformer_dp2_mp2")
    return cases


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every case on one spawned world of ``WORLD`` ranks; returns the
    cases, with the JAX steps computed here while the ranks run, and rank
    0's results."""
    workdir = str(tmp_path_factory.mktemp("mesh_world"))
    cases = _cases()
    torch.save({k: {f: v for f, v in c.items() if f != "want"} for k, c in cases.items()},
               f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_mesh_helpers.run_rank,
                             args=(WORLD, _free_port(), workdir), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for case in cases.values():
            if "want" in case:
                case.update(case.pop("want")())
        for case in cases.values():
            if "want_from" in case:
                twin = cases[case["want_from"]]
                case.update(want_state=twin["want_state"], want_metrics=twin["want_metrics"])
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return cases, torch.load(f"{workdir}/results.pt", weights_only=False)


def _result(world, name):
    cases, results = world
    got = results[name]
    assert "error" not in got or got["error"] is None or name == "refusal", got.get("error")
    return cases[name], got


def _assert_state_close(got, want, param_fields):
    """Params at the JAX test's tolerance, the other floating leaves
    (optimizer moments) at the unmeshed parity tests'; the step count
    exactly (the converted optax states carry no update count where the
    learning rate is constant)."""
    for f in dataclasses.fields(want):
        tol = PARAM_TOL if f.name in param_fields else STATE_TOL
        for a, b in zip(tree_leaves(getattr(got, f.name)), tree_leaves(getattr(want, f.name))):
            if a.is_floating_point():
                np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                           err_msg=f.name, **tol)
    assert int(got.step) == int(want.step)


def _assert_metrics_close(got, want, loss_keys=("total_loss", "loss")):
    for k, v in want.items():
        tol = LOSS_TOL if k in loss_keys else METRIC_TOL
        np.testing.assert_allclose(float(got[k]), float(v), rtol=tol, atol=tol, err_msg=k)


IMPALA_CASES = ["impala_dp4", "impala_dp2_fsdp2", "transformer_dp2_mp2", "transformer_mp4",
                "transformer_mp4_h2", "transformer_dp2_fsdp2", "atari_fsdp2_tp2",
                "atari_dp2_tp2"]


@pytest.mark.parametrize("name", IMPALA_CASES)
def test_impala_meshed_step_matches_jax_unmeshed(world, name):
    case, got = _result(world, name)
    _assert_state_close(got["state"], case["want_state"], ("params",))
    _assert_metrics_close(got["metrics"], case["want_metrics"])
    if "fsdp" in case["spec"]:
        assert got["layout"]["sharded"] > 0  # the MLP's weights really split over fsdp
    if "mp" in case["spec"]:
        assert got["layout"]["mp"] >= 4  # qkv/proj/mlp leaves and moments over mp
    assert int(got["state"].env_frames) == 5 * 8


@pytest.mark.parametrize("name", IMPALA_CASES)
def test_placed_state_gathers_to_the_converted_state(world, name):
    """gather_state gives back the Flax-ordered tensors convert.py made, bit
    for bit; a qkv leaf over mp is stored as its rank's heads' q, k, v rows."""
    case, got = _result(world, name)
    assert got["roundtrip"]
    if "mp" in case["spec"]:
        assert got["head_aligned"] and all(got["head_aligned"])


@pytest.mark.parametrize("name", IMPALA_CASES)
def test_meshed_step_gathers_no_state_leaf(world, name):
    """The learn function gets the local shards: no leaf of the state (no
    optimizer moment, no param) is gathered to a full DTensor in the step."""
    _, got = _result(world, name)
    assert got["seen"]["dtensor_gathers"] == 0


@pytest.mark.parametrize("name", ["impala_dp2_fsdp2", "atari_fsdp2_tp2"])
def test_fsdp_step_holds_at_most_two_leaves_gathered(world, name):
    """fsdp weights are gathered where their layer uses them and freed
    after: the full-weight bytes alive at once stay within the two largest
    leaves' (one layer's weight, and the next's while it is gathered)."""
    _, got = _result(world, name)
    seen = got["seen"]
    assert seen["weight_gathers"] > 0
    assert 0 < seen["peak_gathered_bytes"] <= got["two_largest_bytes"]


@pytest.mark.parametrize("name", ["atari_fsdp2_tp2", "atari_dp2_tp2"])
def test_column_layer_computes_a_tp_slice(world, name):
    """A column-parallel layer computes 1/tp of its output features on each
    rank, then gathers them: every gathered activation is tp slices."""
    _, got = _result(world, name)
    columns = got["seen"]["columns"]
    assert columns, "no column-parallel layer ran"
    assert all(size == 2 and local * 2 == whole for local, whole, size in columns)


@pytest.mark.parametrize("name,heads", [("transformer_dp2_mp2", 1), ("transformer_mp4", 1),
                                        ("transformer_mp4_h2", 2)])
def test_transformer_attends_on_the_rank_own_heads(world, name, heads):
    """Under mp each block's attention runs on n_heads / mp heads a rank."""
    _, got = _result(world, name)
    assert got["seen"]["heads"] and set(got["seen"]["heads"]) == {heads}


def test_nan_in_one_rank_shard_skips_the_step_on_every_rank(world):
    _, got = _result(world, "nan_shard")
    assert got["sharded"]  # the poisoned moment is split over tp
    assert got["skipped"] == [1.0] * WORLD
    assert got["kept"]


@pytest.mark.parametrize("name", ["dqn_dp2", "sac_dp2", "td3_dp2"])
def test_offpolicy_meshed_step_matches_jax_unmeshed(world, name):
    case, got = _result(world, name)
    params = ("params", "target_params", "actor_params", "critic_params",
              "target_critic_params", "target_actor_params", "log_alpha")
    _assert_state_close(got["state"], case["want_state"], params)
    _assert_metrics_close(got["metrics"], case["want_metrics"])
    # the per-sample |TD| comes back whole, for the PER write-back
    np.testing.assert_allclose(got["aux"].numpy(), case["want_aux"], rtol=1e-5, atol=1e-5)
    assert got["layout"]["sharded"] > 0  # hidden 32 weights split over tp


def test_r2d2_meshed_step_matches_jax_with_whole_priorities(world):
    case, got = _result(world, "r2d2_dp2")
    _assert_state_close(got["state"], case["want_state"], ("params", "target_params"))
    _assert_metrics_close(got["metrics"], case["want_metrics"])
    assert got["aux"].shape == (8,)
    np.testing.assert_allclose(got["aux"].numpy(), case["want_aux"], rtol=1e-5, atol=1e-5)
    assert got["layout"]["sharded"] == 0  # an LSTM core: every leaf replicates


def test_token_ppo_meshed_step_matches_jax_unmeshed(world):
    case, got = _result(world, "token_ppo_dp2_mp2")
    _assert_state_close(got["state"], case["want_state"], ("params", "ref_params"))
    _assert_metrics_close(got["metrics"], case["want_metrics"])
    assert got["layout"]["mp"] >= 4 and got["constrained"]
    # the vocab head over mp, and every block's attention on its rank's head
    assert got["vocab_sharded"]
    assert got["seen"]["heads"] and set(got["seen"]["heads"]) == {1}
    assert got["seen"]["dtensor_gathers"] == 0


def test_mp_mesh_without_rules_is_refused(world):
    _, got = _result(world, "refusal")
    assert got["error"] is not None and "model-parallel" in got["error"]


def test_sharded_checkpoint_resumes_bit_for_bit(world):
    _, got = _result(world, "checkpoint")
    assert got["equal"]
    assert got["restored_step"] == 1 and got["steps"] == 2
    assert got["layout"]["mp"] >= 4  # restored into the mp layout, not replicated


def test_on_policy_trainer_resolves_the_mesh_from_args(world):
    _, got = _result(world, "trainer")
    assert got["shape"]["dp"] == 2 and got["shape"]["mp"] == 2
    assert got["layout"]["mp"] >= 4


@pytest.mark.parametrize("name", ["local_impala_dp2_fsdp2", "local_transformer_dp2_mp2",
                                  "local_ppo_dp4"])
def test_trainer_step_on_each_rank_lanes_matches_the_whole_batch_step(world, name):
    case, got = _result(world, name)
    _assert_state_close(got["state"], case["want_state"], ("params",))
    _assert_metrics_close(got["metrics"], case["want_metrics"])
    assert got["agree"]  # one state on every rank, though each had its own seed


def test_host_actor_learner_trains_alike_on_every_rank(world):
    case, got = _result(world, "host_trainer")
    assert got["shape"]["dp"] == 2 and got["shape"]["fsdp"] == 2
    assert got["local"] and got["layout"]["sharded"] > 0
    # the ranks stopped on one step, once the frames of all of them were in
    assert got["learn_steps"][0] >= 2 and len(set(got["learn_steps"])) == 1
    assert sum(got["frames"]) >= case["total_frames"]
    assert max(got["frames"]) < case["total_frames"]  # no rank's own count stopped it
    assert got["agree"], "the ranks' states drifted apart"
    assert got["published"], "the acting copy is not the learned state"
    assert np.isfinite(got["loss"])


def test_on_policy_trainer_trains_alike_on_every_rank(world):
    case, got = _result(world, "trainer")
    # max_timesteps counts the steps of every rank: 4 ranks x 4 envs x 8
    assert got["learn_steps"] == 2 and got["global_step"] == 64
    assert got["agree"]


def test_activation_constraint_redistributes_a_dtensor(world):
    _, got = _result(world, "constraint")
    names = got["names"]
    assert got["dtensor"] and got["equal"] and got["plain_passes"]
    assert got["placements"][names.index("dp")] == "Shard(dim=0)"
    assert got["placements"][names.index("mp")] == "Replicate()"
    assert got["local_shape"] == (2, 8)
