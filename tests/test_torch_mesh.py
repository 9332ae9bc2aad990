"""The port's mesh and layout rules against the JAX package's.

``MeshSpec.parse``, ``mesh_spec_from_args``, ``pad_to_multiple``, the
heuristic ``infer_param_spec`` and the logical ``logical_to_spec`` /
``mp_param_spec`` are pure functions of names, shapes and axis extents, so
they are held to the JAX functions leaf by leaf on the same param trees:
a JAX tree goes through ``convert.py`` with every leaf coded by its index,
so each port leaf finds its Flax leaf and the transpose between them.  No
process group is needed.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.parallel import logical as tlogical
from scalerl_torch.parallel import mesh as tmesh
from scalerl_torch.parallel import sharding as tsharding
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents.impala import ImpalaAgent as JaxImpalaAgent
from scalerl_tpu.parallel import logical as jlogical
from scalerl_tpu.parallel import mesh as jmesh
from scalerl_tpu.parallel import sharding as jsharding

torch.set_num_threads(1)

SPECS = ["dp=4, tp=2", "dp=8", "fsdp=2,tp=2,dp=2", "mp=2,dp=4", "ep=2,sp=2,pp=2", "", None,
         "dp=2,,mp=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_spec_parse_matches_jax(spec):
    t, j = tmesh.MeshSpec.parse(spec), jmesh.MeshSpec.parse(spec)
    assert t.sizes == j.sizes and t.total == j.total and t.shape() == j.shape()
    assert all(t.size(a) == j.size(a) for a in jmesh.AXIS_NAMES)
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES


def test_mesh_spec_errors_match_jax():
    for bad in ("bogus=2", "dp=2,xp=2"):
        with pytest.raises(ValueError) as want:
            jmesh.MeshSpec.parse(bad)
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec.parse(bad)
        assert str(got.value) == str(want.value)


ARGS = [dict(), dict(mp_size=2), dict(mp_size=2, dp_size=2), dict(dp_size=8), dict(dp_size=3),
        dict(mesh_shape="dp=8", mp_size=2), dict(mp_size=4), dict(mp_size=8), dict(mp_size=3)]


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("kw", ARGS, ids=[str(k) for k in ARGS])
def test_mesh_spec_from_args_matches_jax(kw, n):
    targs, jargs = tconfig.ImpalaArguments(**kw), jconfig.ImpalaArguments(**kw)
    try:
        want = jmesh.mesh_spec_from_args(jargs, n_devices=n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_spec_from_args(targs, n_devices=n)
        assert str(got.value) == str(e)
        return
    assert tmesh.mesh_spec_from_args(targs, n_devices=n) == want


def test_one_device_mesh_needs_no_group_and_larger_ones_do():
    mesh = tmesh.make_mesh("dp=1,mp=1")
    assert mesh.device_mesh is None and mesh.size == 1
    assert mesh.shape == {a: 1 for a in tmesh.AXIS_NAMES}
    assert tmesh.resolve_mesh(mesh) is mesh and tmesh.make_mesh().shape["dp"] == 1
    with pytest.raises(ValueError, match="init_process_group"):
        tmesh.make_mesh("dp=2,mp=2")
    with pytest.raises(ValueError, match="init_process_group"):
        tmesh.make_mesh(n_devices=4)


@pytest.mark.parametrize("n,multiple,axis", [(5, 4, 0), (5, 5, 0), (3, 2, 1), (8, 3, 1)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    x = np.arange(n * 3, dtype=np.float32).reshape((n, 3) if axis == 0 else (3, n))
    got, want = tsharding.pad_to_multiple(x, multiple, axis), jsharding.pad_to_multiple(
        x, multiple, axis)
    np.testing.assert_array_equal(got, want)
    assert (got is x) == (want is x)


# ---------------------------------------------------------------------------
# param trees, leaf by leaf


def _coded(tree):
    """Every leaf replaced by ``offset + arange`` (float64, exact), the
    offsets telling the leaves apart."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out, offset = [], 1
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        out.append((np.arange(n, dtype=np.float64) + offset).reshape(leaf.shape))
        offset += n
    return jax.tree_util.tree_unflatten(treedef, out)


def _pairs(jparams, to_torch):
    """``[(flax path, flax leaf, port name, port leaf, perm)]``: perm takes
    the Flax leaf to the port's (``np.transpose(flax, perm) == port``)."""
    coded = _coded(jax.tree_util.tree_map(np.asarray, jparams))
    flat = jax.tree_util.tree_flatten_with_path(coded)[0]
    by_first = {float(leaf.reshape(-1)[0]): (path, leaf) for path, leaf in flat}
    real = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    out = []
    for name, t in to_torch(coded).items():
        t = t.double().numpy()
        path, f = by_first[float(t.reshape(-1)[0])]
        perm = next(p for p in itertools.permutations(range(f.ndim))
                    if np.transpose(f, p).shape == t.shape and np.array_equal(np.transpose(f, p), t))
        out.append((path, real[path] if path in real else f, name, torch.zeros(t.shape), perm))
    return out


def _to_port(spec_f, perm):
    """A Flax-layout spec in the port's dims."""
    if not spec_f:
        return ()
    return tuple(spec_f[i] for i in perm)


TREES = {
    "atari": (dict(use_lstm=False, hidden_size=64), (36, 36, 4), convert.flax_to_torch),
    "mlp": (dict(use_lstm=False, hidden_size=64), (16,), convert.mlp_policy_to_torch),
    "transformer": (dict(policy_arch="transformer", d_model=32, n_heads=2, n_layers=2),
                    (4,), convert.transformer_policy_net_to_torch),
}


def _tree(name):
    kw, obs, to_torch = TREES[name]
    agent = JaxImpalaAgent(jconfig.ImpalaArguments(max_timesteps=0, rollout_length=6,
                                                   batch_size=8, **kw),
                           obs_shape=obs, num_actions=6 if len(obs) == 3 else 4,
                           obs_dtype=jnp.uint8 if len(obs) == 3 else jnp.float32)
    return agent, _pairs(agent.state.params, to_torch)


@pytest.mark.parametrize("spec", ["fsdp=2,tp=2,dp=2", "fsdp=4,dp=2", "tp=8", "dp=8",
                                  "fsdp=8"])
@pytest.mark.parametrize("tree", ["atari", "mlp", "transformer"])
def test_infer_param_spec_matches_jax_leaf_by_leaf(tree, spec):
    jm, tm = jmesh.make_mesh(spec), tmesh.MeshSpec.parse(spec)
    _, pairs = _tree(tree)
    sharded = 0
    for path, f, name, t, perm in pairs:
        want = tuple(jsharding.infer_param_spec(path, f, jm))
        got = tsharding.infer_param_spec(("params", name), t, tm)
        assert got == _to_port(want, perm), (name, got, want)
        sharded += any(e is not None for e in got)
    if spec != "dp=8" and tree != "mlp":
        assert sharded > 0


def test_infer_param_spec_rules_on_shapes():
    """The JAX test's cases, on plain shapes: rank 1 replicates, the
    largest dim goes to fsdp and the next to tp, tiny or indivisible dims
    replicate."""
    mesh = tmesh.MeshSpec.parse("fsdp=2,tp=2,dp=2")
    assert tsharding.infer_param_spec((), torch.zeros(128), mesh) == ()
    assert tsharding.infer_param_spec((), torch.zeros(512, 64), mesh) == ("fsdp", "tp")
    assert tsharding.infer_param_spec((), torch.zeros(7, 13), mesh) == (None, None)
    assert tsharding.infer_param_spec((), torch.zeros(64, 6), mesh) == ("fsdp", None)


def test_lstm_trees_replicate_every_leaf():
    from scalerl_torch.models.atari import AtariNet

    net = AtariNet(num_actions=4, use_lstm=True, hidden_size=32, obs_shape=(16, 16, 4),
                   device="cpu")
    params = dict(net.named_parameters())
    assert tsharding.has_scanned_params(params)
    specs = tsharding.param_sharding(params, tmesh.MeshSpec.parse("fsdp=2,tp=2,dp=2"))
    assert all(s == () for s in specs.values())
    jagent = JaxImpalaAgent(jconfig.ImpalaArguments(max_timesteps=0, use_lstm=True,
                                                    hidden_size=32),
                            obs_shape=(16, 16, 4), num_actions=4)
    assert jsharding.has_scanned_params(jagent.state.params)


@pytest.mark.parametrize("spec", ["dp=4,mp=2", "dp=2,mp=4", "mp=8", "dp=8"])
def test_mp_param_spec_matches_jax_leaf_by_leaf(spec):
    jm, tm = jmesh.make_mesh(spec), tmesh.MeshSpec.parse(spec)
    agent, pairs = _tree("transformer")
    n_mp = 0
    for path, f, name, t, perm in pairs:
        want = tuple(jlogical.mp_param_spec(path, f, jm))
        got = tlogical.mp_param_spec(("params", name), t, tm)
        assert got == _to_port(want, perm), (name, got, want)
        n_mp += "mp" in got
    assert (n_mp >= 4) == (tm.size("mp") > 1)
    assert tlogical.has_mp_params({n: t for _, _, n, t, _ in pairs})
    assert jlogical.has_mp_params(agent.state.params)


def test_opt_state_moments_inherit_the_param_layout():
    """The port's RMSProp moments (``opt_state.nu.<param name>``) take the
    layout of their params, as the JAX ``nu`` leaves do."""
    from scalerl_torch.agents import impala as timpala

    targs = tconfig.ImpalaArguments(policy_arch="transformer", d_model=32, n_heads=2,
                                    n_layers=2, max_timesteps=0, rollout_length=6,
                                    batch_size=8, use_lstm=False)
    agent = timpala.ImpalaAgent(targs, (4,), 4, device="cpu")
    mesh = tmesh.MeshSpec.parse("dp=4,mp=2")
    specs = tlogical.mp_param_sharding(agent.state, mesh)
    qkv = [k for k in specs.params if "qkv" in k]
    assert qkv and all(specs.params[k] == ("mp", None) for k in qkv)
    assert all(specs.opt_state["nu"][k] == specs.params[k] for k in specs.params)
    assert specs.step == () and specs.opt_state["count"] == ()


def test_logical_to_spec_matches_jax_and_never_double_maps():
    jm, tm = jmesh.make_mesh("dp=4,mp=2"), tmesh.MeshSpec.parse("dp=4,mp=2")
    cases = [(("experts", "mlp", "heads"), (4, 8, 8)), (("embed", "heads"), (32, 96)),
             (("vocab",), (3,)), (("batch", None), (8, 4)), ((None, "mlp"), (2, 6))]
    for axes, shape in cases:
        got = tlogical.logical_to_spec(axes, shape, tm)
        assert got == tuple(jlogical.logical_to_spec(axes, shape, jm)), axes
        assert [e for e in got if e is not None].count("mp") <= 1
    assert tlogical.LOGICAL_RULES == jlogical.LOGICAL_RULES
    assert tlogical.MP_AXIS == jlogical.MP_AXIS


def test_batch_sharding_tree_splits_time_major_and_core_state():
    from scalerl_torch.data.trajectory import Trajectory

    B = 8
    traj = Trajectory(obs=torch.zeros(3, B, 4), action=torch.zeros(3, B, dtype=torch.long),
                      reward=torch.zeros(3, B), done=torch.zeros(3, B, dtype=torch.bool),
                      logits=torch.zeros(3, B, 2), core_state=((torch.zeros(B, 16),
                                                                torch.zeros(B, 16)),))
    tree = tsharding.batch_sharding_tree(traj, tmesh.MeshSpec.parse("dp=8"))
    assert tree.obs == (None, ("dp", "fsdp")) == tsharding.trajectory_sharding()
    assert tree.core_state[0][0] == (("dp", "fsdp"),) == tsharding.batch_sharding()
    flat = tsharding.batch_sharding_tree({"x": torch.zeros(B, 3), "s": torch.zeros(())},
                                         time_major=False)
    assert flat == {"x": (("dp", "fsdp"),), "s": ()}


def test_one_device_mesh_step_is_the_plain_step_and_checkpoints(tmp_path):
    """``enable_mesh("dp=1")`` with no process group: the same step, bit for
    bit, through the meshed wrapper; its checkpoint restores the state."""
    from scalerl_torch.agents import impala as timpala
    from scalerl_torch.data.trajectory import Trajectory

    args = tconfig.ImpalaArguments(use_lstm=False, hidden_size=32, rollout_length=5,
                                   batch_size=4, max_timesteps=0)
    rng = np.random.default_rng(0)
    traj = Trajectory(obs=torch.tensor(rng.normal(size=(6, 4, 8)).astype(np.float32)),
                      action=torch.tensor(rng.integers(0, 4, (6, 4))),
                      reward=torch.tensor(rng.normal(size=(6, 4)).astype(np.float32)),
                      done=torch.tensor(rng.uniform(size=(6, 4)) < 0.2),
                      logits=torch.tensor(rng.normal(size=(6, 4, 4)).astype(np.float32)))
    plain = timpala.ImpalaAgent(args, (8,), 4, device="cpu")
    meshed = timpala.ImpalaAgent(args, (8,), 4, device="cpu")
    meshed.enable_mesh("dp=1")
    assert meshed.mesh.device_mesh is None
    assert plain.learn(traj) == meshed.learn(traj)
    for k, v in plain.get_weights().items():
        assert torch.equal(v, meshed.get_weights()[k]), k
    meshed.save_checkpoint(str(tmp_path / "ckpt"))
    other = timpala.ImpalaAgent(dataclasses.replace(args, seed=3), (8,), 4, device="cpu")
    other.enable_mesh("dp=1")
    other.load_checkpoint(str(tmp_path / "ckpt"))
    for k, v in meshed.get_weights().items():
        assert torch.equal(v, other.get_weights()[k]), k


def test_parallel_act_fn_on_one_device():
    from scalerl_torch.parallel import make_parallel_act_fn

    w = torch.arange(6.0).reshape(3, 2)
    act = make_parallel_act_fn(lambda p, x: x @ p["w"], "dp=1", {"w": w})
    out = act(act.shard_params({"w": w}), act.shard_batch(torch.ones(4, 3)))
    assert torch.equal(out, torch.ones(4, 3) @ w)
