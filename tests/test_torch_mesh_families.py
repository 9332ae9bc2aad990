"""The mesh families that compute on shards, on a four-rank gloo world,
against the JAX package on four host devices.

One world of 4 spawned ranks serves the module (``tests/torch_family_helpers.py``,
jax-free) and runs every case below in one spawn; the JAX side runs here on
``jax.devices()[:4]`` meanwhile.  Inputs come from numpy with a seed and
weights cross through ``convert.py``.

- Ring attention at ``sp=4`` (twins of ``tests/test_ring_attention.py``):
  causal and not, float32 and bfloat16, and the uneven value scale, against
  JAX's ``make_ring_attention_fn`` at 2e-5 (bfloat16 and the uneven scale at
  the JAX test's own tolerances); the gradients of q, k and v against JAX's
  at 2e-5, so a hop whose backward went the wrong way, or not at all, fails.
- The sequence-parallel transformer at ``sp=4``: outputs and every
  parameter gradient against JAX's ``make_sequence_parallel_apply`` at
  3e-5, replicated on every rank; the over-long and non-divisible errors
  with JAX's texts.
- The GPipe pipeline at ``pp=4`` (twins of ``tests/test_pipeline.py``): the
  homogeneous form for M in {1, 2, 4} and the heterogeneous transformer
  against JAX's pipelines at 2e-5; gradients on embed, block and head
  against JAX's pipeline gradients at 5e-5 (each rank holding its own
  stage's); one schedule step fewer loses the last microbatch; the
  validation errors with JAX's texts.
- Expert parallelism at ``ep=4``: a rank holds E/4 experts; the forward at
  2e-5 and aux at 1e-5 against JAX's ``make_expert_parallel_apply``; each
  rank's expert-bank gradient against its slice of ``jax.grad`` of the
  unsharded ``MoEMLP`` at 1e-5, so a backward that sums over ``ep`` (ep
  times the gradient) fails; the router's and the input's gradients whole
  on every rank.
- The MoE IMPALA step at ``dp=2,mp=2`` against the JAX unmeshed step at
  ``atol=1e-4``, with the expert banks sharded over ``mp`` (twin of
  ``tests/test_sharded_learner.py::test_moe_sharded_matches_unsharded``).
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_family_helpers
from test_pipeline import _Block, _Embed, _Head, _hetero_setup, _stacked_params
from torch_port_helpers import state_to_torch, to_numpy

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.data.trajectory import Trajectory
from scalerl_tpu import config as jconfig
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory
from scalerl_tpu.models.moe import MoEMLP as JaxMoEMLP
from scalerl_tpu.models.transformer import TransformerPolicy as JaxTransformerPolicy
from scalerl_tpu.ops.ring_attention import full_attention as jax_full_attention
from scalerl_tpu.ops.ring_attention import make_ring_attention_fn as jax_ring_fn
from scalerl_tpu.parallel import make_mesh as jax_make_mesh
from scalerl_tpu.parallel import pipeline as jpipe
from scalerl_tpu.parallel.expert import make_expert_parallel_apply as jax_expert_apply
from scalerl_tpu.parallel.sequence import make_sequence_parallel_apply as jax_sp_apply

torch.set_num_threads(1)

WORLD = 4
JOIN_TIMEOUT_S = 150
RING_TOL = dict(rtol=2e-5, atol=2e-5)
RING_BF16_TOL = dict(rtol=0.06, atol=0.06)  # tests/test_ring_attention.py's bf16 bound
RING_UNEVEN_TOL = dict(rtol=1e-4, atol=1e-4)  # its uneven-scale bound
SEQ_TOL = dict(rtol=3e-5, atol=3e-5)
PIPE_TOL = dict(rtol=2e-5, atol=2e-5)
PIPE_GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
EP_TOL = dict(rtol=2e-5, atol=2e-5)
EP_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
B, T, H, D = 2, 32, 2, 8  # T divides the 4-way sp axis


def _jmesh(spec):
    return jax_make_mesh(spec, devices=jax.devices()[:WORLD])


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# -- cases: what the ranks run, and what JAX computes for them here ----------


def _ring_case(causal, dtype, seed, scale=1.0, grads=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    q, k = q * scale, k * scale

    def want():
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        ring = jax.jit(jax_ring_fn(_jmesh("sp=4"), causal=causal))
        args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
        out = {"out": np.asarray(ring(*args), np.float32),
               "full": np.asarray(jax_full_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                     causal=causal))}
        if grads:
            g = jax.jit(jax.grad(lambda *a: (ring(*a).astype(jnp.float32) ** 2).sum(),
                                 argnums=(0, 1, 2)))(*args)
            out.update({n: np.asarray(x, np.float32) for n, x in zip(("dq", "dk", "dv"), g)})
        return out

    return dict(kind="ring", causal=causal, dtype=dtype, q=torch.tensor(q), k=torch.tensor(k),
                v=torch.tensor(v), want=want)


def _sequence_case():
    jmodel = JaxTransformerPolicy(num_actions=4, d_model=32, num_heads=2, num_layers=2,
                                  max_len=T)
    obs = np.random.default_rng(7).normal(size=(B, T, 6)).astype(np.float32)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(obs))
    bad = {"overlong": np.ones((1, 2 * T, 6), np.float32),
           "indivisible": np.ones((1, T - 2, 6), np.float32)}

    def want():
        apply = jax_sp_apply(jmodel, _jmesh("sp=4"))
        out = jax.jit(apply)(jparams, jnp.asarray(obs))
        grads = jax.jit(jax.grad(
            lambda p: (apply(p, jnp.asarray(obs)).baseline ** 2).mean()))(jparams)
        return dict(policy_logits=np.asarray(out.policy_logits),
                    baseline=np.asarray(out.baseline),
                    grads=convert.transformer_to_torch(to_numpy(grads)),
                    errors={k: _error(lambda o=o: apply(jparams, jnp.asarray(o)))
                            for k, o in bad.items()})

    return dict(kind="sequence", model=dict(num_actions=4, d_model=32, num_heads=2,
                                            num_layers=2, max_len=T, obs_dim=6),
                state=convert.transformer_to_torch(to_numpy(jparams)), obs=torch.tensor(obs),
                bad_obs={k: torch.tensor(o) for k, o in bad.items()}, want=want)


def _homogeneous_case(M, grads=False):
    stage, stacked = _stacked_params(WORLD, jax.random.PRNGKey(M))
    x = np.random.default_rng(M).normal(size=(M * 4, 16)).astype(np.float32)

    def stage_fn(p, h):
        return stage.apply(p, h)

    def want():
        pipe = jpipe.make_pipeline_apply(stage_fn, _jmesh("pp=4"), M)
        out = {"out": np.asarray(jax.jit(pipe)(stacked, jnp.asarray(x))),
               "sequential": np.asarray(jpipe.sequential_apply(stage_fn, stacked,
                                                                jnp.asarray(x)))}
        if grads:
            out["grads"] = to_numpy(jax.jit(jax.grad(
                lambda p: (pipe(p, jnp.asarray(x)) ** 2).mean()))(stacked))
        return out

    return dict(kind="pipeline", hetero=False, M=M, grads=grads,
                params=_tree_to_torch(to_numpy(stacked)), x=torch.tensor(x), want=want)


# tests/test_pipeline.py's heterogeneous transformer: its stage functions, and
# its params initialised under one jit (eager Flax inits take seconds)
HETERO_FNS = (lambda p, x: _Embed().apply(p, x), lambda p, x: _Block().apply(p, x),
              lambda p, x: _Head().apply(p, x))
_hetero_params = jax.jit(lambda key: _hetero_setup(WORLD, key)[1])


def _hetero_case(M, batch, seed, grads=False, loop_steps=None, bad=False):
    embed_fn, block_fn, head_fn = HETERO_FNS
    params = _hetero_params(jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).normal(size=(batch, 6, 9)).astype(np.float32)
    tparams = _tree_to_torch(to_numpy(params))
    bad_inputs = {}
    if bad:
        three = jax.tree_util.tree_map(lambda p: p[:3], params)
        bad_inputs = {
            "stage_axis": ({**params, "block": three}, x),
            "batch": (params, np.ones((batch - 1, 6, 9), np.float32)),
        }

    def want():
        pipe = jpipe.make_hetero_pipeline_apply(embed_fn, block_fn, head_fn, _jmesh("pp=4"), M)
        out = {"out": np.asarray(jax.jit(pipe)(params, jnp.asarray(x))),
               "sequential": np.asarray(jpipe.hetero_sequential_apply(
                   embed_fn, block_fn, head_fn, params, jnp.asarray(x)))}
        if grads:
            out["grads"] = to_numpy(jax.jit(jax.grad(
                lambda p: (pipe(p, jnp.asarray(x)) ** 2).mean()))(params))
        out["errors"] = {k: _error(lambda p=p, b=b: pipe(p, jnp.asarray(b)))
                         for k, (p, b) in bad_inputs.items()}
        return out

    return dict(kind="pipeline", hetero=True, M=M, grads=grads, loop_steps=loop_steps,
                params=tparams, x=torch.tensor(x),
                bad={k: (_tree_to_torch(to_numpy(p)), torch.tensor(b))
                     for k, (p, b) in bad_inputs.items()}, want=want)


def _expert_case():
    jmodel = JaxMoEMLP(num_experts=8, d_model=16, d_hidden=32, capacity_factor=2.0)
    x = np.random.default_rng(2).normal(size=(128, 16)).astype(np.float32)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(x))

    def loss(p, xs):
        out = jmodel.apply(p, xs)
        return (out.out ** 2).sum() + 0.01 * out.aux_loss

    def want():
        apply_fn, sharded = jax_expert_apply(jmodel, _jmesh("ep=4"), jparams)
        got = apply_fn(sharded, jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jparams, jnp.asarray(x))
        return dict(out=np.asarray(got.out), aux=float(got.aux_loss),
                    dispatch_frac=float(got.dispatch_frac),
                    grads=convert.moe_mlp_to_torch(to_numpy(gp)), x=np.asarray(gx))

    return dict(kind="expert", model=dict(num_experts=8, d_model=16, d_hidden=32,
                                          capacity_factor=2.0),
                state=convert.moe_mlp_to_torch(to_numpy(jparams)), x=torch.tensor(x),
                want=want)


def _moe_impala_case():
    fields = dict(policy_arch="moe", d_model=32, moe_experts=4, moe_hidden=64, use_lstm=False,
                  rollout_length=5, batch_size=8, max_timesteps=0)
    obs_dim, A = 8, 4
    jagent = jimpala.ImpalaAgent(jconfig.ImpalaArguments(**fields), obs_shape=(obs_dim,),
                                 num_actions=A, obs_dtype=jnp.float32,
                                 key=jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 8, A)).astype(np.float32)
    logits[-1] = 0.0
    traj = dict(obs=rng.normal(size=(6, 8, obs_dim)).astype(np.float32),
                action=rng.integers(0, A, size=(6, 8)).astype(np.int32),
                reward=(rng.normal(size=(6, 8)) * 1.5).astype(np.float32),
                done=rng.uniform(size=(6, 8)) < 0.2, logits=logits)
    tree = convert.moe_policy_net_to_torch

    def want():
        jstate, jm = jax.jit(jagent.make_learn_fn())(
            jagent.state, JaxTrajectory(**{k: jnp.asarray(v) for k, v in traj.items()},
                                        core_state=()))
        return dict(want_state=state_to_torch(jstate, tree), want_metrics=to_numpy(jm))

    return dict(kind="moe_impala", spec="dp=2,mp=2", args=tconfig.ImpalaArguments(**fields),
                obs_shape=(obs_dim,), num_actions=A, state=state_to_torch(jagent.state, tree),
                batch=Trajectory(**{k: torch.tensor(v) for k, v in traj.items()}), want=want)


def _cases():
    return {
        "ring_f32_causal": _ring_case(True, torch.float32, 0),
        "ring_f32_full": _ring_case(False, torch.float32, 1),
        "ring_bf16_causal": _ring_case(True, torch.bfloat16, 4, grads=False),
        "ring_uneven": _ring_case(False, torch.float32, 3, scale=30.0, grads=False),
        "sequence": _sequence_case(),
        "pipe_m1": _homogeneous_case(1),
        "pipe_m2": _homogeneous_case(2, grads=True),
        "pipe_m4": _homogeneous_case(4),
        "hetero": _hetero_case(4, 8, 0, bad=True),
        "hetero_grads": _hetero_case(2, 4, 6, grads=True),
        "hetero_short": _hetero_case(4, 8, 4, loop_steps=4 + WORLD - 2),
        "expert": _expert_case(),
        "moe_impala": _moe_impala_case(),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every case on one spawned world of ``WORLD`` ranks; returns the
    cases, with the JAX side computed here while the ranks run, and rank
    0's results."""
    workdir = str(tmp_path_factory.mktemp("family_world"))
    cases = _cases()
    torch.save({k: {f: v for f, v in c.items() if f != "want"} for k, c in cases.items()},
               f"{workdir}/cases.pt")
    ctx = mp.start_processes(torch_family_helpers.run_rank,
                             args=(WORLD, _free_port(), workdir), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for case in cases.values():
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


def _result(world, name):
    cases, results = world
    assert name in results, "not run: an earlier case of the world failed"
    got = results[name]
    assert "error" not in got, got.get("error")
    return cases[name], got


def _close(got, want, tol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


# -- ring attention -----------------------------------------------------------


@pytest.mark.parametrize("name", ["ring_f32_causal", "ring_f32_full"])
def test_ring_attention_matches_jax_with_gradients(world, name):
    case, got = _result(world, name)
    _close(got["out"], case["out"], RING_TOL, "out")
    _close(got["out"], case["full"], RING_TOL, "out vs full attention")
    for g in ("dq", "dk", "dv"):
        _close(got[g], case[g], RING_TOL, g)


def test_ring_attention_bfloat16_matches_jax(world):
    case, got = _result(world, "ring_bf16_causal")
    assert got["dtype"] == "torch.bfloat16"
    _close(got["out"], case["out"], RING_BF16_TOL, "bf16 ring vs JAX's")
    _close(got["out"], case["full"], RING_BF16_TOL, "bf16 ring vs float32 full attention")
    assert np.isfinite(got["dq"].numpy()).all()


def test_ring_handles_uneven_value_scale(world):
    case, got = _result(world, "ring_uneven")
    _close(got["out"], case["out"], RING_UNEVEN_TOL, "out")
    _close(got["out"], case["full"], RING_UNEVEN_TOL, "out vs full attention")


# -- sequence parallelism -----------------------------------------------------


def test_sequence_parallel_transformer_matches_jax(world):
    case, got = _result(world, "sequence")
    _close(got["policy_logits"], case["policy_logits"], SEQ_TOL, "policy_logits")
    _close(got["baseline"], case["baseline"], SEQ_TOL, "baseline")
    assert got["replicated"]


def test_sequence_parallel_gradients_match_jax(world):
    case, got = _result(world, "sequence")
    assert set(got["grads"]) == set(case["grads"])
    for name, g in got["grads"].items():
        _close(g, case["grads"][name], SEQ_TOL, name)
    assert sum(float(g.abs().sum()) for g in got["grads"].values()) > 0


def test_sequence_parallel_errors_match_jax(world):
    case, got = _result(world, "sequence")
    assert case["errors"]["overlong"] and case["errors"]["indivisible"]
    assert got["errors"] == case["errors"]


# -- pipelines ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["pipe_m1", "pipe_m2", "pipe_m4", "hetero"])
def test_pipeline_matches_jax(world, name):
    case, got = _result(world, name)
    _close(got["out"], case["out"], PIPE_TOL, "vs JAX's pipeline")
    _close(got["out"], case["sequential"], PIPE_TOL, "vs the sequential reference")
    assert got["replicated"]
    if name == "hetero":
        assert tuple(got["out"].shape) == (8, 6, 5)  # the head's width, not the block's


def _stage_grads(got_grads):
    """Each rank's own stage gradients -> one dict: the block leaves stacked
    over the ranks, embed from rank 0, head from the last."""
    merged = {}
    for rank, own in enumerate(got_grads):
        for path, g in own.items():
            merged.setdefault(path, {})[rank] = g
    return {path: (torch.stack([by_rank[r] for r in range(WORLD)])
                   if len(by_rank) == WORLD else next(iter(by_rank.values())))
            for path, by_rank in merged.items()}


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", ["pipe_m2", "hetero_grads"])
def test_pipeline_gradients_match_jax(world, name):
    case, got = _result(world, name)
    grads = _stage_grads(got["grads"])
    want_paths = [tuple(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(case["grads"])[0]]
    assert set(grads) == set(want_paths)
    if case["hetero"]:  # embed from stage 0 only, head from the last only
        assert len(got["grads"][0]) > len(got["grads"][1]) < len(got["grads"][3])
    for path in want_paths:
        _close(grads[path], _jax_leaf(case["grads"], path), PIPE_GRAD_TOL, str(path))


def test_pipeline_schedule_is_tight(world):
    case, got = _result(world, "hetero_short")
    mb = case["x"].shape[0] // case["M"]
    _close(got["out"][:-mb], case["sequential"][:-mb], PIPE_TOL, "earlier microbatches")
    np.testing.assert_array_equal(got["out"][-mb:].numpy(), 0.0)


def test_pipeline_validation_errors_match_jax(world):
    case, got = _result(world, "hetero")
    assert set(case["errors"]) == {"stage_axis", "batch"}
    assert all(case["errors"].values())
    assert got["errors"] == case["errors"]


# -- expert parallelism ---------------------------------------------------------


def test_expert_parallel_matches_jax(world):
    case, got = _result(world, "expert")
    assert got["local_experts"] == 8 // WORLD
    assert got["specs"]["w_in"] == ("ep", None, None) and got["specs"]["router.weight"] == ()
    _close(got["out"], case["out"], EP_TOL, "out")
    np.testing.assert_allclose(got["aux"], case["aux"], rtol=1e-5, atol=1e-5)
    assert got["dispatch_frac"] == pytest.approx(case["dispatch_frac"], abs=1e-7)
    assert got["replicated"]


def test_expert_parallel_gradients_are_each_ranks_slice(world):
    case, got = _result(world, "expert")
    # the banks gathered from the 4 ranks (2 experts each) are JAX's whole
    # gradient, once: a backward that summed over ep would give 4x
    _close(got["w_in"], case["grads"]["w_in"], EP_GRAD_TOL, "w_in")
    _close(got["w_out"], case["grads"]["w_out"], EP_GRAD_TOL, "w_out")
    _close(got["router"], case["grads"]["router.weight"], EP_GRAD_TOL, "router")
    _close(got["x"], case["x"], EP_GRAD_TOL, "x")


# -- the MoE policy on the dp x mp learner ------------------------------------------


def test_moe_impala_meshed_step_matches_jax_unmeshed(world):
    case, got = _result(world, "moe_impala")
    want, state = case["want_state"], got["state"]
    for name, g in state.params.items():
        _close(g, want.params[name], dict(rtol=0, atol=1e-4), name)
    for k in ("total_loss", "grad_norm"):
        assert abs(float(got["metrics"][k]) - float(case["want_metrics"][k])) < 1e-4, k
    assert got["layout"]["mp"] >= 2  # w_in/w_out (and their moments) over mp
    assert int(state.step) == int(want.step)


def test_moe_impala_step_runs_its_experts_on_their_mp_shards(world):
    """The banks over mp run through the expert-parallel apply with the mp
    group: each rank runs its own experts, and no state leaf is gathered."""
    _, got = _result(world, "moe_impala")
    assert got["seen"]["experts"] > 0
    assert got["seen"]["dtensor_gathers"] == 0
