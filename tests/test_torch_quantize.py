"""Quantized snapshots (``runtime/quantize.py``), the param plane's quantized
push, and the disaggregated wire's numpy quantization, against the JAX
package.

One Flax ``TransformerPolicy`` init is converted into the port; both
packages quantize their own tree.  Per-leaf int8 depends only on
``max|x|``, so a transposed Dense kernel gives the transposed int8 tensor
and the same scale: the comparisons are exact (round half to even and one
float32 division on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.convert import _transformer_names
from scalerl_torch.genrl import disagg as tdisagg
from scalerl_torch.runtime import quantize as tq
from scalerl_torch.runtime.param_server import ParameterServer, ParamSnapshotPlane
from scalerl_tpu.genrl import disagg as jdisagg
from scalerl_tpu.models.transformer import TransformerPolicy as JaxTransformerPolicy
from scalerl_tpu.runtime import quantize as jq

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    jm = JaxTransformerPolicy(num_actions=11, vocab_size=11, d_model=32, num_heads=2,
                              num_layers=2, max_len=16)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 2), jnp.int32))["params"]
    # a leaf of all zeros takes the 1e-12 scale floor; a leaf with exact
    # halves exercises round-half-to-even
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["block_0"]["mlp_in"]["kernel"] = jnp.zeros_like(params["block_0"]["mlp_in"]["kernel"])
    halves = (jnp.arange(32 * 96, dtype=jnp.float32).reshape(32, 96) % 7 - 3) * 0.5
    params["block_1"]["qkv"]["kernel"] = halves.at[0, 0].set(127.0 * 0.5)
    host = jax.tree_util.tree_map(np.asarray, params)
    return dict(jax=params, host=host, port=convert.transformer_to_torch(host))


def _paired_leaves(jtree, ttree):
    for path, name in _transformer_names(jtree).items():
        leaf = jtree
        for key in path:
            leaf = leaf[key]
        yield path, name, leaf, ttree[name]


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantize_tree_matches_jax_exactly(trees, mode):
    jqt = jq.quantize_tree(trees["jax"], mode)
    tqt = tq.quantize_tree(trees["port"], mode)
    seen_q = 0
    for path, name, jleaf, tleaf in _paired_leaves(jqt, tqt):
        kernel = path[-1] == "kernel"
        if isinstance(jleaf, jq.QuantizedLeaf):
            assert isinstance(tleaf, tq.QuantizedLeaf), name
            seen_q += 1
            want = np.asarray(jleaf.q.astype(jnp.float32))
            want = want.T if kernel else want
            got = tleaf.q.to(torch.float32).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert tleaf.q.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
            assert tleaf.dtype == torch.float32
            if mode == "int8":
                assert np.float32(tleaf.scale.item()) == np.float32(jleaf.scale), name
            else:
                assert jleaf.scale is None and tleaf.scale is None
        else:
            assert not isinstance(tleaf, tq.QuantizedLeaf), name
            assert tleaf is trees["port"][name]  # 1-D leaves pass through
    assert seen_q == sum(v.ndim >= 2 for v in trees["port"].values())
    assert tq.tree_wire_bytes(tqt) == jq.tree_wire_bytes(jqt)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_dequantize_tree_matches_jax_exactly(trees, mode):
    jback = jq.dequantize_tree(jq.quantize_tree(trees["jax"], mode))
    tback = tq.dequantize_tree(tq.quantize_tree(trees["port"], mode))
    for path, name, jleaf, tleaf in _paired_leaves(jback, tback):
        want = np.asarray(jleaf)
        want = want.T if path[-1] == "kernel" else want
        assert tleaf.dtype == torch.float32
        np.testing.assert_array_equal(tleaf.numpy(), want, err_msg=name)
        src = trees["port"][name]
        if mode == "int8" and src.ndim >= 2:
            # half a scale in exact arithmetic, plus float32's rounding of
            # x / s and of q * s (chip_smoke.py::INT8_DEQ_SLACK)
            scale = max(float(src.abs().max()) / 127.0, 1e-12)
            err = float((tleaf.double() - src.double()).abs().max())
            assert err <= scale * (0.5 + 2 * 127 * 2.0 ** -24), name


def test_quantize_rejects_unknown_modes_and_keeps_non_float_leaves():
    with pytest.raises(ValueError, match="quantize mode"):
        tq.quantize_tree({"w": torch.ones(2, 2)}, "fp4")
    ids = torch.arange(6).reshape(2, 3)
    out = tq.quantize_tree({"ids": ids, "nested": [torch.ones(2, 2), torch.ones(3)]}, "int8")
    assert out["ids"] is ids
    assert isinstance(out["nested"][0], tq.QuantizedLeaf) and out["nested"][1].dtype == torch.float32


class _Plane(ParamSnapshotPlane):
    def __init__(self, params):
        self._init_param_plane(params, torch.device("cpu"))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_push_dequantizes_on_read_cached_per_generation(trees, mode):
    """The JAX plane's contract (``scalerl_tpu/runtime/param_server.py:83-``):
    a quantized push stores the small format, the first read dequantizes
    and caches it until the next push; 1-D leaves are copies, never the
    live tensors."""
    live = {k: v.clone() for k, v in trees["port"].items()}
    plane = _Plane(live)
    assert plane.push_params(live, learner_step=4, quantize=mode) == 1
    assert plane._params is None and plane._quantized is not None
    first, gen = plane._snapshot_params()
    again, _ = plane._snapshot_params()
    assert gen == 1 and first is again  # cached
    want = {k: v.clone() for k, v in tq.dequantize_tree(tq.quantize_tree(live, mode)).items()}
    for k, v in want.items():
        assert torch.equal(first[k], v), k
    bias = next(k for k, v in live.items() if v.ndim == 1)
    live[bias].add_(1.0)  # the learner updates in place: the snapshot holds
    assert torch.equal(first[bias], want[bias])
    assert plane.staleness_steps(1) == 0.0
    assert plane.push_params(live, learner_step=6) == 2  # full precision again
    assert plane._quantized is None and plane._snapshot_params()[0][bias].equal(live[bias])
    assert plane.staleness_steps(1) == 2.0


def test_parameter_server_push_clears_a_quantized_snapshot(trees):
    ps = ParameterServer()
    ps.push_params(trees["port"], quantize="int8")
    assert ps._quantized is not None
    assert ps.push(trees["port"]) == 2 and ps._quantized is None
    weights, version = ps.pull(-1)
    assert version == 2
    np.testing.assert_array_equal(weights["pos_embed"], trees["port"]["pos_embed"].numpy())


@pytest.mark.parametrize("mode", ["int8", "none"])
def test_wire_quantization_matches_jax_exactly(trees, mode):
    """``genrl/disagg.py``'s numpy wire format: the same frames for the
    same tree (here the port's state dict as numpy, both packages), the
    same decoded arrays, the same byte count."""
    host = {k: v.numpy() for k, v in trees["port"].items()}
    host["bf16_widened"] = np.asarray(jnp.ones((3, 4), jnp.bfloat16))
    jw = jdisagg.quantize_wire_tree(host, mode)
    tw = tdisagg.quantize_wire_tree(host, mode)
    assert tdisagg.wire_tree_bytes(tw) == jdisagg.wire_tree_bytes(jw)
    for k in host:
        j, t = jw[k], tw[k]
        if isinstance(j, dict):
            assert set(t) == set(j) and t["scale"] == j["scale"] and t["dtype"] == j["dtype"]
            np.testing.assert_array_equal(t["q"], j["q"])
            assert t["q"].dtype == np.int8
        else:
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype
    jb, tb = jdisagg.dequantize_wire_tree(jw), tdisagg.dequantize_wire_tree(tw)
    for k in host:
        np.testing.assert_array_equal(tb[k], jb[k])
        assert tb[k].dtype == jb[k].dtype
    if mode == "int8":
        assert tdisagg.wire_tree_bytes(tw) < 0.3 * tdisagg.wire_tree_bytes(
            tdisagg.quantize_wire_tree(host, "none"))
    with pytest.raises(ValueError):
        tdisagg.quantize_wire_tree(host, "fp4")


def test_wire_int8_agrees_with_the_device_format(trees):
    """The wire's numpy int8 and ``runtime/quantize.py``'s tensor int8 are
    one format: the same payload and scale for every leaf."""
    host = {k: v.numpy() for k, v in trees["port"].items()}
    tw = tdisagg.quantize_wire_tree(host, "int8")
    tqt = tq.quantize_tree(trees["port"], "int8")
    for k, leaf in tqt.items():
        if isinstance(leaf, tq.QuantizedLeaf):
            np.testing.assert_array_equal(tw[k]["q"], leaf.q.numpy())
            assert np.float32(tw[k]["scale"]) == np.float32(leaf.scale.item())


def test_upload_wire_params_one_copy_and_refusals(trees):
    host = {k: v.numpy() for k, v in trees["port"].items()}
    up = tdisagg.upload_wire_params(host, torch.device("cpu"))
    assert list(up) == list(host)
    for k, v in host.items():
        assert up[k].shape == v.shape and up[k].dtype == torch.float32
        np.testing.assert_array_equal(up[k].numpy(), v)
    base = {t.untyped_storage().data_ptr() for t in up.values()}
    assert len(base) == 1  # one buffer, one copy
    with pytest.raises(TypeError, match="float32"):
        tdisagg.upload_wire_params({"w": np.ones(3, np.float64)}, torch.device("cpu"))
    with pytest.raises(TypeError, match="float32"):
        tdisagg.upload_wire_params({"w": torch.ones(3)}, torch.device("cpu"))
    with pytest.raises(TypeError, match="dict"):
        tdisagg.upload_wire_params([np.ones(3, np.float32)], torch.device("cpu"))
