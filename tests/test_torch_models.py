"""``AtariNet`` and ``MLPPolicyNet`` in the PyTorch port against the Flax
models, and ``convert.py``.

Weights come from the Flax init and go through ``scalerl_torch.convert``;
inputs are made from a numpy seed.  float32 agrees at 1e-5 (same products,
summed in another order).  With ``compute_dtype=bfloat16`` the two
frameworks round to bf16 at different points, so they agree at rtol 2e-2.
The LSTM core is checked with dones in mid-sequence and a carried state:
outputs and the returned carry at 1e-5 in float32; with a bf16 torso the
core still runs in float32 on both sides, so its carry is float32 and the
outputs keep the bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.models.atari import AtariNet, same_padding
from scalerl_torch.models.policy import MLPPolicyNet
from scalerl_tpu.models.atari import AtariNet as FlaxAtariNet
from scalerl_tpu.models.policy import MLPPolicyNet as FlaxMLPPolicyNet

torch.set_num_threads(1)


def _inputs(T, B, A, obs=(84, 84, 4), seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, size=(T, B) + obs).astype(np.uint8),
        rng.integers(0, A, size=(T, B)).astype(np.int32),
        (rng.normal(size=(T, B)) * 2).astype(np.float32),  # some clip at +-1
        rng.uniform(size=(T, B)) < 0.3,
    )


def _flax_and_port(A, hidden=512, dtype="float32", obs=(84, 84, 4), seed=0, use_lstm=False):
    flax_model = FlaxAtariNet(
        num_actions=A, use_lstm=use_lstm, hidden_size=hidden, dtype=jnp.dtype(dtype)
    )
    frames, la, rew, done = _inputs(2, 1, A, obs)
    params = jax.jit(flax_model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(frames), jnp.asarray(la),
        jnp.asarray(rew), jnp.asarray(done),
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    port = AtariNet(
        num_actions=A, use_lstm=use_lstm, hidden_size=hidden, obs_shape=obs,
        dtype=getattr(torch, dtype), device="cpu",
    )
    port.load_state_dict(convert.flax_to_torch(params))
    return flax_model, params, port


def _run_both(flax_model, params, port, inputs):
    frames, la, rew, done = inputs
    ref, _ = jax.jit(flax_model.apply)(params, *(jnp.asarray(x) for x in inputs))
    with torch.no_grad():
        out, core = port(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    assert core == ()
    return ref, out


def test_same_padding_matches_flax_same():
    # the three convs of AtariNet at 84x84: 84 -> 21 -> 11 -> 11
    assert same_padding(84, 8, 4) == (2, 2)
    assert same_padding(21, 4, 2) == (1, 2)
    assert same_padding(11, 3, 1) == (1, 1)


@pytest.mark.parametrize("A", [4, 6])
def test_atari_net_f32_matches_flax(A):
    flax_model, params, port = _flax_and_port(A)
    assert port.fc.in_features == 11 * 11 * 64
    ref, out = _run_both(flax_model, params, port, _inputs(2, 3, A, seed=A))
    np.testing.assert_allclose(
        out.policy_logits.numpy(), np.asarray(ref.policy_logits), atol=1e-5, rtol=1e-5
    )
    np.testing.assert_allclose(
        out.baseline.numpy(), np.asarray(ref.baseline), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize("A", [4, 6])
def test_atari_net_bf16_matches_flax(A):
    flax_model, params, port = _flax_and_port(A, dtype="bfloat16")
    ref, out = _run_both(flax_model, params, port, _inputs(2, 3, A, seed=A))
    assert out.policy_logits.dtype == torch.float32  # heads stay f32
    for got, want in ((out.policy_logits, ref.policy_logits), (out.baseline, ref.baseline)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max()
        )


def test_convert_round_trip_is_exact():
    _, params, port = _flax_and_port(6, hidden=64)
    back = convert.torch_to_flax(port.state_dict())
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_convert_reads_the_optax_rmsprop_state():
    import optax

    rng = np.random.default_rng(0)
    shapes = {"Conv_0": (8, 8, 4, 32), "Conv_1": (4, 4, 32, 64), "Conv_2": (3, 3, 64, 64),
              "Dense_0": (576, 16), "policy": (21, 4), "baseline": (21, 1)}
    params = {"params": {
        name: {"kernel": rng.normal(size=shape).astype(np.float32),
               "bias": np.zeros(shape[-1], np.float32)}
        for name, shape in shapes.items()
    }}
    tx = optax.chain(
        optax.clip_by_global_norm(40.0),
        optax.rmsprop(optax.linear_schedule(6e-4, 0.0, 10), decay=0.99, eps=0.01,
                      momentum=0.0),
    )
    state = jax.jit(tx.init)(params)
    grads = jax.tree_util.tree_map(lambda p: np.full_like(p, 0.5), params)
    _, state = jax.jit(tx.update)(grads, state, params)
    port_state = convert.rmsprop_state_to_torch(jax.tree_util.tree_map(np.asarray, state))
    assert int(port_state["count"]) == 1
    nu = convert.flax_to_torch(state[1][0].nu)
    for k, v in port_state["nu"].items():
        torch.testing.assert_close(v, nu[k], rtol=0, atol=0)
        assert bool((v > 0).all())


LSTM_OBS = (24, 24, 4)


def _lstm_carry(A, hidden, B, seed):
    """A non-zero carried state: ((c, h),) * 2 layers of [B, hidden + A + 1]."""
    rng = np.random.default_rng(seed)
    width = hidden + A + 1
    return tuple(
        tuple((rng.normal(size=(B, width)) * 0.5).astype(np.float32) for _ in range(2))
        for _ in range(2))


def _torch_carry(carry):
    return tuple(tuple(torch.from_numpy(np.asarray(x)) for x in layer) for layer in carry)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "carried_state"])
def test_atari_net_lstm_matches_flax(dtype, carried):
    A, hidden, T, B = 5, 24, 7, 3
    flax_model, params, port = _flax_and_port(A, hidden, dtype, LSTM_OBS, use_lstm=True)
    assert len(port.core) == 2 and port.core[0].input.in_features == hidden + A + 1
    frames, la, rew, done = _inputs(T, B, A, LSTM_OBS, seed=11)
    done[0] = [True, False, False]  # an episode start, then dones mid-sequence
    done[3] = [False, True, False]
    done[4] = [False, True, True]
    inputs = (frames, la, rew, done)
    carry = _lstm_carry(A, hidden, B, 12) if carried else ()
    want, want_carry = jax.jit(flax_model.apply)(
        params, *(jnp.asarray(x) for x in inputs), jax.tree_util.tree_map(jnp.asarray, carry))
    with torch.no_grad():
        got, got_carry = port(*(torch.from_numpy(np.asarray(x)) for x in inputs),
                              _torch_carry(carry))
    assert len(got_carry) == 2
    for layer_got, layer_want in zip(got_carry, want_carry):
        for g, w in zip(layer_got, layer_want):
            assert g.dtype == torch.float32 and g.shape == (B, hidden + A + 1)
    pairs = [(got.policy_logits, want.policy_logits), (got.baseline, want.baseline)]
    pairs += [(g, w) for lg, lw in zip(got_carry, want_carry) for g, w in zip(lg, lw)]
    for g, w in pairs:
        w = np.asarray(w)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-2, atol=2e-2 * np.abs(w).max())


def test_lstm_done_mask_cuts_the_carry():
    """A lane whose step t is an episode start gives the same outputs from
    t on whatever came before it (the carry is zeroed first)."""
    A, hidden, T, B = 4, 16, 6, 2
    _, _, port = _flax_and_port(A, hidden, "float32", LSTM_OBS, use_lstm=True)
    frames, la, rew, done = (torch.from_numpy(np.asarray(x))
                             for x in _inputs(T, B, A, LSTM_OBS, seed=3))
    done[:] = False
    done[3] = True
    other = frames.clone()
    other[:3] = 255 - other[:3]  # a different history before the start
    with torch.no_grad():
        a, _ = port(frames, la, rew, done, _torch_carry(_lstm_carry(A, hidden, B, 1)))
        b, _ = port(other, la, rew, done, ())
    torch.testing.assert_close(a.policy_logits[3:], b.policy_logits[3:], rtol=0, atol=0)
    assert not torch.equal(a.policy_logits[:3], b.policy_logits[:3])


def test_lstm_init_law():
    """Flax's defaults: each recurrent gate kernel orthogonal on its own,
    zero biases, LeCun-normal input kernels."""
    net = AtariNet(num_actions=3, hidden_size=40, obs_shape=LSTM_OBS, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    H = net.core_size
    assert all(x.shape == (2, H) and not x.any() for layer in net.initial_state(2) for x in layer)
    for layer in net.core:
        for gate in layer.hidden.weight.split(H):
            torch.testing.assert_close(gate @ gate.T, torch.eye(H), atol=1e-5, rtol=0)
        assert not layer.hidden.bias.any() and layer.input.bias is None
        std = float(layer.input.weight.detach().std())
        assert abs(std - H ** -0.5) < 0.1 * H ** -0.5


def test_convert_lstm_round_trip_is_exact():
    _, params, port = _flax_and_port(6, hidden=20, obs=LSTM_OBS, use_lstm=True)
    state = port.state_dict()
    assert {k for k in state if k.startswith("core.")} == {
        f"core.{i}.{p}" for i in range(2)
        for p in ("input.weight", "hidden.weight", "hidden.bias")}
    back = convert.torch_to_flax(state)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back) == 6 * 2 + 2 * 2 * 8 - 8
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # the gates stack in flax's order i, f, g, o along the output axis
    cell = params["params"]["Scan_LSTMCore_0"]["lstm_1"]
    H = cell["hg"]["kernel"].shape[0]
    np.testing.assert_array_equal(state["core.1.hidden.weight"][2 * H:3 * H].numpy(),
                                  cell["hg"]["kernel"].T)
    np.testing.assert_array_equal(state["core.1.input.weight"][H:2 * H].numpy(),
                                  cell["if"]["kernel"].T)


def _mlp_pair(A, D, hidden, normalized_init=False, seed=0):
    flax_model = FlaxMLPPolicyNet(num_actions=A, hidden_sizes=hidden,
                                  normalized_init=normalized_init)
    params = flax_model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 1, D)), None, None, None)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = MLPPolicyNet(A, D, hidden, normalized_init=normalized_init, device="cpu")
    port.load_state_dict(convert.mlp_policy_to_torch(params))
    return flax_model, params, port


@pytest.mark.parametrize("hidden", [(32, 32), (16,), (8, 12, 10)])
def test_mlp_policy_net_matches_flax(hidden):
    A, D, T, B = 3, 6, 4, 5
    flax_model, params, port = _mlp_pair(A, D, hidden)
    rng = np.random.default_rng(len(hidden))
    obs = rng.normal(size=(T, B, D)).astype(np.float32)
    la = rng.integers(0, A, size=(T, B)).astype(np.int32)
    rew, done = rng.normal(size=(T, B)).astype(np.float32), rng.uniform(size=(T, B)) < 0.3
    want, core = flax_model.apply(params, jnp.asarray(obs), la, rew, done)
    with torch.no_grad():
        got, tcore = port(torch.from_numpy(obs), torch.from_numpy(la), torch.from_numpy(rew),
                          torch.from_numpy(done))
    assert core == () and tcore == () and port.initial_state(B) == ()
    assert got.policy_logits.shape == (T, B, A) and got.baseline.shape == (T, B)
    np.testing.assert_allclose(got.policy_logits.numpy(), np.asarray(want.policy_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(want.baseline),
                               atol=1e-5, rtol=1e-5)
    # integer observations are cast to float32, as flax casts them
    ints = rng.integers(0, 5, size=(T, B, D)).astype(np.int32)
    want, _ = flax_model.apply(params, jnp.asarray(ints), None, None, None)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(ints), None, None, None)
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(want.baseline),
                               atol=1e-5, rtol=1e-5)


def test_mlp_policy_normalized_init_and_round_trip():
    _, params, _ = _mlp_pair(4, 6, (16, 16), normalized_init=True)
    port = MLPPolicyNet(4, 6, (16, 16), normalized_init=True, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for head, std in ((port.policy, 0.01), (port.baseline, 1.0)):
        torch.testing.assert_close(head.weight.norm(dim=1), torch.full((head.out_features,), std))
        assert not head.bias.any()
    flax_heads = params["params"]
    np.testing.assert_allclose(np.linalg.norm(flax_heads["policy"]["kernel"], axis=0), 0.01,
                               rtol=1e-5)
    back = convert.torch_to_mlp_policy(convert.mlp_policy_to_torch(params))
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back) == 8
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)
