"""``AtariNet`` in the PyTorch port against the Flax model, and ``convert.py``.

Weights come from the Flax init and go through ``scalerl_torch.convert``;
inputs are made from a numpy seed.  float32 agrees at 1e-5 (same products,
summed in another order).  With ``compute_dtype=bfloat16`` the two
frameworks round to bf16 at different points, so they agree at rtol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch import convert
from scalerl_torch.models.atari import AtariNet, same_padding
from scalerl_tpu.models.atari import AtariNet as FlaxAtariNet

torch.set_num_threads(1)


def _inputs(T, B, A, obs=(84, 84, 4), seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, size=(T, B) + obs).astype(np.uint8),
        rng.integers(0, A, size=(T, B)).astype(np.int32),
        (rng.normal(size=(T, B)) * 2).astype(np.float32),  # some clip at +-1
        rng.uniform(size=(T, B)) < 0.3,
    )


def _flax_and_port(A, hidden=512, dtype="float32", obs=(84, 84, 4), seed=0):
    flax_model = FlaxAtariNet(
        num_actions=A, use_lstm=False, hidden_size=hidden, dtype=jnp.dtype(dtype)
    )
    frames, la, rew, done = _inputs(2, 1, A, obs)
    params = jax.jit(flax_model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(frames), jnp.asarray(la),
        jnp.asarray(rew), jnp.asarray(done),
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    port = AtariNet(
        num_actions=A, use_lstm=False, hidden_size=hidden, obs_shape=obs,
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


def test_atari_net_lstm_is_not_ported():
    with pytest.raises(NotImplementedError, match="LSTM"):
        AtariNet(num_actions=6, use_lstm=True, device="cpu")
