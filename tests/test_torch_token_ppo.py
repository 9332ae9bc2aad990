"""The port's token-PPO learner against the JAX package's.

One Flax init is converted into the port (``convert.transformer_to_torch``);
the same numpy batches go through both.  The model's packed forward through
the segment seam is held to the JAX model running the Pallas segment kernel
in interpret mode; both losses, every metric and the parameter gradients to
the JAX ones; one whole learn step (global-norm clip, then Adam) to the JAX
agent's new parameters and moments.  On the host the port's segment seam
runs the kernels' plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from scalerl_torch import convert
from scalerl_torch.agents import token_ppo as tppo
from scalerl_torch.models.transformer import TransformerPolicy
from scalerl_torch.ops.cuda_segment_attention import segment_flash_attention
from scalerl_torch.runtime import dispatch
from scalerl_torch.trainer.sequence_rl import build_genrl_model
from scalerl_tpu.agents import token_ppo as jppo
from scalerl_tpu.models.transformer import TransformerPolicy as JaxTransformerPolicy
from scalerl_tpu.ops.pallas_attention import segment_flash_attention as jax_segment_flash
from scalerl_tpu.trainer.sequence_rl import build_genrl_model as jax_build_genrl_model

torch.set_num_threads(1)

V, P, R = 12, 8, 8
TOL = 1e-5
LOSS_KW = dict(clip_range=0.2, value_cost=0.5, entropy_cost=0.01, adv_norm=True)


def _models(seg_fn=None, jax_seg_fn=None, layers=1, d_model=32, num_heads=2):
    kw = dict(num_actions=V, vocab_size=V, d_model=d_model, num_heads=num_heads,
              num_layers=layers, max_len=P + R)
    jm = JaxTransformerPolicy(**kw, segment_attn_fn=jax_seg_fn)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    tm = TransformerPolicy(**kw, segment_attn_fn=seg_fn, device="cpu")
    return jm, params, tm, convert.transformer_to_torch(H.to_numpy(params))


def _perturbed(params, seed=1, scale=0.05):
    """Reference params that differ from the live ones, so the KL term and
    its gradient are not trivially zero."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [x + scale * rng.normal(size=x.shape).astype(np.float32) for x in leaves])


def _grads_to_torch(jax_grads):
    return convert.transformer_to_torch(H.to_numpy(jax_grads))


# head dim 64: the width of the segment kernels' DP = 64 builds on the card
@pytest.mark.parametrize("d_model,num_heads", [(32, 2), (128, 2)],
                         ids=["head_dim_16", "head_dim_64"])
def test_packed_forward_through_the_segment_seam_matches_jax_pallas_kernel(d_model, num_heads):
    jm, params, tm, tparams = _models(seg_fn=segment_flash_attention,
                                      jax_seg_fn=jax_segment_flash, layers=2, d_model=d_model,
                                      num_heads=num_heads)
    S = P + R
    rng = np.random.default_rng(2)
    tok = rng.integers(0, V, (2, S)).astype(np.int32)
    seg = np.zeros((2, S), np.int32)
    pos = np.zeros((2, S), np.int32)
    for b, spans in enumerate([[(0, 5), (5, 11), (11, 14)], [(0, 13)]]):
        for i, (s, e) in enumerate(spans, start=1):
            seg[b, s:e] = i
            pos[b, s:e] = np.arange(e - s)
    want = jm.apply(params, jnp.asarray(tok), positions=jnp.asarray(pos),
                    segment_ids=jnp.asarray(seg))
    tm.load_state_dict(tparams)
    got = tm(torch.tensor(tok), positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    dense = TransformerPolicy(num_actions=V, vocab_size=V, d_model=d_model, num_heads=num_heads,
                              num_layers=2, max_len=S, device="cpu")
    dense.load_state_dict(tparams)
    got_dense = dense(torch.tensor(tok), positions=torch.tensor(pos), segment_ids=torch.tensor(seg))
    real = seg > 0
    for g in (got, got_dense):
        np.testing.assert_allclose(g.policy_logits.detach().numpy()[real],
                                   np.asarray(want.policy_logits)[real], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.baseline.detach().numpy()[real],
                                   np.asarray(want.baseline)[real], atol=TOL, rtol=TOL)
    assert torch.isfinite(got.policy_logits).all()  # pad rows stay finite


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("kl_cost", [0.0, 0.1])
@pytest.mark.parametrize("is_weight", [False, True])
def test_losses_metrics_and_gradients_match_jax(layout, kl_cost, is_weight):
    jm, params, tm, tparams = _models(seg_fn=segment_flash_attention)
    ref = _perturbed(params)
    tref = convert.transformer_to_torch(H.to_numpy(ref))
    padded, packed, _ = H.ragged_token_batches(11, V=V, P=P, R=R)
    batch = padded if layout == "padded" else packed
    if is_weight:
        n = batch["tokens"].shape[0]
        batch = dict(batch, is_weight=np.random.default_rng(3).uniform(0.2, 1, n).astype(np.float32))
    jloss_fn = jppo.token_ppo_loss if layout == "padded" else jppo.token_ppo_packed_loss
    tloss_fn = tppo.token_ppo_loss if layout == "padded" else tppo.token_ppo_packed_loss
    kw = dict(LOSS_KW, kl_cost=kl_cost)
    jbatch = H.to_jax_batch(batch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, ref, jm, jbatch, **kw), has_aux=True)(params)

    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tloss, tmetrics = tloss_fn(leaves, tref, tm, H.to_torch_batch(batch), **kw)
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=TOL, rtol=TOL)
    assert set(tmetrics) == set(jmetrics)
    assert ("kl_ref" in tmetrics) == (kl_cost > 0)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(v), atol=TOL, rtol=TOL, err_msg=k)
    want = _grads_to_torch(jgrads)
    assert set(tgrads) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(tgrads[k].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
    for k, v in tmetrics.items():
        assert v.requires_grad == (k == "total_loss"), k


@pytest.mark.parametrize("seed", [5, 11])
def test_packed_loss_equals_padded_loss_inside_the_port(seed):
    _, _, tm, tparams = _models(seg_fn=segment_flash_attention)
    padded, packed, rows = H.ragged_token_batches(seed, V=V, P=P, R=R)
    assert rows < padded["tokens"].shape[0]  # packing actually packed
    kw = dict(LOSS_KW, kl_cost=0.1)
    tref = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
            for k, v in tparams.items()}
    out = {}
    for name, fn, batch in (("padded", tppo.token_ppo_loss, padded),
                            ("packed", tppo.token_ppo_packed_loss, packed)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
        loss, metrics = fn(leaves, tref, tm, H.to_torch_batch(batch), **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[name] = (loss, metrics, torch.cat([g.reshape(-1) for g in grads]))
    (l1, m1, g1), (l2, m2, g2) = out["padded"], out["packed"]
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()), atol=TOL)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-5, rtol=1e-4)
    for key in ("pg_loss", "value_loss", "total_loss"):
        np.testing.assert_allclose(float(m1[key].detach()), float(m2[key].detach()), atol=TOL, err_msg=key)
    np.testing.assert_allclose(float(m1["kl_ref"]), float(m2["kl_ref"]), atol=1e-6)


def test_packed_loss_ignores_pad_poison():
    _, _, tm, tparams = _models(seg_fn=segment_flash_attention)
    _, packed, _ = H.ragged_token_batches(7, V=V, P=6, R=6)
    kw = dict(LOSS_KW, kl_cost=0.0)
    batch = H.to_torch_batch(packed)
    l1, _ = tppo.token_ppo_packed_loss(tparams, tparams, tm, batch, **kw)
    pad = 1.0 - batch["mask"]
    poisoned = dict(batch, behavior_logp=batch["behavior_logp"] - 9.0 * pad,
                    value=batch["value"] + 50.0 * pad, reward=batch["reward"] + 3.0 * pad)
    l2, _ = tppo.token_ppo_packed_loss(tparams, tparams, tm, poisoned, **kw)
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()), atol=TOL)


def _agent_pair(**kw):
    """A JAX agent and a port agent that starts from the JAX agent's state."""
    jargs, targs = H.genrl_args_pair(**kw)
    jagent = jppo.TokenPPOAgent(jargs, jax_build_genrl_model(jargs))
    tagent = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    tagent.state = H.token_ppo_state_to_torch(jagent.state)
    return jagent, tagent


def _assert_tree_close(got, jax_tree, atol=TOL, rtol=TOL):
    want = convert.transformer_to_torch(H.to_numpy(jax_tree))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("kl_cost", [0.0, 0.05])
def test_one_learn_step_matches_jax(layout, kl_cost):
    """Two steps, so the second starts from non-zero Adam moments.  Adam
    turns a gradient element near zero into a step of up to the learning
    rate whatever its size, so float noise of 1e-7 in such an element moves
    the parameter by a fraction of the learning rate: at 1e-4 that stays
    inside the 1e-5 the parameters are held to."""
    jagent, tagent = _agent_pair(learner_packing=True, learner_packed_attn="xla", kl_cost=kl_cost,
                                 max_grad_norm=0.5, learning_rate=1e-4)
    for step, seed in enumerate((21, 22)):
        padded, packed, _ = H.ragged_token_batches(seed, V=V, P=P, R=R)
        batch = padded if layout == "padded" else packed
        n = batch["tokens"].shape[0]
        batch = dict(batch, is_weight=np.random.default_rng(seed).uniform(0.3, 1, n).astype(np.float32))
        jm = jagent.learn(H.to_jax_batch(batch))
        tm = tagent.learn(batch)
        assert set(tm) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k], v, atol=TOL, rtol=TOL, err_msg=f"step {step} {k}")
        _assert_tree_close(tagent.state.params, jagent.state.params)
        _assert_tree_close(tagent.state.ref_params, jagent.state.ref_params, atol=0, rtol=0)
        want_opt = convert.adam_state_to_torch(H.to_numpy(jagent.state.opt_state),
                                               convert.transformer_to_torch)
        for moment in ("mu", "nu"):
            for k, v in want_opt[moment].items():
                np.testing.assert_allclose(tagent.state.opt_state[moment][k].numpy(), v.numpy(),
                                           atol=TOL, rtol=TOL, err_msg=f"{moment} {k}")
        assert int(tagent.state.opt_state["count"]) == int(want_opt["count"]) == step + 1
        assert int(tagent.state.step) == int(jagent.state.step) == step + 1
        assert int(tagent.state.tokens_seen) == int(jagent.state.tokens_seen)


def test_learn_dispatches_on_layout_with_one_batched_read(monkeypatch):
    _, targs = H.genrl_args_pair(learner_packing=True, learner_packed_attn="pallas")
    agent = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    padded, packed, _ = H.ragged_token_batches(5, V=V, P=P, R=R, B=4)
    gets = []
    real = dispatch._device_get
    monkeypatch.setattr(dispatch, "_device_get", lambda x: (gets.append(1), real(x))[1])
    m_pack = agent.learn(packed)
    assert len(gets) == 1 and np.isfinite(m_pack["total_loss"])
    assert "real_token_frac" in m_pack and m_pack["skipped_steps"] == 0.0
    m_pad = agent.learn(padded)
    assert len(gets) == 2 and np.isfinite(m_pad["total_loss"])
    assert "real_token_frac" not in m_pad
    assert all(isinstance(v, float) for v in m_pad.values())
    device_metrics = agent.learn_device(packed)  # stays on the device: no read
    assert len(gets) == 2 and isinstance(device_metrics["total_loss"], torch.Tensor)
    assert int(agent.state.step) == 3


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_guard_keeps_the_old_state_on_a_nan_batch(layout):
    _, targs = H.genrl_args_pair(learner_packing=True)
    agent = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    padded, packed, _ = H.ragged_token_batches(6, V=V, P=P, R=R)
    batch = dict(padded if layout == "padded" else packed)
    agent.learn(batch)
    before = {k: v.clone() for k, v in agent.state.params.items()}
    mu_before = {k: v.clone() for k, v in agent.state.opt_state["mu"].items()}
    step, seen = int(agent.state.step), int(agent.state.tokens_seen)
    bad = dict(batch, reward=np.full_like(batch["reward"], np.nan))
    m = agent.learn(bad)
    assert m["skipped_steps"] == 1.0 and m["nonfinite_grads"] == 1.0
    for k, v in before.items():
        assert torch.equal(agent.state.params[k], v), k
        assert torch.equal(agent.state.opt_state["mu"][k], mu_before[k]), k
    assert int(agent.state.step) == step and int(agent.state.tokens_seen) == seen
    m = agent.learn(batch)  # and the next good batch learns again
    assert m["skipped_steps"] == 0.0 and int(agent.state.step) == step + 1


def test_reference_params_are_a_copy_and_weights_survive_learning():
    _, targs = H.genrl_args_pair(learner_packing=True)
    model = build_genrl_model(targs, device="cpu")
    agent = tppo.TokenPPOAgent(targs, model)
    for k, v in agent.state.params.items():
        assert agent.state.ref_params[k].data_ptr() != v.data_ptr(), k
        assert v.data_ptr() != dict(model.named_parameters())[k].data_ptr(), k
    initial = {k: v.clone() for k, v in agent.state.params.items()}
    handed_out = agent.get_weights()
    _, packed, _ = H.ragged_token_batches(8, V=V, P=P, R=R)
    agent.learn(packed)
    for k, v in initial.items():
        assert torch.equal(agent.state.ref_params[k], v), k  # the anchor did not move
        assert torch.equal(handed_out[k], v), k  # nor did the weights already handed out
    assert any(not torch.equal(agent.state.params[k], v) for k, v in initial.items())
    agent.set_weights(handed_out)
    assert all(torch.equal(agent.get_weights()[k], v) for k, v in initial.items())


def test_unported_parts_raise_and_feature_models_are_refused(tmp_path):
    _, targs = H.genrl_args_pair()
    agent = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    # one process: a two-device mesh needs a process group of two ranks
    with pytest.raises(ValueError, match="init_process_group"):
        agent.enable_mesh("dp=2")
    # checkpoints are ported: a save and a load round-trip the state
    saved = agent.save_checkpoint(str(tmp_path / "ckpt"))
    before = {k: v.clone() for k, v in agent.state.params.items()}
    agent.state = dataclasses.replace(
        agent.state, params={k: torch.zeros_like(v) for k, v in before.items()})
    agent.load_checkpoint(saved)
    assert all(torch.equal(agent.state.params[k], v) for k, v in before.items())
    feature = TransformerPolicy(num_actions=3, obs_dim=4, d_model=16, num_heads=2, num_layers=1,
                                device="cpu")
    with pytest.raises(ValueError, match="token-mode"):
        tppo.TokenPPOAgent(targs, feature)


def test_masked_mean_is_safe_on_an_empty_mask():
    x = torch.tensor([1.0, 3.0])
    assert float(tppo.masked_mean(x, torch.tensor([1.0, 1.0]))) == 2.0
    assert float(tppo.masked_mean(x, torch.zeros(2))) == 0.0
