"""V-trace in the PyTorch port against the JAX package.

The same numpy inputs go through ``scalerl_tpu.ops.vtrace`` (the scan op and
the Pallas kernel, which runs in interpret mode off-TPU) and through the
port's plain version and CUDA-kernel wrapper.  The wrapper runs the plain
version on host tensors; the kernel itself is checked on the card by
``chip_smoke.py``.  Tolerance 1e-5: both sides do the same float32
operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.ops import cuda_vtrace
from scalerl_torch.ops import vtrace as tv
from scalerl_tpu.ops import vtrace as jv

torch.set_num_threads(1)

CLIPS = {
    "default": {},
    "rho2_c1.5": {"clip_rho_threshold": 2.0, "clip_c_threshold": 1.5},
    "no_rho_clip": {"clip_rho_threshold": None, "clip_pg_rho_threshold": None},
}
# (80, 8): ImpalaArguments' defaults; (16, 8): the transformer learner's
# trajectory; (70, 33): T and B past the CUDA kernel's chunks and tiles
SHAPES = [(20, 8), (1, 1), (37, 5), (80, 8), (16, 8), (70, 33)]


def _inputs(T, B, seed=0, nan_share=0.0):
    rng = np.random.default_rng(seed)
    log_rhos = (rng.normal(size=(T, B)) * 0.4).astype(np.float32)
    log_rhos[rng.uniform(size=(T, B)) < nan_share] = np.nan
    return dict(
        log_rhos=log_rhos,
        discounts=(0.99 * (rng.uniform(size=(T, B)) > 0.1)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
    )


def _close(torch_out, jax_out):
    for name in ("vs", "pg_advantages"):
        np.testing.assert_allclose(
            getattr(torch_out, name).numpy(), np.asarray(getattr(jax_out, name)),
            atol=1e-5, rtol=1e-5, err_msg=name,
        )


@pytest.mark.parametrize("jax_impl", ["scan", "pallas"])
@pytest.mark.parametrize("clips", list(CLIPS.values()), ids=list(CLIPS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}_B{s[1]}")
def test_vtrace_matches_jax(shape, clips, jax_impl):
    inp = _inputs(*shape)
    ref = jv.vtrace_from_importance_weights(
        **{k: jnp.asarray(v) for k, v in inp.items()}, **clips, impl=jax_impl
    )
    t_inp = {k: torch.from_numpy(v) for k, v in inp.items()}
    _close(tv.vtrace_from_importance_weights(**t_inp, **clips, impl="scan"), ref)
    _close(tv.vtrace_from_importance_weights(**t_inp, **clips, impl="kernel"), ref)


@pytest.mark.parametrize("jax_impl", ["scan", "pallas"])
def test_vtrace_keeps_nan_where_jax_does(jax_impl):
    """A NaN log-rho stays NaN in the clipped rhos (jnp.minimum and
    torch.clamp keep it), and reaches the same outputs on both sides."""
    inp = _inputs(20, 8, seed=3, nan_share=0.05)
    assert np.isnan(inp["log_rhos"]).sum() > 0
    ref = jv.vtrace_from_importance_weights(
        **{k: jnp.asarray(v) for k, v in inp.items()}, impl=jax_impl
    )
    assert np.isnan(np.asarray(ref.vs)).any()
    t_inp = {k: torch.from_numpy(v) for k, v in inp.items()}
    _close(tv.vtrace_from_importance_weights(**t_inp, impl="scan"), ref)
    _close(tv.vtrace_from_importance_weights(**t_inp, impl="kernel"), ref)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_vtrace_from_logits_matches_jax(impl):
    rng = np.random.default_rng(1)
    T, B, A = 20, 8, 6
    inp = _inputs(T, B, seed=2)
    del inp["log_rhos"]
    behavior = rng.normal(size=(T, B, A)).astype(np.float32)
    target = rng.normal(size=(T, B, A)).astype(np.float32)
    actions = rng.integers(0, A, size=(T, B)).astype(np.int32)
    ref = jv.vtrace_from_logits(
        jnp.asarray(behavior), jnp.asarray(target), jnp.asarray(actions),
        **{k: jnp.asarray(v) for k, v in inp.items()},
    )
    target_t = torch.from_numpy(target).requires_grad_(True)
    out = tv.vtrace_from_logits(
        torch.from_numpy(behavior), target_t, torch.from_numpy(actions),
        **{k: torch.from_numpy(v) for k, v in inp.items()}, impl=impl,
    )
    _close(out, ref)
    # grad-free: the outputs are constants even when an input needs grad
    assert not out.vs.requires_grad and not out.pg_advantages.requires_grad


def test_kernel_wrapper_on_host_tensors_launches_nothing(monkeypatch):
    monkeypatch.setattr(cuda_vtrace, "launches", 0)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(20, 8).items()}
    cuda_vtrace.vtrace_from_importance_weights_kernel(**inp)
    tv.vtrace_from_importance_weights(**inp, impl="kernel")
    assert cuda_vtrace.launches == 0


def test_kernel_wrapper_checks_its_inputs():
    inp = {k: torch.from_numpy(v) for k, v in _inputs(6, 4).items()}
    fn = cuda_vtrace.vtrace_from_importance_weights_kernel
    with pytest.raises(TypeError, match="float32"):
        fn(**{**inp, "rewards": inp["rewards"].double()})
    with pytest.raises(ValueError, match="shape"):
        fn(**{**inp, "values": inp["values"][:-1]})
    with pytest.raises(ValueError, match="contiguous"):
        fn(**{**inp, "discounts": inp["discounts"].t().contiguous().t()})
    with pytest.raises(ValueError, match="values is on meta, log_rhos on cpu"):
        fn(**{**inp, "values": inp["values"].to("meta")})
    with pytest.raises(ValueError, match=r"bootstrap_value must have shape \(4,\)"):
        fn(**{**inp, "bootstrap_value": inp["bootstrap_value"][None]})
    with pytest.raises(ValueError, match=r"T >= 1 and B >= 1, got \[0, 4\]"):
        fn(**{k: v[:0] if v.dim() == 2 else v for k, v in inp.items()})
    with pytest.raises(ValueError, match=r"log_rhos must be \[T, B\]"):
        fn(**{**inp, "log_rhos": inp["log_rhos"].reshape(-1)})
    with pytest.raises(ValueError, match="no V-trace kernel for device meta"):
        fn(**{k: v.to("meta") for k, v in inp.items()})
    with pytest.raises(ValueError, match="impl"):
        tv.vtrace_from_importance_weights(**inp, impl="pallas")
