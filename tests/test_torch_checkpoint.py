"""Parity of the port's checkpoints (``scalerl_torch/utils/checkpoint.py``,
on ``torch.save``) with the JAX package's (Orbax).

Both packages save the same numpy trees; what must agree is exact: the
per-leaf digests, the ``.prev`` names a save sequence leaves, the fallback
order, what a truncated latest falls back to, and that a tampered leaf
raises ``CheckpointIntegrityError``.  The port's own train states
(``ImpalaTrainState`` with RMSProp's moments and momentum trace and the LSTM,
DQN's with the prioritized replay, token-PPO's) round-trip bit for bit, with
their dtypes and counters.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from scalerl_torch import config as tconfig
from scalerl_torch.agents import dqn as tdqn
from scalerl_torch.agents import token_ppo as tppo
from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.data.sampler import Sampler
from scalerl_torch.trainer.sequence_rl import build_genrl_model
from scalerl_torch.utils import checkpoint as tckpt
from scalerl_tpu.utils import checkpoint as jckpt

torch.set_num_threads(1)


def _leaf(dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.uniform(size=(3, 5)) < 0.5
    if dtype == "bfloat16":
        return rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16)
    if dtype.startswith("int") or dtype == "uint8":
        return rng.integers(0, 200, size=(2, 3, 4)).astype(dtype)
    return rng.normal(size=(7,)).astype(dtype)


def _to_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "bool",
                                   "bfloat16"])
def test_leaf_digests_match_jax(dtype):
    x = _leaf(dtype)
    want = jckpt._leaf_digest(x)
    assert tckpt.leaf_digest(_to_torch(x)) == want
    assert tckpt.leaf_digest(x) == want  # numpy leaves as well
    if jnp.asarray(x).dtype == x.dtype:  # a device array (64-bit ones narrow in JAX)
        assert jckpt._leaf_digest(jnp.asarray(x)) == want


@pytest.mark.parametrize("dtype", ["float32", "int64", "int32"])
def test_scalar_leaf_digests_match_jax_and_verify_without_a_target(dtype, tmp_path):
    x = np.asarray(7, dtype)
    want = jckpt._leaf_digest(x)
    assert tckpt.leaf_digest(torch.from_numpy(x.copy())) == want
    assert tckpt.leaf_digest(x) == want
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, {"n": x, "t": torch.tensor(3, dtype=getattr(torch, dtype))})
    out = tckpt.load_checkpoint(path, fallback=False)  # verifies the manifest
    assert int(out["n"]) == 7 and int(out["t"]) == 3


def test_manifests_list_the_same_digests():
    tree = {"w": _leaf("float32"), "b": {"c": _leaf("int32", 1)}, "n": _leaf("uint8", 2)}
    jd = sorted((d["path"], d["sha256"]) for d in jckpt._tree_digests(tree))
    td = sorted((d["path"], d["sha256"]) for d in tckpt._tree_digests(tree))
    assert td == jd  # key paths written as JAX writes them, digests equal


def _state(v: int):
    return {"w": np.full(4, v, np.float32), "step": np.asarray(v, np.int64)}


def _layout(path: str):
    parent = os.path.dirname(path)
    return sorted(n for n in os.listdir(parent) if not n.endswith(".tmp"))


@pytest.mark.parametrize("keep_last", [1, 3])
def test_save_sequences_leave_the_same_prev_chain(tmp_path, keep_last):
    jpath, tpath = str(tmp_path / "jax" / "resume"), str(tmp_path / "torch" / "resume")
    for v in (1, 2, 3, 4, 5):
        jckpt.save_checkpoint(jpath, _state(v), keep_last=keep_last)
        tckpt.save_checkpoint(tpath, _state(v), keep_last=keep_last)
        assert _layout(tpath) == _layout(jpath)
        assert ([os.path.basename(p) for p in tckpt.checkpoint_fallbacks(tpath)]
                == [os.path.basename(p) for p in jckpt.checkpoint_fallbacks(jpath)])
    for k, prev in enumerate([tpath] + tckpt.checkpoint_fallbacks(tpath)):
        got = tckpt.load_checkpoint(prev, _state(0), fallback=False)
        assert int(got["step"]) == 5 - k and got["w"].dtype == np.float32
    tckpt.save_checkpoint(tpath, _state(6), keep_last=0)
    jckpt.save_checkpoint(jpath, _state(6), keep_last=0)
    assert tckpt.checkpoint_fallbacks(tpath) == [] == jckpt.checkpoint_fallbacks(jpath)


def _truncate_files(path: str) -> None:
    for root, _, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            size = os.path.getsize(p)
            with open(p, "r+b") as f:
                f.truncate(size // 2)


def test_truncated_latest_falls_back_to_prev_in_both(tmp_path):
    outs = {}
    for name, mod in (("jax", jckpt), ("torch", tckpt)):
        path = str(tmp_path / name / "resume")
        mod.save_checkpoint(path, _state(1))
        mod.save_checkpoint(path, _state(2))
        _truncate_files(path)
        outs[name] = int(mod.load_checkpoint(path, _state(0))["step"])
        with pytest.raises(Exception):
            mod.load_checkpoint(path, _state(0), fallback=False)
    assert outs == {"jax": 1, "torch": 1}


def test_tampered_leaf_raises_integrity_error_in_both(tmp_path):
    for name, mod in (("jax", jckpt), ("torch", tckpt)):
        good, bad = str(tmp_path / name / "good"), str(tmp_path / name / "bad")
        mod.save_checkpoint(good, _state(3))
        tampered = _state(3)
        tampered["w"][2] = 4.0
        mod.save_checkpoint(bad, tampered)
        # the tampered leaf under the original manifest
        shutil.copy(os.path.join(good, mod.MANIFEST_NAME), os.path.join(bad, mod.MANIFEST_NAME))
        with pytest.raises(mod.CheckpointIntegrityError):
            mod.load_checkpoint(bad, _state(0), fallback=False)
        # with the chain, a tampered latest falls back
        mod.save_checkpoint(good, tampered)
        shutil.copy(os.path.join(good + ".prev", mod.MANIFEST_NAME),
                    os.path.join(good, mod.MANIFEST_NAME))
        assert float(mod.load_checkpoint(good, _state(0))["w"][2]) == 3.0


def _assert_bit_equal(got, want):
    gl, wl = tckpt.flatten_tree(got), tckpt.flatten_tree(want)
    assert [p for p, _ in gl] == [p for p, _ in wl] and gl
    for (path, g), (_, w) in zip(gl, wl):
        if not isinstance(w, torch.Tensor):
            assert type(g) is type(w) and g == w, path
            continue
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device, path
        assert torch.equal(g, w), path


def _flatten(state):
    return dict(tckpt.flatten_tree(state))


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_state_round_trips_bit_for_bit(tmp_path, use_lstm):
    _, targs = H.args_pair(rollout_length=5, batch_size=3, use_lstm=use_lstm,
                           rmsprop_momentum=0.9)
    agent = ImpalaAgent(targs, (84, 84, 4), 6, device="cpu")
    agent.learn(H.torch_traj(H.random_traj(5, 3, (84, 84, 4), 6, seed=3)))
    assert "trace" in agent.state.opt_state and int(agent.state.step) == 1
    want = dataclasses.replace(agent.state)
    path = agent.save_checkpoint(str(tmp_path / "ckpt"))
    fresh = ImpalaAgent(targs, (84, 84, 4), 6, device="cpu")
    fresh.load_checkpoint(path)
    _assert_bit_equal(fresh.state, want)
    assert fresh.state.step.dtype == torch.int32 and fresh.state.env_frames.dtype == torch.int64
    assert _flatten(fresh.state).keys() == _flatten(want).keys()


def test_dqn_state_and_replay_round_trip_bit_for_bit(tmp_path):
    args = tconfig.DQNArguments(hidden_sizes="32,32", batch_size=8, buffer_size=64,
                                use_per=True)
    agent = tdqn.DQNAgent(args, (4,), 2, device="cpu")
    sampler = Sampler((4,), 64, 2, use_per=True, per_alpha=0.6, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(20):
        sampler.add(rng.normal(size=(2, 4)).astype(np.float32),
                    rng.normal(size=(2, 4)).astype(np.float32), rng.integers(0, 2, 2),
                    rng.normal(size=2).astype(np.float32), rng.uniform(size=2) < 0.1)
    batch = sampler.sample(8, beta=0.4, generator=torch.Generator().manual_seed(1))
    _, td_abs = agent.learn_device(batch)
    sampler.update_priorities(batch["indices"], td_abs + 1e-6)
    tree = {"agent": agent.state, "replay": sampler.buffer.state,
            "global_step": np.asarray(40, np.int64)}
    path = tckpt.save_checkpoint(str(tmp_path / "resume"), tree)
    fresh_agent = tdqn.DQNAgent(args, (4,), 2, device="cpu")
    fresh = Sampler((4,), 64, 2, use_per=True, per_alpha=0.6, device="cpu")
    target = {"agent": fresh_agent.state, "replay": fresh.buffer.state,
              "global_step": np.asarray(0, np.int64)}
    got = tckpt.load_checkpoint(path, target)
    _assert_bit_equal(got["agent"], agent.state)
    _assert_bit_equal(got["replay"], sampler.buffer.state)
    assert got["replay"].replay.pos == 20 and got["replay"].replay.size == 20
    assert isinstance(got["global_step"], np.ndarray) and int(got["global_step"]) == 40


def test_token_ppo_state_round_trips_bit_for_bit(tmp_path):
    _, targs = H.genrl_args_pair()
    agent = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    agent.state = dataclasses.replace(
        agent.state, params={k: v + 0.5 for k, v in agent.state.params.items()},
        step=agent.state.step + 3)
    path = agent.save_checkpoint(str(tmp_path / "ckpt"))
    want = agent.state
    fresh = tppo.TokenPPOAgent(targs, build_genrl_model(targs, device="cpu"))
    fresh.load_checkpoint(path)
    _assert_bit_equal(fresh.state, want)
    assert int(fresh.state.step) == 3


def test_restore_refuses_another_tree_and_reads_without_a_target(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(3), "b": [np.ones(2)]})
    with pytest.raises(ValueError, match="leaf"):
        tckpt.load_checkpoint(path, {"a": torch.zeros(4), "b": [np.ones(2)]}, fallback=False)
    raw = tckpt.load_checkpoint(path)
    assert torch.equal(raw["a"], torch.zeros(3)) and torch.equal(raw["b"][0], torch.ones(2,
                                                                                   dtype=torch.float64))
