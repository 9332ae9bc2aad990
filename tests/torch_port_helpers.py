"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Builds the JAX package's IMPALA pieces and the port's from one argument set,
converts JAX train states into the port's, and makes trajectories from a
numpy seed in the JAX package's layout.
"""

import jax
import numpy as np
import torch

from scalerl_torch import config as tconfig
from scalerl_torch import convert
from scalerl_torch.agents.impala import ImpalaTrainState
from scalerl_torch.data.trajectory import Trajectory
from scalerl_tpu import config as jconfig
from scalerl_tpu.data.trajectory import Trajectory as JaxTrajectory

SMALL = dict(use_lstm=False, hidden_size=32, max_timesteps=0)


def args_pair(**kw):
    """The same ImpalaArguments for both packages."""
    fields = {**SMALL, **kw}
    return jconfig.ImpalaArguments(**fields), tconfig.ImpalaArguments(**fields)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def state_to_torch(jax_state, tree_to_torch=convert.flax_to_torch,
                   momentum=False) -> ImpalaTrainState:
    """A JAX ``ImpalaTrainState`` -> the port's, on the host; ``tree_to_torch``
    converts the params' tree (``AtariNet``'s by default), ``momentum``
    carries RMSProp's trace."""
    return ImpalaTrainState(
        params=tree_to_torch(to_numpy(jax_state.params)),
        opt_state=convert.rmsprop_state_to_torch(to_numpy(jax_state.opt_state),
                                                 tree_to_torch=tree_to_torch,
                                                 momentum=momentum),
        step=torch.tensor(int(jax_state.step), dtype=torch.int32),
        env_frames=torch.tensor(int(jax_state.env_frames), dtype=torch.int64),
    )


def random_traj(T, B, obs_shape, A, seed=0):
    """numpy fields of a [T+1, B] trajectory; the last logits row is zero."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T + 1, B, A)).astype(np.float32)
    logits[-1] = 0.0
    return dict(
        obs=rng.integers(0, 256, size=(T + 1, B) + tuple(obs_shape)).astype(np.uint8),
        action=rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
        reward=(rng.normal(size=(T + 1, B)) * 1.5).astype(np.float32),
        done=rng.uniform(size=(T + 1, B)) < 0.2,
        logits=logits,
    )


def jax_traj(fields) -> JaxTrajectory:
    return JaxTrajectory(**{k: jax.numpy.asarray(v) for k, v in fields.items()})


def torch_traj(fields) -> Trajectory:
    return Trajectory(
        **{k: torch.tensor(np.asarray(v)) for k, v in fields.items() if k != "core_state"}
    )


def assert_params_close(port_params, jax_params, atol=1e-5, rtol=1e-5,
                        tree_to_torch=convert.flax_to_torch):
    want = tree_to_torch(to_numpy(jax_params))
    assert set(port_params) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(
            port_params[k].detach().numpy(), v.numpy(), atol=atol, rtol=rtol, err_msg=k
        )


# ---------------------------------------------------------------------------
# sequence-RL training slice (token-PPO over padded sequences and packed rows)

GENRL_SMALL = dict(vocab_size=12, prompt_len=8, max_new_tokens=8, d_model=32, n_layers=1,
                   n_heads=2, genrl_batch=8, genrl_sample_batch=8, genrl_buffer_sequences=16)


def genrl_args_pair(**kw):
    """The same GenRLArguments for both packages (the JAX one with its
    telemetry and logger switched off, fields the port does not have)."""
    fields = {**GENRL_SMALL, **kw}
    jargs = jconfig.GenRLArguments(**fields, telemetry_interval_s=0.0, logger_backend="none")
    return jargs, tconfig.GenRLArguments(**fields)


def token_ppo_state_to_torch(jax_state):
    """A JAX ``TokenPPOTrainState`` -> the port's, on the host."""
    return convert.token_ppo_state_to_torch(to_numpy(jax_state))


def ragged_token_batches(seed, V=12, P=8, R=8, B=6):
    """The SAME ragged sequences in both learner layouts, as numpy dicts:
    ``(padded, packed, rows)`` (tests/test_packed_learner.py::_ragged_batches
    with the port's packer, which tests/test_torch_rollout.py holds equal to
    the JAX one)."""
    from scalerl_torch.genrl.rollout import pack_learner_batch

    rng = np.random.default_rng(seed)
    S = P + R
    plens = rng.integers(1, P + 1, B)
    rlens = rng.integers(1, R + 1, B)
    plens[0], rlens[0] = 1, 1
    plens[1], rlens[1] = P, R
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in plens]
    resps = [rng.integers(1, V, n).astype(np.int32) for n in rlens]
    logps = [np.log(rng.uniform(0.05, 0.5, n)).astype(np.float32) for n in rlens]
    vals = [rng.normal(0, 0.1, n).astype(np.float32) for n in rlens]
    rewards = rng.uniform(0, 1, B).astype(np.float32)
    gens = rng.integers(0, 3, B).astype(np.int32)
    tokens = np.zeros((B, S), np.int32)
    blogp = np.zeros((B, R), np.float32)
    bval = np.zeros((B, R), np.float32)
    mask = np.zeros((B, R), np.float32)
    for i in range(B):
        n, r = int(plens[i]), int(rlens[i])
        tokens[i, P - n:P] = prompts[i]
        tokens[i, P:P + r] = resps[i]
        blogp[i, :r] = logps[i]
        bval[i, :r] = vals[i]
        mask[i, :r] = 1.0
    padded = dict(tokens=tokens, behavior_logp=blogp, value=bval, mask=mask, reward=rewards,
                  prompt_len=plens.astype(np.int32), generation=gens)
    pk = pack_learner_batch(prompts, resps, logps, vals, rewards, gens, pack_len=S)
    return padded, dict(pk.fields()[0]), pk.rows


def to_jax_batch(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


def to_torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# on-policy learners (A3C, PPO): clip-then-Adam train states

def onpolicy_state_to_torch(jax_state, tree_to_torch=convert.mlp_policy_to_torch):
    """A JAX ``A3CTrainState`` / ``PPOTrainState`` -> the port's, on the host."""
    from scalerl_torch.agents.a3c import A3CTrainState

    return A3CTrainState(
        params=tree_to_torch(to_numpy(jax_state.params)),
        opt_state=convert.adam_state_to_torch(to_numpy(jax_state.opt_state), tree_to_torch),
        step=torch.tensor(int(jax_state.step), dtype=torch.int32),
        env_frames=torch.tensor(int(jax_state.env_frames), dtype=torch.int64),
    )


def assert_onpolicy_state_close(tstate, jstate, tree_to_torch=convert.mlp_policy_to_torch,
                                atol=1e-5, conv_atol=1e-5):
    """Params, Adam's moments and counters at ``atol``; ``conv_atol`` for
    the conv weights (``convs.*``), whose gradients at rounding level move
    them by about lr * sign(g) under Adam (the R2D2 case, ROADMAP §C)."""
    want = onpolicy_state_to_torch(jstate, tree_to_torch)
    for k, v in want.params.items():
        tol = conv_atol if k.startswith("convs.") else atol
        np.testing.assert_allclose(tstate.params[k].detach().numpy(), v.numpy(), atol=tol,
                                   rtol=1e-5, err_msg=k)
    for moment in ("mu", "nu"):
        for k, v in want.opt_state[moment].items():
            np.testing.assert_allclose(tstate.opt_state[moment][k].numpy(), v.numpy(),
                                       atol=atol, rtol=1e-5, err_msg=f"{moment}.{k}")
    assert int(tstate.opt_state["count"]) == int(want.opt_state["count"])
    assert int(tstate.step) == int(want.step)
    assert int(tstate.env_frames) == int(want.env_frames)


def flat_traj(seed, T, B, A, obs_dim=4):
    """numpy fields of a [T+1, B] trajectory over flat float32 observations."""
    fields = random_traj(T, B, (), A, seed)
    fields["obs"] = np.random.default_rng(seed + 100).normal(
        size=(T + 1, B, obs_dim)).astype(np.float32)
    return fields
