"""The port's public helpers of ported modules against the JAX package's.

``PiecewiseScheduler`` and ``MultiStepScheduler`` (``utils/schedulers.py``),
``hard_target_update`` (``utils/tree.py``), ``calculate_mean`` and
``calculate_vectorized_scores`` (``utils/metrics.py``),
``stack_trajectories`` (``data/trajectory.py``) and
``make_multi_agent_vect_envs`` (``envs/gym_env.py``), each on the same
inputs in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalerl_torch.data import trajectory as ttraj
from scalerl_torch.envs import gym_env as tgym
from scalerl_torch.envs import multi_agent as tma
from scalerl_torch.utils import metrics as tmetrics
from scalerl_torch.utils import schedulers as tsched
from scalerl_torch.utils import tree as ttree
from scalerl_tpu.data import trajectory as jtraj
from scalerl_tpu.envs import gym_env as jgym
from scalerl_tpu.envs import multi_agent as jma
from scalerl_tpu.utils import metrics as jmetrics
from scalerl_tpu.utils import schedulers as jsched
from scalerl_tpu.utils import tree as jtree

torch.set_num_threads(1)

SCHEDULES = [
    ("PiecewiseScheduler", ([(0, 1.0), (10, 0.5), (20, 0.1)],)),
    ("PiecewiseScheduler", ([(5, 2.0), (5, 3.0), (9, -1.0)],)),
    ("MultiStepScheduler", (1.0, [5, 10], 0.1)),
    ("MultiStepScheduler", (3.0, [0, 4, 4, 30], 0.5)),
]


@pytest.mark.parametrize("cls,args", SCHEDULES)
def test_schedulers_match_jax(cls, args):
    t, j = getattr(tsched, cls)(*args), getattr(jsched, cls)(*args)
    assert [t.value(s) for s in range(-2, 40)] == [j.value(s) for s in range(-2, 40)]
    assert [t.step(3) for _ in range(12)] == [j.step(3) for _ in range(12)]


@pytest.mark.parametrize("cls,args", [("PiecewiseScheduler", ([],)),
                                      ("PiecewiseScheduler", ([(10, 1.0), (0, 0.5)],)),
                                      ("MultiStepScheduler", (1.0, [5, 2]))])
def test_scheduler_errors_match_jax(cls, args):
    with pytest.raises(ValueError) as want:
        getattr(jsched, cls)(*args)
    with pytest.raises(ValueError) as got:
        getattr(tsched, cls)(*args)
    assert str(got.value) == str(want.value)


def test_hard_target_update_matches_jax_and_copies():
    rng = np.random.default_rng(0)
    online = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    target = {k: np.zeros_like(v) for k, v in online.items()}
    want = jtree.hard_target_update({k: jnp.asarray(v) for k, v in online.items()},
                                    {k: jnp.asarray(v) for k, v in target.items()})
    t_online = {k: torch.tensor(v) for k, v in online.items()}
    got = ttree.hard_target_update(t_online, {k: torch.tensor(v) for k, v in target.items()})
    for k in online:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].data_ptr() != t_online[k].data_ptr()


SCORES = [
    (np.array([[1.0, 2.0], [1.0, 2.0], [1.0, 2.0]]),
     np.array([[False, True], [False, False], [True, True]])),
    (np.arange(6.0), np.array([0, 1, 0, 0, 1, 0], bool)),
    (np.random.default_rng(1).normal(size=(20, 5)), np.random.default_rng(2).uniform(size=(20, 5))
     < 0.2),
]


@pytest.mark.parametrize("case", range(len(SCORES)))
@pytest.mark.parametrize("unterminated", [False, True])
def test_calculate_vectorized_scores_matches_jax(case, unterminated):
    rewards, dones = SCORES[case]
    assert (tmetrics.calculate_vectorized_scores(rewards, dones, unterminated)
            == jmetrics.calculate_vectorized_scores(rewards, dones, unterminated))


@pytest.mark.parametrize("dicts", [[{"a": 1.0, "b": 2.0}, {"a": 3.0}], [],
                                   [{"x": 1}, {"x": 2.5, "y": -1.0}, {"y": 0.25}]])
def test_calculate_mean_matches_jax(dicts):
    assert tmetrics.calculate_mean(dicts) == jmetrics.calculate_mean(dicts)


def test_stack_trajectories_matches_jax():
    """The time-major fields concatenate on the batch axis in both
    packages; the port's recurrent cores concatenate on their batch axis
    (dim 0), where the JAX function concatenates every leaf on axis 1."""
    rng = np.random.default_rng(3)

    def fields(B):
        return dict(obs=rng.normal(size=(4, B, 3)).astype(np.float32),
                    action=rng.integers(0, 2, (4, B)).astype(np.int64),
                    reward=rng.normal(size=(4, B)).astype(np.float32),
                    done=rng.uniform(size=(4, B)) < 0.3,
                    logits=rng.normal(size=(4, B, 2)).astype(np.float32))

    parts = [fields(1), fields(2), fields(1)]
    want = jtraj.stack_trajectories([jtraj.Trajectory(
        **{k: jnp.asarray(v) for k, v in f.items()}, core_state=()) for f in parts])
    got = ttraj.stack_trajectories([ttraj.Trajectory(
        **{k: torch.tensor(v) for k, v in f.items()}) for f in parts])
    for k in parts[0]:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    cores = [((torch.full((b, 5), float(i)), torch.full((b, 5), -float(i))),)
             for i, b in enumerate((1, 2, 1))]
    stacked = ttraj.stack_trajectories([ttraj.Trajectory(
        **{k: torch.tensor(v) for k, v in f.items()}, core_state=c)
        for f, c in zip(parts, cores)])
    c, h = stacked.core_state[0]
    assert c.shape == h.shape == (4, 5)
    assert c[:, 0].tolist() == [0.0, 1.0, 1.0, 2.0]


def _trace(make, ma_mod, steps=40):
    vec = make(ma_mod.PursuitToyEnv, num_envs=2)
    rng = np.random.default_rng(0)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return np.asarray(x).tolist() if isinstance(x, np.ndarray) else x

    try:
        trace = [plain(vec.reset(seed=3))]
        for _ in range(steps):  # past the 32-step episode limit
            trace.append(plain(vec.step({"chaser": rng.integers(0, 3, 2),
                                         "runner": rng.integers(0, 3, 2)})))
    finally:
        vec.close()
    return trace


def test_make_multi_agent_vect_envs_matches_jax(monkeypatch):
    # this process holds JAX's threads: the port's pool spawns its workers
    # here, as the JAX pool does once a JAX backend is up
    from scalerl_torch.utils import platform

    monkeypatch.setattr(platform, "safe_mp_context", lambda requested=None: "spawn")
    jnp.zeros(1).block_until_ready()
    assert _trace(tgym.make_multi_agent_vect_envs, tma) == _trace(
        jgym.make_multi_agent_vect_envs, jma)
