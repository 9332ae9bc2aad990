"""The port's n-gram drafter (``genrl/drafter.py``) against the JAX one.

Each trace is a list of operations (start, extend, propose, observe,
release) replayed on both drafters: every proposal, every lane's AIMD cap
and the stats must be equal, step by step.  The traces are the scripted
ones of tests/test_drafter.py plus seeded random traces over a small
vocabulary (repeats are common, so every ladder width hits).
"""

import numpy as np
import pytest

from scalerl_torch.genrl.drafter import NgramDrafter
from scalerl_tpu.genrl.drafter import NgramDrafter as JaxNgramDrafter


def _a(*xs):
    return np.asarray(xs, np.int32)


SCRIPTED = {
    # tests/test_drafter.py, case by case: (n, k, ops)
    "prompt_continuation": (2, 3, [("start", 0, _a(5, 6, 7, 8, 5, 6)), ("propose", 0)]),
    "no_self_match": (2, 4, [("start", 0, _a(3, 4)), ("propose", 0)]),
    "misses": (2, 2, [("propose", 99), ("start", 1, _a(2, 3, 4, 5)), ("propose", 1),
                      ("release", 1), ("propose", 1)]),
    "latest_full_continuation": (2, 2, [("start", 0, _a(9, 2, 5, 9, 2, 6, 9, 2)),
                                        ("propose", 0)]),
    "earliest_fallback": (2, 4, [("start", 0, _a(7, 8, 7, 8, 7, 8)), ("propose", 0)]),
    "extend_feeds": (2, 2, [("start", 0, _a(4, 5)), ("extend", 0, _a(6, 4, 5)), ("propose", 0)]),
    "width_fallback_young_only": (2, 2, [("start", 0, _a(3, 9, 4)), ("extend", 0, _a(9)),
                                         ("propose", 0), ("extend", 0, _a(5)), ("propose", 0)]),
    "aimd": (1, 8, [("start", 0, _a(*[6] * 9)), ("propose", 0), ("observe", 0, 8, 1),
                    ("propose", 0), ("observe", 0, 2, 2), ("propose", 0), ("observe", 0, 4, 4),
                    ("propose", 0), ("observe", 0, 8, 8), ("propose", 0), ("observe", 0, 0, 0),
                    ("propose", 0), ("observe", 123, 4, 0)]),
    "recycle_lane": (2, 2, [("start", 3, _a(5, 6, 5, 6)), ("propose", 3), ("release", 3),
                            ("start", 3, _a(2, 3, 4)), ("propose", 3)]),
}


def _random_trace(seed, n_lanes=3, steps=120, vocab=5):
    rng = np.random.default_rng(seed)
    ops = [("start", lane, rng.integers(0, vocab, rng.integers(1, 9)).astype(np.int32))
           for lane in range(n_lanes)]
    for _ in range(steps):
        lane = int(rng.integers(0, n_lanes + 1))  # lane n_lanes is never started
        r = rng.random()
        if r < 0.4:
            ops.append(("propose", lane))
        elif r < 0.75:
            ops.append(("extend", lane, rng.integers(0, vocab, rng.integers(1, 5)).astype(np.int32)))
        elif r < 0.93:
            proposed = int(rng.integers(0, 7))
            ops.append(("observe", lane, proposed, int(rng.integers(0, proposed + 1))))
        elif r < 0.97:
            ops.append(("release", lane))
        else:
            ops.append(("start", lane, rng.integers(0, vocab, rng.integers(1, 6)).astype(np.int32)))
    return ops


def _replay(drafter, ops):
    out = []
    for op in ops:
        kind, lane, *rest = op
        result = getattr(drafter, kind)(lane, *rest)
        if kind == "propose":
            out.append(None if result is None else (result.dtype.str, result.tolist()))
        lanes = drafter._lanes
        out.append(("cap", lane, lanes[lane].cap if lane in lanes else None))
        out.append(("stats", drafter.stats()))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTED))
def test_scripted_traces_match_jax(name):
    n, k, ops = SCRIPTED[name]
    assert _replay(NgramDrafter(n=n, k=k), ops) == _replay(JaxNgramDrafter(n=n, k=k), ops)


@pytest.mark.parametrize("seed,n,k", [(0, 1, 4), (1, 2, 3), (2, 3, 8), (3, 3, 24), (4, 2, 1)])
def test_random_traces_match_jax(seed, n, k):
    ops = _random_trace(seed)
    got = _replay(NgramDrafter(n=n, k=k), ops)
    assert got == _replay(JaxNgramDrafter(n=n, k=k), ops)
    assert any(x is not None and x[0] != "cap" and x[0] != "stats" for x in got)


def test_proposals_of_the_scripted_cases():
    """The expectations of tests/test_drafter.py, on the port alone."""
    d = NgramDrafter(n=2, k=3)
    d.start(0, _a(5, 6, 7, 8, 5, 6))
    np.testing.assert_array_equal(d.propose(0), [7, 8, 5])
    d = NgramDrafter(n=2, k=4)
    d.start(0, _a(7, 8, 7, 8, 7, 8))
    np.testing.assert_array_equal(d.propose(0), [7, 8, 7, 8])
    d = NgramDrafter(n=1, k=8)
    d.start(0, _a(*[6] * 9))
    d.observe(0, proposed=8, accepted=1)
    assert len(d.propose(0)) == 2


def test_constructor_validation():
    for kw in (dict(n=0), dict(k=0)):
        with pytest.raises(ValueError):
            NgramDrafter(**kw)
