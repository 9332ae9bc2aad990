"""Self-drafting for speculative decode: a per-lane n-gram prompt-lookup
table, host-side numpy.

Port of ``scalerl_tpu/genrl/drafter.py``.  The continuous engine's
speculation loop needs k-token proposals between verify passes, without a
second model (a draft model would ride every ``push_params`` and add a
second forward to the hot loop).  Each lane drafts from its OWN context
(prompt + tokens generated so far): find an earlier occurrence of the
context's trailing gram, widest width first (``n`` down to 1), and propose
the ``k`` tokens that followed it.  A mis-draft costs nothing but verify
work: the verify pass emits at least the bonus token, and the sampled
distribution is unchanged either way.

The index is incremental: O(1) per generated token, O(prompt) at
admission, because the engine calls :meth:`NgramDrafter.extend` with
exactly the tokens each verify pass emitted.

Indexing rule: when token ``t`` is appended at position ``p``, the n-gram
``ctx[p-n:p]`` is recorded as continuing at ``p``, BEFORE the append, so
the context's own trailing n-gram never indexes itself and a proposal
never points past the end of the context.  All occurrence positions are
kept: a proposal prefers the most recent occurrence that still has a full
``k``-token continuation, falling back to the earliest occurrence (the
longest continuation) when every recent one sits too close to the end,
as on a periodic continuation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class _LaneDraft:
    """One lane's context and n-gram index."""

    __slots__ = ("tokens", "indexes", "cap", "prompt_len")

    def __init__(self, n: int, k: int) -> None:
        self.tokens: List[int] = []
        self.prompt_len = 0
        # adaptive proposal cap (AIMD via observe()): starts optimistic
        # at k; a rejection shrinks it toward the observed accept run, a
        # full accept doubles it back — so lanes whose content the table
        # predicts poorly stop paying k verified-but-rejected positions
        # per pass, which on a compute-bound substrate is the difference
        # between speculation winning and losing
        self.cap = k
        # one index per gram width 1..n: ngram -> ascending positions
        # where a continuation of it begins (propose() tries widest
        # first — the longest context match — and falls back down the
        # ladder, so a cold lane drafts off a single repeated token
        # while a warm one gets the precision of the full n-gram)
        self.indexes: List[Dict[Tuple[int, ...], List[int]]] = [
            {} for _ in range(n)
        ]


class NgramDrafter:
    """Per-lane n-gram/prompt-lookup draft tables.

    ``n``: MAXIMUM gram width matched against the context's tail; lookups
    ladder down from ``n`` to 1, widest (most reliable) match first.
    ``k``: maximum proposal length — the verify pass's token width is
    ``k + 1``, so this is a compile-shape knob, not a per-call argument.
    """

    def __init__(self, n: int = 3, k: int = 4) -> None:
        if n < 1:
            raise ValueError(f"ngram width must be >= 1, got {n}")
        if k < 1:
            raise ValueError(f"draft length must be >= 1, got {k}")
        self.n = n
        self.k = k
        self._lanes: Dict[int, _LaneDraft] = {}

    # -- lifecycle (mirrors lane occupancy) -----------------------------
    def start(self, lane_id: int, prompt: np.ndarray) -> None:
        """Begin a lane occupancy: (re)build the context from the prompt.
        O(prompt) once per admission — the per-token path is extend()."""
        lane = _LaneDraft(self.n, self.k)
        self._lanes[lane_id] = lane
        self.extend(lane_id, prompt)
        lane.prompt_len = len(lane.tokens)

    def extend(self, lane_id: int, tokens: np.ndarray) -> None:
        """Append emitted tokens, indexing each position's preceding
        n-gram before the append (the no-self-match rule)."""
        lane = self._lanes.get(lane_id)
        if lane is None:
            return
        ctx, indexes = lane.tokens, lane.indexes
        for t in tokens:
            p = len(ctx)
            for w in range(1, self.n + 1):
                if p >= w:
                    indexes[w - 1].setdefault(
                        tuple(ctx[p - w :]), []
                    ).append(p)
            ctx.append(int(t))

    def observe(self, lane_id: int, proposed: int, accepted: int) -> None:
        """Feed back one verify pass's outcome for the lane: ``proposed``
        draft tokens, ``accepted`` of them taken.  AIMD on the proposal
        cap — full acceptance doubles it (up to ``k``), a rejection
        clamps it just past the accepted run — so proposal length tracks
        how predictable the lane's content actually is."""
        lane = self._lanes.get(lane_id)
        if lane is None or proposed <= 0:
            return
        if accepted >= proposed:
            lane.cap = min(self.k, max(lane.cap, proposed) * 2)
        else:
            lane.cap = max(1, accepted + 1)

    def release(self, lane_id: int) -> None:
        """Drop a finished lane's table (the id is about to be recycled)."""
        self._lanes.pop(lane_id, None)

    # -- proposals -------------------------------------------------------
    def propose(self, lane_id: int) -> Optional[np.ndarray]:
        """Up to ``k`` proposed continuation tokens for the lane's current
        context, or ``None`` on a miss (cold lane, or no trailing gram of
        ANY width 1..n seen before — e.g. a token that never repeated)."""
        lane = self._lanes.get(lane_id)
        if lane is None or not lane.tokens:
            return None
        m, k = len(lane.tokens), min(self.k, lane.cap)
        # the narrow-width fallback exists to cover the cold-start ramp
        # (a lane two tokens into a repetition has no n-gram stats yet);
        # once the response is a full draft old the full-width index is
        # both populated and strictly more precise, and on a
        # compute-bound verify every mis-draft costs a real position —
        # so mature lanes propose full-width or not at all
        lo = self.n if m - lane.prompt_len >= self.k else 1
        for w in range(min(self.n, m), lo - 1, -1):  # widest match first
            positions = lane.indexes[w - 1].get(tuple(lane.tokens[-w:]))
            if not positions:
                continue
            start = positions[0]  # earliest = longest continuation
            for p in reversed(positions):
                if m - p >= k:  # newest with a full-k continuation
                    start = p
                    break
            draft = lane.tokens[start : start + k]
            if draft:
                return np.asarray(draft, np.int32)
        return None

    def stats(self) -> Dict[str, int]:
        return {
            "lanes": len(self._lanes),
            "indexed_ngrams": sum(
                len(ix) for l in self._lanes.values() for ix in l.indexes
            ),
        }
