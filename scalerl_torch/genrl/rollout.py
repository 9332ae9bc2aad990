"""Pack generation rounds into prioritized sequence-replay units.

Port of ``scalerl_tpu/genrl/rollout.py`` (numpy only): the bridge between
the generation engines' host results and ``data/sequence_replay.py``.

**Padded layout.**  Every completed sequence is one replay unit:
``tokens`` ``[S]`` (left-padded prompt + response), ``behavior_logp`` /
``value`` / ``mask`` ``[R]`` over the response bucket, and the scalars
``reward`` / ``prompt_len`` / ``generation`` (the param generation that
produced the sequence).  Priorities default to 1.

**Packed learner layout.**  :func:`greedy_pack` and
:class:`PackedLearnerBatch` lay several COMPACT sequences (prompt +
response, no pad inside a sequence) end to end into fixed
``[rows, pack_len]`` rows, with per-token ``segment_ids`` (1-based,
ascending, 0 = pad tail), positions reset per segment, and the per-token
loss and behaviour fields at each token's own row offset.  The replay unit
becomes a ROW; the learner attends within segments only
(``models/transformer.py::packed_attention_mask`` or the CUDA segment
flash kernels).  Packing is host numpy: lengths and tokens are already on
the host when sequences complete, and the device sees one upload of the
assembled rows.

Field tables name numpy dtypes (``data/sequence_replay.py::seq_init`` maps
them to torch's).  Oversize sheds are counted (``genrl.oversize_shed``,
``genrl.pack_oversize_shed``) and recorded on the flight recorder
(``oversize_shed``, ``pack_oversize_shed`` events).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from scalerl_torch.genrl.engine import GenerationResult
from scalerl_torch.runtime import telemetry


def sequence_field_shapes(
    prompt_pad: int, response_pad: int
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """``seq_init`` field table for one (prompt, response) bucket pair."""
    S = prompt_pad + response_pad
    R = response_pad
    return {
        "tokens": ((S,), np.int32),
        "behavior_logp": ((R,), np.float32),
        "value": ((R,), np.float32),
        "mask": ((R,), np.float32),
        "reward": ((), np.float32),
        "prompt_len": ((), np.int32),
        "generation": ((), np.int32),
    }


def pack_sequences(
    result: GenerationResult,
    rewards: np.ndarray,
    priorities: Optional[np.ndarray] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """``(fields [B, ...], priorities [B])`` ready for ``seq_add``.

    Host-side numpy only: the one host->device copy is the caller's
    upload of the batch for ``seq_add``.
    """
    B = result.sequences.shape[0]
    rewards = np.asarray(rewards, np.float32)
    if rewards.shape != (B,):
        raise ValueError(
            f"rewards must be [B={B}], got shape {rewards.shape}"
        )
    fields = {
        "tokens": result.sequences.astype(np.int32),
        "behavior_logp": result.behavior_logp.astype(np.float32),
        "value": result.values.astype(np.float32),
        "mask": result.mask.astype(np.float32),
        "reward": rewards,
        "prompt_len": result.prompt_len.astype(np.int32),
        "generation": np.full(B, result.generation, np.int32),
    }
    if priorities is None:
        priorities = np.ones(B, np.float32)
    else:
        priorities = np.maximum(
            np.asarray(priorities, np.float32), 1e-6
        )
    return fields, priorities


class PackedCompletions(NamedTuple):
    """A variable-completion round re-batched into one bucket pair.

    The continuous engine finishes sequences one at a time (that is the
    point); the learner still wants rectangular batches.  This is the
    bridge: ``B`` completed sequences padded into the trainer's fixed
    (prompt_pad, response_pad) geometry — prompts LEFT-padded inside
    ``sequences`` (the learner-side layout every mask helper expects),
    RIGHT-padded in ``prompts`` (the task-scoring layout), responses
    zero-padded past each true length with a zeroed mask.  ``generations``
    is per-sequence: a continuous round can straddle a ``push_params``.
    """

    prompts: np.ndarray  # [B, prompt_pad] int32 right-padded (task layout)
    prompt_len: np.ndarray  # [B] int32
    sequences: np.ndarray  # [B, S] int32 left-padded prompt + response
    response_tokens: np.ndarray  # [B, response_pad] int32
    response_len: np.ndarray  # [B] int32
    behavior_logp: np.ndarray  # [B, response_pad] f32
    values: np.ndarray  # [B, response_pad] f32
    mask: np.ndarray  # [B, response_pad] f32
    generations: np.ndarray  # [B] int32 per-sequence admission generation

    @property
    def decode_tokens(self) -> int:
        return int(self.mask.sum())

    def fields(
        self, rewards: np.ndarray, priorities: Optional[np.ndarray] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """``seq_add``-ready fields — same schema as :func:`pack_sequences`
        (one replay, either engine)."""
        B = self.sequences.shape[0]
        rewards = np.asarray(rewards, np.float32)
        if rewards.shape != (B,):
            raise ValueError(
                f"rewards must be [B={B}], got shape {rewards.shape}"
            )
        fields = {
            "tokens": self.sequences,
            "behavior_logp": self.behavior_logp,
            "value": self.values,
            "mask": self.mask,
            "reward": rewards,
            "prompt_len": self.prompt_len,
            "generation": self.generations,
        }
        if priorities is None:
            priorities = np.ones(B, np.float32)
        else:
            priorities = np.maximum(
                np.asarray(priorities, np.float32), 1e-6
            )
        return fields, priorities


def pack_completions(
    completions: List[Any],
    prompt_pad: int,
    response_pad: int,
    pad_token: int = 0,
) -> PackedCompletions:
    """Pack ``CompletedSequence``s (variable prompt/response lengths) into
    the fixed bucket-pair geometry of the replay and the learner.

    A zero-completion round packs to an empty (``B == 0``) batch — every
    field keeps its trailing geometry, so callers can branch on ``B``
    without special-casing shapes.  A completion whose prompt or response
    exceeds the bucket pair is SHED (counted in ``genrl.oversize_shed``
    and dropped from the packed batch), never an error.
    """
    fits = []
    shed = 0
    for c in completions:
        if int(c.prompt_len) > prompt_pad or (
            len(c.response_tokens) > response_pad
        ):
            shed += 1
            continue
        fits.append(c)
    if shed:
        telemetry.get_registry().counter("genrl.oversize_shed").inc(shed)
        telemetry.record_event("oversize_shed", count=shed, prompt_pad=prompt_pad,
                               response_pad=response_pad)
    completions = fits
    B = len(completions)
    S = prompt_pad + response_pad
    prompts = np.full((B, prompt_pad), pad_token, np.int32)
    sequences = np.full((B, S), pad_token, np.int32)
    response = np.full((B, response_pad), pad_token, np.int32)
    logp = np.zeros((B, response_pad), np.float32)
    values = np.zeros((B, response_pad), np.float32)
    mask = np.zeros((B, response_pad), np.float32)
    plen = np.zeros((B,), np.int32)
    rlen = np.zeros((B,), np.int32)
    gens = np.zeros((B,), np.int32)
    for i, c in enumerate(completions):
        n = int(c.prompt_len)
        r = int(len(c.response_tokens))
        prompts[i, :n] = c.prompt[:n]
        sequences[i, prompt_pad - n : prompt_pad] = c.prompt[:n]
        sequences[i, prompt_pad : prompt_pad + r] = c.response_tokens
        response[i, :r] = c.response_tokens
        logp[i, :r] = c.behavior_logp
        values[i, :r] = c.values
        mask[i, :r] = 1.0
        plen[i] = n
        rlen[i] = r
        gens[i] = int(c.generation)
    return PackedCompletions(
        prompts=prompts,
        prompt_len=plen,
        sequences=sequences,
        response_tokens=response,
        response_len=rlen,
        behavior_logp=logp,
        values=values,
        mask=mask,
        generations=gens,
    )


# ---------------------------------------------------------------------------
# pad-free packed learner layout


def packed_field_shapes(
    pack_len: int,
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """``seq_init`` field table for packed learner ROWS.

    Every field is per-token over the row: ``segment_ids`` (0 = pad,
    1..K ascending per packed sequence), ``positions`` (reset to 0 at
    every segment start — the packed twin of ``sequence_positions``),
    ``mask`` (the LOSS mask: 1 exactly on response tokens), and
    ``behavior_logp``/``value``/``reward``/``generation`` aligned at each
    response token's own row offset (zero elsewhere).  The names shared
    with :func:`sequence_field_shapes` keep their meaning; the learner
    dispatches on the presence of ``segment_ids``.
    """
    S = pack_len
    return {
        "tokens": ((S,), np.int32),
        "segment_ids": ((S,), np.int32),
        "positions": ((S,), np.int32),
        "behavior_logp": ((S,), np.float32),
        "value": ((S,), np.float32),
        "mask": ((S,), np.float32),
        "reward": ((S,), np.float32),
        "generation": ((S,), np.int32),
    }


def greedy_pack(
    lengths: Sequence[int], pack_len: int
) -> Tuple[List[List[int]], List[int]]:
    """First-fit-decreasing bin packing of sequence ``lengths`` into rows
    of capacity ``pack_len``.

    Returns ``(rows, shed)``: ``rows`` is a list of index lists (each
    row's members, in placement order), ``shed`` the indices whose length
    exceeds ``pack_len`` outright (counted by the caller — never an
    error).  Pure host arithmetic over python ints: deterministic for a
    given input, no device value anywhere.
    """
    order = sorted(
        range(len(lengths)), key=lambda i: (-int(lengths[i]), i)
    )
    rows: List[List[int]] = []
    free: List[int] = []  # remaining capacity per row
    shed: List[int] = []
    for i in order:
        n = int(lengths[i])
        if n > pack_len:
            shed.append(i)
            continue
        for r, cap in enumerate(free):
            if n <= cap:
                rows[r].append(i)
                free[r] = cap - n
                break
        else:
            rows.append([i])
            free.append(pack_len - n)
    return rows, sorted(shed)


class PackedLearnerBatch(NamedTuple):
    """``N`` packed learner rows, ``seq_add``-ready.

    ``rows == 0`` is a legitimate zero-completion outcome: every field
    keeps its trailing ``[pack_len]`` geometry so callers can branch on
    ``rows`` without special-casing shapes.
    """

    tokens: np.ndarray  # [N, S] int32 compact prompt+response segments
    segment_ids: np.ndarray  # [N, S] int32, 0 = pad tail
    positions: np.ndarray  # [N, S] int32, reset per segment
    behavior_logp: np.ndarray  # [N, S] f32 at response-token offsets
    value: np.ndarray  # [N, S] f32 at response-token offsets
    mask: np.ndarray  # [N, S] f32 loss mask (response tokens)
    reward: np.ndarray  # [N, S] f32 sequence reward at response offsets
    generation: np.ndarray  # [N, S] int32 at segment-token offsets
    priorities: np.ndarray  # [N] f32 (max over member priorities)
    sequences_packed: int  # completions that made it into rows
    sequences_shed: int  # completions longer than pack_len (dropped)

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def pack_len(self) -> int:
        return int(self.tokens.shape[1])

    @property
    def real_tokens(self) -> int:
        """Prompt + response tokens actually occupying row slots."""
        return int((self.segment_ids > 0).sum())

    @property
    def decode_tokens(self) -> int:
        return int(self.mask.sum())

    @property
    def pad_ratio(self) -> float:
        """Pad tokens / total tokens over the row batch (0.0 on empty)."""
        total = self.tokens.size
        return 1.0 - self.real_tokens / total if total else 0.0

    def fields(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """``(fields, priorities)`` matching :func:`packed_field_shapes`
        — same call shape as :meth:`PackedCompletions.fields`, one
        replay, either layout."""
        return {
            "tokens": self.tokens,
            "segment_ids": self.segment_ids,
            "positions": self.positions,
            "behavior_logp": self.behavior_logp,
            "value": self.value,
            "mask": self.mask,
            "reward": self.reward,
            "generation": self.generation,
        }, self.priorities

    def bucketed(self, n_rows: int) -> "PackedLearnerBatch":
        """Pad the row axis up to ``n_rows`` with all-pad rows (segment
        id 0 everywhere, priority 0 = the replay's empty-slot sentinel,
        never sampled), so the replay sees a few insert sizes, not one
        per arrival count."""
        n = self.rows
        if n_rows < n:
            raise ValueError(
                f"row bucket {n_rows} below packed row count {n}"
            )
        if n_rows == n:
            return self
        pad = n_rows - n

        def _pad2(a):
            return np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
            )

        return self._replace(
            tokens=_pad2(self.tokens),
            segment_ids=_pad2(self.segment_ids),
            positions=_pad2(self.positions),
            behavior_logp=_pad2(self.behavior_logp),
            value=_pad2(self.value),
            mask=_pad2(self.mask),
            reward=_pad2(self.reward),
            generation=_pad2(self.generation),
            priorities=_pad2(self.priorities),
        )


def pack_learner_batch(
    prompts: Sequence[np.ndarray],
    responses: Sequence[np.ndarray],
    behavior_logp: Sequence[np.ndarray],
    values: Sequence[np.ndarray],
    rewards: np.ndarray,
    generations: np.ndarray,
    pack_len: int,
    pad_token: int = 0,
    priorities: Optional[np.ndarray] = None,
) -> PackedLearnerBatch:
    """Bin-pack ``B`` completed sequences into learner rows.

    Inputs are per-sequence TRUE-length host arrays (prompt tokens,
    response tokens, and the response-aligned logp/value vectors).  The
    whole function is numpy over python loops and never touches a device
    value; the ONE device upload is the caller's, of the returned fields.
    Sequences longer than ``pack_len`` are shed and counted
    (``genrl.pack_oversize_shed``), the :func:`pack_completions`
    convention.
    """
    B = len(prompts)
    rewards = np.asarray(rewards, np.float32)
    if rewards.shape != (B,):
        raise ValueError(f"rewards must be [B={B}], got {rewards.shape}")
    generations = np.asarray(generations, np.int32)
    if priorities is None:
        prio_in = np.ones(B, np.float32)
    else:
        prio_in = np.maximum(np.asarray(priorities, np.float32), 1e-6)
    lengths = [len(prompts[i]) + len(responses[i]) for i in range(B)]
    rows, shed = greedy_pack(lengths, pack_len)
    if shed:
        telemetry.get_registry().counter("genrl.pack_oversize_shed").inc(
            len(shed)
        )
        telemetry.record_event("pack_oversize_shed", count=len(shed), pack_len=pack_len)
    N, S = len(rows), pack_len
    tokens = np.full((N, S), pad_token, np.int32)
    seg = np.zeros((N, S), np.int32)
    pos = np.zeros((N, S), np.int32)
    logp = np.zeros((N, S), np.float32)
    val = np.zeros((N, S), np.float32)
    mask = np.zeros((N, S), np.float32)
    rew = np.zeros((N, S), np.float32)
    gens = np.zeros((N, S), np.int32)
    prio = np.zeros((N,), np.float32)
    for r, members in enumerate(rows):
        off = 0
        for s_idx, i in enumerate(members, start=1):
            p = np.asarray(prompts[i], np.int32)
            t = np.asarray(responses[i], np.int32)
            n, m = len(p), len(t)
            L = n + m
            tokens[r, off : off + n] = p
            tokens[r, off + n : off + L] = t
            seg[r, off : off + L] = s_idx
            pos[r, off : off + L] = np.arange(L)
            gens[r, off : off + L] = int(generations[i])
            resp = slice(off + n, off + L)
            logp[r, resp] = np.asarray(behavior_logp[i], np.float32)[:m]
            val[r, resp] = np.asarray(values[i], np.float32)[:m]
            mask[r, resp] = 1.0
            rew[r, resp] = rewards[i]
            prio[r] = max(prio[r], prio_in[i])
            off += L
    return PackedLearnerBatch(
        tokens=tokens,
        segment_ids=seg,
        positions=pos,
        behavior_logp=logp,
        value=val,
        mask=mask,
        reward=rew,
        generation=gens,
        priorities=prio,
        sequences_packed=B - len(shed),
        sequences_shed=len(shed),
    )


def packed_rows_from_result(
    result: GenerationResult,
    rewards: np.ndarray,
    pack_len: int,
    pad_token: int = 0,
    priorities: Optional[np.ndarray] = None,
) -> PackedLearnerBatch:
    """Cohort-engine bridge: unpad a :class:`GenerationResult` back to
    true-length sequences and bin-pack them (the packed twin of
    :func:`pack_sequences`)."""
    B = result.sequences.shape[0]
    P = result.prompt_pad
    prompts, responses, logps, vals = [], [], [], []
    for i in range(B):
        n = int(result.prompt_len[i])
        r = int(result.response_len[i])
        prompts.append(result.sequences[i, P - n : P].astype(np.int32))
        responses.append(result.response_tokens[i, :r].astype(np.int32))
        logps.append(result.behavior_logp[i, :r])
        vals.append(result.values[i, :r])
    return pack_learner_batch(
        prompts,
        responses,
        logps,
        vals,
        rewards,
        np.full(B, result.generation, np.int32),
        pack_len,
        pad_token=pad_token,
        priorities=priorities,
    )


def packed_rows_from_completions(
    packed: PackedCompletions,
    rewards: np.ndarray,
    pack_len: int,
    pad_token: int = 0,
    priorities: Optional[np.ndarray] = None,
) -> PackedLearnerBatch:
    """Continuous-engine bridge: re-pack a :class:`PackedCompletions`
    round (already scored against its task layout) into learner rows."""
    B = packed.sequences.shape[0]
    prompts, responses, logps, vals = [], [], [], []
    for i in range(B):
        n = int(packed.prompt_len[i])
        r = int(packed.response_len[i])
        prompts.append(packed.prompts[i, :n].astype(np.int32))
        responses.append(packed.response_tokens[i, :r].astype(np.int32))
        logps.append(packed.behavior_logp[i, :r])
        vals.append(packed.values[i, :r])
    return pack_learner_batch(
        prompts,
        responses,
        logps,
        vals,
        rewards,
        packed.generations,
        pack_len,
        pad_token=pad_token,
        priorities=priorities,
    )
