"""Hermetic synthetic token tasks for the sequence-RL plane.

The port's own copy of ``scalerl_tpu/genrl/task.py`` (numpy only): a reward
computable purely from (prompt, response) token arrays, so the whole
generate -> score -> learn loop trains to a verifiable reward with no
external model, tokenizer or dataset.

- ``recall``: the FIRST real prompt token is the cue; every response token
  should repeat it.  An unconditional policy scores ``1/vocab_size`` in
  expectation, so a high reward needs the policy to attend back into the
  prompt.
- ``copy``: response token ``t`` should equal real prompt token ``t``.

Prompts and scores are host numpy: the reward is the environment half of
the dataflow and stays off the device, while generation and learning run
on it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class TokenRecallTask:
    """Cue-recall / copy reward over fixed-vocabulary token sequences.

    ``prompt_len`` may be an int (fixed) or an ``(lo, hi)`` inclusive range
    — ragged prompts exercise the engine's left-padding and bucket ladder.
    Token ids are drawn from ``[2, vocab_size)`` so 0 (pad) and 1 (a
    potential EOS) never collide with cue tokens.
    """

    def __init__(
        self,
        vocab_size: int = 16,
        prompt_len=4,
        response_len: int = 4,
        mode: str = "recall",
    ) -> None:
        if mode not in ("recall", "copy"):
            raise ValueError(f"mode must be recall | copy, got {mode!r}")
        if vocab_size < 4:
            raise ValueError(f"vocab_size must be >= 4, got {vocab_size}")
        self.vocab_size = vocab_size
        if isinstance(prompt_len, int):
            self.prompt_range = (prompt_len, prompt_len)
        else:
            self.prompt_range = (int(prompt_len[0]), int(prompt_len[1]))
        if self.prompt_range[0] < 1:
            raise ValueError("prompt_len must be >= 1")
        self.response_len = response_len
        self.mode = mode

    @property
    def max_prompt_len(self) -> int:
        return self.prompt_range[1]

    def sample_prompts(
        self, batch: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(prompts [B, max_prompt_len] int32, lengths [B] int32)``
        — right-padded with zeros; the engine re-aligns into its buckets."""
        lo, hi = self.prompt_range
        lengths = rng.integers(lo, hi + 1, size=batch).astype(np.int32)
        prompts = rng.integers(
            2, self.vocab_size, size=(batch, hi)
        ).astype(np.int32)
        # zero out the tail beyond each lane's length (cosmetic: the engine
        # only reads the first ``lengths[b]`` tokens of lane b)
        cols = np.arange(hi)[None, :]
        prompts = np.where(cols < lengths[:, None], prompts, 0)
        return prompts, lengths

    def score(
        self,
        prompts: np.ndarray,
        prompt_lengths: np.ndarray,
        response: np.ndarray,
        response_len: np.ndarray,
    ) -> np.ndarray:
        """Per-sequence reward in ``[0, 1]``: the fraction of real response
        positions matching the target (cue token, or position-wise copy)."""
        B, R = response.shape
        cols = np.arange(R)[None, :]
        alive = cols < np.maximum(response_len[:, None], 1)
        if self.mode == "recall":
            target = np.broadcast_to(prompts[:, :1], (B, R))
        else:
            # copy: target_t = prompt token t (prompt shorter than the
            # response wraps around its real length)
            idx = cols % np.maximum(prompt_lengths[:, None], 1)
            target = np.take_along_axis(prompts, idx, axis=1)
        match = (response == target) & alive
        return (
            match.sum(axis=1) / np.maximum(alive.sum(axis=1), 1)
        ).astype(np.float32)
