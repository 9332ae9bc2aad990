"""Sequence-RL trainer: the generate -> score -> learn round loop.

Port of ``scalerl_tpu/trainer/sequence_rl.py::SequenceRLTrainer``:

1. **generate**: the cohort engine runs one round (prefill + the whole
   decode loop), or the continuous engine steps until ``genrl_batch``
   sequences have finished; either returns host numpy with one batched
   read per dispatch;
2. **score**: the task's rule-based reward runs on host numpy;
3. **pack + replay**: sequences become replay units (``genrl/rollout.py``:
   padded sequences, or packed rows with ``learner_packing``), uploaded
   with ONE host->device copy and written into the prioritized sequence
   replay (``data/sequence_replay.py``), which is then sampled through the
   PER sample kernel;
4. **learn**: one token-PPO step (``agents/token_ppo.py``), its metrics
   read back with ONE batched copy; every ``genrl_push_every`` steps the
   learner publishes its parameters to the engine (a device-side copy),
   and staleness is reported from the metrics already on the host.

Once a round's shapes are warm, steps 3 and 4 run under
``steady_state_guard()``: on a card any other host synchronisation raises.

The disaggregated trainer (``DisaggSequenceRLTrainer``) and the mesh hookup
are not ported yet.
"""

from __future__ import annotations

import logging
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.agents.token_ppo import TokenPPOAgent
from scalerl_torch.config import GenRLArguments
from scalerl_torch.data.sequence_replay import seq_add, seq_init, seq_sample
from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine, _device_put
from scalerl_torch.genrl.rollout import (
    pack_completions,
    pack_sequences,
    packed_field_shapes,
    packed_rows_from_completions,
    packed_rows_from_result,
    sequence_field_shapes,
)
from scalerl_torch.genrl.task import TokenRecallTask
from scalerl_torch.models.transformer import TransformerPolicy
from scalerl_torch.ops.cuda_segment_attention import make_segment_attn_fn
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.dispatch import steady_state_guard
from scalerl_torch.utils.buckets import bucket_for, default_buckets
from scalerl_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def build_genrl_model(args: GenRLArguments, device: DeviceLike = "cuda") -> TransformerPolicy:
    """Token-mode transformer sized off the shared policy fields, with
    ``max_len`` covering the largest (prompt, response) bucket pair and,
    with the packed learner, the packed row length; its weights are drawn
    from ``args.seed``."""
    max_p = bucket_for(args.prompt_len, default_buckets(args.prompt_len))
    max_r = bucket_for(args.max_new_tokens, default_buckets(args.max_new_tokens))
    max_len = max_p + max_r
    seg_fn = None
    if args.learner_packing:
        seg_fn = make_segment_attn_fn(args.learner_packed_attn)
        max_len = max(max_len, args.learner_pack_len or 0)
    return TransformerPolicy(
        num_actions=args.vocab_size,
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        num_heads=args.n_heads,
        num_layers=args.n_layers,
        max_len=max_len,
        segment_attn_fn=seg_fn,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )


def _bucketed_rows(pk, row_buckets, pad_gauge):
    """Bucket a :class:`PackedLearnerBatch`'s row count up the pow2 ladder,
    publish the batch pad ratio, and return ``(fields, priorities,
    decode_tokens)``.  Eager PyTorch needs no fixed insert shape, but the
    all-pad rows are part of what the replay holds (they take slots, at
    priority 0), so the ladder stays."""
    pk = pk.bucketed(bucket_for(max(pk.rows, 1), row_buckets))
    pad_gauge.set(pk.pad_ratio)
    fields, priorities = pk.fields()
    return fields, priorities, pk.decode_tokens


def upload_units(fields: Mapping[str, np.ndarray], priorities: np.ndarray,
                 device: torch.device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One host->device copy for a round's replay units: every field and the
    priorities ride one packed int32 buffer (float32 fields as their bits)."""
    names = list(fields)
    arrays = [np.ascontiguousarray(fields[k]) for k in names]
    arrays.append(np.ascontiguousarray(priorities, np.float32))
    is_float = [a.dtype == np.float32 for a in arrays]
    for a, f in zip(arrays, is_float):
        if not f and a.dtype != np.int32:
            raise TypeError(f"replay fields must be int32 or float32, got {a.dtype}")
    packed = _device_put([a.view(np.int32) if f else a for a, f in zip(arrays, is_float)], device)
    out = [t.view(torch.float32) if f else t for t, f in zip(packed, is_float)]
    return dict(zip(names, out[:-1])), out[-1]


class SequenceRLTrainer:
    """Single-learner sequence-RL loop over a synthetic (or injected) task.

    ``task``: anything with ``sample_prompts(batch, rng) -> (prompts,
    lengths)`` and ``score(prompts, lengths, response, response_len) ->
    rewards``; defaults to :class:`TokenRecallTask`.  ``device``: where the
    model, the engine, the replay and the learner live (the card by
    default; raises without one).  With an ``agent``, its model's device
    must be ``device``.
    """

    def __init__(
        self,
        args: GenRLArguments,
        task: Optional[Any] = None,
        agent: Optional[TokenPPOAgent] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        args.validate()
        self.args = args
        self.device = resolve_device(device)
        self.task = task or TokenRecallTask(
            vocab_size=args.vocab_size,
            prompt_len=args.prompt_len,
            response_len=args.max_new_tokens,
        )
        self.agent = agent or TokenPPOAgent(args, build_genrl_model(args, self.device))
        if self.agent.device.type != self.device.type or (
            self.device.index is not None and self.agent.device.index != self.device.index
        ):
            raise ValueError(f"agent lives on {self.agent.device}, trainer on {self.device}")
        self.device = self.agent.device
        base_cfg = dict(
            vocab_size=args.vocab_size,
            max_prompt_len=max(getattr(self.task, "max_prompt_len", args.prompt_len),
                               args.prompt_len),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_k=args.top_k,
            eos_token=args.eos_token,
            seed=args.seed,
        )
        self.continuous = args.genrl_engine == "continuous"
        if self.continuous:
            self.engine = ContinuousEngine(
                self.agent.model,
                self.agent.get_weights(),
                ContinuousConfig(
                    lanes=args.genrl_lanes or args.genrl_batch,
                    page_size=args.genrl_page_size,
                    num_pages=args.genrl_num_pages,
                    steps_per_macro=args.genrl_macro_steps,
                    admit_max_wait_s=args.genrl_admit_wait_ms / 1e3,
                    max_pending=args.genrl_max_pending,
                    paged_attn=args.genrl_paged_attn,
                    steps_in_flight=args.genrl_steps_in_flight,
                    prefix_cache=args.genrl_prefix_cache,
                    **base_cfg,
                ),
                device=self.device,
            )
            # a macro step can finish more lanes than one learn batch takes;
            # the extras carry into the next round
            self._completion_backlog: List[Any] = []
        else:
            self.engine = GenerationEngine(
                self.agent.model, self.agent.get_weights(), GenerationConfig(**base_cfg),
                device=self.device,
            )
        # the replay's geometry is the engine's LARGEST bucket pair, so one
        # buffer covers every round
        self._prompt_pad = bucket_for(self.engine.config.max_prompt_len,
                                      self.engine.config.resolved_prompt_buckets())
        self._response_pad = bucket_for(args.max_new_tokens,
                                        self.engine.config.resolved_response_buckets())
        # packed learner: the replay unit is a packed ROW of several compact
        # sequences; insert row counts pad up a pow2 ladder
        self.packing = bool(args.learner_packing)
        self._pack_len = args.learner_pack_len or (self._prompt_pad + self._response_pad)
        self._row_buckets = default_buckets(args.genrl_batch)
        self.replay = seq_init(
            packed_field_shapes(self._pack_len) if self.packing
            else sequence_field_shapes(self._prompt_pad, self._response_pad),
            (),  # no recurrent core: attention over the sequence is the memory
            args.genrl_buffer_sequences,
            device=self.device,
        )
        # "pallas" = the CUDA sample kernel (its plain version on the host)
        self._seq_method = "pallas"
        self._rng = np.random.default_rng(args.seed)
        self._sample_generator = torch.Generator(device=self.device).manual_seed(args.seed + 1)
        self._warm_inserts: set = set()
        self.learn_steps = 0
        reg = telemetry.get_registry()
        self._learn_meter = reg.meter("genrl.learn_steps_per_s")
        self._reward_gauge = reg.gauge("genrl.mean_reward")
        self._stale_gauge = reg.gauge("genrl.staleness")
        self._kl_gauge = reg.gauge("genrl.kl_ref")
        self._pad_gauge = reg.gauge("genrl.pad_ratio")
        self.reward_history: List[float] = []

    def _generate_round(self):
        B = self.args.genrl_batch
        spp = self.args.samples_per_prompt
        if spp > 1:
            # group sampling on the cohort engine: each distinct prompt tiled
            # spp times, groups contiguous (every lane pays its own prefill)
            prompts, lengths = self.task.sample_prompts(B // spp, self._rng)
            prompts = np.repeat(prompts, spp, axis=0)
            lengths = np.repeat(lengths, spp, axis=0)
        else:
            prompts, lengths = self.task.sample_prompts(B, self._rng)
        result = self.engine.generate(prompts, lengths)
        rewards = self.task.score(prompts, lengths, result.response_tokens, result.response_len)
        return result, rewards

    def _round_cohort(self):
        result, rewards = self._generate_round()
        if (result.prompt_pad, result.response_pad) != (self._prompt_pad, self._response_pad):
            raise ValueError(
                "generation round landed outside the replay bucket pair "
                f"({result.prompt_pad}x{result.response_pad} vs "
                f"{self._prompt_pad}x{self._response_pad})"
            )
        if self.packing:
            pk = packed_rows_from_result(result, rewards, self._pack_len)
            fields, priorities, decode = _bucketed_rows(pk, self._row_buckets, self._pad_gauge)
            return fields, priorities, rewards, decode
        self._pad_gauge.set(
            1.0 - (result.prompt_tokens + result.decode_tokens) / max(result.sequences.size, 1)
        )
        fields, priorities = pack_sequences(result, rewards)
        return fields, priorities, rewards, result.decode_tokens

    def _round_continuous(self):
        """One continuous round: keep the lane pool fed, then pack exactly
        ``genrl_batch`` finished sequences (overshoot waits in the backlog)."""
        B = self.args.genrl_batch
        spp = self.args.samples_per_prompt
        while len(self._completion_backlog) < B:
            deficit = (B - len(self._completion_backlog) - self.engine.live_lanes
                       - self.engine.pending)
            if deficit > 0:
                # one submit_group per distinct prompt fans out into spp lanes
                # that share the prompt's KV copy-on-write
                n_groups = -(-deficit // spp)
                prompts, lengths = self.task.sample_prompts(n_groups, self._rng)
                for i in range(n_groups):
                    self.engine.submit_group(prompts[i], spp, lengths[i])
            self._completion_backlog.extend(self.engine.step())
        batch = self._completion_backlog[:B]
        self._completion_backlog = self._completion_backlog[B:]
        packed = pack_completions(batch, self._prompt_pad, self._response_pad)
        rewards = self.task.score(packed.prompts, packed.prompt_len, packed.response_tokens,
                                  packed.response_len)
        if self.packing:
            pk = packed_rows_from_completions(packed, rewards, self._pack_len)
            fields, priorities, decode = _bucketed_rows(pk, self._row_buckets, self._pad_gauge)
            return fields, priorities, rewards, decode
        self._pad_gauge.set(
            1.0 - (packed.prompt_len.sum() + packed.mask.sum()) / max(packed.sequences.size, 1)
        )
        fields, priorities = packed.fields(rewards)
        return fields, priorities, rewards, packed.decode_tokens

    def train_round(self) -> Dict[str, float]:
        """One generate -> score -> insert -> sample -> learn round."""
        t_gen0 = time.monotonic()
        fields, priorities, rewards, decode_tokens = (
            self._round_continuous() if self.continuous else self._round_cohort()
        )
        t_add0 = time.monotonic()
        rows = int(priorities.shape[0])
        guard = steady_state_guard() if rows in self._warm_inserts else nullcontext()
        with guard:
            dev_fields, dev_priorities = upload_units(fields, priorities, self.device)
            self.replay = seq_add(self.replay, dev_fields, (), dev_priorities)
            batch, _core, _idx, weights = seq_sample(
                self.replay, self._sample_generator, self.args.genrl_sample_batch,
                method=self._seq_method,
            )
            batch = dict(batch)
            batch["is_weight"] = weights
            t_learn0 = time.monotonic()
            metrics = self.agent.learn(batch)  # ONE batched device->host copy
        self._warm_inserts.add(rows)
        if tracing.sampling_enabled():
            # retroactive spans from stamps the round already took
            t_learn1 = time.monotonic()
            root = tracing.record_span("genrl.round", None, t_gen0, t_learn1, kind="genrl",
                                       step=self.learn_steps + 1)
            if root.sampled:
                tracing.record_span("round.generate", root, t_gen0, t_add0, kind="genrl",
                                    decode_tokens=float(decode_tokens))
                tracing.record_span("round.seq_add", root, t_add0, t_learn0, kind="genrl")
                tracing.record_span("round.learn", root, t_learn0, t_learn1, kind="genrl")
        self.learn_steps += 1
        self._learn_meter.mark()
        if self.learn_steps % self.args.genrl_push_every == 0:
            # learner_step feeds the plane's generation -> step map, so the
            # staleness below counts learner steps behind the newest push
            self.engine.push_params(self.agent.get_weights(), learner_step=self.learn_steps)
        # staleness from the metric that already crossed to the host
        staleness = self.engine.staleness_steps(int(round(metrics["mean_generation"])))
        self._stale_gauge.set(staleness)
        mean_reward = float(np.mean(rewards))
        self._reward_gauge.set(mean_reward)
        if "kl_ref" in metrics:
            self._kl_gauge.set(metrics["kl_ref"])
        metrics["round_reward"] = mean_reward
        metrics["staleness"] = staleness
        metrics["decode_tokens"] = float(decode_tokens)
        self.reward_history.append(mean_reward)
        return metrics

    def train(self, rounds: Optional[int] = None) -> Dict[str, float]:
        rounds = rounds if rounds is not None else self.args.genrl_rounds
        metrics: Dict[str, float] = {}
        log_every = max(self.args.logger_frequency or 50, 1)
        for i in range(rounds):
            metrics = self.train_round()
            if (i + 1) % log_every == 0 or i + 1 == rounds:
                logger.info(
                    "genrl round %d/%d reward=%.3f loss=%.4f staleness=%.1f",
                    i + 1, rounds, metrics.get("round_reward", 0.0),
                    metrics.get("total_loss", 0.0), metrics.get("staleness", 0.0),
                )
        summary = dict(metrics)
        tail = self.reward_history[-10:]
        summary["final_reward_mean"] = float(np.mean(tail)) if tail else 0.0
        summary["rounds"] = float(len(self.reward_history))
        return summary
