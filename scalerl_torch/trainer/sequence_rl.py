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

Both trainers resolve ``RLArguments``' ``mesh_shape``/``dp_size``/``mp_size``
into the agent's dp x mp mesh (``parallel/train_step.py::
maybe_enable_mesh_from_args``).  :class:`SequenceRLTrainer` runs its rounds
on a mesh of several ranks in lockstep, and no rank decides anything on its
own:

- the prompt rng, the replay's sample generator and every engine seed come
  from rank 0's seed (``agreed_seed``);
- each ``dp`` group generates its contiguous share of the round (the cohort
  engine: rows of the round's prompts, padded into the round's prompt
  bucket; the continuous engine: ``genrl_batch / dp`` completions from
  prompts of its own stream), its ``mp`` ranks decoding on their own heads
  (the engines on the agent's local shards, ``genrl/engine.py``); the
  completions are all-gathered over ``dp`` in prompt order, so every rank
  scores, packs and inserts the same rows into its replicated replay and
  samples the same batch;
- the learn step splits that batch over ``dp`` x ``fsdp`` (``"split"``), the
  one-process step on the whole batch;
- stop, the time window and a preemption's save are agreed at each round's
  start (``RankAgreement``).

The steady-state guard is off on such a mesh: gloo stages its collectives
through host memory, and the admission broadcast reads a host int.

:class:`DisaggSequenceRLTrainer` is the same learn half over the
disaggregated dataflow (``genrl/disagg.py``): generation hosts stream
completed sequences into the learner's replay, and quantized snapshots flow
back; with a ledger directory it saves and resumes its whole plane.  Across
ranks, rank 0 owns the generation fleet and broadcasts each round's
sequences; every rank learns its rows of the batch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scalerl_torch.agents.token_ppo import TokenPPOAgent
from scalerl_torch.config import GenRLArguments
from scalerl_torch.data.sequence_replay import (
    seq_add,
    seq_export,
    seq_import,
    seq_init,
    seq_sample,
)
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
from scalerl_torch.parallel.collectives import broadcast_object
from scalerl_torch.parallel.mesh import AXIS_NAMES
from scalerl_torch.parallel.sharding import agreed_seed, gather_batch, shard_seed
from scalerl_torch.parallel.train_step import (
    RankAgreement,
    maybe_enable_mesh_from_args,
    multi_rank,
)
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.dispatch import steady_state_guard
from scalerl_torch.utils.buckets import bucket_for, default_buckets
from scalerl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from scalerl_torch.utils.platform import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def build_genrl_model(args: GenRLArguments, device: DeviceLike = "cuda") -> TransformerPolicy:
    """Token-mode transformer sized off the shared policy fields, with
    ``max_len`` covering the largest (prompt, response) bucket pair and,
    with the packed learner, the packed row length; its weights are drawn
    from ``args.seed``.  ``bf16_params`` gives bfloat16 compute and
    parameters (the LayerNorm scales and the heads stay float32, as Flax's
    ``param_dtype`` leaves them)."""
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
        dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
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


def _gen_config_kwargs(args: GenRLArguments, max_prompt_len: Optional[int] = None) -> Dict[str, Any]:
    return dict(vocab_size=args.vocab_size, max_prompt_len=max_prompt_len or args.prompt_len,
                max_new_tokens=args.max_new_tokens, temperature=args.temperature,
                top_k=args.top_k, eos_token=args.eos_token, seed=args.seed)


def _continuous_config(args: GenRLArguments, lanes: int,
                       max_prompt_len: Optional[int] = None) -> ContinuousConfig:
    """The continuous engine's config from the run's ``genrl_*`` paging
    knobs, with speculation when ``spec_enable``."""
    return ContinuousConfig(
        lanes=lanes, page_size=args.genrl_page_size, num_pages=args.genrl_num_pages,
        steps_per_macro=args.genrl_macro_steps, admit_max_wait_s=args.genrl_admit_wait_ms / 1e3,
        max_pending=args.genrl_max_pending, paged_attn=args.genrl_paged_attn,
        steps_in_flight=args.genrl_steps_in_flight, prefix_cache=args.genrl_prefix_cache,
        spec_k=args.spec_k if args.spec_enable else 0, spec_ngram=args.spec_ngram,
        **_gen_config_kwargs(args, max_prompt_len))


class _LearnHalf:
    """The learn half both sequence-RL trainers share: the agent, the
    prioritized sequence replay, and the round's units -> upload ->
    ``seq_add`` -> ``seq_sample`` (the PER sample kernel) -> token-PPO step,
    with its reward bookkeeping.  The trainers differ in where a round's
    sequences come from and where the learner publishes."""

    def _init_agent(self, args: GenRLArguments, task: Optional[Any],
                    agent: Optional[TokenPPOAgent], device: DeviceLike) -> None:
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
        # every rank learns on its rows of the one batch that all sampled
        maybe_enable_mesh_from_args(self.agent, args, batch_mode="split")
        self.seed = agreed_seed(args.seed, self.agent.mesh)

    def _init_replay(self, prompt_pad: int, response_pad: int) -> None:
        """The replay's geometry is the LARGEST bucket pair, so one buffer
        covers every round; with the packed learner the unit is a packed ROW
        of several compact sequences, and insert row counts pad up a pow2
        ladder."""
        args = self.args
        self._prompt_pad, self._response_pad = prompt_pad, response_pad
        self.packing = bool(args.learner_packing)
        self._pack_len = args.learner_pack_len or (prompt_pad + response_pad)
        self._row_buckets = default_buckets(args.genrl_batch)
        self.replay = seq_init(
            packed_field_shapes(self._pack_len) if self.packing
            else sequence_field_shapes(prompt_pad, response_pad),
            (),  # no recurrent core: attention over the sequence is the memory
            args.genrl_buffer_sequences,
            device=self.device,
        )
        # "pallas" = the CUDA sample kernel (its plain version on the host)
        self._seq_method = "pallas"
        self._sample_generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.learn_steps = 0
        self.reward_history: List[float] = []
        reg = telemetry.get_registry()
        self._learn_meter = reg.meter("genrl.learn_steps_per_s")
        self._reward_gauge = reg.gauge("genrl.mean_reward")
        self._pad_gauge = reg.gauge("genrl.pad_ratio")

    def _completion_units(self, packed, rewards):
        """Replay units of a :func:`pack_completions` batch: ``(fields,
        priorities, decode_tokens)``."""
        if self.packing:
            pk = packed_rows_from_completions(packed, rewards, self._pack_len)
            return _bucketed_rows(pk, self._row_buckets, self._pad_gauge)
        self._pad_gauge.set(
            1.0 - (packed.prompt_len.sum() + packed.mask.sum()) / max(packed.sequences.size, 1)
        )
        fields, priorities = packed.fields(rewards)
        return fields, priorities, packed.decode_tokens

    def _learn_from(self, fields, priorities, guard=None) -> Tuple[Dict[str, float], float]:
        """Upload, insert, sample and take one learn step (inside ``guard``);
        returns the metrics (ONE batched device->host copy) and the learn
        step's start stamp."""
        with guard or nullcontext():
            dev_fields, dev_priorities = upload_units(fields, priorities, self.device)
            self.replay = seq_add(self.replay, dev_fields, (), dev_priorities)
            batch, _core, _idx, weights = seq_sample(
                self.replay, self._sample_generator, self.args.genrl_sample_batch,
                method=self._seq_method,
            )
            batch = dict(batch)
            batch["is_weight"] = weights
            t_learn0 = time.monotonic()
            metrics = self.agent.learn(batch)
        return metrics, t_learn0

    def _close_round(self, metrics: Dict[str, float], rewards, staleness: float,
                     decode_tokens) -> Dict[str, float]:
        mean_reward = float(np.mean(rewards))
        self._reward_gauge.set(mean_reward)
        metrics["round_reward"] = mean_reward
        metrics["staleness"] = staleness
        metrics["decode_tokens"] = float(decode_tokens)
        self.reward_history.append(mean_reward)
        return metrics

    def _summary(self, metrics: Dict[str, float]) -> Dict[str, float]:
        summary = dict(metrics)
        tail = self.reward_history[-10:]
        summary["final_reward_mean"] = float(np.mean(tail)) if tail else 0.0
        summary["rounds"] = float(len(self.reward_history))
        return summary


class SequenceRLTrainer(_LearnHalf):
    """Single-learner sequence-RL loop over a synthetic (or injected) task.

    ``task``: anything with ``sample_prompts(batch, rng) -> (prompts,
    lengths)`` and ``score(prompts, lengths, response, response_len) ->
    rewards``; defaults to :class:`TokenRecallTask`.  ``device``: where the
    model, the engine, the replay and the learner live (the card by
    default; raises without one).  With an ``agent``, its model's device
    must be ``device``.  On a mesh of several ranks every rank builds its
    trainer alike and calls :meth:`train` alike (module docstring).
    """

    def __init__(
        self,
        args: GenRLArguments,
        task: Optional[Any] = None,
        agent: Optional[TokenPPOAgent] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        self._init_agent(args, task, agent, device)
        mesh = self.agent.mesh
        self._mesh = mesh if multi_rank(mesh) else None
        self._agree = RankAgreement(mesh)
        self._dp = 1 if self._mesh is None else mesh.shape["dp"]
        self._dp_index = 0 if self._mesh is None else mesh.coordinate("dp")
        if args.genrl_batch % self._dp:
            raise ValueError(f"genrl_batch ({args.genrl_batch}) must divide by the mesh's dp "
                             f"extent ({self._dp}): each dp group generates its share")
        max_prompt_len = max(getattr(self.task, "max_prompt_len", args.prompt_len),
                             args.prompt_len)
        self.continuous = args.genrl_engine == "continuous"
        # each dp group draws from a stream of its own (dp group 0 from the
        # run's seed, so one group draws what one rank would)
        gen_seed = shard_seed(self.seed, self._dp_index)
        engine_kw = dict(device=self.device, sync_guard=self._mesh is None,
                         shard_ctx=self.agent.shard_ctx)
        if self.continuous:
            config = _continuous_config(args, args.genrl_lanes or args.genrl_batch,
                                        max_prompt_len)
            config.seed = gen_seed
            self.engine = ContinuousEngine(self.agent.model, self.agent.engine_weights(),
                                           config, **engine_kw)
            # a macro step can finish more lanes than one learn batch takes;
            # the extras carry into the next round
            self._completion_backlog: List[Any] = []
            # the prompts of this dp group's own completions
            self._rng = np.random.default_rng(gen_seed)
        else:
            config = GenerationConfig(**_gen_config_kwargs(args, max_prompt_len))
            config.seed = gen_seed
            self.engine = GenerationEngine(self.agent.model, self.agent.engine_weights(),
                                           config, **engine_kw)
            # every rank draws the whole round's prompts and takes its rows
            self._rng = np.random.default_rng(self.seed)
        self._init_replay(
            bucket_for(self.engine.config.max_prompt_len,
                       self.engine.config.resolved_prompt_buckets()),
            bucket_for(args.max_new_tokens, self.engine.config.resolved_response_buckets()),
        )
        self._warm_inserts: set = set()
        reg = telemetry.get_registry()
        self._stale_gauge = reg.gauge("genrl.staleness")
        self._kl_gauge = reg.gauge("genrl.kl_ref")

    def _gather_dp(self, rows):
        """A round's per-row host arrays (the numpy fields of a named tuple,
        ``[n, ...]`` int32 or float32) from every dp group, in dp order: ONE
        all-gather over ``dp`` of one packed int32 buffer (float32 fields as
        their bits)."""
        if self._dp == 1:
            return rows
        fields = {k: v for k, v in rows._asdict().items() if isinstance(v, np.ndarray)}
        n = len(next(iter(fields.values())))
        flat = np.concatenate([np.ascontiguousarray(v).reshape(n, -1).view(np.int32)
                               for v in fields.values()], axis=1)
        every = gather_batch(torch.from_numpy(flat).to(self._mesh.device_type), self._mesh, 0,
                             ("dp",)).cpu().numpy()
        out, col = {}, 0
        for k, v in fields.items():
            width = int(np.prod(v.shape[1:], dtype=np.int64))
            out[k] = np.ascontiguousarray(every[:, col:col + width]).view(v.dtype).reshape(
                (-1,) + v.shape[1:])
            col += width
        return rows._replace(**out)

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
        share = slice(self._dp_index * B // self._dp, (self._dp_index + 1) * B // self._dp)
        # the round's prompt bucket, so every dp group's rows land in it
        bucket = bucket_for(int(np.max(lengths)), self.engine.config.resolved_prompt_buckets())
        result = self._gather_dp(self.engine.generate(prompts[share], lengths[share],
                                                      prompt_bucket=bucket))
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
        B = self.args.genrl_batch // self._dp  # this dp group's share
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
        packed = self._gather_dp(pack_completions(batch, self._prompt_pad, self._response_pad))
        rewards = self.task.score(packed.prompts, packed.prompt_len, packed.response_tokens,
                                  packed.response_len)
        fields, priorities, decode = self._completion_units(packed, rewards)
        return fields, priorities, rewards, decode

    def train_round(self) -> Dict[str, float]:
        """One generate -> score -> insert -> sample -> learn round."""
        t_gen0 = time.monotonic()
        fields, priorities, rewards, decode_tokens = (
            self._round_continuous() if self.continuous else self._round_cohort()
        )
        t_add0 = time.monotonic()
        rows = int(priorities.shape[0])
        guard = (steady_state_guard() if rows in self._warm_inserts and self._mesh is None
                 else None)
        metrics, t_learn0 = self._learn_from(fields, priorities, guard)
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
            self.engine.push_params(self.agent.engine_weights(), learner_step=self.learn_steps)
        # staleness from the metric that already crossed to the host
        staleness = self.engine.staleness_steps(int(round(metrics["mean_generation"])))
        self._stale_gauge.set(staleness)
        telemetry.observe_staleness(staleness, plane="genrl")
        if "kl_ref" in metrics:
            self._kl_gauge.set(metrics["kl_ref"])
        return self._close_round(metrics, rewards, staleness, decode_tokens)

    def train(self, rounds: Optional[int] = None, seconds: Optional[float] = None,
              guard: Optional[Any] = None, save_path: Optional[str] = None) -> Dict[str, float]:
        """Up to ``rounds`` rounds (``genrl_rounds`` by default).  At each
        round's start the ranks agree (``RankAgreement``) whether any of
        them has run ``seconds`` or seen a preemption on ``guard`` (a
        :class:`~scalerl_torch.runtime.supervisor.PreemptionGuard`, polled
        as the learner's safe point); the first stops the loop, the second
        saves to ``save_path`` (:meth:`save_checkpoint`) and stops it."""
        rounds = rounds if rounds is not None else self.args.genrl_rounds
        metrics: Dict[str, float] = {}
        log_every = max(self.args.logger_frequency or 50, 1)
        t0 = time.monotonic()
        for i in range(rounds):
            _, out_of_time, preempted = self._agree(
                0, seconds is not None and time.monotonic() - t0 >= seconds,
                guard is not None and guard.poll_chaos("learner"))
            if preempted:
                telemetry.record_event("preemption_exit", plane="genrl", step=self.learn_steps)
                if save_path is not None:
                    self.save_checkpoint(save_path)
                break
            if out_of_time:
                break
            metrics = self.train_round()
            if (i + 1) % log_every == 0 or i + 1 == rounds:
                logger.info(
                    "genrl round %d/%d reward=%.3f loss=%.4f staleness=%.1f",
                    i + 1, rounds, metrics.get("round_reward", 0.0),
                    metrics.get("total_loss", 0.0), metrics.get("staleness", 0.0),
                )
        return self._summary(metrics)

    def _frame_name(self) -> str:
        return f"trainer_dp{self._dp_index}"

    def save_checkpoint(self, path: str) -> str:
        """The run in the directory ``path``: the agent's state (``agent``,
        under a mesh gathered by every rank and written by rank 0) and each
        dp group's round-loop state, written by its first rank
        (``trainer_dp<g>``: learn steps, reward history, the prompt rng,
        the replay, the sample and engine generators, the engine's
        generation map).  Every rank calls it alike.  A cohort-engine run
        resumed from it (:meth:`load_checkpoint`) continues bit for bit; a
        continuous engine restarts with no lane live and no backlog."""
        self.agent.save_checkpoint(os.path.join(path, "agent"))
        if self._mesh is None or all(self._mesh.coordinate(a) == 0
                                     for a in AXIS_NAMES if a != "dp"):
            save_checkpoint(os.path.join(path, self._frame_name()), {
                "learn_steps": np.int64(self.learn_steps),
                "reward_history": np.asarray(self.reward_history, np.float64),
                "prompt_rng": np.frombuffer(
                    json.dumps(self._rng.bit_generator.state).encode(), np.uint8),
                "sample_generator": self._sample_generator.get_state(),
                "engine_generator": self.engine._generator.get_state(),
                "generation_map": self.engine.generation_map(),
                "replay": seq_export(self.replay),
            })
        if self._mesh is not None:
            dist.barrier()
        return path

    def load_checkpoint(self, path: str) -> None:
        """Resume the run :meth:`save_checkpoint` wrote to ``path``; every
        rank calls it alike."""
        self.agent.load_checkpoint(os.path.join(path, "agent"))
        frame = load_checkpoint(os.path.join(path, self._frame_name()))
        self.learn_steps = int(frame["learn_steps"])
        self.reward_history = [float(r) for r in frame["reward_history"]]
        self._rng.bit_generator.state = json.loads(bytes(frame["prompt_rng"].numpy()))
        self._sample_generator.set_state(frame["sample_generator"])
        self.engine._generator.set_state(frame["engine_generator"])
        self.engine.restore_params(self.agent.engine_weights(), frame["generation_map"])
        # the replay has no recurrent core, whose empty tuple holds no leaf
        self.replay = seq_import({**frame["replay"], "core": ()}, self.device)


# ---------------------------------------------------------------------------
# the disaggregated topology: generation fleet -> this learner


def host_weights(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Params as float32 numpy (bfloat16 leaves widen: the wire frames
    native numpy dtypes), fetched in ONE device->host copy."""
    names = list(params)
    flat = torch.cat([params[k].detach().reshape(-1).to(torch.float32) for k in names])
    host = flat.cpu().numpy()
    out, offset = {}, 0
    for k in names:
        n = params[k].numel()
        out[k] = host[offset:offset + n].reshape(params[k].shape)
        offset += n
    return out


class _WireCompletion:
    """One wire sequence payload seen through the ``CompletedSequence``
    attributes that ``pack_completions`` reads."""

    __slots__ = ("prompt", "prompt_len", "response_tokens", "behavior_logp", "values",
                 "generation")

    def __init__(self, payload: Dict[str, Any]) -> None:
        self.prompt = np.asarray(payload["prompt"], np.int32)
        self.prompt_len = int(payload["prompt_len"])
        self.response_tokens = np.asarray(payload["response_tokens"], np.int32)
        self.behavior_logp = np.asarray(payload["behavior_logp"], np.float32)
        self.values = np.asarray(payload["values"], np.float32)
        self.generation = int(payload["generation"])


class _CohortShellFactory:
    """Picklable engine factory for the generation hosts: the token-mode
    model and a fixed-cohort engine on ``device``, built inside the host
    from the run's args and the first wire snapshot (uploaded in one
    batched copy).  Its engines run without the sync guard: thread hosts
    share the process with the learner, and the guard's mode is
    process-wide."""

    def __init__(self, args: GenRLArguments, round_batch: int, device: DeviceLike = "cuda") -> None:
        self.args = args
        self.round_batch = round_batch
        self.device = device

    def __call__(self, params: Any, generation: int):
        from scalerl_torch.genrl.disagg import CohortEngineShell, upload_wire_params

        dev = resolve_device(self.device)
        engine = GenerationEngine(build_genrl_model(self.args, dev), upload_wire_params(params, dev),
                                  GenerationConfig(**_gen_config_kwargs(self.args)), device=dev,
                                  sync_guard=False)
        return CohortEngineShell(engine, self.round_batch, initial_generation=generation)


class _ContinuousShellFactory(_CohortShellFactory):
    """The continuous-engine twin of :class:`_CohortShellFactory`:
    ``round_batch`` lanes, the run's ``genrl_*`` paging knobs, and
    speculation when ``spec_enable``."""

    def __call__(self, params: Any, generation: int):
        from scalerl_torch.genrl.disagg import ContinuousEngineShell, upload_wire_params

        dev = resolve_device(self.device)
        engine = ContinuousEngine(build_genrl_model(self.args, dev),
                                  upload_wire_params(params, dev),
                                  _continuous_config(self.args, self.round_batch), device=dev,
                                  sync_guard=False)
        return ContinuousEngineShell(engine, initial_generation=generation)


class DisaggSequenceRLTrainer(_LearnHalf):
    """Sequence RL over the disaggregated dataflow (``genrl/disagg.py``):
    ``disagg_hosts`` generation hosts stream completed, generation-tagged
    sequences over the codec-v2 fleet wire into this learner's sequence
    replay, and quantized snapshots flow back every ``genrl_push_every``
    learn steps.  The learn half (upload, replay insert, the PER sample
    kernel, the token-PPO step through the segment kernels under
    ``learner_packing``) is the one :class:`SequenceRLTrainer` runs: disaggregation
    changes where sequences are born, not how they are learned from.

    ``use_threads=True`` (default) runs the hosts as threads of this
    process (the wire, leases, acks, dedup and snapshots all still flow);
    ``False`` spawns host processes.  ``engine_factory`` builds each host's
    engine shell from the first wire snapshot; the default is a real engine
    on ``device``: the cohort engine, or the continuous one when
    ``genrl_engine="continuous"`` (the JAX trainer always takes the cohort
    engine).  No step runs under the steady-state guard: its mode is
    process-wide, and thread hosts share the process.

    On a mesh of several ranks every rank builds the trainer alike and
    calls :meth:`train` alike.  Rank 0 owns the fleet: it alone builds the
    :class:`~scalerl_torch.genrl.disagg.SequenceLearner`, the
    ``LocalGenerationFleet``, the leases and the ledger.  Each round starts
    with a broadcast from rank 0 (``parallel/collectives.py::
    broadcast_object``): a status (go, starved or stop), the round's packed
    fields, priorities and rewards, and the consumed generations; a starved
    round raises the same ``RuntimeError`` on every rank.  Every rank then
    inserts the same rows into its replicated replay, samples them with the
    agreed seed and learns its rows of the batch (``"split"``).  At a push
    every rank gathers the weights (``agent.get_weights``) and rank 0
    publishes them, so an int8 snapshot scales each leaf by the whole
    leaf's max.  The chaos poll and the time window are agreed at each
    round's start (``RankAgreement``).  Rank 0's thread hosts share the
    card with the learner ranks; their engines run whole wire snapshots and
    issue no collective, so the JAX trainer's mesh dispatch lock has no
    counterpart.

    With ``ledger_dir`` (or ``disagg_ledger_dir``), a
    :class:`~scalerl_torch.runtime.supervisor.PreemptionGuard` safe point
    between rounds turns SIGTERM into :meth:`save_resume` (the learner's
    accounting plane, the replay, the agent's weights and the lease
    cursor and generator in ONE crash-safe frame), and the next trainer
    built against the same directory resumes at the same learn step under
    a bumped learner epoch.  On a mesh every rank gathers the weights into
    that frame and rank 0 writes it; a resume hands rank 0's trainer state
    (learn step, replay, weights, sample generator) to every rank, which
    places the weights in its layout.
    """

    def __init__(
        self,
        args: GenRLArguments,
        task: Optional[Any] = None,
        agent: Optional[TokenPPOAgent] = None,
        engine_factory: Optional[Any] = None,
        use_threads: bool = True,
        ledger_dir: Optional[str] = None,
        guard: Optional[Any] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        from scalerl_torch.genrl.disagg import (
            DisaggConfig,
            LocalGenerationFleet,
            SequenceLearner,
            record_consumption_trace,
        )

        self._record_consumption_trace = record_consumption_trace
        self._init_agent(args, task, agent, device)
        mesh = self.agent.mesh
        self._mesh = mesh if multi_rank(mesh) else None
        self._agree = RankAgreement(mesh)
        # rank 0 owns the fleet, the leases and the ledger
        self.owns_fleet = self._mesh is None or dist.get_rank() == 0
        self._init_replay(bucket_for(args.prompt_len, default_buckets(args.prompt_len)),
                          bucket_for(args.max_new_tokens, default_buckets(args.max_new_tokens)))
        lanes = args.disagg_lanes_per_host or max(1, args.genrl_batch // args.disagg_hosts)
        self.config = DisaggConfig(
            num_hosts=args.disagg_hosts,
            lanes_per_host=lanes,
            upload_batch=args.disagg_upload_batch,
            snapshot_quantize=args.disagg_quantize,
            # a shallow accepted-sequence queue with stale eviction keeps the
            # consumed data fresh: queue depth IS worst-case staleness
            seq_maxsize=max(4 * args.genrl_batch, 2 * lanes * args.disagg_hosts),
        )
        # the learner owns the prompts: leases carry the task's tokens, so
        # generation hosts stay task-agnostic decode capacity
        self._lease_rng = np.random.default_rng(args.seed + 2)
        self._lease_lock = threading.Lock()
        self._lease_seq = 0
        self.guard = guard
        ledger_dir = ledger_dir or args.disagg_ledger_dir
        self.ledger_path = os.path.join(ledger_dir, "learner_ledger") if ledger_dir else None
        self.learner = self.fleet = None
        restored, fresh = None, True
        if self.owns_fleet:
            self.learner = SequenceLearner(self.config, self._next_lease,
                                           ledger_path=self.ledger_path)
            restored, fresh = self.learner.restored_extra, self.learner.generation == 0
            self.learner_epoch = self.learner.learner_epoch
        if self._mesh is not None:
            restored, fresh, self.learner_epoch = broadcast_object(
                (restored, fresh, self.learner_epoch) if self.owns_fleet else None)
        if restored is not None:
            self._adopt_restored(restored)
        if self.owns_fleet:
            self.learner.start()
        if fresh:
            # a fresh start only: a restored learner already holds the wire
            # snapshot (and the generation) its hosts must adopt.  Under a
            # mesh every rank gathers, rank 0 publishes
            weights = self.agent.get_weights()
            if self.owns_fleet:
                self.learner.publish(host_weights(weights), learner_step=0)
        self.wire_sequences = 0
        if self.owns_fleet:
            if engine_factory is None:
                cls = (_ContinuousShellFactory if args.genrl_engine == "continuous"
                       else _CohortShellFactory)
                engine_factory = cls(args, lanes, self.device)
            self.fleet = LocalGenerationFleet(self.learner, self.config, engine_factory,
                                              use_threads=use_threads)
            self.fleet.start()

    def _adopt_restored(self, extra: Dict[str, Any]) -> None:
        """Rebuild the trainer half of a preempted run from the ledger's
        ``extra`` tree: the learn step, the replay, the agent's weights, the
        lease cursor and generator (so resumed leases continue the exact
        sequence), the sample generator, and the reward history.  On a mesh
        every rank adopts rank 0's tree."""
        self.learn_steps = int(extra.get("learn_steps", 0))
        self._lease_seq = int(extra.get("lease_seq", 0))
        rng_state = extra.get("lease_rng")
        if rng_state:
            # PCG64's state words are 128-bit: they ride the ledger as JSON
            self._lease_rng.bit_generator.state = json.loads(rng_state)
        if "replay" in extra:
            self.replay = seq_import(extra["replay"], self.device)
        if "sample_generator" in extra:
            self._sample_generator.set_state(
                torch.from_numpy(np.asarray(extra["sample_generator"], np.uint8)))
        if "agent" in extra:
            live = self.agent.state.params
            self.agent.set_weights({
                k: torch.from_numpy(np.asarray(v)).to(device=self.device, dtype=live[k].dtype)
                for k, v in extra["agent"].items()})
        self.reward_history = [float(r) for r in extra.get("reward_history", [])]
        logger.info("disagg trainer resumed at learn step %d (epoch %d)",
                    self.learn_steps, self.learner_epoch)

    def save_resume(self) -> Optional[str]:
        """The PreemptionGuard safe-point action: stop the plane and save
        the learner's ledger and the trainer's state as one crash-safe
        frame.  Returns the ledger path, or None without a ledger dir.  On
        a mesh every rank calls it and gathers the weights; rank 0 writes."""
        if self.ledger_path is None:
            if self.owns_fleet:
                self.learner.stop()
            return None
        weights = host_weights(self.agent.get_weights())  # gathered on every rank of a mesh
        if not self.owns_fleet:
            return self.ledger_path
        self.learner.stop()
        extra = {
            "learn_steps": self.learn_steps,
            "lease_seq": self._lease_seq,
            "lease_rng": json.dumps(self._lease_rng.bit_generator.state),
            "reward_history": [float(r) for r in self.reward_history],
            "replay": seq_export(self.replay),
            "agent": weights,
            "sample_generator": self._sample_generator.get_state().numpy(),
        }
        return self.learner.save_ledger(self.ledger_path, extra=extra)

    def _next_lease(self) -> Dict[str, Any]:
        with self._lease_lock:
            self._lease_seq += 1
            seq = self._lease_seq
            prompts, lengths = self.task.sample_prompts(1, self._lease_rng)
        n = int(lengths[0])
        lease = {"seed": seq, "prompt": prompts[0, :n].astype(np.int32), "length": n}
        if self.args.samples_per_prompt > 1:
            # group sampling: the host fans the lease out into that many
            # completions; the learner closes it when all of them arrived
            lease["samples"] = self.args.samples_per_prompt
        return lease

    def _drain_round(self) -> Dict[str, Any]:
        """Rank 0's half of a round: drain ``genrl_batch`` wire sequences,
        pack and score them.  The status ``"go"`` carries the round's
        fields, priorities, rewards and consumed generations; ``"starved"``
        and ``"stop"`` (and ``"error"``, any other failure of the drain on a
        mesh) the error every rank raises."""
        B = self.args.genrl_batch
        if self.learner.stopped:
            return {"status": "stop", "error": "the disaggregated learner has stopped"}
        batch: List[_WireCompletion] = []
        raw: List[Dict[str, Any]] = []  # keeps the trace and _t_q wire keys
        deadline = time.monotonic() + self.args.disagg_round_timeout_s
        while len(batch) < B:
            payload = self.learner.get_sequence(timeout=0.2)
            if payload is not None:
                raw.append(payload)
                batch.append(_WireCompletion(payload))
            elif time.monotonic() > deadline:
                return {"status": "starved", "error": (
                    f"disagg round starved: {len(batch)}/{B} sequences after "
                    f"{self.args.disagg_round_timeout_s:.0f}s "
                    f"(live hosts: {self.learner.live_host_count()})")}
        t_drain = time.monotonic()
        packed = pack_completions(batch, self._prompt_pad, self._response_pad)
        rewards = self.task.score(packed.prompts, packed.prompt_len, packed.response_tokens,
                                  packed.response_len)
        fields, priorities, _decode = self._completion_units(packed, rewards)
        return {"status": "go", "fields": fields, "priorities": priorities, "rewards": rewards,
                "decode_tokens": packed.decode_tokens,
                "generations": np.asarray([c.generation for c in batch], np.int64),
                "raw": raw, "t_drain": t_drain}

    def train_round(self) -> Dict[str, float]:
        """One disaggregated round: drain ``genrl_batch`` wire sequences ->
        pack -> score -> insert -> sample -> learn -> publish the quantized
        snapshot (on a mesh: rank 0 drains and broadcasts, every rank
        learns)."""
        rnd = None
        if self.owns_fleet:
            try:
                rnd = self._drain_round()
            except Exception as e:  # noqa: BLE001 — raised on every rank below
                if self._mesh is None:
                    raise
                logger.exception("disagg round failed on rank 0")
                rnd = {"status": "error", "error": f"disagg round failed on rank 0: {e!r}"}
        if self._mesh is not None:
            # the wire payloads and the drain stamp stay on rank 0
            shared = broadcast_object(None if rnd is None else {
                k: v for k, v in rnd.items() if k not in ("raw", "t_drain")})
            rnd = shared if rnd is None else rnd
        if rnd["status"] != "go":
            raise RuntimeError(rnd["error"])
        t_add0 = time.monotonic()
        metrics, t_learn0 = self._learn_from(rnd["fields"], rnd["priorities"])
        self.learn_steps += 1
        if self.owns_fleet:
            # the consumed sequences' traces gain the learner-side edges,
            # from stamps the round already took
            self._record_consumption_trace(rnd["raw"], rnd["t_drain"], t_add0, t_learn0,
                                           t_learn0, time.monotonic(), self.learn_steps)
        self._learn_meter.mark()
        if self.learn_steps % self.args.genrl_push_every == 0:
            weights = self.agent.get_weights()  # gathered on every rank of a mesh
            if self.owns_fleet:
                self.learner.publish(host_weights(weights), learner_step=self.learn_steps)
        staleness = wire = None
        if self.owns_fleet:
            staleness = self.learner.observe_consumed(int(round(metrics["mean_generation"])))
            wire = self.learner.total_sequences
        if self._mesh is not None:
            staleness, wire = broadcast_object((staleness, wire))
        self.wire_sequences = wire
        return self._close_round(metrics, rnd["rewards"], staleness, rnd["decode_tokens"])

    def train(self, rounds: Optional[int] = None,
              seconds: Optional[float] = None) -> Dict[str, float]:
        """Up to ``rounds`` rounds (``genrl_rounds`` by default), ``seconds``
        at most; at each round's start the ranks agree whether any of them
        ran out of time or drew a preemption."""
        rounds = rounds if rounds is not None else self.args.genrl_rounds
        metrics: Dict[str, float] = {}
        t0 = time.monotonic()
        try:
            for _ in range(rounds):
                _, out_of_time, preempted = self._agree(
                    0, seconds is not None and time.monotonic() - t0 >= seconds,
                    self.guard is not None and self.guard.poll_chaos("learner"))
                if preempted:
                    # the safe point: SIGTERM (real, or the chaos plan's
                    # seeded preempt draw) landed; save the whole plane
                    # between rounds and exit, and the next trainer against
                    # the same ledger dir resumes this step
                    telemetry.record_event("preemption_exit", plane="disagg",
                                           step=self.learn_steps)
                    self.save_resume()
                    break
                if out_of_time:
                    break
                metrics = self.train_round()
        finally:
            self.close()
        summary = self._summary(metrics)
        summary["wire_sequences"] = float(self.learner.total_sequences if self.owns_fleet
                                          else self.wire_sequences)
        summary["learn_steps"] = float(self.learn_steps)
        return summary

    def close(self) -> None:
        """Stop the learner and join the fleet (rank 0's; the other ranks
        own neither)."""
        if self.owns_fleet:
            self.learner.stop()
            self.fleet.join(timeout=5.0)
