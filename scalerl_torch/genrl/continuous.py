"""Continuous-batching decode: a persistent lane pool over a paged KV cache.

Port of ``scalerl_tpu/genrl/continuous.py``.  :class:`ContinuousEngine`
runs a FIXED number of decode lanes and swaps *sequences* through them:

- **macro steps** — one dispatch advances every lane ``steps_per_macro``
  tokens: sample from the carried logits, latch EOS / the response budget,
  write the new K/V into pool pages, attend through the page table
  (``ops/cuda_paged_attention.py``, the hand-written CUDA kernel, behind
  the model's ``paged_attn_fn`` seam), carry the fresh logits.  One upload
  (the page table) and one batched read per macro step, under
  ``steady_state_guard()`` once warm;
- **pipelined reads** — ``steps_in_flight`` macro steps stay in flight
  with the host read lagging dispatch by K-1, so harvest and admission
  overlap device decode; ``K=1`` reads after every dispatch;
- **continuous admission** — between macro steps the host harvests
  finished lanes (their pages go back at once) and admits queued prompts
  into free lanes through the serving batcher's flush predicate and the
  pow2 bucket ladder.  Admission looks up the :class:`PrefixCache` first:
  the longest cached full-page prefix is shared into the lane's table and
  only the tail is prefilled (local-attention prefill when nothing
  matched, shared-table tail prefill on a hit);
- **group sampling (CoW fork)** — :meth:`submit_group` admits one prompt
  into ``n`` lanes: the leader prefills, the others map the same full
  prompt pages copy-on-write and get a private copy of the partial page;
- **paged KV** — the refcounting :class:`PageAllocator`: admission
  reserves a sequence's worst case (exhaustion backpressures, never
  corrupts); physical pages are drawn as contexts grow;
- **speculative decoding** (``spec_k > 0``) — each pass, every live lane
  proposes up to ``spec_k`` tokens from its own n-gram table
  (:class:`~scalerl_torch.genrl.drafter.NgramDrafter`, no second model),
  and ONE verify dispatch samples the bonus token from the carried logits,
  feeds ``[t0, d1..dk]`` at positions ``cl..cl+k`` through the
  shared-table tail-prefill path, accepts the longest draft prefix under
  the speculative-sampling rule (greedy match at temperature 0; accept
  with probability ``pi(d)`` and a carried banned-token residual at
  temperature > 0) and advances each lane 1..k+1 tokens.  Rejected tails
  roll back on the host by page-cursor rewind (``paging.rewind_pages``);
  the device needs none, since attention never reads past a lane's cursor.
  The verify pass attends without the paged kernel (the tail path gathers
  through the table), so a speculating engine launches no paged decode.
  Spec mode is synchronous (pass ``m+1``'s drafts need pass ``m``'s
  tokens): ``steps_in_flight`` does not apply.

Sampling is the cohort engine's (``engine.py``), so at temperature 0 the
two engines are token-identical on the same params.  A ``push_params``
mid-flight rotates the policy under lanes already decoding and FLUSHES the
prefix cache.

On a mesh (``shard_ctx``, as the cohort engine takes it) the pools hold the
rank's own ``num_heads / mp`` heads, and the paged kernel attends on those.
The ranks that hold one model between them step in lockstep, and their
host bookkeeping (allocator, page table, prefix cache, drafter) evolves
alike because it is deterministic host code fed the same tokens.  The one
host decision that reads the clock, the admission flush, is taken on the
first of those ranks and its request count broadcast (:meth:`_poll`).

What differs from the JAX engine:

- The JAX engine compiles each dispatch into one program (``iter_mode``
  chooses ``lax.scan`` or an unrolled loop, the same computation) and
  donates the pools and lane state through it.  The port runs eagerly with
  one loop form (no ``iter_mode``, no mesh ``dispatch_guard``, no trace
  counters) and updates the pools and lane state IN PLACE.  The lane-state
  tensors have ``lanes + 1`` rows: admission pad rows scatter into the
  last (trash) row where JAX drops out-of-range scatters, so no dispatch
  needs a boolean mask or a data-dependent shape.
- A CUDA index out of range is a device-side assert where a JAX gather
  clamps, so the cursor's table column and position are clamped before
  their gathers (a lane that reached its last slot indexes one past).
- The verify pass's random draws (the bonus token and the accept test's
  uniforms) come from one method, :meth:`ContinuousEngine._verify_draws`,
  so a test can inject JAX's draws; the verify programs of the draft-width
  ladder are one eager function (no per-bucket compile to count).
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scalerl_torch.genrl.engine import (
    GenerationConfig,
    _ModelRunner,
    _device_get,
    _device_put,
    adjust_logits,
    as_int32,
    check_token_model,
    sample_tokens,
    token_logp,
)
from scalerl_torch.genrl.drafter import NgramDrafter
from scalerl_torch.genrl.paging import PageAllocator, rewind_pages
from scalerl_torch.genrl.prefix_cache import PrefixCache
from scalerl_torch.models.transformer import (
    TransformerPolicy,
    init_paged_kv_cache,
    prompt_attention_mask,
)
from scalerl_torch.ops.cuda_paged_attention import make_paged_attn_fn
from scalerl_torch.parallel.collectives import broadcast_int
from scalerl_torch.parallel.shard_compute import model_axis
from scalerl_torch.parallel.sharding import ShardContext
from scalerl_torch.runtime import telemetry, tracing
from scalerl_torch.runtime.dispatch import steady_state_guard
from scalerl_torch.runtime.param_server import ParamSnapshotPlane
from scalerl_torch.serving.batcher import DynamicBatcher, ServingConfig, ServingRequest
from scalerl_torch.utils.buckets import bucket_for, default_buckets
from scalerl_torch.utils.platform import DeviceLike, resolve_device


@dataclass
class ContinuousConfig(GenerationConfig):
    """Cohort knobs plus the continuous-batching geometry (the JAX
    package's fields and defaults).

    ``num_pages = 0`` sizes the pool for every lane's worst case (null page
    included).  ``admit_max_wait_s`` is the deadline half of the admission
    flush predicate.  ``min_free_lanes`` holds admission until that many
    lanes are free (unless the pool is idle), so prefills amortize.
    ``paged_attn``: ``"pallas"`` or ``"auto"`` = the hand kernel,
    ``"xla"`` = the plain version.  ``spec_k > 0`` turns speculative
    decoding on with up to ``spec_k`` drafts a lane a pass, matched by an
    n-gram table of width ``spec_ngram``; 0 leaves it out entirely.
    """

    lanes: int = 64
    page_size: int = 16
    num_pages: int = 0
    steps_per_macro: int = 8
    admit_max_wait_s: float = 0.0
    max_pending: int = 0  # bounded admission queue; 0 = unbounded
    paged_attn: str = "auto"
    min_free_lanes: int = 1
    steps_in_flight: int = 2
    prefix_cache: bool = True
    spec_k: int = 0
    spec_ngram: int = 3

    def validate(self) -> None:
        super().validate()
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")
        if self.min_free_lanes < 1 or self.min_free_lanes > self.lanes:
            raise ValueError(f"min_free_lanes must be in [1, lanes], got {self.min_free_lanes}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.steps_per_macro < 1:
            raise ValueError(f"steps_per_macro must be >= 1, got {self.steps_per_macro}")
        if self.num_pages < 0:
            raise ValueError(f"num_pages must be >= 0 (0 = auto), got {self.num_pages}")
        if self.steps_in_flight < 1:
            raise ValueError(f"steps_in_flight must be >= 1, got {self.steps_in_flight}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (0 = speculation off), got {self.spec_k}")
        if self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {self.spec_ngram}")


class CompletedSequence(NamedTuple):
    """One finished lane occupancy, assembled on the host across the macro
    steps it spanned."""

    prompt: np.ndarray  # [n] int32 true prompt tokens
    prompt_len: int
    response_tokens: np.ndarray  # [r] int32 real tokens only
    behavior_logp: np.ndarray  # [r] f32
    values: np.ndarray  # [r] f32
    generation: int  # param generation at admission
    submit_time: float
    admit_time: float
    finish_time: float
    tag: Any = None  # opaque caller tag carried from submit() to harvest


@dataclass
class _Lane:
    """Host-side record of one lane's current occupancy."""

    busy: bool = False
    prompt: Optional[np.ndarray] = None
    prompt_len: int = 0
    context_len: int = 0
    pages: List[int] = field(default_factory=list)
    reserved: int = 0
    tokens: List[np.ndarray] = field(default_factory=list)
    logps: List[np.ndarray] = field(default_factory=list)
    values: List[np.ndarray] = field(default_factory=list)
    generation: int = 0
    submit_time: float = 0.0
    admit_time: float = 0.0
    tag: Any = None
    # index of the first macro dispatch that includes this occupancy: a
    # pipelined read of an OLDER macro must not be applied to it
    admit_macro: int = 0


class ContinuousEngine(ParamSnapshotPlane):
    """Persistent continuous-batching decode loop over a paged KV cache.

    ``model``: a token-mode :class:`TransformerPolicy` whose ``max_len``
    covers prompt bucket + response budget; ``params``: its initial
    ``{name: tensor}`` snapshot; ``device``: the card by default (raises
    without one).  ``sync_guard=False`` leaves out the steady-state
    guard (``torch.cuda.set_sync_debug_mode`` is process-wide, so an
    engine that shares its process with other threads' work runs without
    it, as does one on a mesh that syncs).  ``shard_ctx``: the mesh's
    computation on shards, ``params`` then the rank's local shards (module
    docstring).
    """

    def __init__(
        self,
        model: TransformerPolicy,
        params: Mapping[str, torch.Tensor],
        config: ContinuousConfig,
        device: DeviceLike = "cuda",
        sync_guard: bool = True,
        shard_ctx: Optional[ShardContext] = None,
    ) -> None:
        config.validate()
        check_token_model(model, "ContinuousEngine")
        self._sync_guard = sync_guard
        self.device = dev = resolve_device(device)
        self.config = config
        self.model = model
        # the model's paged decode reads go through the configured attention
        # unless the caller's model already names one
        self._run = _ModelRunner(model, dev, params,
                                 paged_attn_fn=make_paged_attn_fn(config.paged_attn),
                                 shard_ctx=shard_ctx)
        self._shard_ctx = shard_ctx
        # the ranks that step this engine's lanes with this one (None: alone)
        axis = None if shard_ctx is None else model_axis(shard_ctx.mesh)
        self._lane_group = None if axis is None else shard_ctx.mesh.group(axis)
        self._admits = axis is None or shard_ctx.mesh.coordinate(axis) == 0
        self._init_param_plane(params, dev)
        L = config.lanes
        ps = config.page_size
        self._max_prompt_bucket = bucket_for(config.max_prompt_len,
                                             config.resolved_prompt_buckets())
        # the response budget is the response BUCKET, as in the cohort engine
        self._response_budget = bucket_for(config.max_new_tokens,
                                           config.resolved_response_buckets())
        max_context = self._max_prompt_bucket + self._response_budget
        if model.max_len < max_context:
            raise ValueError(
                f"model.max_len ({model.max_len}) must cover prompt bucket "
                f"+ response budget ({max_context})"
            )
        self._pages_per_lane = -(-max_context // ps)  # table width
        num_pages = config.num_pages or (L * self._pages_per_lane + 1)
        self.allocator = PageAllocator(num_pages, ps)
        self._worst_pages = self.allocator.pages_for_tokens(max_context)
        self._prefix_cache: Optional[PrefixCache] = None
        if config.prefix_cache:
            self._prefix_cache = PrefixCache(self.allocator, ps)
            # cached-but-unreferenced chains are reclaimed on demand
            self.allocator.set_reclaim_hook(self._prefix_cache.evict)
        self._batcher = DynamicBatcher(ServingConfig(
            max_batch=L, max_wait_s=config.admit_max_wait_s, max_pending=config.max_pending,
        ))
        self._admit_buckets = default_buckets(L)
        # device state: pools + per-lane decode carry, updated in place;
        # row L of the lane state is the trash row for admission pad rows
        self._pools = init_paged_kv_cache(num_pages, ps, model.num_layers, self._run.heads,
                                          model.head_dim, device=dev)
        self._logits_st = torch.zeros(L + 1, config.vocab_size, dtype=torch.float32, device=dev)
        self._value_st = torch.zeros(L + 1, dtype=torch.float32, device=dev)
        self._cl = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        self._done = torch.ones(L + 1, dtype=torch.bool, device=dev)  # inert until admitted
        self._resp = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(config.seed)
        # host mirrors / bookkeeping
        self._lanes = [_Lane() for _ in range(L)]
        self._table = np.zeros((L, self._pages_per_lane), np.int32)
        # in-flight macro reads: (dispatch index, packed device outputs)
        self._inflight: Deque[Tuple[int, torch.Tensor]] = deque()
        self._warm = False
        self.macro_steps = 0
        self.completed_total = 0
        self._occupancy_sum = 0.0
        # speculative decode: left out entirely at spec_k = 0
        self._spec_k = config.spec_k
        self._drafter: Optional[NgramDrafter] = None
        # the verify width ladder over the pass's longest draft (0, 1, 2,
        # 4, ..., k): a pass whose drafts are short verifies through a
        # narrow forward instead of paying k positions a lane
        self._spec_buckets: Tuple[int, ...] = ()
        # the token rejected by the last pass's accept test, masked out of
        # the next bonus draw (the residual at temperature > 0); host-side,
        # riding the pass's one upload
        self._banned = np.full((L,), -1, np.int32)
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_rollback_pages_total = 0
        self._spec_draft_s = 0.0
        self._spec_verify_s = 0.0
        if self._spec_k:
            self._drafter = NgramDrafter(n=config.spec_ngram, k=config.spec_k)
            ladder, b = [0], 1
            while b < config.spec_k:
                ladder.append(b)
                b *= 2
            ladder.append(config.spec_k)
            self._spec_buckets = tuple(ladder)
        # prefill-savings accounting: full-page prefix tokens admitted vs
        # those skipped via cache hits and CoW group shares
        self.prefix_tokens_total = 0
        self.prefix_tokens_saved = 0
        self.prefill_tokens = 0
        reg = telemetry.get_registry()
        self._decode_meter = reg.meter("genrl.decode_tokens_per_s")
        self._prompt_meter = reg.meter("genrl.prompt_tokens_per_s")
        self._occupancy_gauge = reg.gauge("genrl.lane_occupancy")
        self._admitted_counter = reg.counter("genrl.admitted")
        self._completed_counter = reg.counter("genrl.completed")
        self._shared_counter = reg.counter("genrl.pages_shared")
        self._admit_hist = reg.histogram("genrl.admission_latency_s")
        self._spec_proposed_counter = reg.counter("genrl.spec_proposed")
        self._spec_accepted_counter = reg.counter("genrl.spec_accepted")
        self._spec_rollback_counter = reg.counter("genrl.spec_rollback_pages")
        self._spec_accept_gauge = reg.gauge("genrl.spec_acceptance_rate")
        reg.bind("genrl.pages", self.allocator.stats)
        if self._prefix_cache is not None:
            reg.bind("genrl.prefix", self._prefix_cache.stats)
        reg.bind("genrl.continuous", lambda: {
            "generation": self.generation,
            "macro_steps": self.macro_steps,
            "completed": self.completed_total,
            "live_lanes": self.live_lanes,
            "pending": self._batcher.stats()["pending_lanes"],
            "in_flight": len(self._inflight),
            "shed_total": self._batcher.shed_total,
            "spec_k": self._spec_k,
        })

    # -- admission ------------------------------------------------------
    def submit(self, prompt: np.ndarray, prompt_length: Optional[int] = None,
               tag: Any = None) -> bool:
        """Queue one prompt for admission; False = shed (queue at
        ``max_pending``).  ``tag`` comes back on the
        :class:`CompletedSequence`."""
        return self.submit_group(prompt, 1, prompt_length, tag)

    def submit_group(self, prompt: np.ndarray, n: int, prompt_length: Optional[int] = None,
                     tag: Any = None) -> bool:
        """Queue one prompt for ``n`` sampled completions (the GRPO group
        shape); False = shed.  The group admits atomically into ``n`` lanes
        that share the prompt's KV copy-on-write; every member completes as
        its own :class:`CompletedSequence` with the same ``tag``."""
        if n < 1 or n > self.config.lanes:
            raise ValueError(f"group size must be in [1, lanes], got {n}")
        if n * self._worst_pages > self.allocator.capacity:
            # groups admit atomically: one the pool can never cover would
            # sit queued forever
            raise ValueError(
                f"group of {n} needs {n * self._worst_pages} worst-case "
                f"pages but the pool caps at {self.allocator.capacity}"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        m = int(prompt_length) if prompt_length is not None else len(prompt)
        if m < 1 or m > self.config.max_prompt_len:
            raise ValueError(f"prompt length {m} outside [1, {self.config.max_prompt_len}]")
        return self._batcher.submit(ServingRequest(
            conn=None, req_id=None, lanes=n,
            payload={"prompt": prompt[:m].copy(), "len": m, "n": n, "tag": tag},
        ))

    @property
    def pending(self) -> int:
        """Queued-but-unadmitted LANES (a group of n counts n)."""
        return self._batcher.stats()["pending_lanes"]

    @property
    def live_lanes(self) -> int:
        return sum(lane.busy for lane in self._lanes)

    @property
    def prefix_saved_ratio(self) -> float:
        """Fraction of admitted full-page prefix tokens whose prefill was
        skipped (cache hits + CoW group shares)."""
        return self.prefix_tokens_saved / max(self.prefix_tokens_total, 1)

    def _admit(self) -> None:
        """Admit queued prompts into free lanes.  All table math is host
        numpy; the device sees one batched upload per prefill group plus
        one for the CoW fork."""
        free_ids = [i for i, lane in enumerate(self._lanes) if not lane.busy]
        if not free_ids:
            return
        if len(free_ids) < self.config.min_free_lanes and len(free_ids) < self.config.lanes:
            return  # wait for more lanes to free (a fully idle pool admits)
        # never over-commit the pool: cap the flush at the number of
        # worst-case sequences the allocator can still reserve
        affordable = (self.allocator.capacity - self.allocator.reserved) // self._worst_pages
        batch = self._poll(min(len(free_ids), affordable))
        if not batch:
            return
        now = time.monotonic()
        ps = self.config.page_size
        params, gen = self._snapshot_params()
        local: Dict[int, List[Tuple]] = {}
        prefix: Dict[int, List[Tuple]] = {}
        forks: List[Tuple[int, int, int, int]] = []
        inserts: List[Tuple[np.ndarray, int, List[int]]] = []
        admitted = 0
        for req in batch:
            prompt = req.payload["prompt"]
            m = req.payload["len"]
            n = req.payload.get("n", 1)
            lane_ids = [free_ids.pop(0) for _ in range(n)]
            leader = lane_ids[0]
            # longest cached full-page prefix, capped at m-1 tokens so the
            # tail always holds the token that yields the first logits
            cached: List[int] = []
            if self._prefix_cache is not None:
                cached = self._prefix_cache.lookup(prompt, m - 1)
            ck = len(cached) * ps
            worst = self.allocator.pages_for_tokens(m + self._response_budget)
            full_tokens = (m // ps) * ps
            if not self.allocator.try_reserve(worst):
                raise RuntimeError("admission cap should have prevented over-reserve")
            holder = f"lane[{leader}]"
            if cached:
                self.allocator.share(cached, holder=holder)
                self._shared_counter.inc(len(cached))
            tail_pages = self.allocator.alloc(
                self.allocator.pages_for_tokens(m) - len(cached), holder=holder)
            pages = cached + tail_pages
            self._occupy(leader, req, prompt, m, pages, worst, gen, now)
            t_len = m - ck
            row = (leader, prompt, m, ck, pages)
            if ck == 0:
                local.setdefault(bucket_for(m, self.config.resolved_prompt_buckets()),
                                 []).append(row)
            else:
                prefix.setdefault(bucket_for(t_len, self.config.resolved_prompt_buckets()),
                                  []).append(row)
            self.prefix_tokens_total += full_tokens
            self.prefix_tokens_saved += min(ck, full_tokens)
            self.prefill_tokens += t_len
            self._prompt_meter.mark(t_len)
            # group members fork off the leader copy-on-write
            n_full = m // ps
            partial = pages[n_full] if m % ps else None
            for member in lane_ids[1:]:
                if not self.allocator.try_reserve(worst):
                    raise RuntimeError("admission cap should have prevented over-reserve")
                mh = f"lane[{member}]"
                mpages = list(pages[:n_full])
                if n_full:
                    self.allocator.share(mpages, holder=mh)
                    self._shared_counter.inc(n_full)
                if partial is not None:
                    copy = self.allocator.alloc(1, holder=mh)[0]
                    mpages.append(copy)
                    forks.append((leader, member, partial, copy))
                else:
                    forks.append((leader, member, 0, 0))
                self._occupy(member, req, prompt, m, mpages, worst, gen, now)
                self.prefix_tokens_total += full_tokens
                self.prefix_tokens_saved += full_tokens
            admitted += n
            self._admit_hist.observe(now - req.t_enqueue)
            if self._prefix_cache is not None and n_full:
                inserts.append((prompt, m, pages[:n_full]))
        self._admitted_counter.inc(admitted)
        with torch.no_grad():
            for P, rows in local.items():
                self._dispatch_local_prefill(P, rows, params, gen)
            for T, rows in prefix.items():
                self._dispatch_prefix_prefill(T, rows, params, gen)
            if forks:
                self._dispatch_fork(forks)
        # register the chains AFTER the prefill dispatches: work on the
        # stream is ordered, so a later reader sees the completed writes
        for prompt, m, full_pages in inserts:
            self._prefix_cache.insert(prompt, m, full_pages)

    def _poll(self, max_lanes: int) -> List[ServingRequest]:
        """The requests to admit now.  The flush predicate reads the host
        clock (``admit_max_wait_s``), so ranks that step these lanes
        together would admit apart: the first of them polls and broadcasts
        how many requests it took, and each other takes that many off its
        own queue, which holds the same requests in the same order."""
        if not self._admits:
            return self._batcher.take(broadcast_int(0, self._shard_ctx.mesh.device_type,
                                                    self._lane_group))
        batch = self._batcher.poll_batch(max_lanes=max_lanes) or []
        if self._lane_group is not None:
            broadcast_int(len(batch), self._shard_ctx.mesh.device_type, self._lane_group)
        return batch

    def _occupy(self, lane_id: int, req: ServingRequest, prompt: np.ndarray, m: int,
                pages: List[int], reserved: int, gen: int, now: float) -> None:
        lane = self._lanes[lane_id]
        lane.busy = True
        lane.prompt = prompt
        lane.prompt_len = m
        lane.context_len = m
        lane.pages = pages
        lane.reserved = reserved
        lane.tokens, lane.logps, lane.values = [], [], []
        lane.generation = gen
        lane.submit_time = req.t_enqueue
        lane.admit_time = now
        lane.tag = req.payload.get("tag")
        lane.admit_macro = self.macro_steps
        self._table[lane_id] = 0
        self._table[lane_id, : len(pages)] = pages
        if self._drafter is not None:
            # a recycled lane id starts a fresh draft table over the new
            # prompt, and the previous occupant's banned token dies with it
            self._drafter.start(lane_id, prompt[:m])
            self._banned[lane_id] = -1

    # -- prefill and fork dispatches --------------------------------------
    def _set_lane_state(self, lane_ids: torch.Tensor, logits: torch.Tensor,
                        value: torch.Tensor, cl: torch.Tensor) -> None:
        """Scatter freshly prefilled lanes' carry into the lane state (pad
        rows carry lane id ``lanes``: the trash row)."""
        idx = lane_ids.long()
        self._logits_st.index_copy_(0, idx, logits)
        self._value_st.index_copy_(0, idx, value)
        self._cl.index_copy_(0, idx, cl.to(torch.int32))
        self._done.index_fill_(0, idx, False)
        self._resp.index_fill_(0, idx, 0)

    def _dispatch_local_prefill(self, P: int, rows: List[Tuple], params, gen: int) -> None:
        """Cold prompts: causal local-attention prefill over the compact
        batch, K/V written straight into the lanes' fresh pages — one
        batched upload, no read."""
        ps = self.config.page_size
        A = bucket_for(len(rows), self._admit_buckets)
        L = self.config.lanes
        tokens = np.full((A, P), self.config.pad_token, np.int32)
        lengths = np.ones((A,), np.int32)
        lane_ids = np.full((A,), L, np.int32)  # pad rows -> trash row
        page_ids = np.zeros((A, P), np.int32)  # pad writes -> null page
        offsets = np.zeros((A, P), np.int32)
        for r, (lane_id, prompt, m, _ck, pages) in enumerate(rows):
            tokens[r, :m] = prompt
            lengths[r] = m
            lane_ids[r] = lane_id
            pos = np.arange(m)
            page_ids[r, :m] = np.asarray(pages, np.int32)[pos // ps]
            offsets[r, :m] = pos % ps
        # ONE batched host->device upload per prefill dispatch
        tokens, lengths, lane_ids, page_ids, offsets = _device_put(
            (tokens, lengths, lane_ids, page_ids, offsets), self.device)
        positions = torch.arange(P, device=self.device).expand(A, P)
        out, _ = self._run(params, gen, tokens, positions=positions,
                           attn_mask=prompt_attention_mask(lengths, P),
                           paged_cache=self._pools, page_ids=page_ids, page_offsets=offsets)
        rows_i = torch.arange(A, device=self.device)
        last = (lengths - 1).long()
        self._set_lane_state(lane_ids, out.policy_logits[rows_i, last],
                             out.baseline[rows_i, last], lengths)

    def _dispatch_prefix_prefill(self, T: int, rows: List[Tuple], params, gen: int) -> None:
        """Cache-hit prompts: prefill ONLY the uncached tail.  Its K/V goes
        into lane-owned pages; attention gathers the whole context (shared
        prefix + tail) through the page table."""
        ps = self.config.page_size
        A = bucket_for(len(rows), self._admit_buckets)
        L = self.config.lanes
        Mp = self._pages_per_lane
        tokens = np.full((A, T), self.config.pad_token, np.int32)
        tail_lengths = np.ones((A,), np.int32)
        lane_ids = np.full((A,), L, np.int32)
        page_ids = np.zeros((A, T), np.int32)
        offsets = np.zeros((A, T), np.int32)
        table = np.zeros((A, Mp), np.int32)
        starts = np.zeros((A,), np.int32)
        for r, (lane_id, prompt, m, ck, pages) in enumerate(rows):
            t_len = m - ck
            tokens[r, :t_len] = prompt[ck:m]
            tail_lengths[r] = t_len
            lane_ids[r] = lane_id
            gpos = ck + np.arange(t_len)
            page_ids[r, :t_len] = np.asarray(pages, np.int32)[gpos // ps]
            offsets[r, :t_len] = gpos % ps
            table[r, : len(pages)] = pages
            starts[r] = ck
        tokens, tail_lengths, lane_ids, page_ids, offsets, table, starts = _device_put(
            (tokens, tail_lengths, lane_ids, page_ids, offsets, table, starts), self.device)
        positions = (starts[:, None] + torch.arange(T, device=self.device)[None, :]).clamp(
            0, self.model.max_len - 1)
        out, _ = self._run(params, gen, tokens, positions=positions, paged_cache=self._pools,
                           page_ids=page_ids, page_offsets=offsets, page_table=table,
                           prefix_starts=starts)
        rows_i = torch.arange(A, device=self.device)
        last = (tail_lengths - 1).long()
        self._set_lane_state(lane_ids, out.policy_logits[rows_i, last],
                             out.baseline[rows_i, last], starts + tail_lengths)

    def _dispatch_fork(self, forks: List[Tuple[int, int, int, int]]) -> None:
        """One page copy + lane-state fork for EVERY group member admitted
        this cycle: the leader's partial prompt page into the member's
        private page, the leader's post-prefill carry into the member's
        lane.  Pad rows copy null -> null and scatter into the trash row."""
        F = bucket_for(len(forks), self._admit_buckets)
        L = self.config.lanes
        src_lane = np.zeros((F,), np.int32)
        dst_lane = np.full((F,), L, np.int32)
        src_page = np.zeros((F,), np.int32)
        dst_page = np.zeros((F,), np.int32)
        for i, (sl, dl, sp, dp) in enumerate(forks):
            src_lane[i], dst_lane[i], src_page[i], dst_page[i] = sl, dl, sp, dp
        src_lane, dst_lane, src_page, dst_page = (
            t.long() for t in _device_put((src_lane, dst_lane, src_page, dst_page), self.device))
        for pool in (*self._pools.k, *self._pools.v):
            pool.index_copy_(0, dst_page, pool.index_select(0, src_page))
        for st in (self._logits_st, self._value_st, self._cl, self._done, self._resp):
            st.index_copy_(0, dst_lane, st.index_select(0, src_lane))

    # -- the macro step ----------------------------------------------------
    def _decode_macro(self, params, gen: int, table: torch.Tensor) -> torch.Tensor:
        """``steps_per_macro`` substeps of sample -> latch -> paged write ->
        paged attention -> carry, on the device.  Returns the packed int32
        ``[L, 4 * steps + 3]`` outputs (tokens, logp bits, value bits,
        alive, then the cursor, done and response count after the macro);
        a fresh tensor, so a pipelined read never sees later state."""
        cfg = self.config
        L, ps, steps = cfg.lanes, cfg.page_size, cfg.steps_per_macro
        M = self._pages_per_lane
        budget = self._response_budget
        pad = max(cfg.eos_token, cfg.pad_token)
        logits, value = self._logits_st[:L], self._value_st[:L]
        cl, done, resp = self._cl[:L], self._done[:L], self._resp[:L]
        cols = []
        for _ in range(steps):
            adj = adjust_logits(logits, cfg.temperature, cfg.top_k, cfg.vocab_size)
            token = sample_tokens(self._generator, adj, cfg.temperature)
            logp = token_logp(adj, token)
            alive = ~done
            alive_i = alive.to(torch.int32)
            resp = resp + alive_i
            finished = resp >= budget
            if cfg.eos_token >= 0:
                finished = finished | (token == cfg.eos_token)
            cols.append((torch.where(alive, token, pad), logp, value, alive_i))
            done = done | finished
            # write K/V at flat position cl (dead lanes -> the null page);
            # the column is clamped: a finished lane's cursor may sit one
            # past its last page
            col = (cl // ps).clamp(max=M - 1).long()
            page_idx = torch.where(alive, table.gather(1, col[:, None])[:, 0], 0)
            offs = torch.where(alive, cl % ps, 0)
            att_len = torch.where(alive, cl + 1, 1)
            out, _ = self._run(params, gen, token[:, None], positions=cl[:, None],
                               paged_cache=self._pools, page_ids=page_idx[:, None],
                               page_offsets=offs[:, None], page_table=table,
                               attn_lengths=att_len)
            cl = cl + alive_i
            logits, value = out.policy_logits[:, 0], out.baseline[:, 0]
        # pack before the state write-back: the first substep's value is a
        # view of the lane state
        packed = torch.cat([
            torch.stack([c[0] for c in cols], dim=1).to(torch.int32),
            as_int32(torch.stack([c[1] for c in cols], dim=1)),
            as_int32(torch.stack([c[2] for c in cols], dim=1)),
            torch.stack([c[3] for c in cols], dim=1),
            cl[:, None], done[:, None].to(torch.int32), resp[:, None],
        ], dim=1)
        self._logits_st[:L].copy_(logits)
        self._value_st[:L].copy_(value)
        self._cl[:L].copy_(cl)
        self._done[:L].copy_(done)
        self._resp[:L].copy_(resp)
        return packed

    def _unpack(self, host: np.ndarray) -> Dict[str, np.ndarray]:
        S = self.config.steps_per_macro
        return {
            "tokens": host[:, :S],
            "logp": host[:, S:2 * S].view(np.float32),
            "value": host[:, 2 * S:3 * S].view(np.float32),
            "mask": host[:, 3 * S:4 * S].astype(np.float32),
            "cl": host[:, 4 * S],
            "done": host[:, 4 * S + 1].astype(bool),
            "resp": host[:, 4 * S + 2],
        }

    def push_params(self, params: Mapping[str, torch.Tensor], learner_step: Optional[int] = None,
                    quantize: Optional[str] = None) -> int:
        """Publish fresh params AND flush the prefix cache: cached K/V was
        computed under the previous generation.  Live lanes keep their
        shared pages (their own refs) until harvest."""
        gen = super().push_params(params, learner_step, quantize)
        if self._prefix_cache is not None:
            self._prefix_cache.flush()
        return gen

    def _ensure_pages(self) -> None:
        """Pre-extend each live lane's pages to cover the in-flight decode
        horizon (within the lane's reservation, so it never fails).  With K
        macros in flight the host's ``context_len`` is stale by up to K-1
        macros, so the horizon covers those plus the one about to go.  In
        spec mode (synchronous) it is one verify pass's worst case: the
        bonus token plus k accepted drafts."""
        if self._spec_k:
            steps = self._spec_k + 1
        else:
            steps = self.config.steps_per_macro * (len(self._inflight) + 1)
        for lane_id, lane in enumerate(self._lanes):
            if not lane.busy:
                continue
            horizon = min(lane.context_len + steps, lane.prompt_len + self._response_budget)
            need = min(self.allocator.pages_for_tokens(horizon), lane.reserved)
            delta = need - len(lane.pages)
            if delta > 0:
                new_pages = self.allocator.alloc(delta, holder=f"lane[{lane_id}]")
                start = len(lane.pages)
                lane.pages.extend(new_pages)
                self._table[lane_id, start:start + len(new_pages)] = new_pages

    def step(self) -> List[CompletedSequence]:
        """One engine cycle: admit -> dispatch the next macro step (ONE
        upload) -> read the OLDEST in-flight macro once ``steps_in_flight``
        are pending (ONE batched read) -> harvest.  Returns the sequences
        that completed in the macro steps read this cycle.

        With ``spec_k > 0`` the cycle is the draft -> verify -> rewind loop
        (:meth:`_spec_step`): the same admission, harvest and
        one-upload-one-read discipline, synchronous by construction."""
        if self._spec_k:
            return self._spec_step()
        t_step0 = time.monotonic()
        self._admit()
        dispatched = False
        occ = 0.0
        if self.live_lanes > 0:
            self._ensure_pages()
            params, gen = self._snapshot_params()
            occ = self.live_lanes / self.config.lanes
            self._occupancy_gauge.set(occ)
            self._occupancy_sum += occ
            guard = steady_state_guard() if self._warm and self._sync_guard else nullcontext()
            with guard, torch.no_grad():
                # ONE batched host->device upload per macro step
                (table,) = _device_put((self._table,), self.device)
                outputs = self._decode_macro(params, gen, table)
            self._inflight.append((self.macro_steps, outputs))
            self.macro_steps += 1
            self._warm = True
            dispatched = True
        completions: List[CompletedSequence] = []
        # read the oldest in-flight macro once K are pending; with nothing
        # dispatched this cycle, drain
        while self._inflight and (len(self._inflight) >= self.config.steps_in_flight
                                  or not dispatched):
            macro_idx, outputs = self._inflight.popleft()
            guard = steady_state_guard() if self._warm and self._sync_guard else nullcontext()
            with guard:
                host = _device_get(outputs)  # ONE batched device->host read
            completions.extend(self._harvest(self._unpack(host), macro_idx))
            if dispatched:
                break  # steady state: exactly one read per step
        if tracing.sampling_enabled():
            # one head-sampled span per macro step, host monotonic stamps
            tracing.record_span(
                "genrl.macro_step", None, t_step0, time.monotonic(),
                kind="genrl", completed=len(completions), live_lanes=self.live_lanes,
                occupancy=round(occ, 4), in_flight=len(self._inflight),
            )
        return completions

    # -- speculative decoding ----------------------------------------------
    def _verify_draws(self, samp0: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One verify pass's random draws from the engine's generator: the
        bonus token from ``samp0`` (the adjusted carried logits, the banned
        token masked) and, at temperature > 0, the accept test's
        ``[lanes, k]`` uniforms in ``[1e-20, 1)``.  A seam: tests inject
        JAX's draws here."""
        cfg = self.config
        t0 = sample_tokens(self._generator, samp0, cfg.temperature)
        if cfg.temperature == 0.0:
            return t0, None
        u = torch.rand((cfg.lanes, k), generator=self._generator, device=self.device)
        return t0, u.clamp_(min=1e-20)

    def _verify(self, params, gen: int, k: int, drafts: torch.Tensor, draft_len: torch.Tensor,
                page_ids: torch.Tensor, offsets: torch.Tensor, table: torch.Tensor,
                banned: torch.Tensor) -> torch.Tensor:
        """One verify pass at draft width ``k`` (a ladder bucket): sample
        the bonus token ``t0`` from the carried logits, run ONE forward
        over ``[t0, d1..dk]`` at positions ``cl..cl+k`` through the
        shared-table tail path (slot j's output is the distribution for
        position ``cl+j+1``), accept the longest draft prefix, and carry
        the state at the LAST ACCEPTED slot, whose output is the
        distribution for the token at the new cursor.  K/V written for
        rejected slots lies past the cursor: never attended (the tail path
        masks ``pos <= qpos``) and overwritten by the next pass.

        At temperature > 0, draft ``d_j`` is accepted with probability
        ``pi_j(d_j)``; a rejected draft must be replaced from the residual
        ``pi(x) / (1 - pi(d))`` over ``x != d``, which is the next pass's
        bonus draw with ``d`` masked out (the ``banned`` carry).  The stored
        behaviour logp always comes from the unmasked distribution.  At
        temperature 0 both rules collapse to argmax equality and nothing is
        banned.  Returns the packed int32 ``[L, 4(k+1) + 4]`` outputs
        (tokens, logp bits, value bits, mask, then cursor, done, response
        count and banned token)."""
        cfg = self.config
        L, T, V = cfg.lanes, k + 1, cfg.vocab_size
        dev = self.device
        greedy = cfg.temperature == 0.0
        pad = max(cfg.eos_token, cfg.pad_token)
        logits_st, value_st = self._logits_st[:L], self._value_st[:L]
        cl, done, resp = self._cl[:L], self._done[:L], self._resp[:L]
        rows = torch.arange(L, device=dev)
        alive = ~done
        adj0 = adjust_logits(logits_st, cfg.temperature, cfg.top_k, V)
        if greedy:
            samp0 = adj0
        else:
            ban_pen = torch.zeros(L, V, dtype=torch.float32, device=dev)
            ban_pen.index_put_((rows, banned.clamp(0, V - 1).long()),
                               torch.where(banned >= 0, -1e9, 0.0))
            samp0 = adj0 + ban_pen
        t0, u = self._verify_draws(samp0, k)
        logp0 = token_logp(adj0, t0)
        X = torch.cat([t0.to(torch.int32)[:, None], drafts], dim=1)
        positions = (cl[:, None] + torch.arange(T, device=dev)[None, :]).clamp(
            0, self.model.max_len - 1)
        out, _ = self._run(params, gen, X, positions=positions, paged_cache=self._pools,
                           page_ids=page_ids, page_offsets=offsets, page_table=table,
                           prefix_starts=cl)
        o_logits, o_value = out.policy_logits, out.baseline  # [L, T, V], [L, T]
        adj = adjust_logits(o_logits.reshape(L * T, V), cfg.temperature, cfg.top_k,
                            V).reshape(L, T, V)
        # the accept test of draft j, against the distribution after slot
        # j - 1, gated on the host's draft length and on no EOS emitted
        # earlier in the pass
        prev = adj[:, :k]
        logp_d = torch.log_softmax(prev, dim=-1).gather(-1, drafts.long()[:, :, None])[:, :, 0]
        if greedy:
            accept = drafts == prev.argmax(dim=-1)
        else:
            accept = torch.log(u) < logp_d
        valid = torch.arange(1, k + 1, device=dev)[None, :] <= draft_len[:, None]
        ok = accept & valid
        if cfg.eos_token >= 0:
            ok = ok & (X[:, :k] != cfg.eos_token)
        a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)  # accepted drafts, [0, k]
        # the emitted stream: t0 and the accepted prefix, in the decode
        # macro's output layout (a prefix-contiguous mask)
        slot = torch.arange(T, device=dev)[None, :]
        mask = (slot <= a[:, None]) & alive[:, None]
        emit = torch.where(mask, X, pad)
        logps = torch.cat([logp0[:, None], logp_d], dim=1)
        values = torch.cat([value_st[:, None], o_value[:, :k]], dim=1)
        n_emit = ((1 + a) * alive.to(a.dtype)).to(torch.int32)
        resp2 = resp + n_emit
        cl2 = cl + n_emit
        last_tok = X.gather(1, a.long()[:, None])[:, 0]
        finished = resp2 >= self._response_budget
        if cfg.eos_token >= 0:
            finished = finished | (last_tok == cfg.eos_token)
        done2 = done | (alive & finished)
        new_logits = o_logits[rows, a.long()]
        new_value = o_value[rows, a.long()]
        if greedy or k == 0:
            banned2 = torch.full((L,), -1, dtype=torch.int32, device=dev)
        else:
            # ban only on a genuine accept-test rejection (not draft or
            # budget exhaustion) of a lane that is still live
            j1 = a.clamp(0, k - 1).long()[:, None]
            hit = accept.gather(1, j1)[:, 0]
            d1 = drafts.gather(1, j1)[:, 0]
            rej = (a < k) & valid.gather(1, j1)[:, 0] & ~hit & alive & ~done2
            if cfg.eos_token >= 0:
                rej = rej & (X[:, :k] != cfg.eos_token).gather(1, j1)[:, 0]
            banned2 = torch.where(rej, d1, -1).to(torch.int32)
        # pack before the state write-back: values[:, 0] reads the lane state
        packed = torch.cat([
            emit.to(torch.int32), as_int32(logps), as_int32(values), mask.to(torch.int32),
            cl2[:, None], done2[:, None].to(torch.int32), resp2[:, None], banned2[:, None],
        ], dim=1)
        self._logits_st[:L].copy_(torch.where(alive[:, None], new_logits, logits_st))
        self._value_st[:L].copy_(torch.where(alive, new_value, value_st))
        self._cl[:L].copy_(cl2)
        self._done[:L].copy_(done2)
        self._resp[:L].copy_(resp2)
        return packed

    @staticmethod
    def _unpack_verify(host: np.ndarray, T: int) -> Dict[str, np.ndarray]:
        return {
            "tokens": host[:, :T],
            "logp": host[:, T:2 * T].view(np.float32),
            "value": host[:, 2 * T:3 * T].view(np.float32),
            "mask": host[:, 3 * T:4 * T].astype(np.float32),
            "cl": host[:, 4 * T],
            "done": host[:, 4 * T + 1].astype(bool),
            "resp": host[:, 4 * T + 2],
            "banned": host[:, 4 * T + 3],
        }

    def _spec_step(self) -> List[CompletedSequence]:
        """One speculative cycle: admit -> draft (host n-gram lookups) ->
        ONE batched upload + the verify pass -> ONE batched read -> feed
        the drafter, harvest, and rewind the page cursor of every rejected
        tail."""
        t_step0 = time.monotonic()
        self._admit()
        completions: List[CompletedSequence] = []
        occ = 0.0
        draft_s = verify_s = 0.0
        if self.live_lanes > 0:
            self._ensure_pages()
            params, gen = self._snapshot_params()
            occ = self.live_lanes / self.config.lanes
            self._occupancy_gauge.set(occ)
            self._occupancy_sum += occ
            cfg = self.config
            ps, k, L = cfg.page_size, self._spec_k, cfg.lanes
            # -- draft: per-lane proposals and page routing, host numpy
            t_draft0 = time.monotonic()
            drafts = np.zeros((L, k), np.int32)
            draft_len = np.zeros((L,), np.int32)
            busy = np.zeros((L,), bool)
            cl_host = np.zeros((L,), np.int64)
            proposed = 0
            for lane_id, lane in enumerate(self._lanes):
                if not lane.busy:
                    continue
                busy[lane_id] = True
                cl_host[lane_id] = lane.context_len
                # the bonus token always fits; drafts are clamped so the
                # whole accepted run stays within the response budget
                room = lane.prompt_len + self._response_budget - lane.context_len - 1
                if room > 0:
                    d = self._drafter.propose(lane_id)
                    if d is not None:
                        dl = min(len(d), room, k)
                        if dl:
                            drafts[lane_id, :dl] = d[:dl]
                            draft_len[lane_id] = dl
                            proposed += dl
            # the smallest ladder width that fits the pass's longest draft
            kb = next(b for b in self._spec_buckets if b >= int(draft_len.max()))
            T = kb + 1
            drafts = drafts[:, :kb]
            # slot j writes K/V at flat position cl + j; slots past the
            # draft length (and dead lanes) route to the null page
            slot = np.arange(T)
            gpos = cl_host[:, None] + slot[None, :]
            page_idx = np.minimum(gpos // ps, self._table.shape[1] - 1)
            writable = (slot[None, :] <= draft_len[:, None]) & busy[:, None]
            page_ids = np.where(writable, self._table[np.arange(L)[:, None], page_idx],
                                0).astype(np.int32)
            offsets = np.where(writable, gpos % ps, 0).astype(np.int32)
            draft_s = time.monotonic() - t_draft0
            # -- verify: ONE batched upload, one pass, ONE batched read
            t_verify0 = time.monotonic()
            guard = steady_state_guard() if self._warm and self._sync_guard else nullcontext()
            with guard, torch.no_grad():
                up = _device_put((drafts, draft_len, page_ids, offsets, self._table,
                                  self._banned), self.device)
                packed = self._verify(params, gen, kb, *up)
                host = self._unpack_verify(_device_get(packed), T)
            verify_s = time.monotonic() - t_verify0
            macro_idx = self.macro_steps
            self.macro_steps += 1
            self._warm = True
            self._banned = np.array(host["banned"], np.int32)
            # -- drafter upkeep from the outputs already read: live lanes
            # learn their emitted tokens, finished lanes drop their tables
            mask, tokens, done = host["mask"], host["tokens"], host["done"]
            accepted = 0
            for lane_id, lane in enumerate(self._lanes):
                if not lane.busy:
                    continue
                count = int(mask[lane_id].sum())
                accepted += max(count - 1, 0)
                self._drafter.observe(lane_id, int(draft_len[lane_id]), max(count - 1, 0))
                if count:
                    self._drafter.extend(lane_id, tokens[lane_id, :count])
                if done[lane_id]:
                    self._drafter.release(lane_id)
            completions = self._harvest(host, macro_idx)
            # -- page-cursor rewind: every live lane frees the whole pages
            # past its new cursor (refcount decrements only, so CoW-shared
            # pages another holder needs are untouched)
            freed = 0
            for lane_id, lane in enumerate(self._lanes):
                if not lane.busy:
                    continue
                keep = self.allocator.pages_for_tokens(lane.context_len)
                n = rewind_pages(self.allocator, lane.pages, keep, holder=f"lane[{lane_id}]")
                if n:
                    self._table[lane_id, keep:keep + n] = 0
                    freed += n
            self.spec_proposed_total += proposed
            self.spec_accepted_total += accepted
            self.spec_rollback_pages_total += freed
            self._spec_draft_s += draft_s
            self._spec_verify_s += verify_s
            if proposed:
                self._spec_proposed_counter.inc(proposed)
            if accepted:
                self._spec_accepted_counter.inc(accepted)
            if freed:
                self._spec_rollback_counter.inc(freed)
            self._spec_accept_gauge.set(self.spec_acceptance_rate)
        if tracing.sampling_enabled():
            # one head-sampled span per pass with draft and verify children
            t_end = time.monotonic()
            ctx = tracing.record_span(
                "genrl.macro_step", None, t_step0, t_end, kind="genrl-spec",
                completed=len(completions), live_lanes=self.live_lanes,
                occupancy=round(occ, 4), acceptance_rate=round(self.spec_acceptance_rate, 4),
            )
            if draft_s or verify_s:
                tracing.record_span("seq.draft", ctx, t_step0, t_step0 + draft_s,
                                    kind="genrl-spec")
                tracing.record_span("seq.verify", ctx, t_step0 + draft_s,
                                    t_step0 + draft_s + verify_s, kind="genrl-spec")
        return completions

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verify pass accepted."""
        return self.spec_accepted_total / max(self.spec_proposed_total, 1)

    def spec_timers(self) -> Optional[Tuple[float, float]]:
        """Cumulative host ``(draft_s, verify_s)`` over all spec passes, or
        None with speculation off (the disaggregated host's seq.draft and
        seq.verify trace edges are deltas of this)."""
        if not self._spec_k:
            return None
        return (self._spec_draft_s, self._spec_verify_s)

    def stats(self) -> Dict[str, Any]:
        """Engine-lifetime counters from host state (no transfer)."""
        return {
            "macro_steps": self.macro_steps,
            "completed": self.completed_total,
            "live_lanes": self.live_lanes,
            "mean_occupancy": self.mean_occupancy,
            "prefill_tokens": self.prefill_tokens,
            "prefix_saved_ratio": self.prefix_saved_ratio,
            "spec_k": self._spec_k,
            "spec_proposed": self.spec_proposed_total,
            "spec_accepted": self.spec_accepted_total,
            "spec_rollback_pages": self.spec_rollback_pages_total,
            "spec_acceptance_rate": self.spec_acceptance_rate,
            "spec_draft_s": self._spec_draft_s,
            "spec_verify_s": self._spec_verify_s,
        }

    def _harvest(self, host: Dict[str, np.ndarray], macro_idx: int) -> List[CompletedSequence]:
        mask, tokens = host["mask"], host["tokens"]
        logp, value = host["logp"], host["value"]
        done, cl = host["done"], host["cl"]
        finish = time.monotonic()
        completions: List[CompletedSequence] = []
        decode_tokens = 0
        for lane_id, lane in enumerate(self._lanes):
            if not lane.busy:
                continue
            if lane.admit_macro > macro_idx:
                # this read predates the lane's current occupancy (the id
                # was recycled while the macro was in flight)
                continue
            count = int(mask[lane_id].sum())
            decode_tokens += count
            if count > 0:
                lane.tokens.append(tokens[lane_id, :count].copy())
                lane.logps.append(logp[lane_id, :count].copy())
                lane.values.append(value[lane_id, :count].copy())
            lane.context_len = int(cl[lane_id])
            if done[lane_id]:
                completions.append(CompletedSequence(
                    prompt=lane.prompt,
                    prompt_len=lane.prompt_len,
                    response_tokens=(np.concatenate(lane.tokens) if lane.tokens
                                     else np.zeros((0,), np.int32)),
                    behavior_logp=(np.concatenate(lane.logps) if lane.logps
                                   else np.zeros((0,), np.float32)),
                    values=(np.concatenate(lane.values) if lane.values
                            else np.zeros((0,), np.float32)),
                    generation=lane.generation,
                    submit_time=lane.submit_time,
                    admit_time=lane.admit_time,
                    finish_time=finish,
                    tag=lane.tag,
                ))
                # release the lane: shared prefix pages drop one ref, owned
                # pages go back to the free list at once
                self.allocator.free(lane.pages, holder=f"lane[{lane_id}]")
                self.allocator.release(lane.reserved)
                self._table[lane_id] = 0
                self._lanes[lane_id] = _Lane()
        self._decode_meter.mark(decode_tokens)
        self.completed_total += len(completions)
        if completions:
            self._completed_counter.inc(len(completions))
        return completions

    @property
    def mean_occupancy(self) -> float:
        """Mean live-lane fraction over all dispatched macro steps."""
        return self._occupancy_sum / max(self.macro_steps, 1)

    def run_until(self, n_completions: int, max_macro_steps: int = 10_000
                  ) -> List[CompletedSequence]:
        """Drive macro steps until ``n_completions`` sequences finished."""
        out: List[CompletedSequence] = []
        for _ in range(max_macro_steps):
            if len(out) >= n_completions:
                return out
            if self.live_lanes == 0 and self.pending == 0 and not self._inflight:
                raise RuntimeError(
                    f"engine drained at {len(out)}/{n_completions} completions "
                    "(no live lanes, empty queue)"
                )
            out.extend(self.step())
        raise RuntimeError(f"run_until({n_completions}) exceeded {max_macro_steps} macro-steps")
