"""Batched KV-cached generation, one fixed cohort at a time.

Port of ``scalerl_tpu/genrl/engine.py``.  One round covers the whole
cohort: prefill over the left-padded prompt batch into a dense
``KVCache``, then single-token decode steps with temperature/top-k
sampling.  The host uploads once and reads back once per round:

- **bucketed shapes** — prompt lengths pad up a power-of-two ladder and
  prompts are LEFT-padded inside the bucket, so every lane's decode cursor
  is the same Python int;
- **one batched host transfer each way** — :func:`_device_put` packs the
  round's int32 inputs into one pinned buffer and copies it without
  blocking the host; the outputs come back packed in one int32 tensor
  through one :func:`_device_get`.  After a bucket pair's first round the
  round runs under ``steady_state_guard()`` (the card raises on any other
  host synchronisation);
- **generation-tagged parameters** — :meth:`push_params` publishes a
  device-side copy with a monotonic generation bump; each result carries
  the generation that produced it.

The JAX engine compiles each round into one program and takes an
``iter_mode`` (``lax.scan`` or an unrolled loop: the same computation).
PyTorch runs eagerly with one loop form, so the port has no ``iter_mode``
and no mesh ``dispatch_guard``.  Sampling draws from a ``torch.Generator``
on the engine's device by Gumbel-argmax, as ``jax.random.categorical``
samples, with no host sync; its stream differs from JAX's, so only
temperature 0 (argmax) is token-identical across the two packages.

The engine runs the model from the parameter snapshot: it keeps its own
copy of the module (``copy.deepcopy``) and loads the snapshot into it when
the generation changes; the caller's module is never modified.

On a mesh (``shard_ctx``, a meshed agent's ``ParallelLearnFn.shard_ctx``)
the snapshot is the rank's local shards: every forward runs on them
(``parallel/shard_compute.py::on_shards``), a block under ``mp`` on the
rank's own heads, and the cache holds those ``num_heads / mp`` heads.  The
policy head's output is gathered, so the logits, the draws from the
identically seeded generator and the tokens are the same on every rank
that holds the model with this one (``shard_compute.model_axis``); those
ranks call the engine in lockstep.
"""

from __future__ import annotations

import copy
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from scalerl_torch.models.transformer import (
    TransformerPolicy,
    decode_attention_mask,
    init_kv_cache,
    prefill_attention_mask,
    sequence_positions,
)
from scalerl_torch.parallel.shard_compute import local_heads, on_shards
from scalerl_torch.parallel.sharding import ShardContext
from scalerl_torch.runtime import dispatch, telemetry, tracing
from scalerl_torch.runtime.dispatch import steady_state_guard
from scalerl_torch.runtime.param_server import ParamSnapshotPlane
from scalerl_torch.utils.buckets import bucket_for, default_buckets
from scalerl_torch.utils.platform import DeviceLike, resolve_device


def _device_put(arrays: Sequence[np.ndarray], device: torch.device) -> Tuple[torch.Tensor, ...]:
    """ONE host->device copy for a group of int32 host arrays.

    The arrays are packed into one flat buffer, pinned on a card and copied
    without blocking the host (an upload from pageable memory would
    synchronise), then split into contiguous views on the device.  A module
    seam: tests count the calls here."""
    flat = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays])
    host = torch.from_numpy(flat)
    dev = host.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else host
    out, offset = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out.append(dev[offset:offset + n].view(np.shape(a)))
        offset += n
    return tuple(out)


def _device_get(packed: torch.Tensor) -> np.ndarray:
    """ONE device->host read of a packed output tensor; the only copy that
    relaxes the steady-state guard.  A module seam: tests count the calls
    here."""
    return dispatch._device_get(packed)


def adjust_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  vocab_size: int) -> torch.Tensor:
    """Top-k mask then temperature.  The behaviour logprob is computed from
    THESE logits, so it is the log-density of the sampling distribution;
    at ``temperature == 0`` (greedy) the scale is skipped."""
    if 0 < top_k < vocab_size:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if temperature > 0:
        logits = logits / temperature
    return logits


def sample_tokens(generator: torch.Generator, adj_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Categorical sample from adjusted logits by Gumbel-argmax (argmax at
    temperature 0); ``generator`` lives on the logits' device."""
    if temperature == 0:
        return adj_logits.argmax(dim=-1)
    u = torch.rand(adj_logits.shape, generator=generator, device=adj_logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (adj_logits - torch.log(-torch.log(u))).argmax(dim=-1)


def token_logp(adj_logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``log_softmax(adj)[token]`` per row."""
    return torch.log_softmax(adj_logits, dim=-1).gather(1, token[:, None])[:, 0]


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret a float32 tensor's bits as int32, to pack it beside
    int32 outputs for one read (``np.ndarray.view(np.float32)`` undoes
    it)."""
    return x.to(torch.float32).contiguous().view(torch.int32)


@dataclass
class GenerationConfig:
    """Knobs for the generation engine (the JAX package's, same defaults).

    ``eos_token < 0`` disables early stopping; with an EOS id, lanes latch
    done on sampling it and their remaining steps emit EOS with a zeroed
    alive mask.  ``temperature == 0`` selects greedy decoding.
    """

    vocab_size: int
    max_prompt_len: int = 64
    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: int = 0  # 0 = full distribution
    eos_token: int = -1
    pad_token: int = 0
    prompt_buckets: Tuple[int, ...] = ()  # () -> pow2 ladder
    response_buckets: Tuple[int, ...] = ()
    seed: int = 0

    def resolved_prompt_buckets(self) -> Tuple[int, ...]:
        return tuple(self.prompt_buckets) or default_buckets(self.max_prompt_len)

    def resolved_response_buckets(self) -> Tuple[int, ...]:
        return tuple(self.response_buckets) or default_buckets(self.max_new_tokens)

    def validate(self) -> None:
        if self.vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {self.vocab_size}")
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError(
                "max_prompt_len and max_new_tokens must be >= 1, got "
                f"{self.max_prompt_len}/{self.max_new_tokens}"
            )
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), got {self.temperature}")
        if self.top_k < 0 or self.top_k > self.vocab_size:
            raise ValueError(f"top_k must be in [0, vocab_size], got {self.top_k}")
        if self.eos_token >= self.vocab_size:
            raise ValueError(f"eos_token {self.eos_token} outside vocab {self.vocab_size}")


class GenerationResult(NamedTuple):
    """One generation round on the host (after the batched read)."""

    sequences: np.ndarray  # [B, P+R] int32 left-padded prompt + response
    response_tokens: np.ndarray  # [B, R] int32
    behavior_logp: np.ndarray  # [B, R] f32 logprob under the SAMPLING dist
    values: np.ndarray  # [B, R] f32 baseline before each sampled token
    mask: np.ndarray  # [B, R] f32 1.0 where the token is real
    response_len: np.ndarray  # [B] int32
    prompt_len: np.ndarray  # [B] int32 true (unpadded) prompt lengths
    prompt_pad: int  # the prompt bucket P
    response_pad: int  # the response bucket R
    generation: int  # param generation that produced the round

    @property
    def decode_tokens(self) -> int:
        return int(self.mask.sum())

    @property
    def prompt_tokens(self) -> int:
        return int(self.prompt_len.sum())


class _ModelRunner:
    """The engines' private copy of the model, with the parameter snapshot
    loaded into it on a generation change (a device-side copy, ordered on
    the stream after any work already enqueued).  Each param takes the
    shape of the snapshot's (a rank's shard under a mesh), and every call
    runs :func:`~scalerl_torch.parallel.shard_compute.on_shards` of
    ``shard_ctx``."""

    def __init__(self, model: TransformerPolicy, device: torch.device,
                 params: Mapping[str, torch.Tensor], paged_attn_fn=None,
                 shard_ctx: Optional[ShardContext] = None) -> None:
        net = copy.deepcopy(model).to(device)
        net.requires_grad_(False)
        for name, t in params.items():
            prefix, _, leaf = name.rpartition(".")
            owner = net.get_submodule(prefix)
            p = owner._parameters[leaf]
            if p.shape != t.shape:
                owner._parameters[leaf] = torch.nn.Parameter(
                    p.new_empty(t.shape), requires_grad=False)
        if paged_attn_fn is not None and net.paged_attn_fn is None:
            net.paged_attn_fn = paged_attn_fn
        self.net = net
        self.shard_ctx = shard_ctx
        self._bound: Optional[int] = None

    def __call__(self, params: Mapping[str, torch.Tensor], generation: int, *args, **kwargs):
        if self._bound != generation:
            self.net.load_state_dict(params)
            self._bound = generation
        with on_shards(self.shard_ctx):
            return self.net(*args, **kwargs)

    @property
    def heads(self) -> int:
        """The heads a cache of this model holds on this rank."""
        return local_heads(self.net.blocks[0], self.shard_ctx)


def check_token_model(model: TransformerPolicy, engine: str) -> None:
    if model.vocab_size is None:
        raise ValueError(
            f"{engine} needs a token-mode TransformerPolicy (vocab_size set); "
            "got a feature-embedding model"
        )


class GenerationEngine(ParamSnapshotPlane):
    """The fixed-cohort engine: generation-tagged parameter snapshots and
    one prefill + decode round per :meth:`generate`.

    ``model``: a token-mode :class:`TransformerPolicy` (``vocab_size`` set,
    ``max_len >= prompt bucket + response bucket``).  ``params``: the
    initial snapshot, a ``{name: tensor}`` state dict of that model.
    ``device``: where the engine runs (the card by default; raises without
    one).  ``sync_guard=False`` leaves out the steady-state guard, for an
    engine that shares its process with other threads' device work (the
    guard's mode is process-wide) or whose mesh syncs (gloo stages its
    collectives through host memory).  ``shard_ctx``: the mesh's
    computation on shards, ``params`` then the rank's local shards (module
    docstring).
    """

    def __init__(
        self,
        model: TransformerPolicy,
        params: Mapping[str, torch.Tensor],
        config: GenerationConfig,
        device: DeviceLike = "cuda",
        sync_guard: bool = True,
        shard_ctx: Optional[ShardContext] = None,
    ) -> None:
        config.validate()
        check_token_model(model, "GenerationEngine")
        self._sync_guard = sync_guard
        self.device = resolve_device(device)
        max_p = bucket_for(config.max_prompt_len, config.resolved_prompt_buckets())
        max_r = bucket_for(config.max_new_tokens, config.resolved_response_buckets())
        if model.max_len < max_p + max_r:
            raise ValueError(
                f"model.max_len ({model.max_len}) must cover the largest "
                f"bucket pair (prompt {max_p} + response {max_r})"
            )
        self.model = model
        self.config = config
        self._run = _ModelRunner(model, self.device, params, shard_ctx=shard_ctx)
        self._shard_ctx = shard_ctx
        self._init_param_plane(params, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._warm: set = set()
        reg = telemetry.get_registry()
        self._round_counter = reg.counter("genrl.rounds")
        self._prompt_meter = reg.meter("genrl.prompt_tokens_per_s")
        self._decode_meter = reg.meter("genrl.decode_tokens_per_s")
        reg.bind("genrl.engine", lambda: {"generation": self.generation,
                                          "warm_buckets": len(self._warm)})

    def _adjust_logits(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return adjust_logits(logits, cfg.temperature, cfg.top_k, cfg.vocab_size)

    def _round(self, params: Mapping[str, torch.Tensor], gen: int, tokens: torch.Tensor,
               lengths: torch.Tensor, P: int, R: int) -> torch.Tensor:
        """Prefill + R decode steps on the device -> one packed int32
        ``[B, 4R + 1]`` tensor (tokens, logp bits, value bits, alive,
        response length)."""
        model, cfg = self.model, self.config
        B = tokens.shape[0]
        S = P + R
        cache = init_kv_cache(B, S, model.num_layers, self._run.heads, model.head_dim,
                              device=self.device)
        ppos = sequence_positions(lengths, P, S)[:, :P]
        pmask = prefill_attention_mask(lengths, P, S)
        out, cache = self._run(params, gen, tokens, positions=ppos, kv_cache=cache,
                               cache_index=0, attn_mask=pmask)
        logits, value = out.policy_logits[:, -1], out.baseline[:, -1]
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        toks, logps, values, alive = [], [], [], []
        for t in range(R):
            adj = self._adjust_logits(logits)
            token = sample_tokens(self._generator, adj, cfg.temperature)
            logp = token_logp(adj, token)
            # a token is real if its lane had not finished BEFORE this step
            # (the step that samples EOS still emits a real token)
            a = ~done
            if cfg.eos_token >= 0:
                token = torch.where(done, cfg.eos_token, token)
                done = done | (token == cfg.eos_token)
            toks.append(token)
            logps.append(logp)
            values.append(value)
            alive.append(a)
            if t == R - 1:
                break  # the last step's forward would feed nothing
            # feed the sampled token back through the cached model
            out, cache = self._run(
                params, gen, token[:, None], positions=(lengths + t)[:, None],
                kv_cache=cache, cache_index=P + t,
                attn_mask=decode_attention_mask(lengths, P, t, S),
            )
            logits, value = out.policy_logits[:, 0], out.baseline[:, 0]
        alive_t = torch.stack(alive, dim=1).to(torch.int32)
        return torch.cat([
            torch.stack(toks, dim=1).to(torch.int32),
            as_int32(torch.stack(logps, dim=1)),
            as_int32(torch.stack(values, dim=1)),
            alive_t,
            alive_t.sum(dim=1, keepdim=True, dtype=torch.int32),
        ], dim=1)

    def _align_prompts(self, prompts: np.ndarray, lengths: np.ndarray, P: int) -> np.ndarray:
        """Right-align (left-pad) host prompts into the ``[B, P]`` bucket."""
        B = prompts.shape[0]
        out = np.full((B, P), self.config.pad_token, np.int32)
        for b in range(B):
            n = int(lengths[b])
            out[b, P - n:] = prompts[b, :n]
        return out

    def generate(
        self,
        prompts: np.ndarray,
        prompt_lengths: Optional[np.ndarray] = None,
        max_new_tokens: Optional[int] = None,
        prompt_bucket: Optional[int] = None,
    ) -> GenerationResult:
        """Run one generation round; returns host numpy results.

        ``prompts``: ``[B, L]`` int32, right-padded (row ``b`` real for its
        first ``prompt_lengths[b]`` columns).  ``prompt_bucket``: the prompt
        bucket to pad into, where it is not the longest prompt's (a
        data-parallel trainer passes its whole round's, so every group's
        share lands in one bucket pair).  One upload, one round on the
        device, one batched read (under ``steady_state_guard()`` once the
        bucket pair is warm)."""
        t_round0 = time.monotonic()
        prompts = np.asarray(prompts, np.int32)
        B, L = prompts.shape
        if prompt_lengths is None:
            prompt_lengths = np.full(B, L, np.int32)
        prompt_lengths = np.asarray(prompt_lengths, np.int32)
        if prompt_lengths.max(initial=1) > self.config.max_prompt_len:
            raise ValueError(
                f"prompt length {int(prompt_lengths.max())} exceeds "
                f"max_prompt_len={self.config.max_prompt_len}"
            )
        P = bucket_for(int(prompt_lengths.max(initial=1)), self.config.resolved_prompt_buckets())
        if prompt_bucket is not None:
            if prompt_bucket < P:
                raise ValueError(f"prompt_bucket {prompt_bucket} is below the longest "
                                 f"prompt's bucket {P}")
            P = prompt_bucket
        R = bucket_for(int(max_new_tokens or self.config.max_new_tokens),
                       self.config.resolved_response_buckets())
        aligned = self._align_prompts(prompts, prompt_lengths, P)
        params, gen = self._snapshot_params()
        guard = (steady_state_guard() if (P, R) in self._warm and self._sync_guard
                 else nullcontext())
        with guard, torch.no_grad():
            # ONE batched host->device upload per round ...
            tokens, lengths = _device_put((aligned, prompt_lengths), self.device)
            packed = self._round(params, gen, tokens, lengths, P, R)
            # ... and ONE batched device->host read
            host = _device_get(packed)
        self._warm.add((P, R))
        toks = host[:, :R].copy()
        result = GenerationResult(
            sequences=np.concatenate([aligned, toks], axis=1),
            response_tokens=toks,
            behavior_logp=host[:, R:2 * R].view(np.float32).copy(),
            values=host[:, 2 * R:3 * R].view(np.float32).copy(),
            mask=host[:, 3 * R:4 * R].astype(np.float32),
            response_len=host[:, 4 * R].copy(),
            prompt_len=prompt_lengths,
            prompt_pad=P,
            response_pad=R,
            generation=gen,
        )
        self._round_counter.inc()
        self._prompt_meter.mark(result.prompt_tokens)
        self._decode_meter.mark(result.decode_tokens)
        if tracing.sampling_enabled():
            # one head-sampled span per round, host monotonic stamps only
            tracing.record_span(
                "genrl.generate_round", None, t_round0, time.monotonic(),
                kind="genrl", batch=B, prompt_pad=P, response_pad=R,
                decode_tokens=int(result.decode_tokens), generation=gen,
            )
        return result
