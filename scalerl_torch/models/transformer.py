"""Decoder-only transformer policy: port of ``scalerl_tpu/models/transformer.py``.

A causal transformer actor-critic over ``[B, T]`` token ids (token mode,
``vocab_size`` set: the sequence-RL plane) or ``[B, T, obs_dim]`` features,
producing per-step policy logits and a baseline.  The Flax module's
numerics are kept: LayerNorm without bias at eps 1e-6, tanh-form GELU,
``qkv`` split on the last axis into q, k, v, masked scores at -1e30 in
float32, fully masked rows uniform.  ``convert.py::transformer_to_torch``
loads a Flax param tree.

``dtype``/``param_dtype`` are the Flax module's mixed precision: the
embeddings and the blocks' dense layers store their params in
``param_dtype`` and compute in ``dtype``; the blocks' LayerNorm scales stay
float32 (Flax's LayerNorm keeps its own float32 ``param_dtype``), take
their statistics in float32 and round once to ``dtype``; ``final_norm`` and
the two heads stay float32 in params and compute.

The forward has the JAX module's paths, chosen by its arguments:

- full causal, through :func:`~scalerl_torch.ops.attention.full_attention`
  or, with ``use_flash``, the CUDA flash kernels
  (``ops/cuda_flash_attention.py``), or through ``attn_fn`` when the model
  has one (ring attention under ``parallel/sequence.py``); or masked under
  ``attn_mask`` ``[B, T, T]``;
- packed rows (``segment_ids``): through ``segment_attn_fn`` in every
  block when the model has one (the CUDA segment flash kernels,
  ``ops/cuda_segment_attention.py``), else the dense
  :func:`packed_attention_mask` on the masked path;
- dense ``KVCache`` prefill and decode (the cohort engine);
- paged (``paged_cache``): local prefill, decode through ``paged_attn_fn``
  (the CUDA paged kernel in the continuous engine), and the shared-table
  tail prefill over a cached prefix.

Cache writes are IN PLACE: the dense cache by slice assignment, the paged
pools by ``index_copy_`` on their flat ``[N * ps, H, D]`` view, where the
JAX module returns new arrays (its engines donate the old ones).  The
returned caches are the same tensors.  Several pad or dead-lane writes
may land on the null page 0, slot 0 in one call; which one wins does not
matter, because page 0 is never read (every read is masked by a lane's
true length).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scalerl_torch.models.atari import lecun_normal_
from scalerl_torch.ops.attention import full_attention
from scalerl_torch.ops.cuda_flash_attention import flash_attention
from scalerl_torch.ops.paged_attention import NEG_BIG, paged_attention_reference
from scalerl_torch.utils.platform import DeviceLike, resolve_device


class TransformerOutput(NamedTuple):
    policy_logits: torch.Tensor  # [B, T, num_actions]
    baseline: torch.Tensor  # [B, T]


class KVCache(NamedTuple):
    """Per-layer ``[B, S, H, D]`` keys and values for incremental decoding
    (``S`` = prompt bucket + response bucket)."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


class PagedKVCache(NamedTuple):
    """Per-layer ``[num_pages, page_size, H, D]`` pools shared by every
    lane; page 0 is the never-read null page."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


def init_kv_cache(batch: int, total_len: int, num_layers: int, num_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda") -> KVCache:
    device = resolve_device(device)
    shape = (batch, total_len, num_heads, head_dim)
    return KVCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)),
    )


def init_paged_kv_cache(num_pages: int, page_size: int, num_layers: int, num_heads: int,
                        head_dim: int, dtype: torch.dtype = torch.float32,
                        device: DeviceLike = "cuda") -> PagedKVCache:
    device = resolve_device(device)
    shape = (num_pages, page_size, num_heads, head_dim)
    return PagedKVCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)),
    )


def prompt_attention_mask(lengths: torch.Tensor, total_len: int) -> torch.Tensor:
    """``[B, T, T]`` causal mask over RIGHT-padded prompts (paged prefill):
    row ``i`` sees columns ``<= i`` inside the real prefix."""
    ar = torch.arange(total_len, device=lengths.device)
    cols, rows = ar[None, None, :], ar[None, :, None]
    return (cols <= rows) & (cols < lengths[:, None, None])


def prefill_attention_mask(lengths: torch.Tensor, prompt_pad: int, total_len: int) -> torch.Tensor:
    """``[B, P, S]`` mask for the prefill over LEFT-padded prompts: row
    ``r`` sees the real prompt causally, never the pad prefix or the
    response region."""
    cols = torch.arange(total_len, device=lengths.device)[None, None, :]
    rows = torch.arange(prompt_pad, device=lengths.device)[None, :, None]
    pad = (prompt_pad - lengths)[:, None, None]
    return (cols >= pad) & (cols <= rows)


def decode_attention_mask(lengths: torch.Tensor, prompt_pad: int, step: int,
                          total_len: int) -> torch.Tensor:
    """``[B, 1, S]`` mask for decode step ``step``: the real prompt plus
    every response token written so far, including this step's."""
    cols = torch.arange(total_len, device=lengths.device)[None, None, :]
    pad = (prompt_pad - lengths)[:, None, None]
    return (cols >= pad) & (cols <= prompt_pad + step)


def sequence_attention_mask(lengths: torch.Tensor, prompt_pad: int, total_len: int) -> torch.Tensor:
    """``[B, S, S]`` causal mask over a whole left-padded sequence (the
    learner's forward), pad-prefix columns excluded."""
    ar = torch.arange(total_len, device=lengths.device)
    cols, rows = ar[None, None, :], ar[None, :, None]
    pad = (prompt_pad - lengths)[:, None, None]
    return (cols >= pad) & (cols <= rows)


def sequence_positions(lengths: torch.Tensor, prompt_pad: int, total_len: int) -> torch.Tensor:
    """``[B, S]`` position ids for left-padded sequences: the first real
    token is position 0; pad positions clamp to 0."""
    pad = (prompt_pad - lengths)[:, None]
    ar = torch.arange(total_len, device=lengths.device)[None, :]
    return (ar - pad).clamp(0, total_len - 1)


def packed_attention_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S, S]`` segment-blocked causal mask over PACKED rows: token
    ``i`` sees ``j <= i`` iff both carry the same nonzero segment id."""
    seg = segment_ids.to(torch.int32)
    S = seg.shape[1]
    ar = torch.arange(S, device=seg.device)
    causal = ar[None, :, None] >= ar[None, None, :]
    return causal & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """q ``[B, T, H, D]`` against k/v ``[B, S, H, D]`` under ``mask``
    ``[B, T, S]`` (True = attend).  Scores and softmax in float32; fully
    masked rows come out uniform, never NaN."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, :, :], NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(out_dtype)


class _LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(use_bias=False, dtype=dtype)``: eps 1e-6, a
    float32 scale, statistics and normalisation in float32, one rounding
    to ``dtype`` at the end."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(d_model, eps=1e-6, bias=False)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), None,
                            self.eps).to(self.out_dtype)


class _Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype`` at the call (no-ops when the params are stored in it)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class TransformerBlock(nn.Module):
    """Pre-norm block: ``x + proj(attn(LN(x)))``, then ``x + MLP(LN(x))``
    (Flax ``_Block``; children named as its params, ``LayerNorm_0`` ->
    ``ln_0`` and ``LayerNorm_1`` -> ``ln_1``), computing in ``dtype``."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False) -> None:
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.ln_0 = _LayerNorm(d_model, dtype)
        self.qkv = _Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        self.proj = _Dense(d_model, d_model, bias=False, dtype=dtype)
        self.ln_1 = _LayerNorm(d_model, dtype)
        self.mlp_in = _Dense(d_model, mlp_ratio * d_model, dtype=dtype)
        self.mlp_out = _Dense(mlp_ratio * d_model, d_model, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        paged_attn_fn: Optional[Callable] = None,
        segment_attn_fn: Optional[Callable] = None,
        segment_ids: Optional[torch.Tensor] = None,
        layer_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        attn_mask: Optional[torch.Tensor] = None,
        paged_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        page_ids: Optional[torch.Tensor] = None,
        page_offsets: Optional[torch.Tensor] = None,
        page_table: Optional[torch.Tensor] = None,
        attn_lengths: Optional[torch.Tensor] = None,
        prefix_starts: Optional[torch.Tensor] = None,
        attn_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Returns the block's output; cache arguments are written in place
        (see :class:`TransformerPolicy`).  ``attn_fn`` replaces the plain
        causal attention (and the flash kernels) on the unmasked path."""
        from scalerl_torch.parallel.shard_compute import head_parallel

        B, T, _ = x.shape
        H = self.num_heads
        D = self.d_model // H
        dtype = x.dtype
        h = self.ln_0(x)
        # inside a learn step on shards over mp: this rank's heads only
        hp = head_parallel(self)
        if hp is None:
            q, k, v = self.qkv(h).split(self.d_model, dim=-1)
        else:
            H //= hp.size
            q, k, v = hp.column(self.qkv, h, self.qkv.compute_dtype).split(H * D, dim=-1)
        q, k, v = q.reshape(B, T, H, D), k.reshape(B, T, H, D), v.reshape(B, T, H, D)
        if paged_cache is not None:
            kp, vp = paged_cache
            N, ps = kp.shape[0], kp.shape[1]
            flat_idx = (page_ids.long() * ps + page_offsets.long()).reshape(B * T)
            kflat = kp.view(N * ps, H, D)
            vflat = vp.view(N * ps, H, D)
            # in place; pad and dead-lane rows all land on page 0 slot 0
            # (never read), so the winner among them does not matter
            kflat.index_copy_(0, flat_idx, k.reshape(B * T, H, D).to(kp.dtype))
            vflat.index_copy_(0, flat_idx, v.reshape(B * T, H, D).to(vp.dtype))
            if page_table is not None and prefix_starts is not None:
                # shared-table tail prefill: gather the whole context (the
                # cached prefix pages and the tail just written) through
                # the table, attend causally from the start; no kernel
                M = page_table.shape[1]
                pages = page_table.long().clamp(0, N - 1)
                gidx = (pages[:, :, None] * ps
                        + torch.arange(ps, device=x.device)[None, None, :]).reshape(B, M * ps)
                pos = torch.arange(M * ps, device=x.device)[None, None, :]
                qpos = (prefix_starts[:, None]
                        + torch.arange(T, device=x.device)[None, :])[:, :, None]
                out = _masked_attention(q, kflat[gidx], vflat[gidx], pos <= qpos, dtype)
            elif page_table is not None:
                paged_attn = paged_attn_fn or paged_attention_reference
                out = paged_attn(q.contiguous(), kp, vp, page_table, attn_lengths).to(dtype)
            else:
                out = _masked_attention(q, k, v, attn_mask, dtype)
        elif layer_cache is not None:
            ck, cv = layer_cache
            ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
            out = _masked_attention(q, ck, cv, attn_mask, dtype)
        elif segment_ids is not None and segment_attn_fn is not None:
            # packed rows through the flash seam: the kernels apply the
            # segment-blocked causal rule and skip cross-segment and pad
            # tiles; q, k, v go in as the strided views they are
            out = segment_attn_fn(q, k, v, segment_ids).to(dtype)
        elif attn_mask is not None:
            out = _masked_attention(q, k, v, attn_mask, dtype)
        elif attn_fn is not None:
            out = attn_fn(q, k, v)
        elif self.use_flash:
            # the whole-trajectory forward through the flash kernels; q, k,
            # v go in as the strided views they are
            out = flash_attention(q, k, v, causal=True)
        else:
            out = full_attention(q, k, v, causal=True)
        if hp is None:
            x = x + self.proj(out.reshape(B, T, self.d_model))
        else:
            x = x + hp.row(self.proj, out.reshape(B, T, H * D), self.proj.compute_dtype)
        h = self.ln_1(x)
        if hp is not None and hp.mlp:
            h = hp.column(self.mlp_in, h, self.mlp_in.compute_dtype)
            h = hp.row(self.mlp_out, F.gelu(h, approximate="tanh"), self.mlp_out.compute_dtype)
        else:
            h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))
        return x + h


class TransformerPolicy(nn.Module):
    """Causal transformer actor-critic (port of the Flax
    ``TransformerPolicy``).

    Token mode (``vocab_size`` set): ``obs`` is int ``[B, T]``, embedded by
    ``token_embed``; ``num_actions`` is the vocabulary the policy head
    scores.  Feature mode needs ``obs_dim`` (Flax infers the Dense input
    width lazily; torch needs it up front).

    ``paged_attn_fn`` is the paged-decode seam
    (``ops/cuda_paged_attention.py::paged_decode_attention`` in the
    continuous engine; None = the plain reference).  ``segment_attn_fn``
    is the packed-learner seam (``ops/cuda_segment_attention.py::
    make_segment_attn_fn``; None = the dense :func:`packed_attention_mask`).
    ``use_flash=True`` routes the full causal forward of every block (no
    mask, cache or segments) through the flash kernels
    (``ops/cuda_flash_attention.py::flash_attention``), as the Flax module
    routes it through the Pallas kernel; every other path is unchanged.
    ``dtype``/``param_dtype``: see the module docstring (bfloat16 for both
    on the sharded learner plane).  ``attn_fn(q, k, v)`` replaces the
    causal attention of the unmasked full forward in every block (and
    ``use_flash`` there), as the Flax module's ``attn_fn``: it must apply
    its own causal mask (``parallel/sequence.py`` passes ring attention);
    the segment, mask, cache and paged paths take precedence over it.
    ``constrain`` is the activation-layout
    seam: when set (``parallel/logical.py::activation_constraint``, by a
    meshed agent's ``enable_mesh``), it is applied to the residual stream
    after the embedding and after every block.  It redistributes DTensor
    activations; the meshed learn step computes on local shards and keeps
    the residual stream a replicated plain tensor, which it passes through
    unchanged.  Inside that step a block under ``mp`` attends on the rank's
    own heads (``parallel/shard_compute.py::head_parallel``).
    """

    constrain: Optional[Callable] = None

    def __init__(
        self,
        num_actions: int,
        d_model: int = 128,
        num_heads: int = 4,
        num_layers: int = 2,
        mlp_ratio: int = 4,
        max_len: int = 4096,
        use_flash: bool = False,
        vocab_size: Optional[int] = None,
        obs_dim: Optional[int] = None,
        paged_attn_fn: Optional[Callable] = None,
        segment_attn_fn: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
        attn_fn: Optional[Callable] = None,
    ) -> None:
        """``generator``: a host ``torch.Generator`` for the initial weights
        (Flax's defaults: truncated LeCun-normal kernels, zero biases, unit
        norm scales, ``normal(1/sqrt(V))`` token and ``normal(0.02)``
        position tables), drawn in float32 and then rounded to
        ``param_dtype``."""
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} must divide by num_heads {num_heads}")
        if vocab_size is None and obs_dim is None:
            raise ValueError("feature mode needs obs_dim (or set vocab_size for token mode)")
        device = resolve_device(device)
        self.num_actions = num_actions
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_ratio = mlp_ratio
        self.max_len = max_len
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.paged_attn_fn = paged_attn_fn
        self.segment_attn_fn = segment_attn_fn
        self.attn_fn = attn_fn
        if vocab_size is not None:
            self.token_embed = nn.Embedding(vocab_size, d_model)
        else:
            self.obs_embed = _Dense(obs_dim, d_model, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.blocks = nn.ModuleList(
            [TransformerBlock(d_model, num_heads, mlp_ratio, dtype, use_flash)
             for _ in range(num_layers)]
        )
        self.final_norm = _LayerNorm(d_model)
        self.policy_head = nn.Linear(d_model, num_actions)
        self.value_head = nn.Linear(d_model, 1)
        self.reset_parameters(generator)  # on the host: one seed, same weights
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not self.keeps_float32(name):
                    p.data = p.data.to(param_dtype)
        self.to(device)

    @staticmethod
    def keeps_float32(name: str) -> bool:
        """Whether param ``name`` stays float32 whatever ``param_dtype`` is:
        the LayerNorm scales, ``final_norm`` and the heads, as in Flax."""
        return name.endswith(("ln_0.weight", "ln_1.weight")) or name.startswith(
            ("final_norm.", "policy_head.", "value_head."))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters():
            if name == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif name == "token_embed.weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
            elif name.endswith(("ln_0.weight", "ln_1.weight")) or name == "final_norm.weight":
                p.fill_(1.0)
            elif name.endswith(".weight"):
                lecun_normal_(p, p.shape[1], generator)
            else:
                p.zero_()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def forward(
        self,
        obs: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        cache_index: Optional[int] = None,
        attn_mask: Optional[torch.Tensor] = None,
        paged_cache: Optional[PagedKVCache] = None,
        page_ids: Optional[torch.Tensor] = None,
        page_offsets: Optional[torch.Tensor] = None,
        page_table: Optional[torch.Tensor] = None,
        attn_lengths: Optional[torch.Tensor] = None,
        prefix_starts: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ):
        """Full forward, masked forward, or a cached incremental step.

        - no cache, no mask: causal attention -> :class:`TransformerOutput`;
        - ``attn_mask`` ``[B, T, T]``: masked forward (the learner's pass
          over left-padded sequences, :func:`sequence_attention_mask`);
        - ``segment_ids`` ``[B, S]``: packed rows (callers pass per-segment
          ``positions``), through ``segment_attn_fn`` in every block or,
          without one, the dense :func:`packed_attention_mask`;
        - ``kv_cache`` + ``cache_index`` (a Python int) + ``attn_mask``
          ``[B, T, S]``: write this call's k/v at ``cache_index`` and attend
          against the cache -> ``(TransformerOutput, kv_cache)``;
        - ``paged_cache``: write this call's k/v at ``(page_ids[b, t],
          page_offsets[b, t])``; attend locally under ``attn_mask`` (paged
          prefill), through ``page_table`` + ``attn_lengths`` with ``T = 1``
          (paged decode), or through ``page_table`` + ``prefix_starts``
          (tail prefill over a cached prefix) -> ``(TransformerOutput,
          paged_cache)``.

        Positions index ``pos_embed`` after a clamp into ``[0, max_len)``,
        as a JAX gather clamps (a dead lane's cursor may sit at the end).
        """
        B, T = obs.shape[:2]
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len={self.max_len}")
        if segment_ids is not None and self.segment_attn_fn is None:
            # one [B, S, S] mask shared by every block
            attn_mask = packed_attention_mask(segment_ids)
            segment_ids = None
        if positions is None:
            positions = torch.arange(T, device=obs.device).expand(B, T)
        if self.vocab_size is not None:
            x = self.token_embed(obs.long()).to(self.dtype)
        else:
            x = self.obs_embed(obs.reshape(B, T, -1))
        pos = F.embedding(positions.long().clamp(0, self.max_len - 1), self.pos_embed)
        x = x + pos.to(self.dtype)
        if self.constrain is not None:
            x = self.constrain(x)
        for i, block in enumerate(self.blocks):
            x = block(
                x, self.paged_attn_fn, self.segment_attn_fn, segment_ids,
                layer_cache=None if kv_cache is None else (kv_cache.k[i], kv_cache.v[i]),
                cache_index=cache_index,
                attn_mask=attn_mask,
                paged_cache=None if paged_cache is None else (paged_cache.k[i], paged_cache.v[i]),
                page_ids=page_ids,
                page_offsets=page_offsets,
                page_table=page_table,
                attn_lengths=attn_lengths,
                prefix_starts=prefix_starts,
                attn_fn=self.attn_fn,
            )
            if self.constrain is not None:
                x = self.constrain(x)
        x = self.final_norm(x.float())
        out = TransformerOutput(self.policy_head(x), self.value_head(x).squeeze(-1))
        if paged_cache is not None:
            return out, paged_cache
        if kv_cache is not None:
            return out, kv_cache
        return out
