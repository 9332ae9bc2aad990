#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure exits non-zero and prints
no result line:

1. ``device``: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. ``build``: compiles every CUDA source of ``scalerl_torch/csrc`` with
   ``nvcc`` (one process per source, all started together).
3. ``vtrace``: the V-trace kernel against its plain PyTorch version on the
   card, at the fused loop's [20, 512] and at ragged shapes, for three clip
   settings (max abs error <= 1e-5); its time beside the plain version's
   and the byte bound.
4. ``model``: full-width ``AtariNet`` on the card against the same weights
   on the host, float32 with TF32 off (atol 1e-4).
5. ``impala_learn``: one full-width learn step with the kernel on the card
   against the plain V-trace on the card and the plain step on the host,
   float32 with TF32 off (tolerances and their reasons in ``LEARN_TOL``).
6. ``impala_fused``: the main path as ``bench.py`` sets it up (synthetic
   84x84x4 env, feed-forward AtariNet with hidden 512 and a bf16 torso,
   B=512, T=20, 5 iterations per chunk, V-trace through the kernel): one
   warm-up chunk, then 10 chunks under ``torch.cuda.set_sync_debug_mode
   ("error")`` with every kernel's launch count zeroed just before; then
   two more chunks under ``torch.profiler`` for the device's busy share and
   the heaviest kernels (``impala_profile``).
7. ``per_kernels``: the two prioritized-replay kernels against their plain
   PyTorch versions on the card.  Sampling at N = 2^20 and a ragged
   N = 1,000,003, S in {32, 512}: exact indices on integer priorities; on
   ``uniform**0.6`` priorities every index brackets its target to within
   ``PER_BRACKET_REL`` of its block's sum, and indices differ from the
   plain version's only where the target lies within that margin of a
   boundary.  The update at M = 512 with duplicates and same-block revisits,
   with and without block sums: the plane exact (and equal to an ordered
   host loop), the sums to ``PER_SUMS_RTOL``.  Times beside the byte bounds.
8. ``dqn_learn``: one full-size learn step (sample -> learn -> priority
   update) from the same buffer contents and uniforms, once through the
   kernels and once through the plain versions, float32 with TF32 off:
   indices equal, priority plane and params within ``DQN_LEARN_TOL``.
9. ``dqn_per``: the slice's main path, ``OffPolicyTrainer(...).run()`` for
   DQN with prioritized replay through both kernels on ``TensorCartPole``
   (16 envs, a 65,536 x 16 replay, batch 512, 3-step returns, 40,000 env
   steps), with every kernel's launch count zeroed just before; then 20
   learn steps under ``torch.profiler`` (``dqn_profile``).
10. ``paged_attn``: the paged decode attention kernel against its plain
    PyTorch version on the card (max abs error <= ``PAGED_TOL``): at the
    generation engine's shape (256 lanes, 8 heads of 32, pages of 16, 24
    per lane, 6,145 pages; fragmented seeded tables with shared pages,
    null or random junk past each length, lengths over [1, 384]), at the
    small layouts of the JAX tests with a length-1 lane, and in bfloat16
    (``PAGED_BF16_TOL``).  Its time by CUDA-graph replay and eagerly, the
    plain version's, the byte bound, and gather + SDPA as context.
11. ``genrl_model``: the full-width generation model (V=32, d=256, 8
    heads, 4 layers) on the card against the same weights on the host,
    float32 with TF32 off (``GEN_MODEL_TOL``): masked forward, paged
    prefill, paged decode through the kernel, tail prefill, the pools.
12. ``genrl_decode``: one full-shape macro step (256 lanes, 16 substeps)
    from the same state and generator seed, through the kernel and
    through the plain version: tokens equal, the rest within
    ``GEN_DECODE_TOL``.
13. ``genrl_continuous``: the main path as ``bench.py --mode genrl
    --continuous`` sets it up on an accelerator: the cohort engine for
    ``GEN_TARGET_S``, a warm-up of six lane-fills, then the continuous
    engine for ``GEN_TARGET_S`` under Poisson arrivals at twice the cohort's
    completion rate with the kernel's launch count zeroed just before
    (launches must equal 64 per dispatched macro step); 8 more macro steps
    of the same traffic under ``torch.profiler`` (``genrl_profile``); a
    drain (every reservation returned); then at temperature 0 a handful of
    prompts through both engines, token-identical with logp within
    ``GEN_IDENTITY_LOGP_TOL`` (``genrl_identity``).

Then a line with the card, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
VTRACE_OPS_PER_ELEMENT = 16  # exp, 3 clips, delta (4), recursion (3), vs (1), pg (4)
VTRACE_TOL = 1e-5
MODEL_TOL = 1e-4

MAIN_T, MAIN_B, MAIN_ITERS, MAIN_CHUNKS = 20, 512, 5, 10

# Prioritized replay (phases 7-9): the DQN slice's configuration
PER_BLOCK = 1024
PER_NUM_ENVS, PER_CAPACITY, PER_BATCH, PER_N_STEP = 16, 65536, 512, 3
# float32 scans in different orders round differently: an index may move
# to a neighbour only where its target lies this close (relative to the
# block's sum) to the boundary between them
PER_BRACKET_REL = 1e-6
PER_SUMS_RTOL = 1e-5
# kernels vs plain versions in one learn step on the card: with equal
# indices the batch, the learn step and the priorities are the same
# operations on the same inputs, so only cuBLAS's sum order could differ
DQN_LEARN_TOL = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_time_ms(fn, launches: int, reps: int = 5) -> float:
    """Median device time of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, replayed between two events, so host overhead drops out."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def eager_time_ms(fn, launches: int, reps: int = 5) -> float:
    """Median time of one eager ``fn()`` from the host, as the main path
    calls it: events around ``launches`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def set_tf32(enabled: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------------------
def phase_device(report: dict) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    report["card"] = smi.stdout.strip().splitlines()[0]
    print(report["card"], flush=True)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         card=report["card"], torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))


def phase_build(report: dict) -> None:
    from scalerl_torch.utils import cuda_build

    # the kernels must come from the checkout this script sits in
    if cuda_build.PACKAGE_DIR.parent != Path(__file__).resolve().parent:
        raise RuntimeError(f"scalerl_torch found at {cuda_build.PACKAGE_DIR}, not beside this script")
    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit("build", seconds=seconds, sources=list(cuda_build.KERNEL_SOURCES), ptxas=ptxas)


def _vtrace_inputs(T, B, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    inp = dict(
        log_rhos=torch.randn(T, B, generator=g) * 0.4,
        discounts=0.99 * (torch.rand(T, B, generator=g) > 0.1).float(),
        rewards=torch.randn(T, B, generator=g),
        values=torch.randn(T, B, generator=g),
        bootstrap_value=torch.randn(B, generator=g),
    )
    return {k: v.to(device) for k, v in inp.items()}


def phase_vtrace(report: dict) -> None:
    from scalerl_torch.ops.cuda_vtrace import vtrace_from_importance_weights_kernel
    from scalerl_torch.ops.vtrace import vtrace_scan

    set_tf32(False)
    clips = {
        "default": {},
        "rho2_c1.5": {"clip_rho_threshold": 2.0, "clip_c_threshold": 1.5},
        "no_rho_clip": {"clip_rho_threshold": None, "clip_pg_rho_threshold": None},
    }
    cases = []
    worst = 0.0
    for T, B in [(MAIN_T, MAIN_B), (1, 1), (37, 5), (20, 1000)]:
        inp = _vtrace_inputs(T, B, seed=T * 1000 + B, device="cuda")
        for clip_name, clip in clips.items():
            got = vtrace_from_importance_weights_kernel(**inp, **clip)
            want = vtrace_scan(**inp, **clip)
            err = max(
                (got.vs - want.vs).abs().max().item(),
                (got.pg_advantages - want.pg_advantages).abs().max().item(),
            )
            cases.append({"shape": [T, B], "clips": clip_name, "max_abs_err": err})
            worst = max(worst, err)
            if not err <= VTRACE_TOL:
                raise AssertionError(f"vtrace {T}x{B} {clip_name}: max abs err {err}")

    inp = _vtrace_inputs(MAIN_T, MAIN_B, seed=0, device="cuda")
    kernel = lambda: vtrace_from_importance_weights_kernel(**inp)  # noqa: E731
    plain = lambda: vtrace_scan(**inp)  # noqa: E731
    out_bytes = 2 * MAIN_T * MAIN_B * 4
    moved = sum(x.numel() * x.element_size() for x in inp.values()) + out_bytes
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = VTRACE_OPS_PER_ELEMENT * MAIN_T * MAIN_B / H100_F32_OPS_PER_S * 1e3
    timing = dict(
        ms=gpu_time_ms(kernel, 200),
        plain_ms=gpu_time_ms(plain, 20),
        eager_ms=eager_time_ms(kernel, 200),
        plain_eager_ms=eager_time_ms(plain, 20),
        bytes_moved=moved,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    report["vtrace"] = {"max_abs_err": worst, **timing}
    emit("vtrace", tol=VTRACE_TOL, max_abs_err=worst, cases=cases, shape=[MAIN_T, MAIN_B],
         card=report["card"], **timing)


def phase_model(report: dict) -> None:
    import torch

    from scalerl_torch.models.atari import AtariNet

    set_tf32(False)
    A, T, B = 6, 2, 8
    gpu = AtariNet(num_actions=A, use_lstm=False, hidden_size=512, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    cpu = AtariNet(num_actions=A, use_lstm=False, hidden_size=512, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = torch.Generator().manual_seed(2)
    inputs = (
        torch.randint(0, 256, (T, B, 84, 84, 4), generator=g, dtype=torch.uint8),
        torch.randint(0, A, (T, B), generator=g),
        torch.randn(T, B, generator=g) * 2,
        torch.rand(T, B, generator=g) < 0.3,
    )
    with torch.no_grad():
        want, _ = cpu(*inputs)
        got, _ = gpu(*(x.cuda() for x in inputs))
    err = max(
        (got.policy_logits.cpu() - want.policy_logits).abs().max().item(),
        (got.baseline.cpu() - want.baseline).abs().max().item(),
    )
    emit("model", tol=MODEL_TOL, max_abs_err=err, shape=[T, B, 84, 84, 4], hidden=512,
         tf32=False)
    if not err <= MODEL_TOL:
        raise AssertionError(f"AtariNet card vs host: max abs err {err}")


LEARN_TOL = {
    # card, kernel V-trace vs card, plain V-trace: the same kernels apart
    # from V-trace, which agrees bit for bit, so only the order of cuDNN's
    # weight-gradient sums may differ
    "kernel_vs_plain_update_abs": 1e-6,
    # card vs host: the forward agrees to ~1e-7, but a pre-activation within
    # that of 0 opens a ReLU on one side only and moves its gradient row by
    # one term of the sum over T*B (6.5e-4 relative L2 measured on an H100)
    "card_vs_host_update_rel_l2": 1e-2,
    "loss_rel": 1e-5,
    "grad_norm_rel": 1e-4,
}


def phase_impala_learn(report: dict) -> None:
    """One learn step from the same weights and trajectory, at full width
    and a small batch: kernel V-trace on the card against plain V-trace on
    the card, and against the plain step on the host."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.data.trajectory import Trajectory

    set_tf32(False)
    T, B, A = 6, 4, 6
    g = torch.Generator().manual_seed(3)
    fields = dict(
        obs=torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=g, dtype=torch.uint8),
        action=torch.randint(0, A, (T + 1, B), generator=g),
        reward=torch.randn(T + 1, B, generator=g),
        done=torch.rand(T + 1, B, generator=g) < 0.2,
        logits=torch.randn(T + 1, B, A, generator=g),
    )
    fields["logits"][-1] = 0.0
    out = {}
    for name, device, use_pallas in (("host", "cpu", False), ("plain", "cuda", False),
                                     ("kernel", "cuda", True)):
        args = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=T,
                               batch_size=B, max_timesteps=0, use_pallas=use_pallas)
        agent = ImpalaAgent(args, (84, 84, 4), A, device=device)
        before = {k: v.cpu() for k, v in agent.get_weights().items()}
        traj = Trajectory(**{k: v.to(device) for k, v in fields.items()})
        metrics = agent.learn(traj)
        update = {k: v.cpu() - before[k] for k, v in agent.get_weights().items()}
        out[name] = (metrics, torch.cat([u.reshape(-1) for u in update.values()]))

    def rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(b), 1.0)

    (m_host, u_host), (_, u_plain), (m_kern, u_kern) = out["host"], out["plain"], out["kernel"]
    errs = {
        "kernel_vs_plain_update_abs": (u_kern - u_plain).abs().max().item(),
        "card_vs_host_update_rel_l2": ((u_kern - u_host).norm() / u_host.norm()).item(),
        "loss_rel": rel(m_kern["total_loss"], m_host["total_loss"]),
        "grad_norm_rel": rel(m_kern["grad_norm"], m_host["grad_norm"]),
    }
    emit("impala_learn", **errs, card_vs_host_update_max_abs_err=(u_kern - u_host).abs().max().item(),
         update_max_abs=u_host.abs().max().item(), total_loss=m_kern["total_loss"],
         grad_norm=m_kern["grad_norm"], grad_norm_host=m_host["grad_norm"], tf32=False,
         tol=LEARN_TOL)
    bad = {k: v for k, v in errs.items() if not v <= LEARN_TOL[k]}
    if bad:
        raise AssertionError(f"learn step off tolerance: {bad}")


def phase_impala_fused(report: dict) -> None:
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(True)  # PyTorch's defaults for cuDNN; the torso is bf16 anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ImpalaArguments(
        use_lstm=False, hidden_size=512, rollout_length=MAIN_T, batch_size=MAIN_B,
        max_timesteps=0, compute_dtype="bfloat16", use_pallas=True,
    )
    env = SyntheticPixelEnv(num_envs=MAIN_B)
    agent = ImpalaAgent(args, obs_shape=env.observation_shape, num_actions=env.num_actions)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(),
                                  unroll_length=MAIN_T, iters_per_call=MAIN_ITERS)
    carry = loop.init_carry()
    t0 = time.perf_counter()
    state, carry, _ = loop.run(agent.state, carry, num_calls=1)  # warm-up chunk
    warmup_s = time.perf_counter() - t0

    chunk_metrics = []
    torch.cuda.reset_peak_memory_stats()
    cuda_vtrace.launches = 0
    t0 = time.perf_counter()
    state, carry, last = loop.run(state, carry, num_calls=MAIN_CHUNKS,
                                  on_metrics=lambda i, m: chunk_metrics.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    report["launches"] = {"vtrace": launches}

    frames = MAIN_CHUNKS * MAIN_ITERS * MAIN_T * MAIN_B
    emit("impala_fused", B=MAIN_B, T=MAIN_T, iters_per_call=MAIN_ITERS,
         chunks=MAIN_CHUNKS, frames=frames, seconds=seconds,
         env_frames_per_s=frames / seconds, warmup_chunk_s=warmup_s,
         vtrace_launches=launches, learner_steps=int(state.step),
         env_frames_total=int(state.env_frames),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         sync_debug_mode="error", last_chunk=last, card=report["card"])
    if launches != MAIN_CHUNKS * MAIN_ITERS:
        raise AssertionError(f"vtrace launches {launches} != {MAIN_CHUNKS * MAIN_ITERS}")
    if len(chunk_metrics) != MAIN_CHUNKS:
        raise AssertionError(f"{len(chunk_metrics)} chunk metrics, want {MAIN_CHUNKS}")
    for i, m in enumerate(chunk_metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or m["skipped_steps"] != 0.0:
            raise AssertionError(f"chunk {i}: non-finite {bad}, skipped {m['skipped_steps']}")
    profile_chunks(loop, state, carry, seconds / MAIN_CHUNKS, report["card"])


def profile_device(fn):
    """Run ``fn()`` under ``torch.profiler``; returns the wall seconds it
    took there and ``[(kernel, device us, calls)]``, heaviest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0

    def device_us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = sorted(
        ((e.key, device_us(e), e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and device_us(e) > 0),
        key=lambda k: -k[1],
    )
    return profiled_s, kernels


def profile_host(fn, top: int = 12):
    """Run ``fn()`` under cProfile; returns the wall seconds and the
    port's functions with the largest cumulative time, as
    ``[(file:function, seconds, calls)]``.  cProfile slows Python calls,
    so read shares, not absolute times."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [(f"{Path(file).name}:{func}", ct, nc)
            for (file, _line, func), (_cc, nc, _tt, ct, _callers) in pstats.Stats(prof).stats.items()
            if "scalerl_torch" in file]
    return wall, sorted(rows, key=lambda r: -r[1])[:top]


def profile_chunks(loop, state, carry, chunk_s: float, card: str, chunks: int = 2) -> None:
    """Where the time goes: ``chunks`` more chunks (after the counted run)
    under ``torch.profiler``; the device's busy time per chunk against the
    unprofiled chunk time, and the kernels that take the most of it."""
    profiled_s, kernels = profile_device(lambda: loop.run(state, carry, num_calls=chunks))
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / chunks
    emit("impala_profile", chunks=chunks, unprofiled_chunk_s=chunk_s,
         profiled_chunk_s=profiled_s / chunks,
         device_busy_s_per_chunk=busy_s if kernels else None,
         device_busy_share=busy_s / chunk_s if kernels else None,
         kernel_launches_per_chunk=sum(n for _, _, n in kernels) / chunks,
         top_kernels=[{"name": k[:90], "ms_per_chunk": us / 1e3 / chunks,
                       "calls_per_chunk": n / chunks} for k, us, n in kernels[:12]],
         card=card)


def _per_bracket(p, b_idx, within_t, got, want, n):
    """The bracket rule on real-valued priorities, against a float64 scan of
    each chosen block: (samples whose index does not bracket its target,
    samples that differ from the plain version away from a boundary)."""
    import torch

    from scalerl_torch.ops import per

    cum = per.gather_blocks(p, b_idx, PER_BLOCK).double().cumsum(dim=1)
    tol = PER_BRACKET_REL * cum[:, -1]
    t = within_t.double()

    def cum_at(w):
        return torch.gather(cum, 1, w.clamp(0, PER_BLOCK - 1)[:, None])[:, 0]

    w = got - b_idx * PER_BLOCK
    clipped = (w == PER_BLOCK - 1) | (got == n - 1)
    lower_ok = (w == 0) | (cum_at(w - 1) <= t + tol)
    upper_ok = clipped | (t <= cum_at(w) + tol)
    off_bracket = int((~(lower_ok & upper_ok)).sum())
    lo = torch.minimum(got, want) - b_idx * PER_BLOCK
    hi = torch.maximum(got, want) - b_idx * PER_BLOCK
    near = ((cum_at(lo) - t).abs() <= tol) & ((cum_at(hi - 1) - t).abs() <= tol)
    far_mismatch = int(((got != want) & ~near).sum())
    return off_bracket, far_mismatch


def _update_case(n, g):
    import torch

    M = PER_BATCH
    p0 = torch.rand(n, generator=g, device="cuda") * 2 + 0.1
    idx = torch.randint(0, n, (M,), generator=g, device="cuda")
    idx[10] = idx[3]  # duplicate slots: the last write wins
    idx[20] = idx[3]
    idx[30] = (idx[5] // PER_BLOCK) * PER_BLOCK + (idx[5] + 1) % PER_BLOCK  # revisit
    idx[40] = n - 1  # the last lane of the plane
    idx[41] = n + 7  # clipped to n - 1
    new_p = torch.rand(M, generator=g, device="cuda") + 0.5
    return p0, idx, new_p


def phase_per_kernels(report: dict) -> None:
    import numpy as np
    import torch

    from scalerl_torch.ops import cuda_per, per

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(5)
    sample_cases, worst_sample = [], 0
    main = None
    for n in (1 << 20, 1_000_003):
        for kind in ("integer", "real"):
            if kind == "integer":
                p = torch.randint(1, 17, (n,), generator=g, device="cuda").float()
            else:
                p = torch.rand(n, generator=g, device="cuda") ** 0.6
            total = p.sum()
            for S in (32, PER_BATCH):
                u = torch.rand(S, generator=g, device="cuda")
                targets = (torch.arange(S, device="cuda") + u) / S * total
                b_idx, within_t = per.split_targets(p, targets, PER_BLOCK)
                got = cuda_per.within_block_kernel(p, b_idx, within_t, PER_BLOCK)
                want = per.within_block_sample(p, b_idx, within_t, PER_BLOCK)
                torch.cuda.synchronize()
                mismatches = int((got != want).sum())
                err = int((got - want).abs().max())
                worst_sample = max(worst_sample, err)
                case = {"n": n, "S": S, "priorities": kind, "mismatches": mismatches,
                        "max_abs_err": err}
                if kind == "integer":
                    if mismatches:
                        raise AssertionError(f"sample kernel: {mismatches} index mismatches {case}")
                else:
                    off, far = _per_bracket(p, b_idx, within_t, got, want, n)
                    case.update(off_bracket=off, mismatch_away_from_boundary=far)
                    if off or far:
                        raise AssertionError(f"sample kernel off its bracket: {case}")
                    if n == 1 << 20 and S == PER_BATCH:
                        main = (p, targets, b_idx, within_t)
                sample_cases.append(case)

    update_cases, worst_update = [], 0.0
    for n in (1 << 20, 1_000_003):
        p0, idx, new_p = _update_case(n, g)
        want_np = p0.cpu().numpy()
        for i, v in zip(idx.clamp(0, n - 1).cpu().numpy(), new_p.cpu().numpy()):
            want_np[i] = v  # the JAX package's ordered loop
        for with_sums in (False, True):
            pk, pp = p0.clone(), p0.clone()
            sk = per.block_sums(p0, PER_BLOCK) if with_sums else None
            sp = sk.clone() if with_sums else None
            cuda_per.update_kernel(pk, idx, new_p, sk, PER_BLOCK)
            per.update_priorities_plain(pp, idx, new_p, sp, PER_BLOCK)
            torch.cuda.synchronize()
            plane_err = float((pk - pp).abs().max())
            loop_exact = bool(np.array_equal(pk.cpu().numpy(), want_np))
            case = {"n": n, "M": PER_BATCH, "sums": with_sums, "plane_max_abs_err": plane_err,
                    "equals_ordered_loop": loop_exact}
            if with_sums:
                case["sums_max_rel_err"] = float(((sk - sp).abs() / sp.abs()).max())
            update_cases.append(case)
            worst_update = max(worst_update, plane_err)
            if plane_err != 0.0 or not loop_exact or case.get("sums_max_rel_err", 0.0) > PER_SUMS_RTOL:
                raise AssertionError(f"update kernel disagrees: {case}")

    # times at the DQN slice's shapes: N = 2^20, S = M = 512, blocks of 1024
    p, targets, b_idx, within_t = main
    n = p.shape[0]
    distinct_blocks = int(torch.unique(b_idx).numel())
    sample_bytes = distinct_blocks * PER_BLOCK * 4 + PER_BATCH * (8 + 4) + PER_BATCH * 8
    sample_ops = 2 * PER_BATCH * PER_BLOCK  # a scan add and a compare per lane
    sample_timing = _bound(sample_bytes, sample_ops, dict(
        ms=gpu_time_ms(lambda: cuda_per.within_block_kernel(p, b_idx, within_t, PER_BLOCK), 200),
        eager_ms=eager_time_ms(lambda: cuda_per.within_block_kernel(p, b_idx, within_t, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.within_block_sample(p, b_idx, within_t, PER_BLOCK), 50),
        plain_eager_ms=eager_time_ms(lambda: per.within_block_sample(p, b_idx, within_t, PER_BLOCK), 50),
        with_phase1_ms=gpu_time_ms(lambda: cuda_per.sample_kernel(p, targets, PER_BLOCK), 50),
        with_phase1_eager_ms=eager_time_ms(lambda: cuda_per.sample_kernel(p, targets, PER_BLOCK), 50),
        plain_hierarchical_ms=gpu_time_ms(lambda: per.hierarchical_sample(p, targets, PER_BLOCK), 50),
        flat_cumsum_ms=gpu_time_ms(lambda: per.cumsum_sample(p, targets), 50),
        distinct_blocks=distinct_blocks,
    ))
    p0, idx, new_p = _update_case(n, g)
    pk, pp = p0.clone(), p0.clone()
    clipped = idx.clamp(0, n - 1)
    slots = int(torch.unique(clipped).numel())
    touched = int(torch.unique(clipped // PER_BLOCK).numel())
    update_bytes = PER_BATCH * (8 + 4) + slots * 4  # indices, values in; slots out
    update_timing = _bound(update_bytes, 0, dict(
        ms=gpu_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, None, PER_BLOCK), 200),
        eager_ms=eager_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, None, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, None, PER_BLOCK), 50),
        plain_eager_ms=eager_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, None, PER_BLOCK), 50),
        distinct_slots=slots, touched_blocks=touched,
    ))
    sk = per.block_sums(p0, PER_BLOCK)
    sp = sk.clone()
    sums_bytes = update_bytes + touched * PER_BLOCK * 4 + touched * 4  # + blocks read, sums out
    sums_timing = _bound(sums_bytes, touched * PER_BLOCK, dict(
        ms=gpu_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, sk, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, sp, PER_BLOCK), 50),
    ))
    report["per_sample"] = {"max_abs_err": float(worst_sample), **sample_timing}
    report["per_update"] = {"max_abs_err": worst_update, **update_timing}
    emit("per_kernels", block=PER_BLOCK, sample_cases=sample_cases, update_cases=update_cases,
         sample=sample_timing, update=update_timing, update_with_sums=sums_timing,
         bracket_rel=PER_BRACKET_REL, sums_rtol=PER_SUMS_RTOL, card=report["card"],
         library_ms=None, library_note="no single PyTorch call computes either function: "
         "index_put_ does not promise last-wins; flat_cumsum_ms times cumsum + searchsorted")


def _bound(moved: int, ops: int, timing: dict) -> dict:
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return dict(timing, bytes_moved=moved, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _dqn_args(**kw):
    from scalerl_torch.config import DQNArguments

    return DQNArguments(num_envs=PER_NUM_ENVS, buffer_size=PER_CAPACITY, batch_size=PER_BATCH,
                        use_per=True, n_steps=PER_N_STEP, **kw)


def phase_dqn_learn(report: dict) -> None:
    """One full-size learn step from the same buffer contents and uniforms,
    through the kernels and through the plain versions, on the card."""
    import dataclasses

    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.prioritized import per_sample_from_uniforms
    from scalerl_torch.data.sampler import Sampler

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (PER_CAPACITY, PER_NUM_ENVS)
    done = torch.rand(shape, generator=g, device="cuda") < 0.05
    contents = dict(
        obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        next_obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        action=torch.randint(0, 2, shape, generator=g, device="cuda"),
        reward=torch.rand(shape, generator=g, device="cuda"),
        done=done,
        boundary=done | (torch.rand(shape, generator=g, device="cuda") < 0.01),
    )
    priorities = torch.rand(shape, generator=g, device="cuda") * 2 + 0.05
    u = torch.rand(PER_BATCH, generator=g, device="cuda")
    out = {}
    for name, use_pallas in (("plain", False), ("kernel", True)):
        args = _dqn_args(use_pallas=use_pallas)
        agent = DQNAgent(args, (4,), 2)
        sampler = Sampler((4,), PER_CAPACITY, PER_NUM_ENVS, use_per=True, per_alpha=args.per_alpha,
                          n_step=PER_N_STEP, gamma=args.gamma, use_pallas=use_pallas)
        state = sampler.buffer.state
        for k, v in contents.items():
            state.replay.storage[k].copy_(v)
        state.priorities.copy_(priorities)
        # a full ring whose head has wrapped: the sample rolls the plane
        sampler.buffer.state = dataclasses.replace(
            state, replay=dataclasses.replace(state.replay, pos=12345, size=PER_CAPACITY))
        batch = per_sample_from_uniforms(sampler.buffer.state, u, args.per_alpha, args.per_beta,
                                         PER_N_STEP, args.gamma, sampler.buffer.sample_method)
        metrics, td_abs = agent.learn_device(batch)
        sampler.update_priorities(batch["indices"], td_abs + 1e-6)
        torch.cuda.synchronize()
        out[name] = dict(indices=batch["indices"], plane=sampler.buffer.state.priorities,
                         params=torch.cat([v.reshape(-1) for v in agent.state.params.values()]),
                         loss=float(metrics["loss"]))
    plain, kern = out["plain"], out["kernel"]
    mismatches = int((plain["indices"] != kern["indices"]).sum())
    errs = {
        "plane_max_abs_err": float((plain["plane"] - kern["plane"]).abs().max()),
        "params_max_abs_err": float((plain["params"] - kern["params"]).abs().max()),
    }
    emit("dqn_learn", index_mismatches=mismatches, **errs, loss_plain=plain["loss"],
         loss_kernel=kern["loss"], batch=PER_BATCH, replay=list(shape), tol=DQN_LEARN_TOL,
         tf32=False)
    if mismatches or any(not v <= DQN_LEARN_TOL for v in errs.values()):
        raise AssertionError(f"kernel learn step off the plain one: {mismatches} indices, {errs}")


class CartPoleVectorView:
    """gym's vector-env API over the port's ``TensorCartPole`` on the card
    (whose machine may have no gymnasium): ``reset(seed)``, ``step(actions)``
    -> ``(obs, reward, terminated, truncated, infos)``, ``num_envs`` and the
    spaces' ``shape`` and ``n``.

    ``done`` splits into ``truncated`` (the step that reaches ``max_steps``)
    and ``terminated`` (every other end).  No ``final_obs``: where an episode
    ends, ``obs`` is already the reset observation, so a truncated
    transition's ``next_obs`` is the reset observation."""

    def __init__(self, num_envs: int) -> None:
        from scalerl_torch.envs.tensor_envs import TensorCartPole

        self.env = TensorCartPole(num_envs)
        self.num_envs = num_envs
        self.single_observation_space = SimpleNamespace(shape=self.env.observation_shape)
        self.single_action_space = SimpleNamespace(n=self.env.num_actions)

    def reset(self, seed: int):
        import torch

        self.generator = torch.Generator(device=self.env.device).manual_seed(seed)
        self.state, obs = self.env.reset(self.generator)
        return obs, {}

    def step(self, actions):
        at_limit = self.state.t + 1 >= self.env.max_steps
        self.state, obs, reward, done = self.env.step(self.state, actions, self.generator)
        truncated = done & at_limit
        return obs, reward, done & ~truncated, truncated, {}


def phase_dqn_per(report: dict) -> None:
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.ops import cuda_per, cuda_vtrace
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    set_tf32(False)
    args = _dqn_args(use_pallas=True, warmup_learn_steps=2000, train_frequency=PER_NUM_ENVS,
                     max_timesteps=40_000, eval_frequency=10**9)
    envs = CartPoleVectorView(PER_NUM_ENVS)
    agent = DQNAgent(args, envs.single_observation_space.shape, envs.single_action_space.n)
    trainer = OffPolicyTrainer(args, agent, envs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_vtrace.launches = 0
    cuda_per.sample_launches = 0
    cuda_per.update_launches = 0
    t0 = time.perf_counter()
    summary = trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"per_sample": cuda_per.sample_launches, "per_update": cuda_per.update_launches}
    report["launches"].update(launches)
    learn_steps = trainer.learn_steps
    skipped = float(trainer.skipped_steps)
    losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the learn step alone (sample -> learn -> priority update), synchronised
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step()
    torch.cuda.synchronize()
    learn_step_s = (time.perf_counter() - t0) / reps

    emit("dqn_per", num_envs=PER_NUM_ENVS, replay=[PER_CAPACITY, PER_NUM_ENVS],
         batch=PER_BATCH, n_step=PER_N_STEP, env_steps=trainer.global_step, seconds=seconds,
         env_steps_per_s=trainer.global_step / seconds, learn_steps=learn_steps,
         learn_steps_per_s=learn_steps / seconds, learn_step_ms=learn_step_s * 1e3,
         launches=launches, vtrace_launches=cuda_vtrace.launches, skipped_steps=skipped,
         logged_losses=len(losses), losses_finite=all(math.isfinite(x) for x in losses),
         last_loss=losses[-1] if losses else None,
         episodes=summary.get("episodes"), return_mean=summary.get("return_mean"),
         peak_mem_gib=peak, card=report["card"])
    if launches != {"per_sample": learn_steps, "per_update": learn_steps} or learn_steps < 2000:
        raise AssertionError(f"PER kernel launches {launches} for {learn_steps} learn steps")
    if not losses or not all(math.isfinite(x) for x in losses) or skipped != 0.0:
        raise AssertionError(f"{len(losses)} logged losses (finite: "
                             f"{all(math.isfinite(x) for x in losses)}), {skipped} skipped steps")

    steps = 20
    profiled_s, kernels = profile_device(lambda: [trainer.train_step() for _ in range(steps)])
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / steps
    emit("dqn_profile", learn_steps=steps, unprofiled_learn_step_s=learn_step_s,
         profiled_learn_step_s=profiled_s / steps,
         device_busy_s_per_learn_step=busy_s if kernels else None,
         device_busy_share=busy_s / learn_step_s if kernels else None,
         kernel_launches_per_learn_step=sum(n for _, _, n in kernels) / steps,
         top_kernels=[{"name": k[:90], "us_per_learn_step": us / steps,
                       "calls_per_learn_step": n / steps} for k, us, n in kernels[:12]],
         card=report["card"])


# Generation plane (phases 10-13): bench.py's genrl-continuous setup
GEN_V, GEN_D, GEN_HEADS, GEN_LAYERS = 32, 256, 8, 4
GEN_P, GEN_R, GEN_LANES = 128, 256, 256
GEN_PAGE, GEN_MACRO, GEN_MIN_FREE = 16, 16, 32
GEN_MAX_LEN = 2 * (GEN_P + GEN_R)
GEN_PAGES_PER_LANE = (GEN_P + GEN_R) // GEN_PAGE  # 24
GEN_NUM_PAGES = GEN_LANES * GEN_PAGES_PER_LANE + 1  # 6,145 with the null page
GEN_TARGET_S = 10.0
# the kernel against its plain version: the same float32 arithmetic summed
# in another order (an online softmax over chunks of 16 tokens against one
# softmax and an einsum); JAX pins its kernel to its reference at 1e-5
PAGED_TOL = 1e-5
# bfloat16 inputs: both sides accumulate in float32 and round the output to
# bfloat16 once, so they may differ by one bfloat16 step of an output below
# 4 in magnitude (2^-6)
PAGED_BF16_TOL = 2.0 ** -6
# the model on the card against the same weights on the host, float32 with
# TF32 off: cuBLAS and the host's BLAS sum the d=256 and 1,024-wide products
# in different orders, which moves logits ~1e-6 per layer
GEN_MODEL_TOL = 1e-4
# one macro step, kernel against plain version on the card: attention
# differs by <= PAGED_TOL per call and that passes through 4 layers and 16
# dependent substeps
GEN_DECODE_TOL = 1e-4
# temperature 0, continuous (paged kernel) against cohort (dense masked
# attention) engine: JAX's acceptance pin, tests/test_continuous.py:74-94
GEN_IDENTITY_LOGP_TOL = 1e-5


def _gen_model(device, seed=0):
    import torch

    from scalerl_torch.models.transformer import TransformerPolicy

    return TransformerPolicy(num_actions=GEN_V, vocab_size=GEN_V, d_model=GEN_D,
                             num_heads=GEN_HEADS, num_layers=GEN_LAYERS, max_len=GEN_MAX_LEN,
                             device=device, generator=torch.Generator().manual_seed(seed))


def _gen_config(**kw):
    from scalerl_torch.genrl.continuous import ContinuousConfig

    base = dict(vocab_size=GEN_V, max_prompt_len=GEN_P, max_new_tokens=GEN_R, temperature=1.0,
                eos_token=1, seed=0, lanes=GEN_LANES, page_size=GEN_PAGE,
                steps_per_macro=GEN_MACRO, min_free_lanes=GEN_MIN_FREE, prompt_buckets=(GEN_P,))
    return ContinuousConfig(**{**base, **kw})


def _paged_case(B, H, D, ps, M, N, lengths, seed, dtype, junk=False, shared=0):
    """Pools, q and a fragmented table: lane pages drawn from one shuffled
    pool order; ``shared`` lanes map lane 0's first two pages; entries past
    a lane's pages are the null page (or random pages with ``junk``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    order = torch.randperm(N - 1, generator=g) + 1
    table = torch.zeros(B, M, dtype=torch.int32)
    cursor = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = order[cursor:cursor + n].to(torch.int32)
        cursor = (cursor + n) % (N - 1 - M)
        if junk and n < M:
            table[b, n:] = torch.randint(0, N, (M - n,), generator=g, dtype=torch.int32)
    for b in range(1, min(B, 1 + shared)):
        if -(-int(lengths[b]) // ps) > 2 and -(-int(lengths[0]) // ps) > 2:
            table[b, :2] = table[0, :2]
    dev = "cuda"
    return dict(
        q=torch.randn(B, 1, H, D, generator=g).to(dev, dtype),
        k_pages=torch.randn(N, ps, H, D, generator=g).to(dev, dtype),
        v_pages=torch.randn(N, ps, H, D, generator=g).to(dev, dtype),
        page_table=table.to(dev),
        lengths=torch.as_tensor(lengths, dtype=torch.int32).to(dev),
    )


def phase_paged_attn(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from scalerl_torch.ops import cuda_paged_attention
    from scalerl_torch.ops.paged_attention import paged_attention_reference

    set_tf32(False)
    kernel = cuda_paged_attention.paged_decode_attention
    g = torch.Generator().manual_seed(11)
    B, H, D = GEN_LANES, GEN_HEADS, GEN_D // GEN_HEADS
    ps, M, N = GEN_PAGE, GEN_PAGES_PER_LANE, GEN_NUM_PAGES
    main_lengths = torch.randint(1, M * ps + 1, (B,), generator=g)
    main_lengths[0], main_lengths[1], main_lengths[2] = M * ps, 1, 17
    cases = []
    worst = 0.0
    layouts = [  # tests/test_paging.py:342-351, plus a length-1 lane
        ([[1, 2, 3], [4, 5, 6]], [12, 8]),
        ([[7, 1, 5], [3, 8, 2]], [12, 12]),
        ([[5, 3, 0], [6, 0, 0]], [7, 2]),
        ([[4, 0, 0], [2, 6, 1]], [1, 9]),
    ]
    for i, (table, lengths) in enumerate(layouts):
        inp = _paged_case(2, 2, 8, 4, 3, 9, lengths, seed=20 + i, dtype=torch.float32)
        inp["page_table"] = torch.tensor(table, dtype=torch.int32, device="cuda")
        err = (kernel(**inp) - paged_attention_reference(**inp)).abs().max().item()
        cases.append({"shape": "small", "table": table, "lengths": lengths, "max_abs_err": err})
        worst = max(worst, err)
    for name, kw in (("main", dict(shared=8)), ("main_junk_tail", dict(junk=True, shared=8))):
        inp = _paged_case(B, H, D, ps, M, N, main_lengths, seed=12, dtype=torch.float32, **kw)
        err = (kernel(**inp) - paged_attention_reference(**inp)).abs().max().item()
        cases.append({"shape": name, "max_abs_err": err})
        worst = max(worst, err)
    torch.cuda.synchronize()
    bad = [c for c in cases if not c["max_abs_err"] <= PAGED_TOL]
    inp16 = _paged_case(B, H, D, ps, M, N, main_lengths, seed=13, dtype=torch.bfloat16, shared=8)
    bf16_err = (kernel(**inp16).float()
                - paged_attention_reference(**inp16).float()).abs().max().item()
    cases.append({"shape": "main_bf16", "max_abs_err": bf16_err, "tol": PAGED_BF16_TOL})
    if bad or not bf16_err <= PAGED_BF16_TOL:
        raise AssertionError(f"paged kernel off its plain version: {cases}")

    inp = _paged_case(B, H, D, ps, M, N, main_lengths, seed=12, dtype=torch.float32, shared=8)
    live = int(main_lengths.sum())
    moved = (live * 2 * H * D * 4 + 2 * B * H * D * 4 + B * M * 4 + B * 4)
    ops = live * H * (4 * D + 6)  # q.k and p.v (2D each), the softmax's few
    kflat = inp["k_pages"].view(N * ps, H, D)
    vflat = inp["v_pages"].view(N * ps, H, D)
    idx = (inp["page_table"].long()[:, :, None] * ps
           + torch.arange(ps, device="cuda")[None, None, :]).reshape(B, M * ps)
    valid = torch.arange(M * ps, device="cuda")[None, :] < inp["lengths"][:, None]
    valid = valid[:, None, None, :]

    def gather_sdpa():
        k = kflat[idx].transpose(1, 2)
        v = vflat[idx].transpose(1, 2)
        return F.scaled_dot_product_attention(inp["q"].transpose(1, 2), k, v, attn_mask=valid)

    lib_err = (gather_sdpa().transpose(1, 2) - paged_attention_reference(**inp)).abs().max().item()
    timing = _bound(moved, ops, dict(
        ms=gpu_time_ms(lambda: kernel(**inp), 200),
        eager_ms=eager_time_ms(lambda: kernel(**inp), 200),
        plain_ms=gpu_time_ms(lambda: paged_attention_reference(**inp), 20),
        plain_eager_ms=eager_time_ms(lambda: paged_attention_reference(**inp), 20),
        library_ms=gpu_time_ms(gather_sdpa, 20),
        live_tokens=live,
    ))
    report["paged_attention"] = {"max_abs_err": worst, **timing}
    emit("paged_attn", tol=PAGED_TOL, max_abs_err=worst, cases=cases,
         shape={"lanes": B, "heads": H, "head_dim": D, "page_size": ps, "pages_per_lane": M,
                "num_pages": N},
         library="gather + F.scaled_dot_product_attention (context only; the port never "
                 "calls it)", library_max_abs_err=lib_err, card=report["card"], **timing)


def phase_genrl_model(report: dict) -> None:
    """The full-width model on the card against the same weights on the
    host, on the masked, paged prefill, paged decode (kernel on the card,
    plain version on the host) and tail prefill paths."""
    import torch

    from scalerl_torch.models.transformer import (
        init_paged_kv_cache,
        prompt_attention_mask,
        sequence_attention_mask,
        sequence_positions,
    )
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    gpu = _gen_model("cuda", seed=1)
    gpu.paged_attn_fn = cuda_paged_attention.paged_decode_attention
    cpu = _gen_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(3)
    A, P, ps, M = 4, GEN_P, GEN_PAGE, GEN_PAGES_PER_LANE
    N = A * M + 1
    lengths = np.array([P, P * 3 // 5, P // 8 + 1, 2], np.int32)
    tokens = rng.integers(2, GEN_V, size=(A, P)).astype(np.int32)
    order = rng.permutation(np.arange(1, N)).astype(np.int32)  # fragmented pages
    table = order.reshape(A, M)
    pos = np.arange(P)
    page_ids = np.where(pos[None] < lengths[:, None], table[:, pos // ps], 0).astype(np.int32)
    offsets = np.where(pos[None] < lengths[:, None], pos % ps, 0).astype(np.int32)
    head_dim = GEN_D // GEN_HEADS

    def run(model, dev):
        t = dict(tokens=tokens, lengths=lengths, table=table, page_ids=page_ids, offsets=offsets)
        t = {k: torch.as_tensor(v).to(dev) for k, v in t.items()}
        out = {}
        with torch.no_grad():
            S = P
            mask = sequence_attention_mask(t["lengths"], S, S)
            o = model(t["tokens"], positions=sequence_positions(t["lengths"], S, S), attn_mask=mask)
            out["masked"] = (o.policy_logits, o.baseline)
            pools = init_paged_kv_cache(N, ps, GEN_LAYERS, GEN_HEADS, head_dim, device=dev)
            o, _ = model(t["tokens"], positions=torch.arange(P, device=dev).expand(A, P),
                         attn_mask=prompt_attention_mask(t["lengths"], P), paged_cache=pools,
                         page_ids=t["page_ids"], page_offsets=t["offsets"])
            out["paged_prefill"] = (o.policy_logits, o.baseline)
            # one decode token at each lane's cursor, through the table
            cl = t["lengths"].clone()
            tok = t["tokens"][:, :1].clone()
            pid = t["table"].gather(1, (cl // ps).long()[:, None])
            o, _ = model(tok, positions=cl[:, None], paged_cache=pools, page_ids=pid,
                         page_offsets=(cl % ps)[:, None], page_table=t["table"],
                         attn_lengths=cl + 1)
            out["paged_decode"] = (o.policy_logits, o.baseline)
            # tail prefill: the last 5 prompt tokens again, on top of the
            # prefix before them in the pool
            T = 5
            starts = (t["lengths"] - T).clamp(min=0)
            gpos = starts[:, None] + torch.arange(T, device=dev)[None, :]
            toks = t["tokens"].gather(1, gpos.long())
            o, _ = model(toks, positions=gpos, paged_cache=pools,
                         page_ids=t["table"].gather(1, (gpos // ps).long()),
                         page_offsets=gpos % ps, page_table=t["table"], prefix_starts=starts)
            out["tail_prefill"] = (o.policy_logits, o.baseline)
            out["pools"] = torch.cat([torch.stack(pools.k)[:, 1:].reshape(-1),
                                      torch.stack(pools.v)[:, 1:].reshape(-1)])
        return out

    launches0 = cuda_paged_attention.launches
    want, got = run(cpu, "cpu"), run(gpu, "cuda")
    kernel_calls = cuda_paged_attention.launches - launches0
    errs = {}
    for path in ("masked", "paged_prefill", "paged_decode", "tail_prefill"):
        errs[path] = max((g.cpu() - w).abs().max().item() for g, w in zip(got[path], want[path]))
    errs["pools"] = (got["pools"].cpu() - want["pools"]).abs().max().item()
    emit("genrl_model", tol=GEN_MODEL_TOL, max_abs_err=errs, kernel_calls=kernel_calls,
         d_model=GEN_D, heads=GEN_HEADS, layers=GEN_LAYERS, vocab=GEN_V, tf32=False)
    if kernel_calls != GEN_LAYERS:
        raise AssertionError(f"paged decode ran the kernel {kernel_calls} times, want {GEN_LAYERS}")
    bad = {k: v for k, v in errs.items() if not v <= GEN_MODEL_TOL}
    if bad:
        raise AssertionError(f"model card vs host off tolerance: {bad}")


def _prompts(rng, n):
    lengths = rng.integers(2, GEN_P + 1, size=n).astype(np.int32)
    prompts = rng.integers(2, GEN_V, size=(n, GEN_P)).astype(np.int32)
    return prompts, lengths


def phase_genrl_decode(report: dict) -> None:
    """One full-shape macro step from the same state and generator seed:
    through the kernel and through the plain version, on the card."""
    import torch

    from scalerl_torch.genrl import continuous
    from scalerl_torch.genrl.continuous import ContinuousEngine
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    model = _gen_model("cuda")
    params = model.state_dict()
    prompts, lengths = _prompts(np.random.default_rng(5), GEN_LANES)
    out = {}
    for impl in ("pallas", "xla"):
        eng = ContinuousEngine(model, params, _gen_config(paged_attn=impl))
        for i in range(GEN_LANES):
            eng.submit(prompts[i], lengths[i])
        launches0 = cuda_paged_attention.launches
        eng._admit()
        eng._ensure_pages()
        p, gen = eng._snapshot_params()
        with torch.no_grad():
            (table,) = continuous._device_put((eng._table,), eng.device)
            packed = eng._decode_macro(p, gen, table)
        host = eng._unpack(continuous._device_get(packed))
        out[impl] = dict(host=host, logits=eng._logits_st.cpu(), live=eng.live_lanes,
                         pools=torch.cat([torch.stack(eng._pools.k)[:, 1:].reshape(-1),
                                          torch.stack(eng._pools.v)[:, 1:].reshape(-1)]).cpu(),
                         launches=cuda_paged_attention.launches - launches0)
        del eng
    k, p = out["pallas"], out["xla"]
    mismatches = {f: int((k["host"][f] != p["host"][f]).sum())
                  for f in ("tokens", "mask", "cl", "done", "resp")}
    errs = {
        "logp": float(np.abs(k["host"]["logp"] - p["host"]["logp"]).max()),
        "value": float(np.abs(k["host"]["value"] - p["host"]["value"]).max()),
        "logits": (k["logits"] - p["logits"]).abs().max().item(),
        "pools": (k["pools"] - p["pools"]).abs().max().item(),
    }
    emit("genrl_decode", lanes=GEN_LANES, live_lanes=k["live"], steps=GEN_MACRO,
         mismatches=mismatches, max_abs_err=errs, tol=GEN_DECODE_TOL, kernel_launches=k["launches"],
         plain_launches=p["launches"], tf32=False)
    if any(mismatches.values()) or any(not v <= GEN_DECODE_TOL for v in errs.values()):
        raise AssertionError(f"macro step kernel vs plain: {mismatches}, {errs}")
    if k["launches"] != GEN_MACRO * GEN_LAYERS or p["launches"] != 0:
        raise AssertionError(f"launches {k['launches']} / {p['launches']}")


def phase_genrl_continuous(report: dict) -> None:
    """The main path as bench.py's genrl-continuous mode sets it up: the
    cohort engine, then the continuous engine under Poisson arrivals at
    twice the cohort's completion rate, then the temperature-0 identity of
    the two engines at full width, then a profile."""
    import torch

    from scalerl_torch.genrl.continuous import ContinuousEngine
    from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    model = _gen_model("cuda")
    params = model.state_dict()
    rng = np.random.default_rng(0)
    base = dict(vocab_size=GEN_V, max_prompt_len=GEN_P, max_new_tokens=GEN_R, temperature=1.0,
                eos_token=1, seed=0)
    cohort = GenerationEngine(model, params, GenerationConfig(**base))
    cohort.generate(*_prompts(rng, GEN_LANES))  # warm-up round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cohort_tokens = cohort_rounds = 0
    while time.perf_counter() - t0 < GEN_TARGET_S or cohort_rounds < 2:
        cohort_tokens += cohort.generate(*_prompts(rng, GEN_LANES)).decode_tokens
        cohort_rounds += 1
    cohort_s = time.perf_counter() - t0
    cohort_seq_per_s = cohort_rounds * GEN_LANES / cohort_s

    engine = ContinuousEngine(model, params, _gen_config())
    rate = 2.0 * cohort_seq_per_s
    t_warm = time.perf_counter()
    prompts, lengths = _prompts(rng, 6 * GEN_LANES)  # six lane-fills
    for i in range(len(lengths)):
        engine.submit(prompts[i], lengths[i])
    while engine.live_lanes or engine.pending or engine._inflight:
        engine.step()
    warm_s = time.perf_counter() - t_warm

    clock = {"t0": time.perf_counter()}
    clock["next"] = rng.exponential(1.0 / rate)

    def cycle():
        """Submit the arrivals that are due, then one engine step."""
        now = time.perf_counter() - clock["t0"]
        n_new = 0
        while clock["next"] <= now:
            n_new += 1
            clock["next"] += rng.exponential(1.0 / rate)
        if n_new:
            prompts, lengths = _prompts(rng, n_new)
            for i in range(n_new):
                engine.submit(prompts[i], lengths[i])
        if engine.live_lanes == 0 and engine.pending == 0:
            return []  # idle until the next arrival lands
        return engine.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_paged_attention.launches = 0
    occ0, macro0 = engine._occupancy_sum, engine.macro_steps
    saved0 = engine.prefix_tokens_saved
    done = []
    t0 = clock["t0"] = time.perf_counter()
    while time.perf_counter() - t0 < GEN_TARGET_S or len(done) < 2:
        done.extend(cycle())
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    launches = cuda_paged_attention.launches
    macros = engine.macro_steps - macro0
    occupancy = (engine._occupancy_sum - occ0) / max(macros, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    window = list(done)
    cont_tokens = sum(len(c.response_tokens) for c in window)
    report["launches"]["paged_attention"] = launches
    macro_s = cont_s / max(macros, 1)

    # where the time goes: more macro steps of the same traffic (arrivals
    # timed from each window's own start) under torch.profiler, against the
    # unprofiled macro step time above; then the host's side under cProfile
    def more_cycles(k=8):
        clock["t0"] = time.perf_counter()
        clock["next"] = rng.exponential(1.0 / rate)
        for _ in range(k):
            done.extend(cycle())

    macro1 = engine.macro_steps
    profiled_s, kernels = profile_device(more_cycles)
    pmacros = max(engine.macro_steps - macro1, 1)
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / pmacros
    paged_us = sum(us for k, us, _ in kernels if "paged_decode" in k) / pmacros
    macro1 = engine.macro_steps
    host_s, host_top = profile_host(more_cycles)
    hmacros = max(engine.macro_steps - macro1, 1)

    while engine.live_lanes or engine.pending or engine._inflight:  # drain
        done.extend(engine.step())
    lat = np.array([c.admit_time - c.submit_time for c in window]) * 1e3
    lens = [len(c.response_tokens) for c in done]
    tokens_ok = all(((c.response_tokens >= 0) & (c.response_tokens < GEN_V)).all() for c in done)
    logp_ok = all(np.isfinite(c.behavior_logp).all() for c in done)
    emit("genrl_continuous", lanes=GEN_LANES, page_size=GEN_PAGE, steps_per_macro=GEN_MACRO,
         min_free_lanes=GEN_MIN_FREE, vocab=GEN_V, d_model=GEN_D, layers=GEN_LAYERS,
         prompt_max=GEN_P, response_budget=GEN_R, pages_capacity=engine.allocator.capacity,
         decode_tokens_per_s=cont_tokens / cont_s,
         cohort_decode_tokens_per_s=cohort_tokens / cohort_s,
         speedup_vs_cohort=(cont_tokens / cont_s) / max(cohort_tokens / cohort_s, 1e-9),
         cohort_rounds=cohort_rounds, cohort_s=cohort_s, arrival_rate_per_s=rate,
         warmup_s=warm_s, seconds=cont_s, macro_steps=macros, macro_step_ms=macro_s * 1e3,
         lane_occupancy_mean=occupancy,
         admission_latency_ms={f"p{q}": float(np.percentile(lat, q)) for q in (50, 95, 99)},
         completed_in_window=len(window), completed_total=len(done),
         prefix_tokens_saved=engine.prefix_tokens_saved - saved0,
         kernel_launches=launches, response_len_max=max(lens),
         response_len_mean=float(np.mean(lens)), reserved_after_drain=engine.allocator.reserved,
         shed_total=engine._batcher.shed_total, peak_mem_gib=peak, card=report["card"])
    emit("genrl_profile", macro_steps=pmacros, unprofiled_macro_step_s=macro_s,
         profiled_macro_step_s=profiled_s / pmacros,
         device_busy_s_per_macro_step=busy_s if kernels else None,
         device_busy_share=busy_s / macro_s if kernels else None,
         kernel_launches_per_macro_step=sum(n for _, _, n in kernels) / pmacros,
         paged_kernel_us_per_macro_step=paged_us,
         paged_kernel_share_of_device=paged_us / 1e6 / busy_s if kernels else None,
         top_kernels=[{"name": k[:90], "us_per_macro_step": us / pmacros,
                       "calls_per_macro_step": n / pmacros} for k, us, n in kernels[:12]],
         cprofile_macro_step_s=host_s / hmacros,
         host_top=[{"function": f, "cumulative_ms_per_macro_step": ct / hmacros * 1e3,
                    "calls_per_macro_step": n / hmacros} for f, ct, n in host_top],
         card=report["card"])
    if launches != GEN_MACRO * GEN_LAYERS * macros or macros == 0:
        raise AssertionError(f"paged kernel launches {launches} for {macros} macro steps")
    if max(lens) > GEN_R or not tokens_ok or not logp_ok or engine.allocator.reserved != 0:
        raise AssertionError(f"bad completions: max len {max(lens)}, tokens in vocab {tokens_ok}, "
                             f"finite logp {logp_ok}, reserved {engine.allocator.reserved}")
    del engine

    # temperature 0 at full width: the continuous engine (paged kernel)
    # token-identical to the cohort engine (dense masked attention)
    n = 8
    prompts, lengths = _prompts(np.random.default_rng(9), n)
    greedy = dict(base, temperature=0.0)
    ref = GenerationEngine(model, params, GenerationConfig(**greedy)).generate(prompts, lengths)
    eng0 = ContinuousEngine(model, params, _gen_config(temperature=0.0))
    for i in range(n):
        eng0.submit(prompts[i], lengths[i])
    by_prompt = {tuple(c.prompt.tolist()): c for c in eng0.run_until(n)}
    mismatched, logp_err, value_err = 0, 0.0, 0.0
    for i in range(n):
        c = by_prompt[tuple(prompts[i, :lengths[i]].tolist())]
        r = int(ref.response_len[i])
        same = len(c.response_tokens) == r and np.array_equal(c.response_tokens,
                                                               ref.response_tokens[i, :r])
        mismatched += int(not same)
        if same:
            logp_err = max(logp_err, float(np.abs(c.behavior_logp - ref.behavior_logp[i, :r]).max()))
            value_err = max(value_err, float(np.abs(c.values - ref.values[i, :r]).max()))
    emit("genrl_identity", prompts=n, response_lens=[int(x) for x in ref.response_len],
         mismatched_sequences=mismatched, logp_max_abs_err=logp_err, value_max_abs_err=value_err,
         tol=GEN_IDENTITY_LOGP_TOL)
    if mismatched or not logp_err <= GEN_IDENTITY_LOGP_TOL:
        raise AssertionError(f"temperature-0 identity: {mismatched} sequences differ, logp {logp_err}")


PHASES = [phase_device, phase_build, phase_vtrace, phase_model, phase_impala_learn,
          phase_impala_fused, phase_per_kernels, phase_dqn_learn, phase_dqn_per,
          phase_paged_attn, phase_genrl_model, phase_genrl_decode, phase_genrl_continuous]


def main() -> int:
    report: dict = {}
    for phase in PHASES:
        name = phase.__name__[len("phase_"):]
        try:
            phase(report)
        except Exception as exc:  # noqa: BLE001 — report the phase and fail
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(exc).__name__}: {exc}")
            return 1
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "scalerl_tpu"))
    if leaked:
        emit("isolation", ok=False, error=f"imported {leaked}")
        return 1

    import torch

    # (name, source, the TPU kernel it replaces); library_ms is null where
    # no single PyTorch call computes the same function (the paged kernel's
    # is gather + scaled_dot_product_attention, timed in phase_paged_attn)
    kernels = [
        ("vtrace", "scalerl_torch/csrc/vtrace.cu", "scalerl_tpu/ops/pallas_vtrace.py:36"),
        ("per_sample", "scalerl_torch/csrc/per.cu", "scalerl_tpu/ops/pallas_per.py:66"),
        ("per_update", "scalerl_torch/csrc/per.cu", "scalerl_tpu/ops/pallas_per.py:225"),
        ("paged_attention", "scalerl_torch/csrc/paged_attention.cu",
         "scalerl_tpu/ops/pallas_paged_attention.py:108"),
    ]
    print(report["card"], flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": report["launches"][name],
        "max_abs_err": report[name]["max_abs_err"],
        "ms": report[name]["ms"],
        "plain_ms": report[name]["plain_ms"],
        "bound_ms": report[name]["bound_ms"],
        "bound_by": report[name]["bound_by"],
        "library_ms": report[name].get("library_ms"),
    } for name, source, replaces in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
