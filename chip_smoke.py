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

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
VTRACE_OPS_PER_ELEMENT = 16  # exp, 3 clips, delta (4), recursion (3), vs (1), pg (4)
VTRACE_TOL = 1e-5
MODEL_TOL = 1e-4

MAIN_T, MAIN_B, MAIN_ITERS, MAIN_CHUNKS = 20, 512, 5, 10


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


def profile_chunks(loop, state, carry, chunk_s: float, card: str, chunks: int = 2) -> None:
    """Where the time goes: ``chunks`` more chunks (after the counted run)
    under ``torch.profiler``; the device's busy time per chunk against the
    unprofiled chunk time, and the kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(state, carry, num_calls=chunks)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0

    def device_us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = sorted(
        ((e.key, device_us(e), e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and device_us(e) > 0),
        key=lambda k: -k[1],
    )
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / chunks
    emit("impala_profile", chunks=chunks, unprofiled_chunk_s=chunk_s,
         profiled_chunk_s=profiled_s / chunks,
         device_busy_s_per_chunk=busy_s if kernels else None,
         device_busy_share=busy_s / chunk_s if kernels else None,
         kernel_launches_per_chunk=sum(n for _, _, n in kernels) / chunks,
         top_kernels=[{"name": k[:90], "ms_per_chunk": us / 1e3 / chunks,
                       "calls_per_chunk": n / chunks} for k, us, n in kernels[:12]],
         card=card)


PHASES = [phase_device, phase_build, phase_vtrace, phase_model, phase_impala_learn,
          phase_impala_fused]


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

    vt = report["vtrace"]
    print(report["card"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "vtrace",
        "route": "cuda",
        "source": "scalerl_torch/csrc/vtrace.cu",
        "replaces": "scalerl_tpu/ops/pallas_vtrace.py:36",
        "launches": report["launches"]["vtrace"],
        "max_abs_err": vt["max_abs_err"],
        "ms": vt["ms"],
        "plain_ms": vt["plain_ms"],
        "bound_ms": vt["bound_ms"],
        "bound_by": vt["bound_by"],
        "library_ms": None,  # no single PyTorch call computes V-trace
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
