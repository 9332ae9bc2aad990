#!/usr/bin/env python3
"""The port's prioritized-replay kernels against an earlier version of
their source, on one GPU.

    python3 tools/per_study.py --old OLD.cu [--variants a,b]

Builds ``scalerl_torch/csrc/per.cu`` as it stands, variants of it that
change one design choice each (``VARIANTS``; some are timing probes that
skip work and compute nothing right), and an earlier version
(``--old``, e.g. taken with ``git show <commit>:scalerl_torch/csrc/per.cu``;
its launch signatures are those before the sample took both phases: a
phase-2 kernel over ``split_targets``' blocks and residuals, and an update
with a 64-bit ``n``), all with the build's own nvcc flags, and reports each
build's registers and spills per kernel.  Then, each in turns (this source,
the other, the other, this source) on one card, by CUDA-graph replay
(``chip_smoke.gpu_time_ms``) and eagerly (``chip_smoke.eager_time_ms``):

1. ``sample``: the whole sample function at N = 2^20, S = 512 on
   ``uniform**0.6`` priorities (the old source: ``ops/per.py::split_targets``
   in PyTorch, then its kernel), and the old phase-2 kernel alone.
2. ``update``: the update at M = 512 (``chip_smoke._update_case``), plane
   only and with block sums.
3. ``dqn_sequence`` (the old source only): the DQN learn step's
   prioritized sample and priority update (``per_sample_from_uniforms`` and
   ``per_update_priorities`` at ``chip_smoke.py``'s 65,536 x 16 replay,
   batch 512) captured in one CUDA graph, and its kernel launches under
   ``torch.profiler``.

Beside them the replay floor of a one-element PyTorch op.  One JSON line
per reading on stdout.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what it changes, [(text in csrc/per.cu, replacement)])
VARIANTS = {
    "table_load_4": ("the update's tables at least 4 entries a key (2 in the source)",
                     [("    while ((1 << bits) < 2 * M) ++bits;", "    while ((1 << bits) < 4 * M) ++bits;")]),
    "grid_by_32": ("the update over ceil(M / 32) CTAs (M / 8 in the source)",
                   [("    const int grid = (M + kWarps - 1) / kWarps < kMaxUpdateGrid ? (M + kWarps - 1) / kWarps\n"
                     "                                                                 : kMaxUpdateGrid;",
                     "    const int grid = (M + 31) / 32;")]),
    "overlap_launch": ("the search launched with programmatic dependent launch: its CTAs "
                       "start once every block-sum CTA has begun, and wait for the block sums "
                       "in griddepcontrol.wait",
                       [("    const int lane = threadIdx.x & 31;\n"
                         "    const long long b = static_cast<long long>(blockIdx.x) * kWarps",
                         "    asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n"
                         "    const int lane = threadIdx.x & 31;\n"
                         "    const long long b = static_cast<long long>(blockIdx.x) * kWarps"),
                        ("    const float t = active ? targets[s] : 0.0f;\n",
                         "    const float t = active ? targets[s] : 0.0f;\n"
                         "    asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"),
                        ("    per_search_kernel<<<(S + kWarps - 1) / kWarps, kThreads, 0, st>>>("
                         "p, sums, targets, n, bs, nb,\n"
                         "                                                                      S, out);\n"
                         "    return static_cast<int>(cudaGetLastError());",
                         "    cudaLaunchAttribute overlap[1];\n"
                         "    overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
                         "    overlap[0].val.programmaticStreamSerializationAllowed = 1;\n"
                         "    cudaLaunchConfig_t config = {};\n"
                         "    config.gridDim = dim3((S + kWarps - 1) / kWarps);\n"
                         "    config.blockDim = dim3(kThreads);\n"
                         "    config.stream = st;\n"
                         "    config.attrs = overlap;\n"
                         "    config.numAttrs = 1;\n"
                         "    return static_cast<int>(cudaLaunchKernelEx(\n"
                         "        &config, per_search_kernel, p, static_cast<const float*>(sums), "
                         "targets, n, bs, nb, S, out));")]),
    "resum_none": ("timing probe: with sums, the tables built but no block re-summed",
                   [("    if (!with_sums) return;\n", "    if (true) return;\n")]),
    "no_inserts": ("timing probe: the tables cleared but nothing inserted (no update written)",
                   [("        atomicMax(&slot_last[table_insert(", "        if (false) atomicMax(&slot_last[table_insert(")]),
    "sums_kernel_only": ("timing probe: the sample launches only its block-sum kernel",
                         [("    if (err != cudaSuccess) return static_cast<int>(err);\n"
                           "    per_search_kernel",
                           "    if (err != cudaSuccess || true) return static_cast<int>(err);\n"
                           "    per_search_kernel")]),
    "search_kernel_only": ("timing probe: the sample launches only its search kernel "
                           "(over a scratch it did not fill)",
                           [("    per_block_sums_kernel<<<", "    if (false) per_block_sums_kernel<<<")]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="an earlier per.cu")
    ap.add_argument("--variants", help="a comma-separated subset of VARIANTS (none: no variant)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from scalerl_torch.data.prioritized import per_sample_from_uniforms, per_update_priorities
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.ops import cuda_per, per
    from scalerl_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")

    def emit(kind, **fields):
        print(json.dumps({"study": kind, **fields}), flush=True)

    report = {"launches": {}}
    cs.phase_device(report)
    build_dir = cuda_build.BUILD_DIR / "study"
    build_dir.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC_DIR / "per.cu").read_text()
    jobs = {"this": text, "old": args.old.read_text()}
    for name in filter(None, (args.variants or "").split(",")):
        what, subs = VARIANTS[name]
        if not all(a in text for a, _ in subs):
            emit("skipped", name=name, reason="its text is not in the source")
            continue
        variant = text
        for a, b in subs:
            variant = variant.replace(a, b)
        emit("variant", name=name, changes=what)
        jobs[name] = variant
    running = {}
    for name, body in jobs.items():  # one nvcc each, all at once
        cu, so = build_dir / f"per_{name}.cu", build_dir / f"libper_{name}.so"
        cu.write_text(body)
        running[name] = (so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in running.items():
        out, _ = proc.communicate(timeout=cuda_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {name}: exit {proc.returncode}\n{out[-2000:]}")
        emit("build", name=name, registers=cs._registers(out, cs._per_kernel_name),
             spills=cs._spills(out))
        libs[name] = ctypes.CDLL(str(so))
    old = libs.pop("old")
    ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old.per_sample_launch.argtypes = [ptr, ptr, ptr, c_ll, c_int, c_int, ptr, ptr]
    old.per_sample_launch.restype = c_int
    old.per_update_launch.argtypes = [ptr, ptr, ptr, ptr, c_int, c_ll, c_int, ptr]
    old.per_update_launch.restype = c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_phase2(flat_p, b_idx, within_t, block_size=cs.PER_BLOCK):
        out = torch.empty(b_idx.shape[0], dtype=torch.int64, device=flat_p.device)
        err = old.per_sample_launch(flat_p.data_ptr(), b_idx.data_ptr(), within_t.data_ptr(),
                                    flat_p.shape[0], block_size, b_idx.shape[0], out.data_ptr(),
                                    stream())
        if err != 0:
            raise RuntimeError(f"old sample kernel launch failed: cudaError {err}")
        return out

    def old_sample(flat_p, targets, block_size=cs.PER_BLOCK):
        b_idx, within_t = per.split_targets(flat_p, targets, block_size)
        return old_phase2(flat_p, b_idx, within_t.contiguous(), block_size)

    def old_update(flat_p, idx, new_p, block_sums=None, block_size=cs.PER_BLOCK):
        idx = idx.to(torch.int64).contiguous()
        new_p = new_p.to(torch.float32).contiguous()
        err = old.per_update_launch(flat_p.data_ptr(),
                                    None if block_sums is None else block_sums.data_ptr(),
                                    idx.data_ptr(), new_p.data_ptr(), idx.shape[0],
                                    flat_p.shape[0], block_size, stream())
        if err != 0:
            raise RuntimeError(f"old update kernel launch failed: cudaError {err}")

    this_impl = (cuda_per.sample_kernel, cuda_per.update_kernel)

    def use(which):
        """The dispatch in ops/per.py looks both wrappers up at each call;
        a variant is this source's wrappers over its library."""
        cuda_build._loaded["per"] = libs["this" if which == "old" else which]
        cuda_per._lib()  # sets a fresh library's argument types
        cuda_per.sample_kernel, cuda_per.update_kernel = (
            (old_sample, old_update) if which == "old" else this_impl)

    def turns(measure, other="old"):
        seq = []
        for which in ("this", other, other, "this"):
            use(which)
            seq.append([which, measure(which)])
        use("this")
        return seq

    others = ["old", *(n for n in libs if n != "this")]
    use("this")

    cs.set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(5)
    one = torch.zeros(1, device="cuda")
    emit("floor", replay_us=1e3 * cs.gpu_time_ms(lambda: one.add_(1.0), 200),
         eager_us=1e3 * cs.eager_time_ms(lambda: one.add_(1.0), 200), card=report["card"])

    # 1. the sample at the DQN slice's shape
    n, S = 1 << 20, cs.PER_BATCH
    p = torch.rand(n, generator=g, device="cuda") ** 0.6
    targets = (torch.arange(S, device="cuda") + torch.rand(S, generator=g, device="cuda")) / S * p.sum()
    b_idx, within_t = per.split_targets(p, targets, cs.PER_BLOCK)
    within_t = within_t.contiguous()

    def sample_us(_):
        fn = cuda_per.sample_kernel
        return {"replay_us": 1e3 * cs.gpu_time_ms(lambda: fn(p, targets, cs.PER_BLOCK), 200),
                "eager_us": 1e3 * cs.eager_time_ms(lambda: fn(p, targets, cs.PER_BLOCK), 200)}

    emit("old_phase2_alone", replay_us=1e3 * cs.gpu_time_ms(
        lambda: old_phase2(p, b_idx, within_t), 200))
    for other in others:
        emit("sample", against=other, n=n, S=S,
             bound_us=(4 * n + 12 * S) / cs.H100_BYTES_PER_S * 1e6,
             us=turns(sample_us, other))

    # 2. the update at M = 512
    p0, idx, new_p = cs._update_case(n, g)
    for with_sums in (False, True):
        plane = p0.clone()
        sums = per.block_sums(p0, cs.PER_BLOCK) if with_sums else None

        def update_us(_):
            fn = cuda_per.update_kernel
            call = lambda: fn(plane, idx, new_p, sums, cs.PER_BLOCK)  # noqa: E731
            return {"replay_us": 1e3 * cs.gpu_time_ms(call, 200),
                    "eager_us": 1e3 * cs.eager_time_ms(call, 200)}

        for other in others:
            emit("update", against=other, n=n, M=idx.shape[0], sums=with_sums,
                 us=turns(update_us, other))

    # 3. the DQN learn step's sample and update, in one graph
    dargs = cs._dqn_args(use_pallas=True)
    sampler = Sampler((4,), cs.PER_CAPACITY, cs.PER_NUM_ENVS, use_per=True,
                      per_alpha=dargs.per_alpha, n_step=cs.PER_N_STEP, gamma=dargs.gamma,
                      use_pallas=True)
    state = sampler.buffer.state
    shape = (cs.PER_CAPACITY, cs.PER_NUM_ENVS)
    for v in state.replay.storage.values():
        v.copy_(torch.rand(v.shape, generator=g, device="cuda") < 0.05)
    state.priorities.copy_(torch.rand(shape, generator=g, device="cuda") * 2 + 0.05)
    # a full ring whose head has wrapped: the sample rolls the plane
    state = dataclasses.replace(state, replay=dataclasses.replace(
        state.replay, pos=12345, size=cs.PER_CAPACITY))
    u = torch.rand(S, generator=g, device="cuda")
    td = torch.rand(S, generator=g, device="cuda")

    def sequence():
        batch = per_sample_from_uniforms(state, u, dargs.per_alpha, dargs.per_beta,
                                         cs.PER_N_STEP, dargs.gamma, "pallas")
        per_update_priorities(state, batch["indices"], td + 1e-6, method="pallas")

    def sequence_us(_):
        _, kernels = cs.profile_device(sequence)
        return {"replay_us": 1e3 * cs.gpu_time_ms(sequence, 20),
                "eager_us": 1e3 * cs.eager_time_ms(sequence, 20),
                "launches": sum(c for _, _, c in kernels),
                "device_us": sum(us for _, us, _ in kernels)}

    emit("dqn_sequence", replay=list(shape), batch=S, us=turns(sequence_us))
    return 0


if __name__ == "__main__":
    sys.exit(main())
