#!/usr/bin/env python3
"""The port's V-trace kernel against an earlier version of its source, on
one GPU.

    python3 tools/vtrace_study.py --old OLD.cu [--old-wrapper OLD.py] [--variants a,b]

Builds ``scalerl_torch/csrc/vtrace.cu`` as it stands, variants of it that
change one design choice each (``VARIANTS``), and an earlier version
(``--old``, e.g. taken with ``git show <commit>:scalerl_torch/csrc/vtrace.cu``;
the launch signature of ``vtrace_launch`` is unchanged), all with the
build's own nvcc flags, and reports each build's registers, shared memory
and spills per kernel instantiation, with the CTAs an SM can hold.  Then:

1. ``bits``: every build against the old one, bit for bit (NaN payloads
   included), on every shape below and ``(1, 1)``, ``(37, 5)``,
   ``(70, 1001)``, ``(70, 33)``, for three clip settings, with and without
   NaN log-rhos, and with planes offset by one float (not 16-byte aligned).
2. ``time``: each build in turns with this source (this, other, other,
   this) by CUDA-graph replay (``chip_smoke.gpu_time_ms``) and eagerly
   (``chip_smoke.eager_time_ms``, through ``ops/cuda_vtrace.py``; for the
   old source through ``--old-wrapper``, e.g. ``git show
   <commit>:scalerl_torch/ops/cuda_vtrace.py``, when given), at the fused
   loop's [20, 512], ImpalaArguments' defaults [80, 8], the transformer
   learner's [16, 8], the bandwidth probe [80, 4096] and [1000, 512], a
   walk of 8 chunks, beside each shape's bytes bound and the replay floor
   of a one-element op.
3. ``host``: the wrapper's eager path at [20, 512] piece by piece on the
   host clock (the validation, the outputs' allocation three ways, the
   device and stream lookups, the bare ctypes launch, the whole wrapper),
   beside one eager one-element op.

One JSON line per reading on stdout.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what it changes, [(text in csrc/vtrace.cu, replacement)])
VARIANTS = {
    "width_16": ("tiles of 16 columns, chunks of 64 rows (8 and 128 in the source)",
                 [("constexpr int kWidth = 8;", "constexpr int kWidth = 16;")]),
    "width_32": ("tiles of 32 columns, one 128-byte row segment, chunks of 32 rows",
                 [("constexpr int kWidth = 8;", "constexpr int kWidth = 32;")]),
    "chunk_512": ("chunks of 512 elements, 64 rows (1,024 and 128 in the source)",
                  [("constexpr int kChunkElems = 1024;", "constexpr int kChunkElems = 512;")]),
    "plain_loads": ("the chunks copied through registers by plain loads, not cp.async",
                    [("constexpr bool kAsyncCopy = true;", "constexpr bool kAsyncCopy = false;")]),
    "single_buffer": ("one stage: a chunk is copied only after the one before it is done",
                      [("constexpr int kStages = 2;", "constexpr int kStages = 1;")]),
    "recursion_scalar": ("the recursion one row at a time (a load of each array and a store "
                         "a row), unrolled 4, not four rows in 16-byte accesses",
                         [("            for (int t = top - 4; t >= 0; t -= 4) {  // rows t + 3,",
                           "#pragma unroll 4\n            for (int t = top - 1; t >= 0; --t) {\n"
                           "                acc = add(delta[tid][t], mul(dc[tid][t], acc));\n"
                           "                delta[tid][t] = acc;\n            }\n"
                           "            for (int t = -4; t >= 0; t -= 4) {  // rows t + 3,")]),
    "threads_128": ("128 threads a CTA (256 in the source)",
                    [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    "passes_unrolled": ("the elementwise and output loops unrolled by 2 (rolled in the source)",
                        [("        for (int g = tid; g < n * G; g += kThreads) {",
                          "#pragma unroll 2\n        for (int g = tid; g < n * G; g += kThreads) {")]),
    # timing probes: they skip work, compute nothing right and are not held to the old source
    "probe_empty": ("timing probe: every CTA returns at once",
                    [("    const int tid = threadIdx.x;\n", "    if (T > 0) return;\n    const int tid = threadIdx.x;\n")]),
    "probe_copy_only": ("timing probe: the copies and barriers, no pass",
                        [("        for (int g = tid; g < n * G; g += kThreads) {", "        for (int g = tid; g < 0; g += kThreads) {"),
                         ("        if (tid < W) {\n            float4 de = ", "        if (false) {\n            float4 de = ")]),
    "probe_no_recursion": ("timing probe: no recursion",
                           [("        if (tid < W) {\n            float4 de = ", "        if (false) {\n            float4 de = ")]),
    "probe_no_elementwise": ("timing probe: no elementwise pass",
                             [("        for (int g = tid; g < n * G; g += kThreads) {\n            const int t = g / G, jb = (g % G) * V;\n            float x[V]",
                               "        for (int g = tid; g < 0; g += kThreads) {\n            const int t = g / G, jb = (g % G) * V;\n            float x[V]")]),
    "probe_no_output": ("timing probe: no output pass (nothing stored)",
                        [("        for (int g = tid; g < n * G; g += kThreads) {\n            const int t = g / G, jb = (g % G) * V;\n            float at[V]",
                          "        for (int g = tid; g < 0; g += kThreads) {\n            const int t = g / G, jb = (g % G) * V;\n            float at[V]")]),
}

TIMED = {"fused_loop": (20, 512), "impala_defaults": (80, 8), "transformer_learner": (16, 8),
         "bandwidth_probe": (80, 4096), "long_T": (1000, 512)}
CHECKED = [*TIMED.values(), (1, 1), (37, 5), (70, 1001), (70, 33)]
CLIPS = {
    "default": {},
    "rho2_c1.5": {"clip_rho_threshold": 2.0, "clip_c_threshold": 1.5},
    "no_rho_clip": {"clip_rho_threshold": None, "clip_pg_rho_threshold": None},
}
SM_SHARED_BYTES = 233472  # 228 KB an SM, of which each CTA also takes 1 KB
SM_THREADS, SM_REGISTERS = 2048, 65536


def _ptxas(log: str) -> dict:
    """{kernel: {registers, smem_bytes}} from ptxas -v's lines."""
    import chip_smoke as cs

    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = cs._vtrace_kernel_name(ln.split("Function properties for", 1)[1].strip())
        elif name and "Used" in ln and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = {"registers": int(re.search(r"Used (\d+) registers", ln).group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0}
            name = None
    return out


def _ctas_per_sm(registers: int, smem: int, threads: int) -> int:
    regs = -(-registers // 8) * 8 * threads  # allocated by 256 a warp
    return min(SM_THREADS // threads, SM_REGISTERS // regs, SM_SHARED_BYTES // (smem + 1024))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="an earlier vtrace.cu")
    ap.add_argument("--old-wrapper", type=Path,
                    help="the earlier ops/cuda_vtrace.py, for the old source's eager time")
    ap.add_argument("--variants", help="a comma-separated subset of VARIANTS (none: no variant)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")

    def emit(kind, **fields):
        print(json.dumps({"study": kind, **fields}), flush=True)

    report = {"launches": {}}
    cs.phase_device(report)
    build_dir = cuda_build.BUILD_DIR / "study"
    build_dir.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC_DIR / "vtrace.cu").read_text()
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
        cu, so = build_dir / f"vtrace_{name}.cu", build_dir / f"libvtrace_{name}.so"
        cu.write_text(body)
        running[name] = (so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    launchers = {}
    for name, (so, proc) in running.items():
        out, _ = proc.communicate(timeout=cuda_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {name}: exit {proc.returncode}\n{out[-2000:]}")
        threads = 128 if name == "threads_128" else 256
        kernels = {k: {**v, "ctas_per_sm": _ctas_per_sm(v["registers"], v["smem_bytes"], threads)}
                   for k, v in _ptxas(out).items()}
        emit("build", name=name, kernels=kernels, spills=cs._spills(out))
        fn = ctypes.CDLL(str(so)).vtrace_launch
        fn.argtypes = cuda_vtrace._ARGTYPES
        fn.restype = ctypes.c_int
        launchers[name] = fn

    old_wrapper = None
    if args.old_wrapper:
        spec = importlib.util.spec_from_file_location("old_cuda_vtrace", args.old_wrapper)
        old_wrapper = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old_wrapper)
        cuda_build._loaded["vtrace"] = ctypes.CDLL(str(running["old"][0]))
        old_wrapper._launcher().argtypes = cuda_vtrace._ARGTYPES  # its own types, set at first use

    def launch(name, inp, clip):
        """One direct launch of a build's vtrace_launch on fresh outputs."""
        T, B = inp["log_rhos"].shape
        vs, pg = torch.empty((2, T, B), device="cuda")
        rho, pg_rho = clip.get("clip_rho_threshold", 1.0), clip.get("clip_pg_rho_threshold", 1.0)
        err = launchers[name](*(x.data_ptr() for x in inp.values()), vs.data_ptr(), pg.data_ptr(),
                              T, B, float(rho or 0.0), rho is not None, float(pg_rho or 0.0),
                              pg_rho is not None, float(clip.get("clip_c_threshold", 1.0)),
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: cudaError {err}")
        return vs, pg

    def offset(inp):
        """The same values in planes one float past a 16-byte boundary."""
        out = {}
        for k, x in inp.items():
            buf = torch.empty(x.numel() + 1, device="cuda")
            buf[1:] = x.reshape(-1)
            out[k] = buf[1:].view(x.shape)
        return out

    # 1. bit for bit against the old source
    for name in launchers:
        if name == "old" or name.startswith("probe_"):
            continue
        mismatches, cases = [], 0
        for T, B in CHECKED:
            for nan_share in (0.0, 0.02):
                base = cs._vtrace_inputs(T, B, seed=T * 1000 + B, device="cuda",
                                         nan_share=nan_share)
                for inp, aligned in ((base, True), (offset(base), False)):
                    for clip_name, clip in CLIPS.items():
                        got, want = launch(name, inp, clip), launch("old", inp, clip)
                        cases += 1
                        if not all(cs._bits_equal(x, y) for x, y in zip(got, want)):
                            mismatches.append([T, B, nan_share, aligned, clip_name])
        emit("bits", name=name, against="old", cases=cases, mismatches=mismatches)
        if mismatches:
            raise AssertionError(f"{name} differs from the old source: {mismatches}")

    # 2. times in turns
    def use(name):
        cuda_vtrace._launch = launchers[name]
        return (old_wrapper.vtrace_from_importance_weights_kernel
                if name == "old" and old_wrapper else cuda_vtrace.vtrace_from_importance_weights_kernel)

    one = torch.zeros(1, device="cuda")
    emit("floor", replay_us=1e3 * cs.gpu_time_ms(lambda: one.add_(1.0), 200),
         eager_us=1e3 * cs.eager_time_ms(lambda: one.add_(1.0), 200), card=report["card"])
    for shape_name, (T, B) in TIMED.items():
        inp = cs._vtrace_inputs(T, B, seed=0, device="cuda")
        bound = cs._vtrace_bound(inp)
        for other in (n for n in launchers if n != "this"):
            seq = []
            for name in ("this", other, other, "this"):
                fn = use(name)
                call = lambda: fn(**inp)  # noqa: E731
                seq.append([name, {"replay_us": 1e3 * cs.gpu_time_ms(call, 200),
                                   "eager_us": 1e3 * cs.eager_time_ms(call, 200)}])
            use("this")
            emit("time", shape=shape_name, T=T, B=B, against=other,
                 bound_us=1e3 * bound["bound_ms"], bound_by=bound["bound_by"], us=seq)

    # 3. the eager path's pieces at the fused loop's shape
    T, B = TIMED["fused_loop"]
    inp = cs._vtrace_inputs(T, B, seed=0, device="cuda")
    planes = tuple(inp.values())
    vs, pg = torch.empty((2, T, B), device="cuda")
    bare = (*(x.data_ptr() for x in planes), vs.data_ptr(), pg.data_ptr(), T, B,
            1.0, True, 1.0, True, 1.0, torch.cuda.current_stream().cuda_stream)
    fn = launchers["this"]
    pieces = {
        "one_element_op": lambda: one.add_(1.0),
        "check_inputs": lambda: cuda_vtrace._check_inputs(*planes),
        "two_empty": lambda: (torch.empty((T, B), device="cuda"),
                              torch.empty((T, B), device="cuda")),
        "two_empty_like": lambda: (torch.empty_like(planes[0]), torch.empty_like(planes[0])),
        "one_empty_unbind": lambda: torch.empty((2, T, B), device="cuda").unbind(),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(vs.device).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "bare_launch": lambda: fn(*bare),
        "wrapper": lambda: cuda_vtrace.vtrace_from_importance_weights_kernel(**inp),
    }
    for name, call in pieces.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                call()
            runs.append((time.perf_counter() - t0) / 500 * 1e6)
        torch.cuda.synchronize()
        emit("host", piece=name, us=sorted(runs)[2], runs_us=runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
