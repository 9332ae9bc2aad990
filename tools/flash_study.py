#!/usr/bin/env python3
"""Design comparisons of the port's flash attention kernels on one GPU.

    python3 tools/flash_study.py [--other OLD.cu] [--seeds 8] [--variants a,b]

Builds ``scalerl_torch/csrc/flash_attention.cu`` as it stands, variants of
it that undo one design choice each (``VARIANTS``), and optionally another
version of the source (``--other``, e.g. one taken from an earlier commit
with ``git show <commit>:scalerl_torch/csrc/flash_attention.cu``), all with
the build's own nvcc flags, and swaps them in under the kernel wrappers of
``scalerl_torch/ops/cuda_flash_attention.py``.  Three comparisons, each in
turns (this source, the other, the other, this source) on one card:

1. ``kernel_times``: each kernel a variant changes (all six against
   ``--other``) alone, by CUDA-graph replay
   (``chip_smoke.gpu_time_ms``), at the learner's ``[8, 17, 16, 64]``
   views, ``[4, 256, 2, 64]``, by type ``[1, 4096, 8, 64]`` (bf16) or
   ``[2, 1024, 4, 64]`` (float32), and ``[2, 256, 4, 128]`` for
   ``--other`` and the variants at D = 128.  Each build reports ptxas's
   registers and spills and each kernel's instructions in its SASS
   (``cuobjdump -sass``).
2. ``learner_step_f32`` and ``learner_step_bf16``: the flash kernels'
   device time inside the transformer learner's learn step
   (``chip_smoke``'s sharded width; float32 as ``ImpalaArguments``
   defaults it, or ``bf16_params``) under ``torch.profiler``, this source
   against ``--other`` (both) and each variant, by the type of the kernels
   it changes.
3. ``learner_loss``: the float32 learner's loss and gradients through the
   flash kernels against the plain attention, relative as
   ``chip_smoke.py``'s ``transformer_learn`` holds them (the loss over
   max(|loss|, 1), each leaf's largest gradient error over its largest
   element), over seeds (the check's own seed pair first), for this
   source, the variants that change a float32 kernel and ``--other``.

One JSON line per reading on stdout.
A variant whose text no longer matches the source, or that does not build,
is reported and skipped.
Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

F32 = ("f32_forward", "f32_dq", "f32_dkv")
BF16 = ("bf16_forward", "bf16_dq", "bf16_dkv")
D128 = ((2, 256, 4, 128), False, 50)  # the JAX package's compiled-check shape

# name -> (what it undoes, [(text in the source, replacement)], kernels it
# changes, shapes it is timed at besides the learner's, T = 256 and the long one)
VARIANTS = {
    "dq_4_warps": ("the bf16 dq kernel with 4 warps (64 queries) a block",
                   [("constexpr int kDqWarps = 8;", "constexpr int kDqWarps = 4;")],
                   ("bf16_dq",), ()),
    "f32_8_warps": ("the float32 kernels with 8 warps a block (128-row tiles of the streamed "
                    "axis; the rings do not fit at D = 128)",
                    [("constexpr int kWarps = 4;\nconstexpr int kThreads = 32 * kWarps;",
                      "constexpr int kWarps = 8;\nconstexpr int kThreads = 32 * kWarps;"),
                     ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
                    F32, ()),
    "fwd32_reciprocal": ("the float32 forward multiplying o by one rounded 1 / sum a row",
                         [("        den_s[row] = denom;", "        den_s[row] = 1.0f / denom;"),
                          ("= x / den_s[row];", "= x * den_s[row];")],
                         ("f32_forward",), ()),
    "dkv32_two_passes": ("float32 dk/dv computing S^T and dP^T in two passes over D (the way "
                         "out of an 8-byte spill at DP = 128 while the kernels were unrolled "
                         "wholly)",
                         [("            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);\n"
                           "            const float(&st)",
                           "            micro_tiles<DP, kS, 1>(sd, rows, cols, r, c);\n"
                           "            micro_tiles<DP, kS, 1>(sd + 1, rows + 1, cols + 1, r, c);\n"
                           "            const float(&st)")],
                         ("f32_dkv",), (D128,)),
    "f32_unrolled": ("the float32 kernels with their loops over D unrolled wholly, over a "
                     "warp's 16 rows 4 times, and their ring stages' staging wholly (the first "
                     "design)",
                     [("constexpr int kDotUnroll = 4;", "constexpr int kDotUnroll = 32;"),
                      ("constexpr int kStageUnroll = 1;", "constexpr int kStageUnroll = 0;")],
                     F32, ()),
    "f32_stage_unrolled": ("the float32 kernels staging a ring stage with its loop over a "
                           "thread's chunks unrolled wholly",
                           [("constexpr int kStageUnroll = 1;", "constexpr int kStageUnroll = 0;")],
                           F32, ()),
    "f32_dot_unroll_2": ("the float32 kernels with their loops over D unrolled twice",
                         [("constexpr int kDotUnroll = 4;", "constexpr int kDotUnroll = 2;")],
                         F32, ()),
    "f32_rows_rolled": ("the float32 kernels with their loops over a warp's 16 rows not "
                        "unrolled",
                        [("constexpr int kRowUnroll = 4;", "constexpr int kRowUnroll = 1;")],
                        F32, ()),
    "max_shared_carveout": ("every flash kernel asking for the largest shared-memory carveout",
                            [("    if (bytes <= 48 * 1024) return cudaSuccess;\n",
                              "    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemory"
                              "Carveout, 100);\n    if (bytes <= 48 * 1024) return cudaSuccess;\n")],
                            F32, ()),
    "bf16_stage_rolled": ("the bf16 tensor-core kernels staging their tiles with the loop over "
                          "a thread's chunks not unrolled, as the float32 kernels do",
                          [("          int UNROLL = 0, typename T>",
                            "          int UNROLL = 1, typename T>")],
                          BF16, ()),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another flash_attention.cu to compare with")
    ap.add_argument("--seeds", type=int, default=8,
                    help="seed pairs for learner_loss (0: skip it)")
    ap.add_argument("--variants",
                    help="a comma-separated subset of VARIANTS to build (none: no variant)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from scalerl_torch.ops import cuda_flash_attention as cfa
    from scalerl_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")
    def emit(kind, **fields):
        print(json.dumps({"study": kind, **fields}), flush=True)

    report = {"launches": {}}
    cs.phase_device(report)
    emit("card", card=report["card"])
    cuda_build.build(["flash_attention"])
    src = (cuda_build.CSRC_DIR / "flash_attention.cu").read_text()
    libs = {"this": cfa._lib()}
    build_dir = cuda_build.BUILD_DIR / "study"
    build_dir.mkdir(parents=True, exist_ok=True)

    def sass_sizes(so):
        """Instructions per flash kernel instantiation in the library's SASS."""
        tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
        r = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True)
        out, name = {}, None
        for ln in r.stdout.splitlines():
            if "Function :" in ln:
                name = cs._kernel_name(ln.split("Function :", 1)[1].strip())
            elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
                out[name] = out.get(name, 0) + 1
        return out

    emit("sass", name="this", instructions=sass_sizes(cuda_build.library_path("flash_attention")))

    def build(name, text):
        cu = build_dir / f"flash_{name}.cu"
        cu.write_text(text)
        so = build_dir / f"libflash_{name}.so"
        r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                            str(cu)], capture_output=True, text=True)
        if r.returncode != 0:
            emit("skipped", name=name, reason=f"nvcc exit {r.returncode}",
                 log=(r.stdout + r.stderr)[-2000:])
            return None
        log = r.stdout + r.stderr
        emit("build", name=name, registers=cs._registers(log), spills=cs._spills(log),
             instructions=sass_sizes(so))
        return ctypes.CDLL(str(so))

    chosen = args.variants.split(",") if args.variants else list(VARIANTS)
    for name, (what, subs, _, _) in VARIANTS.items():
        if name not in chosen:
            continue
        text = src
        if not all(old in text for old, _ in subs):
            emit("skipped", name=name, reason="its text is not in the source")
            continue
        for old, new in subs:
            text = text.replace(old, new)
        emit("variant", name=name, undoes=what)
        libs[name] = build(name, text)
    if args.other:
        libs["other"] = build("other", args.other.read_text())
    libs = {name: lib for name, lib in libs.items() if lib is not None}

    def use(name):
        cuda_build._loaded["flash_attention"] = libs[name]
        cfa._lib()  # sets the argument types of a fresh library

    def turns(name, measure):
        """this, name, name, this: the readings in that order."""
        seq = []
        for which in ("this", name, name, "this"):
            use(which)
            seq.append([which, measure()])
        use("this")
        return seq

    cs.set_tf32(False)

    # 1. kernels alone, each on its inputs made once with this source
    def kernel_us(kernel, shape, strided, launches):
        B, T, H, D = shape
        dtype = torch.bfloat16 if kernel.startswith("bf16") else torch.float32
        q, k, v, do = cs._flash_case(B, T, T, H, D, dtype, seed=100, strided=strided)
        scale = 1.0 / math.sqrt(D)
        o, lse = cfa.flash_forward_kernel(q, k, v, scale, True)
        _, delta = cfa.flash_dq_kernel(q, k, v, o, lse, do, scale, True)
        call = {
            "forward": lambda: cfa.flash_forward_kernel(q, k, v, scale, True),
            "dq": lambda: cfa.flash_dq_kernel(q, k, v, o, lse, do, scale, True),
            "dkv": lambda: cfa.flash_dkv_kernel(q, k, v, lse, delta, do, scale, True),
        }[kernel[kernel.index("_") + 1:]]
        return lambda: 1e3 * cs.gpu_time_ms(call, launches)

    shapes = [((8, 17, 16, 64), True, 200), ((4, 256, 2, 64), False, 50)]
    long = {"bf16": ((1, 4096, 8, 64), False, 10), "f32": ((2, 1024, 4, 64), False, 10)}
    changed = {name: kernels for name, (_, _, kernels, _) in VARIANTS.items()}
    extra = {name: more for name, (_, _, _, more) in VARIANTS.items()}
    changed["other"] = F32 + BF16
    extra["other"] = (D128,)
    for name in libs:
        if name == "this":
            continue
        for kernel in changed[name]:
            for shape, strided, launches in (shapes + [long[kernel[:kernel.index("_")]]]
                                             + list(extra[name])):
                use("this")
                measure = kernel_us(kernel, shape, strided, launches)
                emit("kernel_times", against=name, kernel=kernel, shape=list(shape),
                     us=turns(name, measure))

    # 2. the flash kernels inside the learn step: float32 for --other and each
    # variant that changes a float32 kernel, bf16 for those that change a bf16 one
    from scalerl_torch.agents.impala import ImpalaAgent

    for dtype, kinds in (("f32", F32), ("bf16", BF16)):
        names = [n for n in libs if any(k in kinds for k in changed.get(n, ()))]
        if not names:
            continue
        agent = ImpalaAgent(cs._shard_args(bf16_params=dtype == "bf16"), (cs.SHARD_OBS,),
                            cs.SHARD_A)
        traj = cs._shard_traj("cuda")
        steps = 5

        def step_us():
            for _ in range(3):
                agent.learn(traj)
            torch.cuda.synchronize()
            _, kernels = cs.profile_device(
                lambda: [agent.learn_device(traj) for _ in range(steps)])
            return {"device_us_per_step": sum(us for _, us, _ in kernels) / steps,
                    **{n: sum(us for kk, us, _ in kernels if n in kk) / steps
                       for n in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel")}}

        for name in names:
            emit(f"learner_step_{dtype}", against=name, us_per_step=turns(name, step_us))
        del agent
        torch.cuda.empty_cache()

    # 3. the float32 learner's loss and gradients, flash against plain, over seeds
    from scalerl_torch.agents.impala import ImpalaAgent

    compared = ["this"] + [n for n in libs if n == "other" or
                           any(k in F32 for k in changed.get(n, ()))]
    rel = {n: [] for n in compared}
    grad_rel = {n: [] for n in compared}
    pairs = ([(42, 0)] + [(s, s) for s in range(1, args.seeds)]) if args.seeds > 0 else []
    for seed, traj_seed in pairs:
        sargs = cs._shard_args(seed=seed)
        traj = cs._shard_traj("cuda", seed=traj_seed)
        agents = {p: ImpalaAgent(dataclasses.replace(sargs, use_pallas=p), (cs.SHARD_OBS,),
                                 cs.SHARD_A) for p in (True, False)}
        plain, plain_grads = cs._loss_grads(agents[False].state.params, agents[False].model,
                                            traj, sargs)
        row, grow = {}, {}
        for name in compared:
            use(name)
            flash, grads = cs._loss_grads(agents[True].state.params, agents[True].model, traj,
                                          sargs)
            row[name] = abs(flash.item() - plain.item()) / max(abs(plain.item()), 1.0)
            grow[name] = max(cs._leaf_rel(grads, plain_grads).values())
            rel[name].append(row[name])
            grad_rel[name].append(grow[name])
        use("this")
        emit("learner_loss", seed=seed, traj_seed=traj_seed, loss_plain=plain.item(),
             loss_rel=row, grad_leaf_rel=grow)
        del agents
        torch.cuda.empty_cache()

    def summary(values):
        return {n: {"median": statistics.median(v), "mean": statistics.mean(v), "max": max(v)}
                for n, v in values.items()}

    if pairs:
        emit("learner_loss_summary", limit=cs.SHARD_LEARN_TOL["loss_rel"], **summary(rel))
        emit("learner_grad_summary", limit=cs.SHARD_LEARN_TOL["grad_leaf_rel"],
             **summary(grad_rel))
    return 0


if __name__ == "__main__":
    sys.exit(main())
