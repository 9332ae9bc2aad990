#!/usr/bin/env python3
"""Design comparisons of the port's flash attention kernels on one GPU.

    python3 tools/flash_study.py [--other OLD.cu] [--seeds 8]

Builds ``scalerl_torch/csrc/flash_attention.cu`` as it stands, variants of
it that undo one design choice each (``VARIANTS``), and optionally another
version of the source (``--other``, e.g. one taken from an earlier commit
with ``git show <commit>:scalerl_torch/csrc/flash_attention.cu``), all with
the build's own nvcc flags, and swaps them in under the kernel wrappers of
``scalerl_torch/ops/cuda_flash_attention.py``.  Three comparisons, each in
turns (this source, the other, the other, this source) on one card:

1. ``kernel_times``: the bf16 dq kernel and the float32 forward alone, by
   CUDA-graph replay (``chip_smoke.gpu_time_ms``), at the learner's
   ``[8, 17, 16, 64]`` views, ``[4, 256, 2, 64]``, ``[1, 4096, 8, 64]``
   (dq) and ``[2, 1024, 4, 64]`` (forward).
2. ``learner_step``: the flash kernels' device time inside the transformer
   learner's bf16 learn step (``chip_smoke``'s sharded width) under
   ``torch.profiler``, this source against ``--other``.
3. ``learner_loss``: the float32 learner's loss through the flash kernels
   against the plain attention, relative as ``chip_smoke.py``'s
   ``transformer_learn`` holds it, over seeds (the check's own seed pair
   first), for this source, the variants that change the float32 forward
   and ``--other``.

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
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what it undoes, [(text in the source, replacement)])
VARIANTS = {
    "dq_4_warps": ("the bf16 dq kernel with 4 warps (64 queries) a block",
                   [("constexpr int kDqWarps = 8;", "constexpr int kDqWarps = 4;")]),
    "fwd32_8_warps": ("the float32 forward with 8 warps a block (128-key tiles; "
                      "its ring does not fit at D = 128)",
                      [("constexpr int kWarps = 4;\nconstexpr int kThreads = 32 * kWarps;",
                        "constexpr int kWarps = 8;\nconstexpr int kThreads = 32 * kWarps;"),
                       ("constexpr int kMinBlocks = 2;\n\ntemplate <int DP>\nstruct Dims {\n"
                        "    static_assert(DP % 8 == 0",
                        "constexpr int kMinBlocks = 1;\n\ntemplate <int DP>\nstruct Dims {\n"
                        "    static_assert(DP % 8 == 0")]),
    "fwd32_reciprocal": ("the float32 forward multiplying o by one rounded 1 / sum a row",
                         [("        den_s[row] = denom;", "        den_s[row] = 1.0f / denom;"),
                          ("= x / den_s[row];", "= x * den_s[row];")]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another flash_attention.cu to compare with")
    ap.add_argument("--seeds", type=int, default=8, help="seed pairs for learner_loss")
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
        emit("build", name=name, registers=cs._registers(r.stdout + r.stderr))
        return ctypes.CDLL(str(so))

    for name, (what, subs) in VARIANTS.items():
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

    # 1. kernels alone
    def dq_us(shape, strided, launches):
        B, T, H, D = shape
        q, k, v, do = cs._flash_case(B, T, T, H, D, torch.bfloat16, seed=100, strided=strided)
        scale = 1.0 / math.sqrt(D)
        o, lse = cfa.flash_forward_kernel(q, k, v, scale, True)
        return 1e3 * cs.gpu_time_ms(
            lambda: cfa.flash_dq_kernel(q, k, v, o, lse, do, scale, True), launches)

    def fwd32_us(shape, strided, launches):
        B, T, H, D = shape
        q, k, v, _ = cs._flash_case(B, T, T, H, D, torch.float32, seed=100, strided=strided)
        scale = 1.0 / math.sqrt(D)
        return 1e3 * cs.gpu_time_ms(lambda: cfa.flash_forward_kernel(q, k, v, scale, True),
                                    launches)

    dq_shapes = [((8, 17, 16, 64), True, 200), ((4, 256, 2, 64), False, 50),
                 ((1, 4096, 8, 64), False, 10)]
    fwd_shapes = [((8, 17, 16, 64), True, 200), ((4, 256, 2, 64), False, 50),
                  ((2, 1024, 4, 64), False, 10)]
    for name in libs:
        if name == "this":
            continue
        for kernel, fn, shapes in (("bf16_dq", dq_us, dq_shapes),
                                   ("f32_forward", fwd32_us, fwd_shapes)):
            for shape, strided, launches in shapes:
                emit("kernel_times", against=name, kernel=kernel, shape=list(shape),
                     us=turns(name, lambda: fn(shape, strided, launches)))

    # 2. the flash kernels inside the bf16 learn step
    if "other" in libs:
        from scalerl_torch.agents.impala import ImpalaAgent

        agent = ImpalaAgent(cs._shard_args(bf16_params=True), (cs.SHARD_OBS,), cs.SHARD_A)
        traj = cs._shard_traj("cuda")
        steps = 5

        def in_step():
            for _ in range(3):
                agent.learn(traj)
            torch.cuda.synchronize()
            _, kernels = cs.profile_device(
                lambda: [agent.learn_device(traj) for _ in range(steps)])
            return {"device_us_per_step": sum(us for _, us, _ in kernels) / steps,
                    **{n: sum(us for kk, us, _ in kernels if n in kk) / steps
                       for n in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel")}}

        emit("learner_step", against="other", us_per_step=turns("other", in_step))
        del agent
        torch.cuda.empty_cache()

    # 3. the float32 learner's loss, flash against plain, over seeds
    from scalerl_torch.agents.impala import ImpalaAgent

    compared = ["this"] + [n for n in libs if n in ("fwd32_8_warps", "fwd32_reciprocal", "other")]
    rel = {n: [] for n in compared}
    pairs = [(42, 0)] + [(s, s) for s in range(1, args.seeds)]
    for seed, traj_seed in pairs:
        sargs = cs._shard_args(seed=seed)
        traj = cs._shard_traj("cuda", seed=traj_seed)
        agents = {p: ImpalaAgent(dataclasses.replace(sargs, use_pallas=p), (cs.SHARD_OBS,),
                                 cs.SHARD_A) for p in (True, False)}
        plain, _ = cs._loss_grads(agents[False].state.params, agents[False].model, traj, sargs)
        row = {}
        for name in compared:
            use(name)
            flash, _ = cs._loss_grads(agents[True].state.params, agents[True].model, traj, sargs)
            row[name] = abs(flash.item() - plain.item()) / max(abs(plain.item()), 1.0)
            rel[name].append(row[name])
        use("this")
        emit("learner_loss", seed=seed, traj_seed=traj_seed, loss_plain=plain.item(),
             loss_rel=row)
        del agents
        torch.cuda.empty_cache()
    emit("learner_loss_summary", limit=cs.SHARD_LEARN_TOL["loss_rel"],
         **{n: {"median": statistics.median(v), "mean": statistics.mean(v), "max": max(v)}
            for n, v in rel.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
