#!/usr/bin/env python3
"""Design comparisons of the port's paged decode and segment attention
kernels on one GPU.

    python3 tools/paged_segment_study.py [--old-paged OLD.cu] [--old-segment OLD.cu]
        [--variants a,b] [--path-for old,a]

Builds ``scalerl_torch/csrc/paged_attention.cu`` and
``segment_attention.cu`` as they stand, variants of them that change one
design choice each (``VARIANTS``), and optionally earlier versions of the
sources (``--old-paged``, ``--old-segment``, e.g. taken from an earlier
commit with ``git show <commit>:scalerl_torch/csrc/paged_attention.cu``),
all with the build's own nvcc flags.  Each build reports ptxas's registers
and spills per kernel instantiation.  Then, each in turns (this source, the
other, the other, this source) on one card:

1. ``paged_times``: the paged decode kernel alone by CUDA-graph replay
   (``chip_smoke.gpu_time_ms``) at ``chip_smoke.py``'s ``paged_attn`` shape
   (256 lanes, 8 heads of 32, lengths over [1, 384]), beside its byte bound.
2. ``segment_times``: the segment forward, dq and dk/dv kernels, each alone,
   at the token-PPO learn step's ``[64, 512, 8, 32]`` rows and the bench's
   packed ``[32, 256, 8, 32]``, beside their operations bounds.
3. ``paged_in_engine`` (for the builds named by ``--path-for``, by default
   the old source): the paged kernel's device time a call inside the
   continuous engine (``chip_smoke.py``'s generation setup, lanes filled by
   a warm-up), 8 macro steps under ``torch.profiler``.
4. ``segment_in_learn_step`` (the same builds): the three segment kernels'
   device time a call, and the step's device time, inside the token-PPO
   learn step (64 rows of 512) under ``torch.profiler``.

An earlier paged source with the launch signature before the context split
(no scratch, no counters) is called through its own signature.  One JSON
line per reading on stdout.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (source, what it changes, [(text in the source, replacement)],
# {wrapper attribute: value while the variant runs})
VARIANTS = {
    "paged_3_stages": ("paged_attention", "a 3-stage ring (two chunks in flight), 2 blocks an SM",
                       [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                        ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")], {}),
    "paged_split_128": ("paged_attention", "128-token splits (8 chunks a block)",
                        [("constexpr int kSplitChunks = 4;", "constexpr int kSplitChunks = 8;")],
                        {"SPLIT_TOKENS": 128}),
    "paged_split_32": ("paged_attention", "32-token splits (2 chunks a block)",
                       [("constexpr int kSplitChunks = 4;", "constexpr int kSplitChunks = 2;")],
                       {"SPLIT_TOKENS": 32}),
    "queries_first_blocks_first": ("segment_attention",
                                   "the forward and dq taking their query blocks from the start "
                                   "of S first",
                                   [("constexpr bool kQueriesLastFirst = true;",
                                     "constexpr bool kQueriesLastFirst = false;")], {}),
    "seg_dot_unroll_2": ("segment_attention", "the three kernels' loops over D unrolled twice",
                         [("constexpr int kDotUnroll = 4;", "constexpr int kDotUnroll = 2;")], {}),
    "seg_rows_unrolled": ("segment_attention",
                          "the three kernels' loops over a warp's 16 streamed rows unrolled",
                          [("constexpr int kRowUnroll = 4;", "constexpr int kRowUnroll = 16;")],
                          {}),
    "seg_no_warp_skip": ("segment_attention",
                         "the three kernels without the skip of a warp whose rows meet no "
                         "segment of the block's",
                         [("    return ranges_meet(w_lo, w_hi, lo, hi);",
                           "    return w_lo <= w_hi || true;")], {}),
    "seg_no_tile_scan": ("segment_attention",
                         "the three kernels staging every tile of their walk (no id-range scan; "
                         "the warp skip stays)",
                         [("    for (; it < n_tiles; ++it) {\n        const int i0 = r0 + it * kTile;",
                           "    for (; false; ++it) {\n        const int i0 = r0 + it * kTile;")], {}),
    "fwd_4_blocks": ("segment_attention",
                     "the forward at DP = 32 at the others' 2-block minimum (114-116 registers, "
                     "4 blocks an SM) and its loop over D unrolled 4 times",
                     [("constexpr int kFwdMinBlocks = DP == 32 ? 5 : kMinBlocks;",
                       "constexpr int kFwdMinBlocks = kMinBlocks;"),
                      ("constexpr int kFwdDotUnroll = DP == 32 ? 2 : kDotUnroll;",
                       "constexpr int kFwdDotUnroll = kDotUnroll;")], {}),
    "dq_5_blocks": ("segment_attention",
                    "dq at DP = 32 held to 5 blocks an SM: its dS tile in the warp's own v rows "
                    "of the ring stage (read by then), 42 KB of shared memory, registers capped "
                    "at 96, the loop over D unrolled twice (spills 4 bytes)",
                    [("((2 * kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride + "
                      "2 * kRows)",
                      "((2 * kRows + 4 * kTile) * Dims<DP>::kStride + 2 * kRows)"),
                     ("    float* ds_s = v_s + 2 * L::kTileElems;        // [kWarps][16 keys]"
                      "[kPStride] dS\n    float* lse_s = ds_s + kWarps * 16 * kPStride;  // [kRows]",
                      "    float* lse_s = v_s + 2 * L::kTileElems;  // [kRows]"),
                     ("    float* pw = ds_s + warp * 16 * kPStride;\n", ""),
                     ("            put_weights(pw, ds, r, c);\n            __syncwarp();\n"
                      "            // dq += dS k",
                      "            float* pw = const_cast<float*>(vt);\n            __syncwarp();\n"
                      "            put_weights(pw, ds, r, c);\n            __syncwarp();\n"
                      "            // dq += dS k"),
                     ("__launch_bounds__(kThreads, kMinBlocks)\nseg_bwd_dq_kernel(",
                      "__launch_bounds__(kThreads, DP == 32 ? 5 : kMinBlocks)\nseg_bwd_dq_kernel("),
                     ("const float* cols[2] = {kt, vt};\n            micro_tiles<DP, kS, 2>(",
                      "const float* cols[2] = {kt, vt};\n            micro_tiles<DP, kS, 2, "
                      "DP == 32 ? 2 : kDotUnroll>(")], {}),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-paged", type=Path, help="an earlier paged_attention.cu")
    ap.add_argument("--old-segment", type=Path, help="an earlier segment_attention.cu")
    ap.add_argument("--variants",
                    help="a comma-separated subset of VARIANTS to build (none: no variant)")
    ap.add_argument("--path-for", default="old",
                    help="comma-separated builds (old, or variants) read inside the engine "
                         "and the learn step too (empty: none)")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from scalerl_torch.ops import cuda_paged_attention as cpa
    from scalerl_torch.ops import cuda_segment_attention as csa
    from scalerl_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")

    def emit(kind, **fields):
        print(json.dumps({"study": kind, **fields}), flush=True)

    report = {"launches": {}}
    cs.phase_device(report)
    sources = ("paged_attention", "segment_attention")
    logs = cuda_build.build(sources)
    for src in sources:
        log = logs.get(src, "")
        emit("build", name=f"{src}:this", registers=cs._registers(log), spills=cs._spills(log))
    libs = {src: {"this": cuda_build.load(src)} for src in sources}
    build_dir = cuda_build.BUILD_DIR / "study"
    build_dir.mkdir(parents=True, exist_ok=True)

    # every variant and old source compiled together, one nvcc each
    jobs = {}
    chosen = args.variants.split(",") if args.variants else []
    for name in chosen:
        src, what, subs, _ = VARIANTS[name]
        text = (cuda_build.CSRC_DIR / f"{src}.cu").read_text()
        if not all(old in text for old, _ in subs):
            emit("skipped", name=name, reason="its text is not in the source")
            continue
        for old, new in subs:
            text = text.replace(old, new)
        emit("variant", name=name, source=src, changes=what)
        jobs[(src, name)] = text
    for src, path in (("paged_attention", args.old_paged), ("segment_attention", args.old_segment)):
        if path is not None:
            jobs[(src, "old")] = path.read_text()
    running = {}
    for (src, name), text in jobs.items():
        cu = build_dir / f"{src}_{name}.cu"
        cu.write_text(text)
        so = build_dir / f"lib{src}_{name}.so"
        running[(src, name)] = (so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (src, name), (so, proc) in running.items():
        log, _ = proc.communicate(timeout=cuda_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            emit("skipped", name=f"{src}:{name}", reason=f"nvcc exit {proc.returncode}",
                 log=log[-2000:])
            continue
        emit("build", name=f"{src}:{name}", registers=cs._registers(log), spills=cs._spills(log))
        libs[src][name] = ctypes.CDLL(str(so))

    old_paged = libs["paged_attention"].get("old")
    if old_paged is not None:
        fn = old_paged.paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def paged_old(q, k_pages, v_pages, page_table, lengths, scale=None):
        """The paged kernel through the launch signature before the split."""
        B, _, H, D = q.shape
        N, ps = k_pages.shape[:2]
        out = torch.empty_like(q)
        err = old_paged.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, D, N, ps, page_table.shape[1],
            1.0 / math.sqrt(D) if scale is None else scale, 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old paged kernel launch failed: cudaError {err}")
        return out

    paged_this = cpa.paged_decode_attention

    defaults = {"SPLIT_TOKENS": cpa.SPLIT_TOKENS}

    def use(src, name):
        cuda_build._loaded[src] = libs[src][name]
        overrides = VARIANTS[name][3] if name in VARIANTS else {}
        for attr, value in defaults.items():
            setattr(cpa, attr, overrides.get(attr, value))
        if src == "segment_attention":
            csa._lib()  # sets the argument types of a fresh library
        elif name != "old":
            cpa._lib()

    def paged_fn(name):
        return paged_old if name == "old" else paged_this

    def turns(src, name, measure):
        """this, name, name, this: the readings in that order."""
        seq = []
        for which in ("this", name, name, "this"):
            use(src, which)
            seq.append([which, measure(which)])
        use(src, "this")
        return seq

    cs.set_tf32(False)
    others = {src: [n for n in libs[src] if n != "this"] for src in sources}

    # 1. the paged kernel alone at the paged_attn phase's shape
    B, H, D = cs.GEN_LANES, cs.GEN_HEADS, cs.GEN_D // cs.GEN_HEADS
    ps, M, N = cs.GEN_PAGE, cs.GEN_PAGES_PER_LANE, cs.GEN_NUM_PAGES
    g = torch.Generator().manual_seed(11)
    lengths = torch.randint(1, M * ps + 1, (B,), generator=g)
    lengths[0], lengths[1], lengths[2] = M * ps, 1, 17
    inp = cs._paged_case(B, H, D, ps, M, N, lengths, seed=12, dtype=torch.float32, shared=8)
    live = int(lengths.sum())
    moved = live * 2 * H * D * 4 + 2 * B * H * D * 4 + B * M * 4 + B * 4  # as chip_smoke counts
    bound_us = moved / cs.H100_BYTES_PER_S * 1e6
    for name in others["paged_attention"]:
        def measure(which):
            fn = paged_fn(which)
            return 1e3 * cs.gpu_time_ms(lambda: fn(**inp), 200)
        emit("paged_times", against=name, shape=[B, H, D, ps, M], live_tokens=live,
             bound_us=bound_us, us=turns("paged_attention", name, measure))

    # 2. the three segment kernels alone at the learn step's and the bench's batch
    seg_shapes = {
        "learn_step": cs._learn_step_fields(np.random.default_rng(2))["segment_ids"],
        "bench_packed": cs._bench_learn_batches()[0].segment_ids,
    }
    for shape_name, seg_ids in seg_shapes.items():
        c = cs._seg_case(seg_ids, cs.TRAIN_HEADS, cs.TRAIN_HEAD_DIM, torch.float32, seed=100)
        q, k, v, seg, do = c["q"], c["k"], c["v"], c["seg"], c["do"]
        scale = 1.0 / math.sqrt(q.shape[-1])
        use("segment_attention", "this")
        o, lse = csa.segment_forward_kernel(q, k, v, seg, scale)
        _, delta = csa.segment_dq_kernel(q, k, v, seg, o, lse, do, scale)
        pairs = cs._live_pairs(seg_ids) * q.shape[2]
        calls = {
            "forward": (4, lambda: csa.segment_forward_kernel(q, k, v, seg, scale)),
            "dq": (6, lambda: csa.segment_dq_kernel(q, k, v, seg, o, lse, do, scale)),
            "dkv": (8, lambda: csa.segment_dkv_kernel(q, k, v, seg, lse, delta, do, scale)),
        }
        for name in others["segment_attention"]:
            for kernel, (flops, call) in calls.items():
                emit("segment_times", against=name, kernel=kernel, shape=shape_name,
                     dims=list(q.shape),
                     ops_bound_us=flops * q.shape[-1] * pairs / cs.H100_F32_OPS_PER_S * 1e6,
                     us=turns("segment_attention", name,
                              lambda _, call=call: 1e3 * cs.gpu_time_ms(call, 20)))

    in_path = set(filter(None, args.path_for.split(",")))
    path_others = {src: [n for n in names if n in in_path] for src, names in others.items()}

    # 3. the paged kernel inside the continuous engine
    if path_others["paged_attention"]:
        from scalerl_torch.genrl.continuous import ContinuousEngine

        model = cs._gen_model("cuda")
        engine = ContinuousEngine(model, model.state_dict(), cs._gen_config())
        rng = np.random.default_rng(0)

        def fill():
            prompts, plens = cs._prompts(rng, 2 * cs.GEN_LANES)
            for i in range(len(plens)):
                engine.submit(prompts[i], plens[i])

        fill()
        for _ in range(24):  # lanes at a spread of lengths
            engine.step()
        net = engine._run.net

        def engine_us(which):
            net.paged_attn_fn = paged_fn(which)
            if engine.pending < cs.GEN_LANES:
                fill()
            for _ in range(2):
                engine.step()
            macro0 = engine.macro_steps
            _, kernels = cs.profile_device(lambda: [engine.step() for _ in range(8)])
            macros = max(engine.macro_steps - macro0, 1)
            calls = sum(n for kk, _, n in kernels if "paged_decode" in kk)
            paged = sum(us for kk, us, _ in kernels if "paged_decode" in kk)
            return {"us_per_call": paged / max(calls, 1), "calls": calls,
                    "us_per_macro_step": paged / macros,
                    "device_us_per_macro_step": sum(us for _, us, _ in kernels) / macros}

        for name in path_others["paged_attention"]:
            emit("paged_in_engine", against=name, readings=turns("paged_attention", name,
                                                                 engine_us))
        net.paged_attn_fn = paged_this
        del engine, model
        torch.cuda.empty_cache()

    # 4. the segment kernels inside the token-PPO learn step
    if path_others["segment_attention"]:
        from scalerl_torch.agents.token_ppo import TokenPPOAgent
        from scalerl_torch.trainer.sequence_rl import build_genrl_model

        fields = cs._learn_step_fields(np.random.default_rng(2))
        batch = {k: torch.tensor(v).cuda() for k, v in fields.items()}
        batch["is_weight"] = torch.ones(cs.TRAIN_B, device="cuda")
        targs = cs._train_args()
        agent = TokenPPOAgent(targs, build_genrl_model(targs))
        steps = 3

        def learn_us(_):
            for _ in range(2):
                agent.learn(batch)
            torch.cuda.synchronize()
            _, kernels = cs.profile_device(lambda: [agent.learn(batch) for _ in range(steps)])
            out = {"device_us_per_step": sum(us for _, us, _ in kernels) / steps}
            for n in ("seg_fwd_kernel", "seg_bwd_dq_kernel", "seg_bwd_dkv_kernel"):
                calls = sum(c for kk, _, c in kernels if n in kk)
                out[n] = sum(us for kk, us, _ in kernels if n in kk) / max(calls, 1)
            return out

        for name in path_others["segment_attention"]:
            emit("segment_in_learn_step", against=name,
                 us_per_call=turns("segment_attention", name, learn_us))
    return 0


if __name__ == "__main__":
    sys.exit(main())
