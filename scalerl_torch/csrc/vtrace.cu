// V-trace targets over a [T, B] float32 trajectory, staged through shared
// memory by column tiles.
//
// Replaces the TPU kernel scalerl_tpu/ops/pallas_vtrace.py::_vtrace_kernel
// (launched by vtrace_from_importance_weights_pallas), which holds the whole
// [T, B] plane in VMEM and runs the backward recursion as a loop of row ops.
//
// Bound on an H100: the function moves 6*T*B*4 + 4*B bytes (four input
// planes, the bootstrap row, two output planes) and does ~16 operations per
// element, so it is bound by bytes: 0.074 us at the fused loop's [20, 512],
// 2.35 us at [80, 4096].  What holds it back in practice is latency: the
// recursion runs T dependent steps per column, and a thread that loads the
// inputs of step t only after the arithmetic of step t + 1 pays one trip to
// memory per step (the first port's design, one thread per column: ~180 ns
// a step).
//
// Design.  A CTA of 256 threads owns a tile of W = 8 columns (one 32-byte
// sector a row) and walks time in chunks of TC = 1024 / W = 128 rows, from
// the last chunk to the first:
//   1. copy: all threads copy the chunk's four input tiles (and, with the
//      last chunk, the bootstrap row) into shared memory with cp.async
//      (16-byte copies where B % 4 == 0 and every plane is 16-byte
//      aligned, 4-byte copies otherwise), double-buffered, so the next
//      earlier chunk is in flight while this one is computed: a chunk costs
//      about one memory latency, not TC of them, and shared memory stays
//      bounded for any T;
//   2. elementwise: over the chunk's elements, rho, the clipped rhos, c,
//      delta and d * c into shared memory; V(x_{t+1}) at the chunk's edge is
//      the first row of the later chunk (or the bootstrap row), carried;
//   3. recursion: one thread per column runs acc = delta + (d*c) * acc over
//      the chunk from shared memory, where delta and d * c lie by column, so
//      four rows come in one 16-byte load of each and go out in one store,
//      the next four loaded before the current four recur; the rows past
//      the chunk's end, up to a multiple of 4, hold -0 and 1, which recur as
//      the identity.  The chain is two rounded operations a step, and the
//      warp runs ~4 instructions a step (from row-major arrays it ran ~12
//      a step, at 25-29 cycles a step);
//   4. output: over the chunk's elements, vs = acc + V and pg from vs_{t+1}
//      (carried across the chunk's edge like V), both stored coalesced.
// The grid is ceil(B / W) CTAs (64 at [20, 512]): the kernel is bound by
// latency, and narrow tiles put more chains and more copies in flight.  No
// parallel scan over T: the recursion stays sequential in t per column.
// tools/vtrace_study.py times the choices (width, chunk, stages, cp.async,
// recursion layout, threads) against this source and an earlier one.
//
// Numerics are those of the first port's kernel, element by element: the
// reference op
// (scalerl_tpu/ops/vtrace.py) step by step in float32, each product and sum
// rounded on its own (no FMA contraction), with expf (not __expf): build
// without --use_fast_math.  The clip is written as (x > m ? m : x) so a NaN
// input stays NaN, as jnp.minimum and torch.clamp keep it (fminf would drop
// it).  vs_{t+1} is recomputed as acc + V from the same floats (or carried
// from the later chunk), so the outputs are bit-equal to a walk of one
// thread per column.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Columns a CTA: 8, one 32-byte sector a row, so that B = 512 gives 64 CTAs.
constexpr int kWidth = 8;
// Elements of one chunk: TC = kChunkElems / kWidth rows (128).
constexpr int kChunkElems = 1024;
// Chunks in flight: 2 copies the next earlier chunk while one is computed.
constexpr int kStages = 2;
// Stage by cp.async; false copies through registers (plain loads), for study.
constexpr bool kAsyncCopy = true;

__device__ __forceinline__ float clip_max(float x, float m) {
    return x > m ? m : x;
}

// Round after every multiply and add, as the plain version's separate
// elementwise kernels do: nvcc would otherwise contract a * b + c into one
// FMA, whose single rounding drifts past 1e-5 on long recursions.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// --- PTX wrappers
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// --- end PTX wrappers

template <int V>
__device__ __forceinline__ void copy(float* dst, const float* src) {
    if constexpr (!kAsyncCopy) {
#pragma unroll
        for (int u = 0; u < V; ++u) dst[u] = src[u];
    } else if constexpr (V == 4) {
        cp_async_16(dst, src);
    } else {
        cp_async_4(dst, src);
    }
}

// V consecutive floats between shared memory and registers (V = 4: one
// 16-byte access, free of bank conflicts).
template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
    if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    } else {
        x[0] = *p;
    }
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
        *p = x[0];
    }
}

// V = 4: 16-byte copies and stores, four columns a thread.
template <int V>
__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ log_rhos,
              const float* __restrict__ discounts,
              const float* __restrict__ rewards,
              const float* __restrict__ values,
              const float* __restrict__ bootstrap,
              float* __restrict__ vs,
              float* __restrict__ pg,
              int T, int B,
              float rho_clip, int has_rho_clip,
              float pg_rho_clip, int has_pg_rho_clip,
              float c_clip) {
    constexpr int W = kWidth;
    constexpr int TC = kChunkElems / W;
    constexpr int G = W / V;  // column groups a row
    // the four input tiles of each stage: log_rhos, discounts, rewards, values
    __shared__ __align__(16) float in[kStages][4][TC][W];
    // delta (acc after the recursion) and d * c by column: a column's rows are
    // contiguous, so the recursion reads four rows in one 16-byte load; rows
    // padded by 4 so the W columns' loads fall in distinct banks
    __shared__ __align__(16) float delta[W][TC + 4];
    __shared__ __align__(16) float dc[W][TC + 4];
    __shared__ __align__(16) float pgr[TC][W];    // the pg advantages' rho
    // V(x) and vs of the row just after a chunk, by the chunk's parity
    __shared__ __align__(16) float carry_v[2][W];
    __shared__ __align__(16) float carry_vs[2][W];

    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * W;
    const int chunks = (T + TC - 1) / TC;

    // chunk k holds rows [max(0, T - (k + 1) * TC), T - k * TC): k = 0 is the last
    auto stage_chunk = [&](int k) {
        if (k < chunks) {
            const int t0 = max(0, T - (k + 1) * TC);
            const int groups = (T - k * TC - t0) * G;
            float(*stage)[TC][W] = in[k % kStages];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const float* src = p == 0 ? log_rhos : p == 1 ? discounts : p == 2 ? rewards : values;
                for (int g = tid; g < groups; g += kThreads) {
                    const int t = g / G, jj = (g % G) * V;
                    if (j0 + jj < B) {
                        copy<V>(&stage[p][t][jj],
                                src + static_cast<size_t>(t0 + t) * B + j0 + jj);
                    }
                }
            }
            if (k == 0 && tid < W && j0 + tid < B) {  // the bootstrap row: V and vs past the end
                copy<1>(&carry_v[0][tid], bootstrap + j0 + tid);
                copy<1>(&carry_vs[0][tid], bootstrap + j0 + tid);
            }
        }
        if constexpr (kAsyncCopy) cp_async_commit();  // an empty group past the first chunk
    };

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) stage_chunk(k);

    float acc = 0.0f;  // vs_{t+1} - V(x_{t+1}) of the recursion, one column a thread
    for (int k = 0; k < chunks; ++k) {
        stage_chunk(k + kStages - 1);  // into the stage chunk k - 1 left
        if constexpr (kAsyncCopy) cp_async_wait<kStages - 1>();
        __syncthreads();  // chunk k has landed, for every thread

        const int t0 = max(0, T - (k + 1) * TC);
        const int n = T - k * TC - t0;
        const int par = k & 1;
        float(*stage)[TC][W] = in[k % kStages];
        const float(*lr)[W] = stage[0];
        const float(*d)[W] = stage[1];
        const float(*r)[W] = stage[2];
        const float(*v)[W] = stage[3];

        // 2. elementwise: delta = rho * (r + d * V_{t+1} - V_t), d * c, pg rho
        for (int g = tid; g < n * G; g += kThreads) {
            const int t = g / G, jb = (g % G) * V;
            float x[V], dt[V], rt[V], vt[V], vn[V], de[V], dcs[V], pr[V];
            load(x, &lr[t][jb]);
            load(dt, &d[t][jb]);
            load(rt, &r[t][jb]);
            load(vt, &v[t][jb]);
            load(vn, t + 1 < n ? &v[t + 1][jb] : &carry_v[par][jb]);
#pragma unroll
            for (int u = 0; u < V; ++u) {
                const float rho = expf(x[u]);
                const float clipped_rho = has_rho_clip ? clip_max(rho, rho_clip) : rho;
                const float c = clip_max(rho, c_clip);
                de[u] = mul(clipped_rho, sub(add(rt[u], mul(dt[u], vn[u])), vt[u]));
                dcs[u] = mul(dt[u], c);
                pr[u] = has_pg_rho_clip ? clip_max(rho, pg_rho_clip) : rho;
            }
#pragma unroll
            for (int u = 0; u < V; ++u) {
                delta[jb + u][t] = de[u];
                dc[jb + u][t] = dcs[u];
            }
            store(&pgr[t][jb], pr);
        }
        // rows n .. top - 1, up to a multiple of 4, recur as the identity:
        // -0 + 1 * acc is acc, bit for bit (NaN, infinities and -0 included)
        const int top = (n + 3) & ~3;
        if (tid < W) {
            for (int t = n; t < top; ++t) {
                delta[tid][t] = -0.0f;
                dc[tid][t] = 1.0f;
            }
        }
        __syncthreads();

        // 3. recursion: acc = delta + d * c * acc, four rows a step of the
        // loop (one 16-byte load of each array, one store of acc), the next
        // four loaded before the current four recur
        if (tid < W) {
            float4 de = *reinterpret_cast<const float4*>(&delta[tid][top - 4]);
            float4 cs = *reinterpret_cast<const float4*>(&dc[tid][top - 4]);
            for (int t = top - 4; t >= 0; t -= 4) {  // rows t + 3, t + 2, t + 1, t
                const int next = t >= 4 ? t - 4 : 0;
                const float4 next_de = *reinterpret_cast<const float4*>(&delta[tid][next]);
                const float4 next_cs = *reinterpret_cast<const float4*>(&dc[tid][next]);
                const float a3 = acc = add(de.w, mul(cs.w, acc));
                const float a2 = acc = add(de.z, mul(cs.z, acc));
                const float a1 = acc = add(de.y, mul(cs.y, acc));
                acc = add(de.x, mul(cs.x, acc));
                *reinterpret_cast<float4*>(&delta[tid][t]) = make_float4(acc, a1, a2, a3);
                de = next_de;
                cs = next_cs;
            }
        }
        __syncthreads();

        // 4. output: vs = acc + V_t; pg = pg_rho * (r + d * vs_{t+1} - V_t)
        for (int g = tid; g < n * G; g += kThreads) {
            const int t = g / G, jb = (g % G) * V;
            float at[V], vst[V], an[V], vn[V], vsn[V], pr[V], dt[V], rt[V], vt[V], out[V];
#pragma unroll
            for (int u = 0; u < V; ++u) {
                at[u] = delta[jb + u][t];
                an[u] = delta[jb + u][t + 1];  // row t + 1 < TC + 4: read even past n
            }
            load(vt, &v[t][jb]);
            if (t + 1 < n) load(vn, &v[t + 1][jb]);
            load(vsn, &carry_vs[par][jb]);
            load(pr, &pgr[t][jb]);
            load(dt, &d[t][jb]);
            load(rt, &r[t][jb]);
#pragma unroll
            for (int u = 0; u < V; ++u) {
                vst[u] = add(at[u], vt[u]);
                if (t + 1 < n) vsn[u] = add(an[u], vn[u]);  // vs_{t+1}, as the row above computes it
                out[u] = mul(pr[u], sub(add(rt[u], mul(dt[u], vsn[u])), vt[u]));
            }
            if (t == 0) {  // the next earlier chunk's V(x_{t+1}) and vs_{t+1}
                store(&carry_v[par ^ 1][jb], vt);
                store(&carry_vs[par ^ 1][jb], vst);
            }
            if (j0 + jb < B) {
                const size_t i = static_cast<size_t>(t0 + t) * B + j0 + jb;
                store(vs + i, vst);
                store(pg + i, out);
            }
        }
        __syncthreads();  // chunk k's stage and carries are read: free to refill
    }
}

template <int V>
cudaError_t launch(const float* log_rhos, const float* discounts, const float* rewards,
                   const float* values, const float* bootstrap, float* vs, float* pg, int T,
                   int B, float rho_clip, int has_rho_clip, float pg_rho_clip,
                   int has_pg_rho_clip, float c_clip, cudaStream_t stream) {
    vtrace_kernel<V><<<(B + kWidth - 1) / kWidth, kThreads, 0, stream>>>(
        log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, B, rho_clip,
        has_rho_clip, pg_rho_clip, has_pg_rho_clip, c_clip);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// reaches the caller; it does not synchronise.
extern "C" int vtrace_launch(const float* log_rhos, const float* discounts,
                             const float* rewards, const float* values,
                             const float* bootstrap, float* vs, float* pg,
                             int T, int B,
                             float rho_clip, int has_rho_clip,
                             float pg_rho_clip, int has_pg_rho_clip,
                             float c_clip, void* stream) {
    const bool vec = B % 4 == 0 && aligned16(log_rhos) && aligned16(discounts) &&
                     aligned16(rewards) && aligned16(values) && aligned16(vs) && aligned16(pg);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        vec ? launch<4>(log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, B, rho_clip,
                        has_rho_clip, pg_rho_clip, has_pg_rho_clip, c_clip, st)
            : launch<1>(log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, B, rho_clip,
                        has_rho_clip, pg_rho_clip, has_pg_rho_clip, c_clip, st);
    return static_cast<int>(err);
}
