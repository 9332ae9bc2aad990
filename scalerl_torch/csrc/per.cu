// Prioritized-replay kernels over a flat float32 priority plane [n], seen as
// blocks of `bs` priorities (the last block ragged: lanes past n read 0).
//
// The sample, per_block_sums_kernel then per_search_kernel, is the whole of
// scalerl_tpu/ops/pallas_per.py:79 pallas_sample in two launches: its phase
// 1 (_split_targets :30, which XLA runs before the Pallas call) and its
// Pallas kernel (_within_block_kernel :66).
// - Bound on an H100: bytes.  The plane is read once (4 MiB at n = 2^20,
//   1.25 us at 3.35 TB/s), plus 12 bytes a sample; each sample's block is
//   read again, mostly from L2.  At the replay path's sizes the floor is two
//   launches' latency: the plain version takes about eleven.
// - per_block_sums_kernel: one warp a block, 16-byte loads, one fixed order
//   (load_segment, add_segment, warp_sum), into a [nb] scratch the wrapper
//   allocates.
// - per_search_kernel: 8 samples a CTA, one a warp.  The CTA stages the
//   block sums in shared memory, kWindow at a time (a larger plane is
//   scanned window by window, the prefix carried), and scans them once.
//   Each warp binary-searches its target (side="left", clamped to nb - 1)
//   and takes the residual t - prev in float32, as split_targets does.  The
//   warp then scans its block in registers, a lane a run of kLaneRun lanes
//   (eight 16-byte loads), with shuffles and no __syncthreads; it counts the
//   running sums below the residual and writes
//   min(b*bs + min(count, bs-1), n-1).
// - The search launches after the block sums end.  Launched with Hopper's
//   programmatic dependent launch instead, so that its CTAs start during the
//   block sums and wait in griddepcontrol.wait, the pair took 0.2 us longer
//   by graph replay on an H100.
// scalerl_torch/ops/per.py::kernel_order_sample does the same arithmetic in
// the same order in plain PyTorch.
//
// The update, per_update_kernel, replaces pallas_per.py:309
// update_priorities_blocks(method="pallas") (_pallas_update :256, kernel
// _update_kernel_factory :225), whose grid steps run in order, so a block
// revisited by a later step just recomputes it.  CUDA blocks run at once.
// - Bound: bytes, M indices and values in and M priorities out (6 KiB at
//   M = 512), and with sums each touched block read once (~1.6 MB): the
//   floor is one launch's latency.
// - One launch for up to kMaxUpdates updates (the wrapper cuts more into
//   ordered chunks, one launch each on one stream, which keeps last-wins and
//   the sums right), ceil(M / 8) CTAs up to kMaxUpdateGrid.  The updates are
//   dealt out by block: CTA c takes those whose block b has b % grid == c,
//   so each slot and each block belongs to one CTA, and a CTA inserts only
//   its own share into its tables (every insert is a shared-memory atomic,
//   and tables that every CTA built from all M updates made the update
//   slower on an H100).  The slot table, keyed by slot
//   (atomicCAS on the key, atomicMax on the update's order), keeps each
//   slot's last update, so a slot's winner is ascending-order last-wins
//   whatever order the threads insert in; the CTA then writes each of its
//   slots once.
// - With sums, a second table keyed by block lists the CTA's touched
//   blocks.  No other CTA writes a slot of them, and __syncthreads makes
//   the CTA's own writes visible to all its threads, so after one more
//   barrier a warp re-sums each touched block from the plane, bounded at n,
//   in the block sums' order.  Repeats are bit-equal, and no grid-wide
//   barrier is needed.
// - No per-update CTA, no scan over earlier updates, no 64-bit division.
//
// Indices are clipped to [0, n-1], as update_priorities_blocks does.
// Priorities are assumed non-negative (the running sums are then monotone).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlock = 4096;          // the widest block
constexpr int kRound = 8;                // 4-lane chunks a lane loads at once in a block sum
constexpr int kLaneRun = 32;             // lanes of a block one lane scans in the search
constexpr int kSegment = 32 * kLaneRun;  // lanes of a block a warp scans at once
static_assert(kRound * 4 * 32 == kSegment, "a block sum's round is one segment");
constexpr int kWindow = 8192;            // block sums a search CTA scans at once (32 KB)
constexpr int kMaxUpdates = 4096;        // updates one update launch takes
constexpr int kUpdatesPerThread = kMaxUpdates / kThreads;
constexpr int kMaxUpdateGrid = 128;      // CTAs of an update launch, at most
constexpr int kEmpty = -1;               // a free table key
constexpr int kStaticSmem = 48 * 1024;   // dynamic shared memory without an opt-in

__device__ __forceinline__ bool aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Inclusive scan over the warp's lanes, the reach doubling each step.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += y;
    }
    return v;
}

__device__ __forceinline__ float warp_exclusive(float incl, int lane) {
    const float e = __shfl_up_sync(kFull, incl, 1);
    return lane == 0 ? 0.0f : e;
}

// A block's sum, the same on every lane of a warp, goes in one fixed order:
// lane l adds the 4-lane chunks l, l + 32, l + 64, ... in turn, each chunk's
// four in order, then a butterfly over the warp.  It takes the block by
// 1024-lane segments, 8 chunks a lane in registers: x[k] holds lanes
// s0 + 4 (32 k + lane) + 0..3 of the block at `base`, 0 past bs or n.
__device__ __forceinline__ void load_segment(const float* p, long long base, int s0, int bs,
                                             long long n, bool vec, int lane,
                                             float4 (&x)[kRound]) {
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
        const int w = s0 + 4 * (32 * k + lane);
        const long long g = base + w;
        if (vec && w + 4 <= bs && g + 4 <= n) {
            x[k] = *reinterpret_cast<const float4*>(p + g);
        } else {
            x[k].x = (w < bs && g < n) ? p[g] : 0.0f;
            x[k].y = (w + 1 < bs && g + 1 < n) ? p[g + 1] : 0.0f;
            x[k].z = (w + 2 < bs && g + 2 < n) ? p[g + 2] : 0.0f;
            x[k].w = (w + 3 < bs && g + 3 < n) ? p[g + 3] : 0.0f;
        }
    }
}

__device__ __forceinline__ float add_segment(float acc, const float4 (&x)[kRound]) {
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
        acc += x[k].x;
        acc += x[k].y;
        acc += x[k].z;
        acc += x[k].w;
    }
    return acc;
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    return acc;
}

// How many of the running sums over lanes [0, bs) of the block at `base`
// lie below t, the same on every lane of the warp.  Lane l scans its run
// [32 l, 32 l + 32) of each 1024-lane segment in registers: the run's total,
// a shuffle scan of the totals, then the run again from its exclusive
// prefix.
__device__ __forceinline__ int warp_count_below(const float* __restrict__ p, long long base,
                                                int bs, long long n, bool vec, int lane,
                                                float t) {
    float carry = 0.0f;
    int count = 0;
    for (int s0 = 0; s0 < bs; s0 += kSegment) {
        const int lo = s0 + lane * kLaneRun;
        float x[kLaneRun];
        if (vec && lo + kLaneRun <= bs && base + lo + kLaneRun <= n) {
            const float4* v4 = reinterpret_cast<const float4*>(p + base + lo);
#pragma unroll
            for (int k = 0; k < kLaneRun / 4; ++k) {
                const float4 v = v4[k];
                x[4 * k] = v.x;
                x[4 * k + 1] = v.y;
                x[4 * k + 2] = v.z;
                x[4 * k + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int j = 0; j < kLaneRun; ++j) {
                const int w = lo + j;
                x[j] = (w < bs && base + w < n) ? p[base + w] : 0.0f;
            }
        }
        float total = 0.0f;
#pragma unroll
        for (int j = 0; j < kLaneRun; ++j) total += x[j];
        const float incl = warp_inclusive_scan(total, lane);
        float run = carry + warp_exclusive(incl, lane);
#pragma unroll
        for (int j = 0; j < kLaneRun; ++j) {
            run += x[j];
            count += (lo + j < bs && run < t) ? 1 : 0;
        }
        carry += __shfl_sync(kFull, incl, 31);
    }
    return __reduce_add_sync(kFull, count);
}

__global__ void __launch_bounds__(kThreads)
per_block_sums_kernel(const float* __restrict__ p, long long n, int bs, long long nb,
                      float* __restrict__ sums) {
    const int lane = threadIdx.x & 31;
    const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (b >= nb) return;
    const bool vec = aligned16(p) && bs % 4 == 0;
    float acc = 0.0f;
    for (int s0 = 0; s0 < bs; s0 += kSegment) {
        float4 x[kRound];
        load_segment(p, b * bs, s0, bs, n, vec, lane, x);
        acc = add_segment(acc, x);
    }
    acc = warp_sum(acc);
    if (lane == 0) sums[b] = acc;
}

__global__ void __launch_bounds__(kThreads)
per_search_kernel(const float* __restrict__ p, const float* __restrict__ sums,
                  const float* __restrict__ targets, long long n, int bs, long long nb, int S,
                  long long* __restrict__ out) {
    __shared__ float cum[kWindow];
    __shared__ float warp_pre[kWarps];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int s = blockIdx.x * kWarps + warp;
    const bool active = s < S;
    const float t = active ? targets[s] : 0.0f;
    long long b = -1;      // this warp's block, once found
    float prev = 0.0f;     // the running sum before it
    float carry = 0.0f;    // the running sum before this window
    for (long long w0 = 0; w0 < nb; w0 += kWindow) {
        const int L = static_cast<int>(nb - w0 < kWindow ? nb - w0 : kWindow);
        for (int i = tid; i < L; i += kThreads) cum[i] = sums[w0 + i];
        __syncthreads();
        // thread tid scans its run [r0, r1) of the window: its total, a
        // shuffle scan of the totals, a scan of the 8 warps' totals, then
        // the run again from its exclusive prefix, in place
        const int per = (L + kThreads - 1) / kThreads;
        const int r0 = min(tid * per, L);
        const int r1 = min(r0 + per, L);
        float total = 0.0f;
        for (int i = r0; i < r1; ++i) total += cum[i];
        const float incl = warp_inclusive_scan(total, lane);
        const float excl = warp_exclusive(incl, lane);
        if (lane == 31) warp_pre[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const float v = warp_inclusive_scan(lane < kWarps ? warp_pre[lane] : 0.0f, lane);
            const float e = warp_exclusive(v, lane);
            __syncwarp();
            if (lane < kWarps) warp_pre[lane] = e;
        }
        __syncthreads();
        float acc = carry + (warp_pre[warp] + excl);
        for (int i = r0; i < r1; ++i) {
            acc += cum[i];
            cum[i] = acc;
        }
        __syncthreads();
        if (active && b < 0) {
            if (t <= cum[L - 1]) {
                int lo = 0, hi = L;  // the first running sum >= t
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (cum[mid] < t) {
                        lo = mid + 1;
                    } else {
                        hi = mid;
                    }
                }
                b = w0 + lo;
                prev = lo > 0 ? cum[lo - 1] : carry;
            } else if (w0 + L == nb) {  // past the total: the last block
                b = nb - 1;
                prev = L > 1 ? cum[L - 2] : carry;
            }
        }
        carry = cum[L - 1];
        __syncthreads();  // the next window overwrites cum
    }
    if (!active) return;
    const bool vec = aligned16(p) && bs % 4 == 0;
    const int count = warp_count_below(p, b * bs, bs, n, vec, lane, t - prev);
    if (lane == 0) {
        const long long idx = b * bs + (count < bs - 1 ? count : bs - 1);
        out[s] = idx < n - 1 ? idx : n - 1;
    }
}

// The update's tables: open addressing over 1 << bits int keys (>= 0).
__device__ __forceinline__ int table_hash(int key, int bits) {
    return static_cast<int>((static_cast<unsigned>(key) * 2654435761u) >> (32 - bits));
}

// The entry holding `key`, or -1.  Called only after the table is complete.
__device__ __forceinline__ int table_find(const int* keys, int key, int bits) {
    const int mask = (1 << bits) - 1;
    for (int h = table_hash(key, bits);; h = (h + 1) & mask) {
        const int k = keys[h];
        if (k == key) return h;
        if (k == kEmpty) return -1;
    }
}

// The entry of `key`, claimed if no thread has claimed one yet (then
// *claimed is set).  The table has at least twice as many entries as keys,
// so a free one is found.
__device__ __forceinline__ int table_insert(int* keys, int key, int bits, bool* claimed) {
    const int mask = (1 << bits) - 1;
    for (int h = table_hash(key, bits);; h = (h + 1) & mask) {
        const int k = atomicCAS(&keys[h], kEmpty, key);
        *claimed = k == kEmpty;
        if (k == kEmpty || k == key) return h;
    }
}

// p and sums are read and written here, so neither is __restrict__.
__global__ void __launch_bounds__(kThreads)
per_update_kernel(float* p, float* sums, const long long* __restrict__ idx,
                  const float* __restrict__ new_p, int M, int n, int bs, int bits) {
    extern __shared__ __align__(16) int smem[];
    const bool with_sums = sums != nullptr;
    const int T = 1 << bits;
    int* slot_key = smem;                                   // slot table: keys,
    int* slot_last = slot_key + T;                          //   the last update to each
    float* value_of = reinterpret_cast<float*>(slot_last + T);  // [M] update i's priority
    int* block_key = reinterpret_cast<int*>(value_of + M);  // with sums: block table keys,
    int* touched = block_key + T;                           //   the CTA's blocks
    int* touched_count = touched + M;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    // the updates' indices and values, read while the tables are cleared
    long long g[kUpdatesPerThread];
    float v[kUpdatesPerThread];
#pragma unroll
    for (int k = 0; k < kUpdatesPerThread; ++k) {
        const int i = tid + k * kThreads;
        g[k] = i < M ? idx[i] : 0;
        v[k] = i < M ? new_p[i] : 0.0f;
    }
    for (int h = tid; h < T; h += kThreads) {
        slot_key[h] = kEmpty;
        slot_last[h] = -1;
        if (with_sums) block_key[h] = kEmpty;
    }
    if (with_sums && tid == 0) *touched_count = 0;
    __syncthreads();
    // this CTA's updates: those to its blocks, b % gridDim.x == blockIdx.x
#pragma unroll
    for (int k = 0; k < kUpdatesPerThread; ++k) {
        const int i = tid + k * kThreads;
        if (i >= M) break;
        const int slot = static_cast<int>(g[k] < 0 ? 0 : (g[k] >= n ? n - 1 : g[k]));
        const int b = slot / bs;
        if (b % static_cast<int>(gridDim.x) != static_cast<int>(blockIdx.x)) continue;
        value_of[i] = v[k];
        bool claimed;
        atomicMax(&slot_last[table_insert(slot_key, slot, bits, &claimed)], i);
        if (with_sums) {
            table_insert(block_key, b, bits, &claimed);
            if (claimed) touched[atomicAdd(touched_count, 1)] = b;
        }
    }
    __syncthreads();
    // each slot's last update
    for (int h = tid; h < T; h += kThreads) {
        const int slot = slot_key[h];
        if (slot != kEmpty) p[slot] = value_of[slot_last[h]];
    }
    if (!with_sums) return;
    // The CTA's blocks hold no slot another CTA writes, and the barrier makes
    // this CTA's writes visible to all its threads: a warp a touched block
    // sums it from the plane, in the block sums' order.
    __syncthreads();
    const bool vec = aligned16(p) && bs % 4 == 0;
    for (int t = tid >> 5; t < *touched_count; t += kWarps) {
        const int b = touched[t];
        float acc = 0.0f;
        for (int s0 = 0; s0 < bs; s0 += kSegment) {
            float4 x[kRound];
            load_segment(p, static_cast<long long>(b) * bs, s0, bs, n, vec, lane, x);
            acc = add_segment(acc, x);
        }
        acc = warp_sum(acc);
        if (lane == 0) sums[b] = acc;
    }
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after each launch,
// so a refused launch reaches the caller; neither synchronises.

// The sample: `sums` is a [ceil(n / bs)] float32 scratch, `out` [S] int64.
extern "C" int per_sample_launch(const float* p, const float* targets, long long n, int bs,
                                 int S, float* sums, long long* out, void* stream) {
    if (bs < 1 || bs > kMaxBlock || n < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long nb = (n + bs - 1) / bs;
    per_block_sums_kernel<<<static_cast<unsigned>((nb + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        p, n, bs, nb, sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    per_search_kernel<<<(S + kWarps - 1) / kWarps, kThreads, 0, st>>>(p, sums, targets, n, bs, nb,
                                                                      S, out);
    return static_cast<int>(cudaGetLastError());
}

// The update of M <= kMaxUpdates priorities, in place; `sums` may be null.
extern "C" int per_update_launch(float* p, float* sums, const long long* idx, const float* new_p,
                                 int M, int n, int bs, void* stream) {
    if (bs < 1 || bs > kMaxBlock || n < 1 || M < 1 || M > kMaxUpdates) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int bits = 1;
    while ((1 << bits) < 2 * M) ++bits;  // tables at most half full
    const bool with_sums = sums != nullptr;
    const int words = 2 * (1 << bits) + M + (with_sums ? (1 << bits) + M + 1 : 0);
    const int smem = words * 4;
    if (smem > kStaticSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            per_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int grid = (M + kWarps - 1) / kWarps < kMaxUpdateGrid ? (M + kWarps - 1) / kWarps
                                                                 : kMaxUpdateGrid;
    per_update_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, sums, idx, new_p, M, n, bs, bits);
    return static_cast<int>(cudaGetLastError());
}
