// Prioritized-replay kernels over a flat float32 priority plane [n], seen as
// blocks of `bs` priorities (the last block ragged: lanes past n read 0).
//
// per_sample_kernel replaces scalerl_tpu/ops/pallas_per.py::
// _within_block_kernel (launched by pallas_sample), whose grid walks the
// samples in order and DMAs each sample's block into VMEM through a
// scalar-prefetched index map.  Here one CTA per sample loads its block
// straight from device memory (a float4 per thread at bs = 1024), runs a
// block-wide inclusive scan (thread-local running sums, then warp shuffles,
// then one pass over the warp totals in shared memory) and counts the
// running sums below the residual target; it writes
// min(b*bs + min(count, bs-1), n-1).
//
// per_update_kernel replaces _pallas_update (_update_kernel_factory), whose
// grid steps run in order, so a block revisited by a later step simply
// recomputes it.  CUDA blocks run in parallel, and two CTAs writing one block
// would race.  So update j's CTA works only if no earlier update hits its
// block: exactly one CTA owns each distinct block.  The owner finds, for every
// lane of its block, the LAST update i >= j that writes it (atomicMax in
// shared memory) and writes that value, which is ascending-order last-wins.
// With sums, it then reduces the block, bounded at n, into sums[b].  The plane
// and the sums are updated in place.
//
// Bound on an H100: bytes.  The sample kernel reads one 4 KiB block per
// sample (~2.1 MB at S = 512, under a microsecond at 3.35 TB/s); the update
// kernel moves M indices and values in and M priorities out, plus each
// touched block once with sums.  At the replay path's sizes both sit near the
// launch latency.
//
// Indices are clipped to [0, n-1], as update_priorities_blocks does.
// Priorities are assumed non-negative (the running sums are then monotone).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 16;  // bs <= kThreads * kMaxItems = 4096
constexpr int kMaxBlock = kThreads * kMaxItems;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clip_index(long long i, long long n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
per_sample_kernel(const float* __restrict__ p,
                  const long long* __restrict__ b_idx,
                  const float* __restrict__ within_t,
                  long long n, int bs,
                  long long* __restrict__ out) {
    __shared__ float warp_pre[kWarps];
    __shared__ int warp_count[kWarps];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long b = b_idx[s];
    const float t = within_t[s];
    const long long base = b * bs;

    // this thread's lanes [lo, hi) of the block, loaded into registers
    const int items = (bs + kThreads - 1) / kThreads;
    const int lo = tid * items;
    float x[kMaxItems];
    const bool vec = (items == 4) && ((reinterpret_cast<uintptr_t>(p) & 15) == 0) &&
                     (base % 4 == 0) && (lo + 4 <= bs) && (base + lo + 4 <= n);
    if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(p + base + lo);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
#pragma unroll
        for (int k = 4; k < kMaxItems; ++k) x[k] = 0.0f;
    } else {
#pragma unroll
        for (int k = 0; k < kMaxItems; ++k) {
            const int w = lo + k;
            const long long g = base + w;
            x[k] = (k < items && w < bs && g < n) ? p[g] : 0.0f;
        }
    }
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) total += x[k];

    // inclusive scan of the thread totals within the warp
    float incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) warp_pre[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const float v = lane < kWarps ? warp_pre[lane] : 0.0f;
        float vi = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(kFull, vi, off);
            if (lane >= off) vi += y;
        }
        float ve = __shfl_up_sync(kFull, vi, 1);
        if (lane == 0) ve = 0.0f;
        __syncwarp();
        if (lane < kWarps) warp_pre[lane] = ve;
    }
    __syncthreads();

    // walk this thread's lanes from its exclusive prefix; count sums < t
    float run = warp_pre[warp] + excl;
    int count = 0;
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
        if (k < items && lo + k < bs) {
            run += x[k];
            count += run < t ? 1 : 0;
        }
    }
    count = __reduce_add_sync(kFull, count);
    if (lane == 0) warp_count[warp] = count;
    __syncthreads();
    if (tid == 0) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += warp_count[w];
        const long long w_idx = c < bs - 1 ? c : bs - 1;
        const long long idx = base + w_idx;
        out[s] = idx < n - 1 ? idx : n - 1;
    }
}

__global__ void __launch_bounds__(kThreads)
per_update_kernel(float* __restrict__ p,
                  float* __restrict__ sums,
                  const long long* __restrict__ idx,
                  const float* __restrict__ new_p,
                  int M, long long n, int bs) {
    __shared__ int last[kMaxBlock];
    __shared__ float warp_sum[kWarps];
    const int j = blockIdx.x;
    const int tid = threadIdx.x;
    const long long my_b = clip_index(idx[j], n) / bs;

    // 1. ownership: an earlier update to the same block owns it
    int earlier = 0;
    for (int i = tid; i < j; i += kThreads) {
        earlier |= (clip_index(idx[i], n) / bs == my_b) ? 1 : 0;
    }
    if (__syncthreads_or(earlier)) return;

    // 2. the last update (in ascending order) to each lane of the block
    for (int w = tid; w < bs; w += kThreads) last[w] = -1;
    __syncthreads();
    const long long base = my_b * bs;
    for (int i = j + tid; i < M; i += kThreads) {
        const long long g = clip_index(idx[i], n);
        if (g / bs == my_b) atomicMax(&last[g - base], i);
    }
    __syncthreads();

    // 3. write the winners; with sums, re-sum the block bounded at n
    float s = 0.0f;
    for (int w = tid; w < bs; w += kThreads) {
        const long long g = base + w;
        if (g >= n) break;
        const int i = last[w];
        float v;
        if (i >= 0) {
            v = new_p[i];
            p[g] = v;
        } else {
            v = sums != nullptr ? p[g] : 0.0f;
        }
        s += v;
    }
    if (sums == nullptr) return;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = s;
    __syncthreads();
    if (tid == 0) {
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
        sums[my_b] = total;
    }
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError(), so a refused
// launch reaches the caller; neither synchronises.

extern "C" int per_sample_launch(const float* p, const long long* b_idx,
                                 const float* within_t, long long n, int bs,
                                 int S, long long* out, void* stream) {
    if (bs < 1 || bs > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
    per_sample_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, b_idx, within_t, n, bs, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int per_update_launch(float* p, float* sums, const long long* idx,
                                 const float* new_p, int M, long long n, int bs,
                                 void* stream) {
    if (bs < 1 || bs > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
    per_update_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, sums, idx, new_p, M, n, bs);
    return static_cast<int>(cudaGetLastError());
}
