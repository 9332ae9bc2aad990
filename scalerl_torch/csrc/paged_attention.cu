// Paged decode attention: one query token per lane against a block-paged
// K/V pool, through the lane's page table.
//
// Replaces the TPU kernel scalerl_tpu/ops/pallas_paged_attention.py::
// _decode_kernel (launched by paged_decode_attention), whose grid (B, H, M)
// DMAs one pool page per step through the scalar-prefetched table and keeps
// the online-softmax state in VMEM across the sequential page axis.
//
// Contract (ops/paged_attention.py::paged_attention_reference): q [B, 1, H,
// D], pools [N, ps, H, D], table [B, M] int32, lengths [B] int32 (>= 1);
// scores in float32 scaled by `scale`, positions >= length masked, out =
// acc / max(l, 1e-30) in q's dtype.  float32 or bfloat16 inputs, all three
// the same type; V is accumulated in float32 either way.  Table entries are
// clamped into [0, N) as a JAX gather clamps them.
//
// Design: FlashDecoding's split of the context across blocks, with the
// pages staged through shared memory by asynchronous copies.
//   Grid: one block per (lane, head group, context split), the splits of a
//   lane kSplit = 64 tokens each; splits at or past a lane's length exit at
//   once.  A head group is as many heads (one warp each, at most 8) as make
//   a staged token slot of at most 1 KiB: all 8 heads at D = 32 in float32,
//   so a block reads whole, contiguous 16-byte pieces of every slot and the
//   8 heads share one read of the table.
//   Table: the split's 64 token slots (clamped page * ps + offset) are
//   computed once into shared memory.
//   Staging: the split's tokens stream through a 2-stage ring of kChunk =
//   16-token stages (one page at ps = 16) by 16-byte cp.async.cg copies (8,
//   4 or 2 bytes where the pools' rows are not 16-byte aligned), so the
//   next chunk's copy overlaps this chunk's math.  bfloat16 pools are
//   staged as they are and converted at the read.  Tokens past the length
//   are zero-filled, never read.  Each staged token row is padded by 16
//   bytes, so the 8 lanes of a quarter-warp that read 8 rows at one column
//   fall in distinct bank groups.
//   Math: warp w takes head h0 + w.  Lane 16 u + t scores token t of the
//   chunk over half u of D (pre-scaled q in registers, float4 reads of the
//   K row), and one shuffle adds the halves: both lanes hold the score.
//   The online max and sum close once a chunk over 16 lanes (4 shuffles
//   each); p . V accumulates with D across lanes (lane L owns columns
//   L * D / 32 ..), p of token t broadcast by a shuffle.
//   Combine, deterministic and in the same launch: a lane whose length fits
//   one split writes its output directly.  Otherwise each split writes its
//   partial (m, l, acc[D]) to a float32 scratch buffer owned by the wrapper
//   and takes a ticket from the (lane, head group)'s arrival counter; the
//   block that arrives last resets the counter to 0 and combines the
//   partials in split order, so repeats are bit-equal whatever order the
//   blocks ran in and no sum is made by atomics.
//
// Bound on an H100: bytes.  The function must read every live token's K
// and V once, 2*H*D*4 bytes per token in float32 (2 KiB at H=8, D=32), plus
// q, the table, the lengths and the output; it does ~4*D flops per token
// and head, far below the float32 rate for those bytes.  At the generation
// engine's shape (256 lanes, contexts up to 384 tokens) that is tens of MB
// per call, tens of microseconds at 3.35 TB/s.  The splits give that shape
// several blocks per lane (about 3 on average, 6 at most), enough to fill
// 132 SMs a few times over where a block per (lane, head) walking the
// whole context let the longest lanes set the time; with 3 blocks an SM,
// each keeping a chunk of copies in flight, ~100 KB of loads are in flight
// per SM.  The partials add 4*(D+2) bytes per
// (lane, head, split) written and read once, a few percent of the pools'
// bytes.
//
// Numerics: expf (not __expf), no fast math; the float32 sums run in
// another order than the reference's softmax and einsum, within 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 16;       // tokens per ring stage (lanes t and 16 + t score token t)
constexpr int kSplitChunks = 4;  // ring stages a split walks
constexpr int kSplit = kChunk * kSplitChunks;  // tokens per context split (a block)
constexpr int kStages = 2;       // ring depth: one chunk in flight while one is read
constexpr int kSlotBytes = 1024;  // a staged token slot of a head group, at most
constexpr int kMaxHeads = 8;      // heads (warps) per block, at most
// Blocks per SM the registers must allow, as the shared memory does (3 x
// 67 KB at D = 32 in float32): without a minimum, ptxas spilled two index
// registers across the chunk loop of the bf16 kernels at D = 32 and 64.
// (3 stages, 2 blocks an SM: 3% slower at the engine's shape on an H100.)
constexpr int kMinBlocks = 3;

// DP: D padded to a multiple of 16 (16, 32, 64, 128); columns past D stage
// as zeros and are never stored.
template <typename T, int DP>
struct Cfg {
    static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "head dim padded to 16");
    static constexpr int kEsz = static_cast<int>(sizeof(T));
    static constexpr int kHeads =
        kSlotBytes / (DP * kEsz) < kMaxHeads ? kSlotBytes / (DP * kEsz) : kMaxHeads;
    static constexpr int kThreads = 32 * kHeads;
    static constexpr int kPer = 16 / kEsz;              // elements per 16-byte piece
    static constexpr int kRow = kHeads * DP + kPer;     // elements per staged token row
    static constexpr int kStageElems = kChunk * kRow;   // K (or V) of one stage
    static constexpr int kHalf = DP / 2;                // columns a lane dots
    static constexpr int kCols = DP >= 32 ? DP / 32 : 1;  // accumulator columns a lane owns
    static constexpr int kSmemBytes = 2 * kStages * kStageElems * kEsz +
                                      kSplit * static_cast<int>(sizeof(long long));
};

// --- PTX wrappers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of `size` bytes, of which the first `bytes` are read and the rest
// zero-filled; src aligned to `size`
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// --- end PTX wrappers

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float32 -> bfloat16 cast rounds
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// n consecutive elements of a staged row as floats (n = 1, 2 or 4 for
// float32 and bf16; 8 for bf16), aligned to n
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p) {
    if constexpr (N == 4) {
        const float4 u = *reinterpret_cast<const float4*>(p);
        x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    } else if constexpr (N == 2) {
        const float2 u = *reinterpret_cast<const float2*>(p);
        x[0] = u.x, x[1] = u.y;
    } else {
        static_assert(N == 1, "float reads of 1, 2 or 4");
        x[0] = *p;
    }
}
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const bf16* p) {
    // the two bf16 of a 32-bit word, the low half first (exact)
    auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
    auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
    if constexpr (N == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) x[2 * i] = lo(w[i]), x[2 * i + 1] = hi(w[i]);
    } else if constexpr (N == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        x[0] = lo(u.x), x[1] = hi(u.x), x[2] = lo(u.y), x[3] = hi(u.y);
    } else if constexpr (N == 2) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
        x[0] = lo(u), x[1] = hi(u);
    } else {
        static_assert(N == 1, "bf16 reads of 1, 2, 4 or 8");
        x[0] = __bfloat162float(*p);
    }
}

// 16 bytes of elements at src, of which `valid` are read and the rest zero,
// into 16 bytes of shared memory, in copies of `width` bytes (2 only for
// bf16, whose rows may sit 2 bytes off: through registers)
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, int valid, int width) {
    const uint32_t d = smem_u32(dst);
    const char* s = reinterpret_cast<const char*>(src);
    const int bytes = static_cast<int>(sizeof(T)) * valid;
    if (width == 16) {
        cp_async_16(d, src, bytes);
    } else if (width == 8) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int n = min(8, max(0, bytes - 8 * p));
            cp_async_8(d + 8 * p, n > 0 ? s + 8 * p : s, n);
        }
    } else if (width == 4) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const int n = min(4, max(0, bytes - 4 * p));
            cp_async_4(d + 4 * p, n > 0 ? s + 4 * p : s, n);
        }
    } else if constexpr (sizeof(T) == 2) {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
        uint32_t w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint32_t lo = 2 * p < valid ? h[2 * p] : 0u;
            const uint32_t hi = 2 * p + 1 < valid ? h[2 * p + 1] : 0u;
            w[p] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// One block per (lane b, head group g, split); blockIdx.x = (b * groups + g)
// * n_splits + split.  scratch: [B, H, n_splits, D + 2] floats (m, l, acc);
// counters: [B * groups] ints, 0 between launches.
template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, kMinBlocks)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ scratch, int* __restrict__ counters, int H, int D, int N,
                    int ps, int M, int groups, int n_splits, float scale) {
    using C = Cfg<T, DP>;
    extern __shared__ __align__(16) unsigned char smem[];
    T* k_s = reinterpret_cast<T*>(smem);           // kStages x [kChunk][kRow]
    T* v_s = k_s + kStages * C::kStageElems;      // kStages x [kChunk][kRow]
    long long* slot_s = reinterpret_cast<long long*>(v_s + kStages * C::kStageElems);  // [kSplit]
    __shared__ int last_s;

    const int split = static_cast<int>(blockIdx.x % n_splits);
    const int bg = static_cast<int>(blockIdx.x / n_splits);
    const int g = bg % groups, b = bg / groups;
    const int len = min(lengths[b], M * ps);
    const int n_live = len > 0 ? (len + kSplit - 1) / kSplit : 1;
    if (split >= n_live) return;  // past the lane's length: no work, no ticket
    const int t0 = split * kSplit;
    const int t1 = min(len, t0 + kSplit);  // live tokens [t0, t1)
    const int n_chunks = (t1 - t0 + kChunk - 1) / kChunk;  // 0 only for len <= 0

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h0 = g * C::kHeads;
    const int h = h0 + warp;  // this warp's head (>= H: idle but for the barriers)
    const long long slot_stride = static_cast<long long>(H) * D;

    // the split's token slots, the table entry clamped into [0, N)
    if (threadIdx.x < kSplit) {
        const int pos = t0 + static_cast<int>(threadIdx.x);
        long long slot = 0;
        if (pos < t1) {
            const int page = min(max(table[static_cast<long long>(b) * M + pos / ps], 0), N - 1);
            slot = static_cast<long long>(page) * ps + pos % ps;
        }
        slot_s[threadIdx.x] = slot;
    }
    // the widest copy every piece allows: the pools' base, the slot stride
    // and the head stride share it
    const unsigned long long bits = reinterpret_cast<unsigned long long>(k_pages) |
                                    reinterpret_cast<unsigned long long>(v_pages) |
                                    static_cast<unsigned long long>(D) * C::kEsz;
    const int width = (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : (bits & 3) == 0 ? 4 : 2;
    __syncthreads();  // slot_s

    // chunk c of the split into ring stage st: kChunk token rows of the
    // group's heads, DP columns each, in 16-byte pieces
    auto stage_chunk = [&](int st, int c) {
        constexpr int kHeadPieces = DP / C::kPer;
        constexpr int kTokPieces = C::kHeads * kHeadPieces;
        constexpr int kPieces = kChunk * kTokPieces;
        T* kd = k_s + st * C::kStageElems;
        T* vd = v_s + st * C::kStageElems;
#pragma unroll 1
        for (int idx = threadIdx.x; idx < kPieces; idx += C::kThreads) {
            const int t = idx / kTokPieces;
            const int rem = idx - t * kTokPieces;
            const int hh = rem / kHeadPieces;
            const int pc = rem - hh * kHeadPieces;
            const int pos = t0 + c * kChunk + t;
            const int col = C::kPer * pc;
            const int valid = (pos < t1 && h0 + hh < H) ? min(C::kPer, max(0, D - col)) : 0;
            const long long off =
                slot_s[c * kChunk + t] * slot_stride + static_cast<long long>(h0 + hh) * D + col;
            const int dst = t * C::kRow + hh * DP + col;
            copy_piece(kd + dst, valid > 0 ? k_pages + off : k_pages, valid, width);
            copy_piece(vd + dst, valid > 0 ? v_pages + off : v_pages, valid, width);
        }
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < n_chunks) stage_chunk(st, st);
        cp_async_commit();
    }

    // lane 16 u + t: token t of each chunk over columns [u DP/2, (u+1) DP/2)
    // of q (pre-scaled, as the Pallas kernel scales q); acc: columns
    // (lane kCols + e) mod DP
    const int t = lane & 15, u = lane >> 4;
    const int col0 = (lane * C::kCols) % DP;
    const bool owns = lane * C::kCols < DP;
    const bool head_live = h < H;
    float qr[C::kHalf];
#pragma unroll
    for (int i = 0; i < C::kHalf; ++i) {
        const int d = u * C::kHalf + i;
        qr[i] = head_live && d < D
                    ? to_float(q[(static_cast<long long>(b) * H + h) * D + d]) * scale
                    : 0.0f;
    }
    float acc[C::kCols];
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) acc[e] = 0.0f;
    float m = -CUDART_INF_F;  // running max of the live scores
    float l = 0.0f;       // running sum of exp(score - m)
    constexpr int kRead = sizeof(T) == 2 ? 8 : 4;  // elements per shared read of K

    for (int c = 0; c < n_chunks; ++c) {
        if (c + kStages - 1 < n_chunks) stage_chunk((c + kStages - 1) % kStages, c + kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();  // chunk c has landed for every thread
        if (head_live) {
            const T* kt = k_s + (c % kStages) * C::kStageElems + warp * DP;
            const T* vt = v_s + (c % kStages) * C::kStageElems + warp * DP;
            const bool live = t0 + c * kChunk + t < t1;
            // the score of token t: this lane's half of D, then the other's
            float part = 0.0f;
            const T* krow = kt + t * C::kRow + u * C::kHalf;
#pragma unroll
            for (int i = 0; i < C::kHalf; i += kRead) {
                float kv[kRead];
                load_row<kRead>(kv, krow + i);
#pragma unroll
                for (int e = 0; e < kRead; ++e) part = fmaf(qr[i + e], kv[e], part);
            }
            float s = part + __shfl_xor_sync(kFull, part, 16);
            s = live ? s : -CUDART_INF_F;
            // the chunk's max and sum over its 16 tokens (each half holds all 16)
            float mc = s;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
            const float m_new = fmaxf(m, mc);  // finite: the chunk's first token is live
            const float corr = expf(m - m_new);  // 0 on the first chunk (m = -inf)
            const float p = live ? expf(s - m_new) : 0.0f;
            float ps_sum = p;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) ps_sum += __shfl_xor_sync(kFull, ps_sum, o);
            l = l * corr + ps_sum;
            m = m_new;
#pragma unroll
            for (int e = 0; e < C::kCols; ++e) acc[e] *= corr;
            // p . V over the chunk's tokens in order, p of token j from lane j
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const float pj = __shfl_sync(kFull, p, j);
                float vv[C::kCols];
                load_row<C::kCols>(vv, vt + j * C::kRow + col0);
#pragma unroll
                for (int e = 0; e < C::kCols; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
            }
        }
        __syncthreads();  // stage c % kStages read before it is refilled
    }
    cp_async_wait<0>();

    const long long bh = static_cast<long long>(b) * H + h;
    if (n_live == 1) {  // the whole context in this block: the output directly
        if (head_live && owns) {
            const float denom = fmaxf(l, 1e-30f);
#pragma unroll
            for (int e = 0; e < C::kCols; ++e) {
                if (col0 + e < D) store(out + bh * D + col0 + e, acc[e] / denom);
            }
        }
        return;
    }
    // this split's partial, then a ticket; the last block to arrive combines
    const int rec = D + 2;
    if (head_live) {
        float* part = scratch + (bh * n_splits + split) * rec;
        if (lane == 0) part[0] = m, part[1] = l;
        if (owns) {
#pragma unroll
            for (int e = 0; e < C::kCols; ++e) {
                if (col0 + e < D) part[2 + col0 + e] = acc[e];
            }
        }
    }
    __threadfence();  // the partial is visible device-wide before the ticket
    __syncthreads();
    if (threadIdx.x == 0) {
        const int ticket = atomicAdd(counters + bg, 1);
        last_s = ticket == n_live - 1;
        if (last_s) counters[bg] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    if (!head_live) return;
    // combine in split order: the largest max first, then the weighted sums
    const float* parts = scratch + bh * n_splits * rec;
    float m_all = -CUDART_INF_F;
    for (int s = 0; s < n_live; ++s) m_all = fmaxf(m_all, __ldcg(parts + s * rec));
    float l_all = 0.0f;
    float o[C::kCols];
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) o[e] = 0.0f;
    for (int s = 0; s < n_live; ++s) {
        const float* ps_ = parts + s * rec;
        const float w = expf(__ldcg(ps_) - m_all);
        l_all = l_all + __ldcg(ps_ + 1) * w;
#pragma unroll
        for (int e = 0; e < C::kCols; ++e) {
            const int col = col0 + e;
            o[e] = o[e] + (col < D ? __ldcg(ps_ + 2 + col) : 0.0f) * w;
        }
    }
    if (owns) {
        const float denom = fmaxf(l_all, 1e-30f);
#pragma unroll
        for (int e = 0; e < C::kCols; ++e) {
            if (col0 + e < D) store(out + bh * D + col0 + e, o[e] / denom);
        }
    }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* table,
                   const int* lengths, void* out, float* scratch, int* counters, int B, int H,
                   int D, int N, int ps, int M, float scale, cudaStream_t stream) {
    using C = Cfg<T, DP>;
    const int groups = (H + C::kHeads - 1) / C::kHeads;
    const int n_splits = (M * ps + kSplit - 1) / kSplit;
    const unsigned long long blocks =
        static_cast<unsigned long long>(B) * groups * static_cast<unsigned long long>(n_splits);
    if (blocks == 0 || blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    auto kernel = paged_decode_kernel<T, DP>;
    if (C::kSmemBytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmemBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        table, lengths, static_cast<T*>(out), scratch, counters, H, D, N, ps, M, groups,
        n_splits, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const void* q, const void* k_pages, const void* v_pages,
                        const int* table, const int* lengths, void* out, float* scratch,
                        int* counters, int B, int H, int D, int N, int ps, int M, float scale,
                        cudaStream_t s) {
#define PAGED_LAUNCH(DP) \
    launch<T, DP>(q, k_pages, v_pages, table, lengths, out, scratch, counters, B, H, D, N, ps, M, \
                  scale, s)
    if (D <= 16) return PAGED_LAUNCH(16);
    if (D <= 32) return PAGED_LAUNCH(32);
    if (D <= 64) return PAGED_LAUNCH(64);
    if (D <= 128) return PAGED_LAUNCH(128);
#undef PAGED_LAUNCH
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  split_tokens: the wrapper's tokens per
// split, which sized its scratch; any value but kSplit is refused.  scratch:
// at least B * H * ceil(M * ps / kSplit) * (D + 2) floats; counters: at
// least B * H ints, all 0, which the kernel leaves 0 (launches sharing them
// must be ordered, as on one stream).
// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// reaches the caller; it does not synchronise.  The caller checks shapes
// (D <= 128), types and contiguity.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* table, const int* lengths, void* out,
                                      float* scratch, int* counters, int split_tokens, int B,
                                      int H, int D, int N, int ps, int M, float scale, int dtype,
                                      void* stream) {
    if (split_tokens != kSplit) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return static_cast<int>(by_head_dim<float>(q, k_pages, v_pages, table, lengths, out,
                                                   scratch, counters, B, H, D, N, ps, M, scale,
                                                   s));
    }
    if (dtype == 1) {
        return static_cast<int>(by_head_dim<bf16>(q, k_pages, v_pages, table, lengths, out,
                                                  scratch, counters, B, H, D, N, ps, M, scale,
                                                  s));
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
