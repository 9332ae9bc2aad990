// Causal self-attention within packed segments: forward, dq and dk/dv.
//
// Replaces the three TPU kernels behind scalerl_tpu/ops/pallas_attention.py::
// segment_flash_attention: _seg_fwd_kernel, _seg_bwd_dq_kernel and
// _seg_bwd_dkv_kernel.  Their grids put the other axis innermost and carry
// the accumulators in VMEM scratch from one grid step to the next; here a
// block owns its rows and loops over the other axis itself.
//
// Contract (ops/attention.py::segment_attention_reference): q, k, v
// [B, S, H, D] (float32 or bfloat16, one type for all three), segment ids
// [B, S] int32 with 0 = pad.  Query i attends key j iff j <= i and
// seg[j] == seg[i] != 0; scores are scale * q.k in float32; the output is in
// q's type and lse [B, H, S] in float32.  A query with no live key gives
// exact zeros and lse = -inf; dq of such a query and dk, dv of a key that no
// query attends are exact zeros.  Head dims: the forward kernel takes D <=
// 64 (instantiated at 32 and 64), dq D <= 32 (at 64 its three row vectors
// spill registers), dk/dv D <= 128 (32, 64, 128); columns past D ride as
// zeros.
//
// Two designs.
//
// Forward and dq, one row per thread: a block of kOwn = 64 threads owns 64
// consecutive queries of one (batch row, head), one per thread, with that
// row's vectors (q and the output accumulator; q, do and dq) in registers.
// It walks the keys in tiles of kOther = 32 rows staged in shared memory as
// float32, so every inner product reads its second operand as a broadcast
// float4 from shared memory.  The forward takes scores kChunk = 8 at a
// time, to keep them in registers, and folds each chunk into an online
// softmax; dq, whose row vectors already fill the register file, takes one
// key of the tile at a time.  q enters both multiplied by scale; dq gets
// the second factor when it is stored.  A warp reduces a tile's 32 ids to
// the range of its nonzero ids; a tile is skipped when its range cannot
// meet the range of the block's own rows, or when it lies wholly above the
// diagonal (the loop bounds).
//
// dk/dv, register-blocked micro-tiles (namespace mt; the float32 design of
// csrc/flash_attention.cu's mt::flash_bwd_dkv_kernel, with the segment
// rule): a block of 4 warps owns 16 keys of one (batch row, head), k and v
// staged once; q, do, lse, delta and the query ids stream through a
// 2-stage cp.async ring of 64-query tiles from the block's first key, warp
// w taking queries 16 w .. 16 w + 15 of each.  Lane 8 r + c computes the
// 4 x 2 micro-tiles of S^T = k q^T and dP^T = v do^T of keys r + 4 i
// against queries c + 8 j in one pass over D (float4 reads of both sides,
// shared rows padded by 4 floats), P^T = exp(S^T scale - lse) kept where
// the segment rule holds element by element, and dS^T = P^T (dP^T -
// delta); both pass through per-warp shared tiles into dv += P^T do and
// dk += dS^T q, micro-tiled over the keys and D / 8 columns of lane c.  The
// 4 warps' partials combine through shared memory in warp order; scale
// multiplies dk once, at the store.  A 64-query tile whose ids cannot meet
// the block's keys' is neither staged nor read (every warp reduces the
// tile's ids itself and reaches the same verdict), and a warp whose 16
// queries lie in other segments skips its products.  The staging loops stay
// rolled.  float32 is staged by 16-, 8- or 4-byte cp.async copies by the
// rows' alignment; bfloat16 is converted to float32 on its way to shared
// memory, through registers.  The arithmetic is exact float32 either way:
// FMAs and expf, no TF32.
//
// Ragged S: rows past S load as zeros with id 0 and are never stored.  q, k
// and v are addressed through their batch, token and head strides (unit
// stride along D), so the views a fused qkv projection hands over are read
// in place.  o, lse, delta, do, dq, dk and dv are contiguous.
//
// No atomics: dq is summed by the thread that owns the query, dk and dv by
// the warps that own the key's queries and then in warp order, each in a
// fixed order, so results repeat bit for bit.  delta = sum_d do * o is
// computed by the dq kernel (each thread has its row of do and reads its
// row of o) and written to a [B, H, S] buffer that the dk/dv kernel,
// launched after it on the same stream, reads.
//
// Bound on an H100.  The work is 4*D flops per live (i, j) pair forward, 6*D
// for dq and 8*D for dk/dv, in float32 FMAs outside the tensor cores (67
// TFLOP/s); the bytes are q, k, v, o, do, dq, dk, dv and the ids, lse and
// delta.  At the bench's packed batch ([32, 256, 8, 32]) bytes bound every
// kernel; at the learn step's rows of 512 ([64, 512, 8, 32], 2-3 segments a
// row) operations do.  The one-row-per-thread design runs dependent chains
// of 32 FMAs per pair with no independent work across pairs, so it reaches
// a tenth of that bound; the micro-tiles give each lane 16 independent
// chains per pass over D and read each staged value once per 8 FMAs.
//
// Numerics: expf and logf (no fast math).  Sums over D and over the keys run
// in another order than the plain version's softmax and einsum.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kOwn = 64;     // rows a block owns, one per thread
constexpr int kOther = 32;   // rows of the other axis per shared-memory tile
constexpr int kChunk = 8;    // scores held in registers at a time
constexpr unsigned kFull = 0xffffffffu;

static_assert(kOther == kWarp, "a tile's ids are reduced one per lane");
static_assert(kOwn % kWarp == 0 && kOther % kChunk == 0, "tile sizes");

struct Strides {
    long long b, t, h;  // in elements; the stride along D is 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float32 -> bfloat16 cast rounds
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// (min nonzero id, max id) over the warp's 32 ids, in every lane
__device__ __forceinline__ void warp_seg_range(int id, int& lo, int& hi) {
    hi = __reduce_max_sync(kFull, id);
    lo = __reduce_min_sync(kFull, id > 0 ? id : INT_MAX);
}

// the range over the block's own kOwn ids (one per thread), in every thread
__device__ __forceinline__ void block_seg_range(int id, int* scratch, int& lo, int& hi) {
    int w_lo, w_hi;
    warp_seg_range(id, w_lo, w_hi);
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) {
        scratch[2 * warp] = w_lo;
        scratch[2 * warp + 1] = w_hi;
    }
    __syncthreads();
    lo = INT_MAX;
    hi = 0;
#pragma unroll
    for (int w = 0; w < kOwn / kWarp; ++w) {
        lo = min(lo, scratch[2 * w]);
        hi = max(hi, scratch[2 * w + 1]);
    }
}

__device__ __forceinline__ bool ranges_meet(int a_lo, int a_hi, int b_lo, int b_hi) {
    return a_hi > 0 && b_hi > 0 && a_lo <= b_hi && b_lo <= a_hi;
}

// Stage rows [r0, r0 + kOther) of x (one head of one batch row) into a
// float32 tile, times `mul`; rows past S and columns past D read as zero.
template <typename T, int DMAX>
__device__ __forceinline__ void stage_tile(float (*tile)[DMAX], const T* __restrict__ x,
                                           long long base, long long stride_t, int r0, int S,
                                           int D, float mul) {
    for (int idx = threadIdx.x; idx < kOther * DMAX; idx += kOwn) {
        const int r = idx / DMAX;
        const int d = idx - r * DMAX;
        const int row = r0 + r;
        const bool ok = row < S && d < D;
        tile[r][d] = ok ? to_float(x[base + row * stride_t + d]) * mul : 0.0f;
    }
}

// this thread's row of x into registers, times `mul`
template <typename T, int DMAX>
__device__ __forceinline__ void load_row(float (&reg)[DMAX], const T* __restrict__ x,
                                         long long offset, bool live, int D, float mul) {
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        reg[d] = (live && d < D) ? to_float(x[offset + d]) * mul : 0.0f;
    }
}

template <int DMAX>
__device__ __forceinline__ float dot_shared(const float (&reg)[DMAX], const float* row) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + d);
        acc += reg[d] * x.x;
        acc += reg[d + 1] * x.y;
        acc += reg[d + 2] * x.z;
        acc += reg[d + 3] * x.w;
    }
    return acc;
}

// reg += w * row
template <int DMAX>
__device__ __forceinline__ void axpy_shared(float (&reg)[DMAX], float w, const float* row) {
#pragma unroll
    for (int d = 0; d < DMAX; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + d);
        reg[d] += w * x.x;
        reg[d + 1] += w * x.y;
        reg[d + 2] += w * x.z;
        reg[d + 3] += w * x.w;
    }
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(S / kOwn), H, B), one query per thread
template <typename T, int DMAX>
__global__ void __launch_bounds__(kOwn)
seg_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
               int S, int H, int D, Strides sq, Strides sk, Strides sv, float scale) {
    __shared__ __align__(16) float k_s[kOther][DMAX];
    __shared__ __align__(16) float v_s[kOther][DMAX];
    __shared__ int seg_s[kOther];
    __shared__ int range_s[2 * (kOwn / kWarp)];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kOwn;
    const int lane = threadIdx.x % kWarp;
    const int i = q0 + threadIdx.x;
    const bool in_range = i < S;
    const int* seg_row = seg + static_cast<long long>(b) * S;
    const int my_seg = in_range ? seg_row[i] : 0;
    int q_lo, q_hi;
    block_seg_range(my_seg, range_s, q_lo, q_hi);

    float q_r[DMAX], acc[DMAX];
    load_row<T, DMAX>(q_r, q, b * sq.b + i * sq.t + h * sq.h, in_range, D, scale);
#pragma unroll
    for (int d = 0; d < DMAX; ++d) acc[d] = 0.0f;
    float m = -CUDART_INF_F;  // running max of the live scores
    float l = 0.0f;           // running sum of exp(score - m)

    const long long k_base = b * sk.b + h * sk.h;
    const long long v_base = b * sv.b + h * sv.h;
    const int last = min(q0 + kOwn, S) - 1;  // the block's last query bounds the keys
    for (int k0 = 0; k0 <= last; k0 += kOther) {
        const int k_id = k0 + lane < S ? seg_row[k0 + lane] : 0;
        int k_lo, k_hi;
        warp_seg_range(k_id, k_lo, k_hi);
        if (!ranges_meet(q_lo, q_hi, k_lo, k_hi)) continue;  // the same in every warp

        __syncthreads();  // the previous tile has been read
        stage_tile<T, DMAX>(k_s, k, k_base, sk.t, k0, S, D, 1.0f);
        stage_tile<T, DMAX>(v_s, v, v_base, sv.t, k0, S, D, 1.0f);
        if (threadIdx.x < kOther) seg_s[threadIdx.x] = k_id;
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < kOther; c += kChunk) {
            float s[kChunk];
            float m_chunk = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const int key = k0 + c + j;
                const bool valid = my_seg > 0 && key <= i && seg_s[c + j] == my_seg;
                const float dot = dot_shared<DMAX>(q_r, k_s[c + j]);
                s[j] = valid ? dot : -CUDART_INF_F;
                m_chunk = fmaxf(m_chunk, s[j]);
            }
            const float m_new = fmaxf(m, m_chunk);
            // no live key yet: exp(-inf - 0) = 0 everywhere, never -inf - -inf
            const float safe_m = m_new == -CUDART_INF_F ? 0.0f : m_new;
            const float corr = expf(m - safe_m);
            float p_sum = 0.0f;
#pragma unroll
            for (int d = 0; d < DMAX; ++d) acc[d] *= corr;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const float p = expf(s[j] - safe_m);
                p_sum += p;
                axpy_shared<DMAX>(acc, p, v_s[c + j]);
            }
            l = l * corr + p_sum;
            m = m_new;
        }
    }

    if (!in_range) return;
    const float denom = fmaxf(l, 1e-30f);
    T* o_row = o + ((static_cast<long long>(b) * S + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        if (d < D) store(o_row + d, acc[d] / denom);
    }
    lse[(static_cast<long long>(b) * H + h) * S + i] =
        l > 0.0f ? m + logf(denom) : -CUDART_INF_F;
}

// ---------------------------------------------------------------------------
// dq (and delta): grid (ceil(S / kOwn), H, B), one query per thread
template <typename T, int DMAX>
__global__ void __launch_bounds__(kOwn)
seg_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ seg, const T* __restrict__ o,
                  const T* __restrict__ d_o, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ delta,
                  int S, int H, int D, Strides sq, Strides sk, Strides sv, float scale) {
    __shared__ __align__(16) float k_s[kOther][DMAX];
    __shared__ __align__(16) float v_s[kOther][DMAX];
    __shared__ int seg_s[kOther];
    __shared__ int range_s[2 * (kOwn / kWarp)];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kOwn;
    const int lane = threadIdx.x % kWarp;
    const int i = q0 + threadIdx.x;
    const bool in_range = i < S;
    const int* seg_row = seg + static_cast<long long>(b) * S;
    const int my_seg = in_range ? seg_row[i] : 0;
    int q_lo, q_hi;
    block_seg_range(my_seg, range_s, q_lo, q_hi);

    const long long row = ((static_cast<long long>(b) * S + i) * H + h) * D;  // o, do, dq
    const long long stat = (static_cast<long long>(b) * H + h) * S + i;      // lse, delta
    float q_r[DMAX], do_r[DMAX], dq_r[DMAX];
    load_row<T, DMAX>(q_r, q, b * sq.b + i * sq.t + h * sq.h, in_range, D, scale);
    load_row<T, DMAX>(do_r, d_o, row, in_range, D, 1.0f);
    float my_delta = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        dq_r[d] = 0.0f;
        if (in_range && d < D) my_delta += do_r[d] * to_float(o[row + d]);
    }
    float my_lse = in_range ? lse[stat] : -CUDART_INF_F;
    if (my_lse == -CUDART_INF_F) my_lse = 0.0f;  // a pad query: every p is masked anyway

    const long long k_base = b * sk.b + h * sk.h;
    const long long v_base = b * sv.b + h * sv.h;
    const int last = min(q0 + kOwn, S) - 1;
    for (int k0 = 0; k0 <= last; k0 += kOther) {
        const int k_id = k0 + lane < S ? seg_row[k0 + lane] : 0;
        int k_lo, k_hi;
        warp_seg_range(k_id, k_lo, k_hi);
        if (!ranges_meet(q_lo, q_hi, k_lo, k_hi)) continue;

        __syncthreads();
        stage_tile<T, DMAX>(k_s, k, k_base, sk.t, k0, S, D, 1.0f);
        stage_tile<T, DMAX>(v_s, v, v_base, sv.t, k0, S, D, 1.0f);
        if (threadIdx.x < kOther) seg_s[threadIdx.x] = k_id;
        __syncthreads();

        // one key at a time: three row vectors already fill the registers
#pragma unroll 2
        for (int j = 0; j < kOther; ++j) {
            const bool valid = my_seg > 0 && k0 + j <= i && seg_s[j] == my_seg;
            const float s = dot_shared<DMAX>(q_r, k_s[j]);
            const float dp = dot_shared<DMAX>(do_r, v_s[j]);
            const float ds = valid ? expf(s - my_lse) * (dp - my_delta) : 0.0f;
            axpy_shared<DMAX>(dq_r, ds, k_s[j]);
        }
    }

    if (!in_range) return;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        if (d < D) store(dq + row + d, dq_r[d] * scale);
    }
    delta[stat] = my_delta;
}

// ---------------------------------------------------------------------------
// dk and dv: register-blocked micro-tiles (the header's dk/dv design)
namespace mt {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // keys a block owns
constexpr int kTile = 16 * kWarps;   // queries per ring stage, 16 a warp
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kPStride = 16 + kPad;  // floats per row of a warp's P^T (or dS^T) tile
// Blocks per SM the register budget must allow (at most 255 registers a
// thread, for dk and dv's 2 x 4 x DP / 8 accumulators a lane at DP = 128);
// at DP = 32 ptxas takes 128, so 4 blocks an SM fit, as the shared memory
// does (4 x 53 KB)
constexpr int kMinBlocks = 2;
// Unrolling: the loops over D kDotUnroll times, those over a warp's 16
// queries kRowUnroll times, the staging loops not at all (unrolled staging
// doubled the float32 flash kernels' time inside a learn step on an H100,
// through the instruction caches, however they timed alone)
constexpr int kDotUnroll = 4;
constexpr int kRowUnroll = 4;

template <int DP>
struct Dims {
    static_assert(DP % 8 == 0 && DP >= 8 && DP <= 128, "8 lanes share a row's columns");
    static constexpr int kStride = DP + kPad;           // floats per shared row
    static constexpr int kTileElems = kTile * kStride;  // one [64][DP + 4] tile
    static constexpr int kCols = DP / 8;                // accumulator columns a lane holds
    static constexpr int kVec = kCols < 4 ? kCols : 4;  // floats per vector read
    static constexpr int kSmemBytes =
        ((2 * kRows + 4 * kTile) * kStride + 2 * kWarps * 16 * kPStride + 4 * kTile) *
            static_cast<int>(sizeof(float)) +
        (2 * kTile + kRows) * static_cast<int>(sizeof(int));
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

// The widest copy every row of a slice allows: its first row's address and
// its row stride, in bytes, share this power of two (16 at most).
template <typename T>
__device__ __forceinline__ int copy_width(const T* x, long long stride_t) {
    const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                    static_cast<unsigned long long>(stride_t) * sizeof(T);
    return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : (bits & 3) == 0 ? 4 : 2;
}

// Rows [r0, r0 + ROWS) of a float32 slice (x at its row 0, rows stride_t
// apart) into a [ROWS][DP + kPad] tile by cp.async, zero at or past row n
// and column D; the loop over a thread's 16-byte pieces stays rolled.  The
// caller commits the group.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(float* tile, const float* __restrict__ x,
                                           long long stride_t, int r0, int n, int D, int width) {
    constexpr int kRowPieces = DP / 4;
    constexpr int kPieces = ROWS * kRowPieces;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kPieces; idx += kThreads) {
        const int r = idx / kRowPieces;
        const int col = 4 * (idx - r * kRowPieces);
        const int row = r0 + r;
        const int valid = row < n ? min(4, max(0, D - col)) : 0;
        const float* src = valid > 0 ? x + row * stride_t + col : x;
        const uint32_t dst = smem_u32(tile + r * Dims<DP>::kStride + col);
        if (width == 16) {
            cp_async_16(dst, src, 4 * valid);
        } else if (width == 8) {
            cp_async_8(dst, src, 4 * min(2, valid));
            cp_async_8(dst + 8, valid > 2 ? src + 2 : src, 4 * max(0, valid - 2));
        } else {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                cp_async_4(dst + 4 * p, p < valid ? src + p : src, p < valid ? 4 : 0);
            }
        }
    }
}

// The same for a bfloat16 slice, converted to float32 on the way: through
// registers (8- or 2-byte loads, by the rows' alignment), not cp.async.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(float* tile, const __nv_bfloat16* __restrict__ x,
                                           long long stride_t, int r0, int n, int D, int width) {
    constexpr int kRowPieces = DP / 4;
    constexpr int kPieces = ROWS * kRowPieces;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kPieces; idx += kThreads) {
        const int r = idx / kRowPieces;
        const int col = 4 * (idx - r * kRowPieces);
        const int row = r0 + r;
        const int valid = row < n ? min(4, max(0, D - col)) : 0;
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (valid > 0) {
            const __nv_bfloat16* src = x + row * stride_t + col;
            if (valid == 4 && width >= 8) {
                const uint2 w = *reinterpret_cast<const uint2*>(src);
                f = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                                __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
            } else {
                float e[4];
#pragma unroll
                for (int p = 0; p < 4; ++p) e[p] = p < valid ? __bfloat162float(src[p]) : 0.0f;
                f = make_float4(e[0], e[1], e[2], e[3]);
            }
        }
        *reinterpret_cast<float4*>(tile + r * Dims<DP>::kStride + col) = f;
    }
}

// kTile 4-byte values (lse, delta or ids) from rows [r0, r0 + kTile) of x,
// zero past n, by threads `first` .. first + kTile - 1 of the block
template <typename V>
__device__ __forceinline__ void stage_column(V* dst, const V* __restrict__ x, int r0, int n,
                                             int first) {
    const int i = static_cast<int>(threadIdx.x) - first;
    if (i >= 0 && i < kTile) {
        const int row = r0 + i;
        cp_async_4(smem_u32(dst + i), row < n ? x + row : x, row < n ? 4 : 0);
    }
}

// n < N: acc[n][i][j] += (row r + 4 i of a[n]) . (row c + 8 j of b[n]) over
// DP columns in order, rows kS floats apart: 4 x 2 micro-tiles fed by float4
// reads, N products in one pass over D
template <int DP, int kS, int N>
__device__ __forceinline__ void micro_tiles(float (*acc)[4][2], const float* const* a,
                                            const float* const* b, int r, int c) {
#pragma unroll(kDotUnroll)
    for (int d = 0; d < DP; d += 4) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            float4 av[4], bv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                av[i] = *reinterpret_cast<const float4*>(a[n] + (r + 4 * i) * kS + d);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                bv[j] = *reinterpret_cast<const float4*>(b[n] + (c + 8 * j) * kS + d);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    acc[n][i][j] = fmaf(av[i].x, bv[j].x, acc[n][i][j]);
                    acc[n][i][j] = fmaf(av[i].y, bv[j].y, acc[n][i][j]);
                    acc[n][i][j] = fmaf(av[i].z, bv[j].z, acc[n][i][j]);
                    acc[n][i][j] = fmaf(av[i].w, bv[j].w, acc[n][i][j]);
                }
            }
        }
    }
}

// n floats from shared memory (n = 1, 2 or 4, aligned to n)
template <int N>
__device__ __forceinline__ void load_f(float (&x)[N], const float* p) {
    if constexpr (N == 4) {
        const float4 u = *reinterpret_cast<const float4*>(p);
        x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    } else if constexpr (N == 2) {
        const float2 u = *reinterpret_cast<const float2*>(p);
        x[0] = u.x, x[1] = u.y;
    } else {
        x[0] = *p;
    }
}

// A 1-D grid of ceil(S / kRows) * H * B blocks, the first key tiles first.
// Lane 8 r + c of warp w: S^T and dP^T of keys k0 + r + 4 i against queries
// 16 w + c + 8 j of each tile; dk and dv of keys k0 + r + 4 i at the columns
// col(u, e) = 8 kVec u + kVec c + e.
// The addresses of one (batch row, head)'s streamed rows
template <typename T>
struct Rows {
    const T* q;
    const T* d_o;
    const float* lse;
    const float* delta;
    const int* seg;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ seg, const T* __restrict__ d_o,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int H, int B, int D,
                   Strides sq, Strides sk, Strides sv, float scale) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
    constexpr int kU = L::kCols / L::kVec;  // vector reads per dk or dv row
    extern __shared__ __align__(16) unsigned char smem[];
    float* k_s = reinterpret_cast<float*>(smem);  // [kRows][DP + 4]
    float* v_s = k_s + kRows * kS;                // [kRows][DP + 4]
    float* q_s = v_s + kRows * kS;                // 2 stages
    float* do_s = q_s + 2 * L::kTileElems;        // 2 stages
    float* p_s = do_s + 2 * L::kTileElems;        // [kWarps][16 queries][kPStride] P^T
    float* ds_s = p_s + kWarps * 16 * kPStride;   // [kWarps][16 queries][kPStride] dS^T
    float* lse_s = ds_s + kWarps * 16 * kPStride;  // 2 stages of kTile
    float* dl_s = lse_s + 2 * kTile;              // 2 stages of kTile
    int* qid_s = reinterpret_cast<int*>(dl_s + 2 * kTile);  // 2 stages of kTile query ids
    int* kid_s = qid_s + 2 * kTile;               // [kRows] the block's key ids
    float* part = q_s;  // [2][kWarps][kRows][DP]: the warps' dk and dv, once the ring is done

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int k0 = static_cast<int>(blockIdx.x / slices) * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    const T* kx = k + b * sk.b + h * sk.h;
    const T* vx = v + b * sv.b + h * sv.h;
    const long long do_stride = static_cast<long long>(H) * D;
    // The streamed rows' addresses sit in shared memory and are read again
    // after each barrier.  Held in registers across the loop they took the
    // kernel to 158 registers at DP = 32 (3 blocks an SM, 7-10% slower at
    // the token-PPO learner's shapes on an H100), and held to 128 ptxas
    // spilled two of them
    __shared__ Rows<T> rows_s;
    if (threadIdx.x == 0) {
        const long long stat = (static_cast<long long>(b) * H + h) * S;
        rows_s = Rows<T>{q + b * sq.b + h * sq.h,
                         d_o + (static_cast<long long>(b) * S * H + h) * D, lse + stat,
                         delta + stat, seg + static_cast<long long>(b) * S};
    }
    __syncthreads();

    // the block's key ids and their range (min nonzero, max), in every thread
    int k_lo = INT_MAX, k_hi = 0;
    for (int x = 0; x < kRows; ++x) {
        const int id = k0 + x < S ? rows_s.seg[k0 + x] : 0;
        if (id > 0) k_lo = min(k_lo, id);
        k_hi = max(k_hi, id);
    }
    if (threadIdx.x < kRows) {
        const int key = k0 + static_cast<int>(threadIdx.x);
        kid_s[threadIdx.x] = key < S ? rows_s.seg[key] : 0;
    }
    // queries before the block's first key see none of its keys; a 64-query
    // tile whose ids cannot meet the keys' is skipped (the same verdict in
    // every warp, from its own reduction of the tile's ids)
    const int n_tiles = (S - k0 + kTile - 1) / kTile;
    auto next_live = [&](int it) {
        for (; it < n_tiles; ++it) {
            const int i0 = k0 + it * kTile;
            const int a = i0 + lane < S ? rows_s.seg[i0 + lane] : 0;
            const int z = i0 + 32 + lane < S ? rows_s.seg[i0 + 32 + lane] : 0;
            const int hi = __reduce_max_sync(kFull, max(a, z));
            const int lo = __reduce_min_sync(kFull, min(a > 0 ? a : INT_MAX, z > 0 ? z : INT_MAX));
            if (ranges_meet(lo, hi, k_lo, k_hi)) break;
        }
        return it;
    };
    auto stage_queries = [&](int st, int i0) {
        const Rows<T> x = rows_s;
        stage_rows<DP, kTile>(q_s + st * L::kTileElems, x.q, sq.t, i0, S, D, copy_width(x.q, sq.t));
        stage_rows<DP, kTile>(do_s + st * L::kTileElems, x.d_o, do_stride, i0, S, D,
                              copy_width(x.d_o, do_stride));
        stage_column(lse_s + st * kTile, x.lse, i0, S, 0);
        stage_column(dl_s + st * kTile, x.delta, i0, S, kTile);
        stage_column(qid_s + st * kTile, x.seg, i0, S, 0);
    };
    stage_rows<DP, kRows>(k_s, kx, sk.t, k0, S, D, copy_width(kx, sk.t));
    stage_rows<DP, kRows>(v_s, vx, sv.t, k0, S, D, copy_width(vx, sv.t));
    int it = k_hi > 0 ? next_live(0) : n_tiles;
    if (it < n_tiles) stage_queries(0, k0 + it * kTile);
    cp_async_commit();

    float dk_acc[4][L::kCols], dv_acc[4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.0f;
    }
    float* pw = p_s + warp * 16 * kPStride;
    float* dw = ds_s + warp * 16 * kPStride;

    for (int st = 0; it < n_tiles; st ^= 1) {
        const int nxt = next_live(it + 1);
        if (nxt < n_tiles) stage_queries(st ^ 1, k0 + nxt * kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int iw = k0 + it * kTile + 16 * warp;  // the warp's first query
        const float* qt = q_s + st * L::kTileElems + 16 * warp * kS;
        const float* gt = do_s + st * L::kTileElems + 16 * warp * kS;
        const float* lse_t = lse_s + st * kTile + 16 * warp;
        const float* dl_t = dl_s + st * kTile + 16 * warp;
        const int* qid_t = qid_s + st * kTile + 16 * warp;
        // the warp's 16 query ids (0 past S) against the keys' range: a warp
        // whose queries all lie in other segments adds nothing
        const int my_q = qid_t[lane & 15];
        const int w_hi = __reduce_max_sync(kFull, my_q);
        const int w_lo = __reduce_min_sync(kFull, my_q > 0 ? my_q : INT_MAX);
        if (ranges_meet(w_lo, w_hi, k_lo, k_hi)) {
            // S^T = k q^T and dP^T = v do^T, the 4 x 2 micro-tiles
            float sd[2][4][2] = {};
            const float* rows[2] = {k_s, v_s};
            const float* cols[2] = {qt, gt};
            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);
            const float(&st_)[4][2] = sd[0];
            const float(&dpt)[4][2] = sd[1];
            // P^T = exp(S^T scale - lse) (-inf read as 0), kept where query
            // iw + c + 8 j sees key k0 + r + 4 i: at or after it, in its
            // segment (not pad), before S (a query past S has id 0)
            float p[4][2], dl[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float row_lse = lse_t[c + 8 * j];
                row_lse = row_lse == -CUDART_INF_F ? 0.0f : row_lse;
                dl[j] = dl_t[c + 8 * j];
                const int qi = iw + c + 8 * j;
                const int qid = qid_t[c + 8 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int kid = kid_s[r + 4 * i];
                    const bool valid = kid > 0 && kid == qid && k0 + r + 4 * i <= qi;
                    p[i][j] = valid ? expf(__fmul_rn(st_[i][j], scale) - row_lse) : 0.0f;
                }
            }
            // P^T and dS^T = P^T (dP^T - delta) to the warp's tiles,
            // query-major: row 4 r + i of query c + 8 j
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float ds[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) ds[i] = p[i][j] * (dpt[i][j] - dl[j]);
                *reinterpret_cast<float4*>(pw + (c + 8 * j) * kPStride + 4 * r) =
                    make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
                *reinterpret_cast<float4*>(dw + (c + 8 * j) * kPStride + 4 * r) =
                    make_float4(ds[0], ds[1], ds[2], ds[3]);
            }
            __syncwarp();
            // dv += P^T do and dk += dS^T q over the warp's 16 queries, in order
#pragma unroll(kRowUnroll)
            for (int qi = 0; qi < 16; ++qi) {
                const float4 pv = *reinterpret_cast<const float4*>(pw + qi * kPStride + 4 * r);
                const float4 sv4 = *reinterpret_cast<const float4*>(dw + qi * kPStride + 4 * r);
                const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
                const float sr[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    float gg[L::kVec], qq[L::kVec];
                    load_f<L::kVec>(gg, gt + qi * kS + 8 * L::kVec * u + L::kVec * c);
                    load_f<L::kVec>(qq, qt + qi * kS + 8 * L::kVec * u + L::kVec * c);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int e = 0; e < L::kVec; ++e) {
                            const int n = L::kVec * u + e;
                            dv_acc[i][n] = fmaf(pr[i], gg[e], dv_acc[i][n]);
                            dk_acc[i][n] = fmaf(sr[i], qq[e], dk_acc[i][n]);
                        }
                    }
                }
            }
        }
        __syncthreads();  // tile it (and the P^T, dS^T tiles) read before refilling
        it = nxt;
    }

    // combine the 4 warps' dk and dv in warp order; scale on dk once, at the store
    cp_async_wait<0>();
    __syncthreads();  // the ring's last reads are done before it becomes `part`
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float* dst_k = part + (warp * kRows + r + 4 * i) * DP;
        float* dst_v = dst_k + kWarps * kRows * DP;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) {
                dst_k[8 * L::kVec * u + L::kVec * c + e] = dk_acc[i][L::kVec * u + e];
                dst_v[8 * L::kVec * u + L::kVec * c + e] = dv_acc[i][L::kVec * u + e];
            }
        }
    }
    __syncthreads();
    const long long base = (static_cast<long long>(b) * S * H + h) * D;
    const float* part_v = part + kWarps * kRows * DP;
    constexpr int kOut = kRows * DP;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kOut; idx += kThreads) {
        const int row = idx / DP, col = idx % DP;
        if (col >= D || k0 + row >= S) continue;
        float xk = part[row * DP + col], xv = part_v[row * DP + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            xk += part[(w * kRows + row) * DP + col];
            xv += part_v[(w * kRows + row) * DP + col];
        }
        store(dk + base + (k0 + row) * do_stride + col, xk * scale);
        store(dv + base + (k0 + row) * do_stride + col, xv);
    }
}

}  // namespace mt

// ---------------------------------------------------------------------------
struct Args {
    const void *q, *k, *v;
    const int* seg;
    int B, S, H, D;
    Strides sq, sk, sv;
    float scale;
    cudaStream_t stream;
};

dim3 grid_of(const Args& a) {
    return dim3(static_cast<unsigned>((a.S + kOwn - 1) / kOwn), static_cast<unsigned>(a.H),
                static_cast<unsigned>(a.B));
}

template <typename T, int DMAX>
cudaError_t fwd(const Args& a, void* o, float* lse) {
    seg_fwd_kernel<T, DMAX><<<grid_of(a), kOwn, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<T*>(o), lse, a.S, a.H, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
                   float* delta) {
    seg_bwd_dq_kernel<T, DMAX><<<grid_of(a), kOwn, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(o), static_cast<const T*>(d_o), lse, static_cast<T*>(dq), delta,
        a.S, a.H, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta,
                    void* dk, void* dv) {
    const unsigned long long blocks = static_cast<unsigned long long>((a.S + mt::kRows - 1) /
                                                                      mt::kRows) *
                                      static_cast<unsigned long long>(a.H) *
                                      static_cast<unsigned long long>(a.B);
    if (blocks == 0 || blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    constexpr int kSmem = mt::Dims<DP>::kSmemBytes;
    if (kSmem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            mt::seg_bwd_dkv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (err != cudaSuccess) return err;
    }
    mt::seg_bwd_dkv_kernel<T, DP><<<static_cast<unsigned>(blocks), mt::kThreads, kSmem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a.S,
        a.H, a.B, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T>
struct Type {
    using type = T;
};

// f(Type<T>{}, integral_constant<DMAX>) for the smallest built width DMAX >= D
template <typename T, int DMAX, int... REST, typename F>
int by_width(int D, F& f) {
    if (D >= 1 && D <= DMAX) {
        return static_cast<int>(f(Type<T>{}, std::integral_constant<int, DMAX>{}));
    }
    if constexpr (sizeof...(REST) > 0) {
        return by_width<T, REST...>(D, f);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dtype: 0 = float32, 1 = bfloat16; the widths DMAXES that are built, in
// ascending order.  Columns D..DMAX-1 ride as zeros.
template <int... DMAXES, typename F>
int dispatch(int dtype, int D, F f) {
    if (dtype == 0) return by_width<float, DMAXES...>(D, f);
    if (dtype == 1) return by_width<__nv_bfloat16, DMAXES...>(D, f);
    return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const int* seg, int B, int S, int H,
               int D, const long long* strides, float scale, void* stream) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.seg = seg;
    a.B = B;
    a.S = S;
    a.H = H;
    a.D = D;
    a.sq = Strides{strides[0], strides[1], strides[2]};
    a.sk = Strides{strides[3], strides[4], strides[5]};
    a.sv = Strides{strides[6], strides[7], strides[8]};
    a.scale = scale;
    a.stream = static_cast<cudaStream_t>(stream);
    return a;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError(), so a refused
// launch reaches the caller; none synchronises.  `strides` holds the batch,
// token and head strides (in elements) of q, then k, then v, on the host.
// The forward kernel takes D <= 64, dq D <= 32 and dk/dv D <= 128.  The
// caller checks shapes (H and B <= 65535), types and that o, lse, delta,
// do, dq, dk and dv are contiguous.

extern "C" int segment_attention_fwd_launch(const void* q, const void* k, const void* v,
                                            const int* seg, void* o, float* lse, int B, int S,
                                            int H, int D, const long long* strides, float scale,
                                            int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    return dispatch<32, 64>(dtype, D, [&](auto t, auto dmax) {
        return fwd<typename decltype(t)::type, decltype(dmax)::value>(a, o, lse);
    });
}

extern "C" int segment_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                               const int* seg, const void* o, const void* d_o,
                                               const float* lse, void* dq, float* delta, int B,
                                               int S, int H, int D, const long long* strides,
                                               float scale, int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    // DMAX = 64 spills: three 64-float rows a thread exceed 255 registers
    return dispatch<32>(dtype, D, [&](auto t, auto dmax) {
        return bwd_dq<typename decltype(t)::type, decltype(dmax)::value>(a, o, d_o, lse, dq,
                                                                          delta);
    });
}

extern "C" int segment_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                                const int* seg, const void* d_o,
                                                const float* lse, const float* delta, void* dk,
                                                void* dv, int B, int S, int H, int D,
                                                const long long* strides, float scale, int dtype,
                                                void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    return dispatch<32, 64, 128>(dtype, D, [&](auto t, auto dmax) {
        return bwd_dkv<typename decltype(t)::type, decltype(dmax)::value>(a, d_o, lse, delta, dk,
                                                                           dv);
    });
}
