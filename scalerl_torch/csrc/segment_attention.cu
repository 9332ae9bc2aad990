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
// query attends are exact zeros.  Every kernel takes D <= 128, instantiated
// at DP = 32, 64 and 128; columns past D ride as zeros.
//
// One design for all three kernels (namespace mt): the float32
// register-blocked micro-tiles of csrc/flash_attention.cu's mt kernels, with
// the segment rule.  A block of 4 warps owns 16 rows of one (batch row,
// head) -- queries in the forward and dq, keys in dk/dv -- and stages them
// once; the other axis streams through a 2-stage cp.async ring of 64-row
// tiles with its segment ids, warp w taking rows 16 w .. 16 w + 15 of each.
// Lane 8 r + c computes the 4 x 2 micro-tiles of the products of owned rows
// r + 4 i against streamed rows c + 8 j in one pass over D (float4 reads of
// both sides, shared rows padded by 4 floats), keeps an element where the
// segment rule holds, and passes the weights through a per-warp shared tile
// into the lane's accumulators: owned rows r + 4 i at D / 8 columns.
//   forward: S = q k^T scale, an online softmax per warp (its own running
//     max and sum), o += P v; the warps' (m, l, o) combine in warp order and
//     o is divided by its row sum element by element.  The key walk ends at
//     the block's last query.
//   dq: q, do and lse staged once; delta = sum_d do * o computed in the
//     kernel, 8 lanes a row in a fixed order, and written to a [B, H, S]
//     buffer; S = q k^T, dP = do v^T, P = exp(S scale - lse) (lse = -inf read
//     as 0), dS = P (dP - delta), dq += dS k.  The key walk ends at the
//     block's last query; scale multiplies dq at the store.
//   dk/dv: k and v staged once; q, do, lse, delta and the query ids stream
//     from the block's first key; S^T = k q^T, dP^T = v do^T, P^T and dS^T =
//     P^T (dP^T - delta) as in dq, dv += P^T do and dk += dS^T q; scale
//     multiplies dk at the store.
// The 4 warps' partials combine through shared memory in warp order.  A
// 64-row tile whose ids cannot meet the block's own ids' range (min nonzero,
// max) is neither staged nor read (every warp reduces the tile's ids itself
// and reaches the same verdict), and a warp whose 16 streamed rows cannot
// meet them skips its products.  The range test is conservative and right
// for any ids; it skips most when ids ascend from 1 with a zero tail, as the
// packer lays them out.  The staging loops stay rolled.  float32 is staged by
// 16-, 8- or 4-byte cp.async copies by the rows' alignment; bfloat16 is
// converted to float32 on its way to shared memory, through registers.  The
// arithmetic is exact float32 either way: FMAs, expf and logf, no TF32, no
// fast math.
//
// Ragged S: rows past S load as zeros with id 0 and are never stored.  q, k
// and v are addressed through their batch, token and head strides (unit
// stride along D), so the views a fused qkv projection hands over are read
// in place.  o, lse, delta, do, dq, dk and dv are contiguous.
//
// No atomics: every sum runs in a fixed order, so results repeat bit for
// bit.  The dk/dv kernel reads the delta the dq kernel wrote, launched after
// it on the same stream.
//
// Bound on an H100.  The work is 4*D flops per live (i, j) pair forward, 6*D
// for dq and 8*D for dk/dv, in float32 FMAs outside the tensor cores (67
// TFLOP/s); the bytes are q, k, v, o, do, dq, dk, dv and the ids, lse and
// delta.  At the bench's packed batch ([32, 256, 8, 32]) bytes bound every
// kernel; at the learn step's rows of 512 ([64, 512, 8, 32], 2-3 segments a
// row) operations do.  The micro-tiles give each lane 8 or 16 independent
// chains per pass over D and read each staged value once per 8 FMAs.
//
// Numerics: sums over D and over the other axis run in another order than
// the plain version's softmax and einsum.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Strides {
    long long b, t, h;  // in elements; the stride along D is 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float32 -> bfloat16 cast rounds
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool ranges_meet(int a_lo, int a_hi, int b_lo, int b_hi) {
    return a_hi > 0 && b_hi > 0 && a_lo <= b_hi && b_lo <= a_hi;
}

namespace mt {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // rows a block owns: queries (forward, dq) or keys (dk/dv)
constexpr int kTile = 16 * kWarps;   // streamed rows per ring stage, 16 a warp
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kPStride = 16 + kPad;  // floats per row of a warp's weight tile (P, dS or their ^T)
// Blocks per SM the register budget must allow (at most 255 registers a
// thread, for dk and dv's 2 x 4 x DP / 8 accumulators a lane at DP = 128);
// without a minimum ptxas spilled below its budget
constexpr int kMinBlocks = 2;
// Unrolling: the loops over D kDotUnroll times, those over a warp's 16
// streamed rows kRowUnroll times, the staging loops not at all (unrolled
// staging doubled the float32 flash kernels' time inside a learn step on an
// H100, through the instruction caches, however they timed alone)
constexpr int kDotUnroll = 4;
constexpr int kRowUnroll = 4;
// The forward at DP = 32 fits 5 blocks an SM in shared memory (45 KB each):
// held to the registers that allows (96), with its loop over D unrolled twice
// so that they suffice without a spill, it ran 8% faster than at 4 blocks at
// the token-PPO learner's shapes on an H100 (the others need 47-53 KB)
template <int DP>
constexpr int kFwdMinBlocks = DP == 32 ? 5 : kMinBlocks;
template <int DP>
constexpr int kFwdDotUnroll = DP == 32 ? 2 : kDotUnroll;
// The forward and dq take their query blocks from the end of S first: a
// block's walk reaches back to its segment's first key, and late blocks can
// reach furthest
constexpr bool kQueriesLastFirst = true;

static_assert(kTile == 2 * 32, "a tile's ids are reduced two per lane");
static_assert(kThreads / 8 == kRows, "dq's delta: 8 lanes a row, every row at once");

template <int DP>
struct Dims {
    static_assert(DP % 8 == 0 && DP >= 8 && DP <= 128, "8 lanes share a row's columns");
    static constexpr int kStride = DP + kPad;           // floats per shared row
    static constexpr int kTileElems = kTile * kStride;  // one [64][DP + 4] tile
    static constexpr int kCols = DP / 8;                // accumulator columns a lane holds
    static constexpr int kVec = kCols < 4 ? kCols : 4;  // floats per vector read
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
// and column D.  A thread keeps one 16-byte column of the rows and passes
// down them kThreads / (DP / 4) rows at a time, its column's offsets and
// bounds worked out once; the loop stays rolled.  The caller commits the
// group.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(float* tile, const float* __restrict__ x,
                                           long long stride_t, int r0, int n, int D, int width) {
    constexpr int kRowPieces = DP / 4;
    constexpr int kPass = kThreads / kRowPieces;  // rows one pass of the block covers
    static_assert(kThreads % kRowPieces == 0 && ROWS % kPass == 0, "whole passes");
    const int r = static_cast<int>(threadIdx.x) / kRowPieces;
    const int col = 4 * (static_cast<int>(threadIdx.x) - r * kRowPieces);
    const int cols = min(4, max(0, D - col));  // the column's floats inside D
    uint32_t dst = smem_u32(tile + r * Dims<DP>::kStride + col);
#pragma unroll 1
    for (int row = r0 + r; row < r0 + ROWS; row += kPass, dst += 4 * kPass * Dims<DP>::kStride) {
        const int valid = row < n ? cols : 0;
        const float* src = valid > 0 ? x + row * stride_t + col : x;
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
    constexpr int kPass = kThreads / kRowPieces;
    static_assert(kThreads % kRowPieces == 0 && ROWS % kPass == 0, "whole passes");
    const int r = static_cast<int>(threadIdx.x) / kRowPieces;
    const int col = 4 * (static_cast<int>(threadIdx.x) - r * kRowPieces);
    const int cols = min(4, max(0, D - col));
    float* dst = tile + r * Dims<DP>::kStride + col;
#pragma unroll 1
    for (int row = r0 + r; row < r0 + ROWS; row += kPass, dst += kPass * Dims<DP>::kStride) {
        const int valid = row < n ? cols : 0;
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
        *reinterpret_cast<float4*>(dst) = f;
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

// The ids of the block's own rows r0 .. r0 + kRows - 1 (0 at or past S) into
// ids_s, and their range (min nonzero, max) in every thread
__device__ __forceinline__ void own_ids(const int* __restrict__ seg, int r0, int S, int* ids_s,
                                        int& lo, int& hi) {
    lo = INT_MAX;
    hi = 0;
    for (int x = 0; x < kRows; ++x) {
        const int id = r0 + x < S ? seg[r0 + x] : 0;
        if (id > 0) lo = min(lo, id);
        hi = max(hi, id);
    }
    if (threadIdx.x < kRows) {
        const int row = r0 + static_cast<int>(threadIdx.x);
        ids_s[threadIdx.x] = row < S ? seg[row] : 0;
    }
}

// The first tile t in [it, n_tiles) whose rows r0 + kTile t .. r0 + kTile t
// + kTile - 1 (ids 0 at or past S) can meet the range [lo, hi], or n_tiles;
// every warp reduces the tile's ids itself and reaches the same verdict
__device__ __forceinline__ int next_live_tile(const int* __restrict__ seg, int r0, int it,
                                              int n_tiles, int S, int lo, int hi) {
    const int lane = threadIdx.x & 31;
    for (; it < n_tiles; ++it) {
        const int i0 = r0 + it * kTile;
        const int a = i0 + lane < S ? seg[i0 + lane] : 0;
        const int z = i0 + 32 + lane < S ? seg[i0 + 32 + lane] : 0;
        const int t_hi = __reduce_max_sync(kFull, max(a, z));
        const int t_lo = __reduce_min_sync(kFull, min(a > 0 ? a : INT_MAX, z > 0 ? z : INT_MAX));
        if (ranges_meet(t_lo, t_hi, lo, hi)) break;
    }
    return it;
}

// Whether the warp's 16 streamed rows (their ids at ids16, 0 past S) can
// meet the range [lo, hi]: a warp whose rows all lie in other segments adds
// nothing
__device__ __forceinline__ bool warp_meets(const int* ids16, int lo, int hi) {
    const int id = ids16[threadIdx.x & 15];
    const int w_hi = __reduce_max_sync(kFull, id);
    const int w_lo = __reduce_min_sync(kFull, id > 0 ? id : INT_MAX);
    return ranges_meet(w_lo, w_hi, lo, hi);
}

// The block's slice (batch row b, head h) and its first owned row r0, from a
// 1-D grid of ceil(S / kRows) * H * B blocks: every slice's first row block
// first, or with last_first its last
__device__ __forceinline__ void block_slice(int S, int H, int B, bool last_first, int& b, int& h,
                                            int& r0) {
    const int slices = H * B;
    const int bh = static_cast<int>(blockIdx.x) % slices;
    h = bh % H;
    b = bh / H;
    const int t = static_cast<int>(blockIdx.x) / slices;
    r0 = (last_first ? (S + kRows - 1) / kRows - 1 - t : t) * kRows;
}

// n < N: acc[n][i][j] += (row r + 4 i of a[n]) . (row c + 8 j of b[n]) over
// DP columns in order, rows kS floats apart: 4 x 2 micro-tiles fed by float4
// reads, N products in one pass over D, the loop unrolled UNROLL times
template <int DP, int kS, int N, int UNROLL = kDotUnroll>
__device__ __forceinline__ void micro_tiles(float (*acc)[4][2], const float* const* a,
                                            const float* const* b, int r, int c) {
#pragma unroll(UNROLL)
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

// The weights of a lane's micro-tile, element (i, j) = owned row r + 4 i
// against streamed row c + 8 j, into a warp's tile by streamed row: row
// c + 8 j holds the lane's 4 owned rows at 4 r .. 4 r + 3
__device__ __forceinline__ void put_weights(float* tile, const float (&x)[4][2], int r, int c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float4*>(tile + (c + 8 * j) * kPStride + 4 * r) =
            make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    }
}

// n < N: acc[n][i][col] += w[n][x][4 r + i] * src[n][x][col] over the warp's
// 16 streamed rows x in order (w as put_weights leaves it, src rows kS floats
// apart), at the lane's columns col(u, e) = 8 kVec u + kVec c + e
template <int DP, int N>
__device__ __forceinline__ void accumulate_rows(float (*acc)[4][Dims<DP>::kCols],
                                                const float* const* w, const float* const* src,
                                                int r, int c) {
    using L = Dims<DP>;
    constexpr int kU = L::kCols / L::kVec;  // vector reads per row
#pragma unroll(kRowUnroll)
    for (int x = 0; x < 16; ++x) {
        float wr[N][4];
#pragma unroll
        for (int n = 0; n < N; ++n) load_f<4>(wr[n], w[n] + x * kPStride + 4 * r);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            float s[N][L::kVec];
#pragma unroll
            for (int n = 0; n < N; ++n) {
                load_f<L::kVec>(s[n], src[n] + x * L::kStride + 8 * L::kVec * u + L::kVec * c);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int e = 0; e < L::kVec; ++e) {
#pragma unroll
                    for (int n = 0; n < N; ++n) {
                        acc[n][i][L::kVec * u + e] =
                            fmaf(wr[n][i], s[n][e], acc[n][i][L::kVec * u + e]);
                    }
                }
            }
        }
    }
}

// A lane's accumulator (owned rows r + 4 i at the columns col(u, e)) into
// its warp's [kRows][DP] part
template <int DP>
__device__ __forceinline__ void write_partial(float* part, const float (&acc)[4][Dims<DP>::kCols],
                                              int r, int c) {
    using L = Dims<DP>;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float* dst = part + (r + 4 * i) * DP;
#pragma unroll
        for (int u = 0; u < L::kCols / L::kVec; ++u) {
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) {
                dst[8 * L::kVec * u + L::kVec * c + e] = acc[i][L::kVec * u + e];
            }
        }
    }
}

// The kWarps parts [kWarps][kRows][DP] at (row, col), summed in warp order
template <int DP>
__device__ __forceinline__ float warp_order_sum(const float* part, int row, int col) {
    float x = part[row * DP + col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += part[(w * kRows + row) * DP + col];
    return x;
}

// The addresses of one (batch row, head)'s streamed rows.  They sit in
// shared memory and are read again after each barrier: held in registers
// across the loop they took dk/dv to 158 registers at DP = 32 (3 blocks an
// SM, 7-10% slower at the token-PPO learner's shapes on an H100), and held
// to 128 ptxas spilled two of them.
template <typename T>
struct KeyRows {  // the forward and dq
    const T* k;
    const T* v;
    const int* seg;
};
template <typename T>
struct QueryRows {  // dk/dv
    const T* q;
    const T* d_o;
    const float* lse;
    const float* delta;
    const int* seg;
};

template <int DP>
constexpr int fwd_smem_bytes() {
    return ((kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride +
            (2 * kWarps + 1) * kRows) * static_cast<int>(sizeof(float)) +
           (2 * kTile + kRows) * static_cast<int>(sizeof(int));
}
template <int DP>
constexpr int dq_smem_bytes() {
    return ((2 * kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride + 2 * kRows) *
               static_cast<int>(sizeof(float)) +
           (2 * kTile + kRows) * static_cast<int>(sizeof(int));
}
template <int DP>
constexpr int dkv_smem_bytes() {
    return ((2 * kRows + 4 * kTile) * Dims<DP>::kStride + 2 * kWarps * 16 * kPStride +
            4 * kTile) * static_cast<int>(sizeof(float)) +
           (2 * kTile + kRows) * static_cast<int>(sizeof(int));
}

// ---------------------------------------------------------------------------
// forward: blocks by block_slice (the last query blocks first).  Lane 8 r + c
// of warp w: scores of queries q0 + r + 4 i against keys 16 w + c + 8 j of
// each tile; o of queries q0 + r + 4 i at the columns col(u, e).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks<DP>)
seg_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse, int S,
               int H, int B, int D, Strides sq, Strides sk, Strides sv, float scale) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);  // [kRows][DP + 4]
    float* k_s = q_s + kRows * kS;                // 2 stages
    float* v_s = k_s + 2 * L::kTileElems;         // 2 stages
    float* p_s = v_s + 2 * L::kTileElems;         // [kWarps][16 keys][kPStride] P
    float* m_s = p_s + kWarps * 16 * kPStride;    // [kWarps][kRows] running max
    float* l_s = m_s + kWarps * kRows;            // [kWarps][kRows] running sum
    float* den_s = l_s + kWarps * kRows;          // [kRows] the rows' sums
    int* kid_s = reinterpret_cast<int*>(den_s + kRows);  // 2 stages of kTile key ids
    int* qid_s = kid_s + 2 * kTile;               // [kRows] the block's query ids
    float* part = k_s;  // [kWarps][kRows][DP]: the warps' o, once the ring is done

    int b, h, q0;
    block_slice(S, H, B, kQueriesLastFirst, b, h, q0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    __shared__ KeyRows<T> rows_s;
    if (threadIdx.x == 0) {
        rows_s = KeyRows<T>{k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                            seg + static_cast<long long>(b) * S};
    }
    __syncthreads();
    int q_lo, q_hi;
    own_ids(rows_s.seg, q0, S, qid_s, q_lo, q_hi);
    // keys past the block's last query are above the diagonal of every row
    const int q_last = min(q0 + kRows, S) - 1;
    const int n_tiles = q_last / kTile + 1;
    auto stage_keys = [&](int st, int j0) {
        const KeyRows<T> x = rows_s;
        stage_rows<DP, kTile>(k_s + st * L::kTileElems, x.k, sk.t, j0, S, D, copy_width(x.k, sk.t));
        stage_rows<DP, kTile>(v_s + st * L::kTileElems, x.v, sv.t, j0, S, D, copy_width(x.v, sv.t));
        stage_column(kid_s + st * kTile, x.seg, j0, S, 0);
    };
    const T* qx = q + b * sq.b + h * sq.h;
    stage_rows<DP, kRows>(q_s, qx, sq.t, q0, S, D, copy_width(qx, sq.t));
    int it = q_hi > 0 ? next_live_tile(rows_s.seg, 0, 0, n_tiles, S, q_lo, q_hi) : n_tiles;
    if (it < n_tiles) stage_keys(0, it * kTile);
    cp_async_commit();

    float acc[1][4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[0][i][n] = 0.0f;
    }
    // running max of this warp's live scores and this lane's part of the
    // running sum of exp(score - m), queries q0 + r + 4 i
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F, l[i] = 0.0f;
    float* pw = p_s + warp * 16 * kPStride;

    for (int st = 0; it < n_tiles; st ^= 1) {
        const int nxt = next_live_tile(rows_s.seg, 0, it + 1, n_tiles, S, q_lo, q_hi);
        if (nxt < n_tiles) stage_keys(st ^ 1, nxt * kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int kw = it * kTile + 16 * warp;  // the warp's first key
        const int* kid_t = kid_s + st * kTile + 16 * warp;
        if (kw <= q_last && warp_meets(kid_t, q_lo, q_hi)) {
            const float* kt = k_s + st * L::kTileElems + 16 * warp * kS;
            const float* vt = v_s + st * L::kTileElems + 16 * warp * kS;
            // S = q k^T, the 4 x 2 micro-tile, summed over D in order
            float s[1][4][2] = {};
            micro_tiles<DP, kS, 1, kFwdDotUnroll<DP>>(s, &q_s, &kt, r, c);
            // scale * q.k where query q0 + r + 4 i sees key kw + c + 8 j (at
            // or before it, in its segment, not pad), else -inf
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kid = kid_t[c + 8 * j];
                const int key = kw + c + 8 * j;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qid = qid_s[r + 4 * i];
                    const bool valid = qid > 0 && kid == qid && key <= q0 + r + 4 * i;
                    s[0][i][j] = valid ? __fmul_rn(s[0][i][j], scale) : -CUDART_INF_F;
                }
            }
            // online softmax: a row's max over its 8 lanes, then P = exp(s - m)
            float p[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float mx = fmaxf(s[0][i][0], s[0][i][1]);
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
                const float m_new = fmaxf(m[i], mx);
                // no live key yet: exp(-inf - 0) = 0, never -inf - -inf
                const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
                const float corr = expf(m[i] - safe);
                p[i][0] = expf(s[0][i][0] - safe);
                p[i][1] = expf(s[0][i][1] - safe);
                l[i] = l[i] * corr + (p[i][0] + p[i][1]);
                m[i] = m_new;
#pragma unroll
                for (int n = 0; n < L::kCols; ++n) acc[0][i][n] *= corr;
            }
            put_weights(pw, p, r, c);
            __syncwarp();
            // o += P v over the warp's 16 keys, in key order
            accumulate_rows<DP, 1>(acc, &pw, &vt, r, c);
        }
        __syncthreads();  // tile it (and the P tiles) read before refilling
        it = nxt;
    }

    // combine the 4 warps' (m, l, o) in warp order
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        l[i] += __shfl_xor_sync(kFull, l[i], 1);
        l[i] += __shfl_xor_sync(kFull, l[i], 2);
        l[i] += __shfl_xor_sync(kFull, l[i], 4);
        if (c == 0) {
            m_s[warp * kRows + r + 4 * i] = m[i];
            l_s[warp * kRows + r + 4 * i] = l[i];
        }
    }
    __syncthreads();  // also: the ring's last reads are done before it becomes `part`
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r + 4 * i;
        float mx = m_s[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRows + row]);
        const float f = expf(m[i] - (mx == -CUDART_INF_F ? 0.0f : mx));
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[0][i][n] *= f;
    }
    write_partial<DP>(part + warp * kRows * DP, acc[0], r, c);
    if (threadIdx.x < kRows) {
        const int row = threadIdx.x;
        float mx = m_s[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRows + row]);
        const float safe = mx == -CUDART_INF_F ? 0.0f : mx;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            sum += l_s[w * kRows + row] * expf(m_s[w * kRows + row] - safe);
        }
        const float denom = fmaxf(sum, 1e-30f);
        den_s[row] = denom;
        if (q0 + row < S) {
            lse[(static_cast<long long>(b) * H + h) * S + q0 + row] =
                sum > 0.0f ? mx + logf(denom) : -CUDART_INF_F;
        }
    }
    __syncthreads();
    const long long row_stride = static_cast<long long>(H) * D;
    T* out = o + (static_cast<long long>(b) * S * H + h) * D;
    constexpr int kOut = kRows * DP;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kOut; idx += kThreads) {
        const int row = idx / DP, col = idx % DP;
        if (col >= D || q0 + row >= S) continue;
        // a division per element, as the plain version divides p by l: one
        // rounded reciprocal would give every element of a row the same error
        store(out + (q0 + row) * row_stride + col, warp_order_sum<DP>(part, row, col) / den_s[row]);
    }
}

// ---------------------------------------------------------------------------
// dq (and delta): blocks by block_slice (the last query blocks first).  Lane
// 8 r + c of warp w: S and dP of queries q0 + r + 4 i against keys 16 w + c
// + 8 j of each tile; dq of queries q0 + r + 4 i at the columns col(u, e).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ seg, const T* __restrict__ o,
                  const T* __restrict__ d_o, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ delta, int S, int H, int B, int D,
                  Strides sq, Strides sk, Strides sv, float scale) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);  // [kRows][DP + 4]
    float* do_s = q_s + kRows * kS;               // [kRows][DP + 4]
    float* k_s = do_s + kRows * kS;               // 2 stages
    float* v_s = k_s + 2 * L::kTileElems;         // 2 stages
    float* ds_s = v_s + 2 * L::kTileElems;        // [kWarps][16 keys][kPStride] dS
    float* lse_s = ds_s + kWarps * 16 * kPStride;  // [kRows]
    float* dl_s = lse_s + kRows;                  // [kRows] delta
    int* kid_s = reinterpret_cast<int*>(dl_s + kRows);  // 2 stages of kTile key ids
    int* qid_s = kid_s + 2 * kTile;               // [kRows] the block's query ids
    float* part = k_s;  // [kWarps][kRows][DP]: the warps' dq, once the ring is done

    int b, h, q0;
    block_slice(S, H, B, kQueriesLastFirst, b, h, q0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    __shared__ KeyRows<T> rows_s;
    if (threadIdx.x == 0) {
        rows_s = KeyRows<T>{k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                            seg + static_cast<long long>(b) * S};
    }
    __syncthreads();
    int q_lo, q_hi;
    own_ids(rows_s.seg, q0, S, qid_s, q_lo, q_hi);
    const int q_last = min(q0 + kRows, S) - 1;
    const int n_tiles = q_last / kTile + 1;
    auto stage_keys = [&](int st, int j0) {
        const KeyRows<T> x = rows_s;
        stage_rows<DP, kTile>(k_s + st * L::kTileElems, x.k, sk.t, j0, S, D, copy_width(x.k, sk.t));
        stage_rows<DP, kTile>(v_s + st * L::kTileElems, x.v, sv.t, j0, S, D, copy_width(x.v, sv.t));
        stage_column(kid_s + st * kTile, x.seg, j0, S, 0);
    };
    const long long row_stride = static_cast<long long>(H) * D;  // of o, do and dq
    const long long rows_base = (static_cast<long long>(b) * S * H + h) * D;
    const long long stat_base = (static_cast<long long>(b) * H + h) * S;
    {
        const T* qx = q + b * sq.b + h * sq.h;
        const T* dox = d_o + rows_base;
        stage_rows<DP, kRows>(q_s, qx, sq.t, q0, S, D, copy_width(qx, sq.t));
        stage_rows<DP, kRows>(do_s, dox, row_stride, q0, S, D, copy_width(dox, row_stride));
    }
    cp_async_commit();
    int it = q_hi > 0 ? next_live_tile(rows_s.seg, 0, 0, n_tiles, S, q_lo, q_hi) : n_tiles;
    if (it < n_tiles) stage_keys(0, it * kTile);
    cp_async_commit();
    cp_async_wait<1>();  // q and do
    __syncthreads();

    // delta = sum_d do * o of query q0 + threadIdx.x / 8 from the staged do
    // and the stored o: this lane's columns col(u, e) in order, then the
    // row's 8 lanes (3 shuffles); with lse (-inf read as 0: every probability
    // of such a row is masked) into shared memory, and delta into its buffer
    {
        const int row = threadIdx.x >> 3;
        const bool live = q0 + row < S;
        float sum = 0.0f;
        if (live) {
            const T* orow = o + rows_base + (q0 + row) * row_stride;
#pragma unroll
            for (int u = 0; u < L::kCols / L::kVec; ++u) {
#pragma unroll
                for (int e = 0; e < L::kVec; ++e) {
                    const int col = 8 * L::kVec * u + L::kVec * c + e;
                    if (col < D) sum = fmaf(do_s[row * kS + col], to_float(orow[col]), sum);
                }
            }
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        sum += __shfl_xor_sync(kFull, sum, 4);
        if (c == 0) {
            dl_s[row] = sum;
            const float x = live ? lse[stat_base + q0 + row] : 0.0f;
            lse_s[row] = x == -CUDART_INF_F ? 0.0f : x;
            if (live) delta[stat_base + q0 + row] = sum;
        }
    }
    __syncthreads();
    float lse_r[4], dl_r[4];  // queries q0 + r + 4 i
#pragma unroll
    for (int i = 0; i < 4; ++i) lse_r[i] = lse_s[r + 4 * i], dl_r[i] = dl_s[r + 4 * i];

    float acc[1][4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[0][i][n] = 0.0f;
    }
    float* pw = ds_s + warp * 16 * kPStride;

    for (int st = 0; it < n_tiles; st ^= 1) {
        const int nxt = next_live_tile(rows_s.seg, 0, it + 1, n_tiles, S, q_lo, q_hi);
        if (nxt < n_tiles) stage_keys(st ^ 1, nxt * kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int kw = it * kTile + 16 * warp;  // the warp's first key
        const int* kid_t = kid_s + st * kTile + 16 * warp;
        if (kw <= q_last && warp_meets(kid_t, q_lo, q_hi)) {
            const float* kt = k_s + st * L::kTileElems + 16 * warp * kS;
            const float* vt = v_s + st * L::kTileElems + 16 * warp * kS;
            // S = q k^T and dP = do v^T, the 4 x 2 micro-tiles, in one pass over D
            float sd[2][4][2] = {};
            const float* rows[2] = {q_s, do_s};
            const float* cols[2] = {kt, vt};
            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);
            // P = exp(S scale - lse), the scale rounded apart (as the
            // forward's scores), kept where query q0 + r + 4 i sees key
            // kw + c + 8 j; dS = P (dP - delta)
            float ds[4][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kid = kid_t[c + 8 * j];
                const int key = kw + c + 8 * j;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qid = qid_s[r + 4 * i];
                    const bool valid = qid > 0 && kid == qid && key <= q0 + r + 4 * i;
                    const float p =
                        valid ? expf(__fmul_rn(sd[0][i][j], scale) - lse_r[i]) : 0.0f;
                    ds[i][j] = p * (sd[1][i][j] - dl_r[i]);
                }
            }
            put_weights(pw, ds, r, c);
            __syncwarp();
            // dq += dS k over the warp's 16 keys, in key order
            accumulate_rows<DP, 1>(acc, &pw, &kt, r, c);
        }
        __syncthreads();  // tile it (and the dS tiles) read before refilling
        it = nxt;
    }

    // combine the 4 warps' dq in warp order; scale once, at the store
    cp_async_wait<0>();
    __syncthreads();  // the ring's last reads are done before it becomes `part`
    write_partial<DP>(part + warp * kRows * DP, acc[0], r, c);
    __syncthreads();
    T* out = dq + rows_base;
    constexpr int kOut = kRows * DP;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kOut; idx += kThreads) {
        const int row = idx / DP, col = idx % DP;
        if (col >= D || q0 + row >= S) continue;
        store(out + (q0 + row) * row_stride + col, warp_order_sum<DP>(part, row, col) * scale);
    }
}

// ---------------------------------------------------------------------------
// dk and dv: blocks by block_slice (the first key blocks first).  Lane 8 r +
// c of warp w: S^T and dP^T of keys k0 + r + 4 i against queries 16 w + c +
// 8 j of each tile; dk and dv of keys k0 + r + 4 i at the columns col(u, e).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ seg, const T* __restrict__ d_o,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int H, int B, int D,
                   Strides sq, Strides sk, Strides sv, float scale) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
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

    int b, h, k0;
    block_slice(S, H, B, false, b, h, k0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    const T* kx = k + b * sk.b + h * sk.h;
    const T* vx = v + b * sv.b + h * sv.h;
    const long long do_stride = static_cast<long long>(H) * D;
    __shared__ QueryRows<T> rows_s;
    if (threadIdx.x == 0) {
        const long long stat = (static_cast<long long>(b) * H + h) * S;
        rows_s = QueryRows<T>{q + b * sq.b + h * sq.h,
                              d_o + (static_cast<long long>(b) * S * H + h) * D, lse + stat,
                              delta + stat, seg + static_cast<long long>(b) * S};
    }
    __syncthreads();

    int k_lo, k_hi;
    own_ids(rows_s.seg, k0, S, kid_s, k_lo, k_hi);
    // queries before the block's first key see none of its keys
    const int n_tiles = (S - k0 + kTile - 1) / kTile;
    auto stage_queries = [&](int st, int i0) {
        const QueryRows<T> x = rows_s;
        stage_rows<DP, kTile>(q_s + st * L::kTileElems, x.q, sq.t, i0, S, D, copy_width(x.q, sq.t));
        stage_rows<DP, kTile>(do_s + st * L::kTileElems, x.d_o, do_stride, i0, S, D,
                              copy_width(x.d_o, do_stride));
        stage_column(lse_s + st * kTile, x.lse, i0, S, 0);
        stage_column(dl_s + st * kTile, x.delta, i0, S, kTile);
        stage_column(qid_s + st * kTile, x.seg, i0, S, 0);
    };
    stage_rows<DP, kRows>(k_s, kx, sk.t, k0, S, D, copy_width(kx, sk.t));
    stage_rows<DP, kRows>(v_s, vx, sv.t, k0, S, D, copy_width(vx, sv.t));
    int it = k_hi > 0 ? next_live_tile(rows_s.seg, k0, 0, n_tiles, S, k_lo, k_hi) : n_tiles;
    if (it < n_tiles) stage_queries(0, k0 + it * kTile);
    cp_async_commit();

    float acc[2][4][L::kCols];  // dv, dk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[0][i][n] = acc[1][i][n] = 0.0f;
    }
    float* pw = p_s + warp * 16 * kPStride;
    float* dw = ds_s + warp * 16 * kPStride;

    for (int st = 0; it < n_tiles; st ^= 1) {
        const int nxt = next_live_tile(rows_s.seg, k0, it + 1, n_tiles, S, k_lo, k_hi);
        if (nxt < n_tiles) stage_queries(st ^ 1, k0 + nxt * kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int iw = k0 + it * kTile + 16 * warp;  // the warp's first query
        const int* qid_t = qid_s + st * kTile + 16 * warp;
        if (warp_meets(qid_t, k_lo, k_hi)) {
            const float* qt = q_s + st * L::kTileElems + 16 * warp * kS;
            const float* gt = do_s + st * L::kTileElems + 16 * warp * kS;
            const float* lse_t = lse_s + st * kTile + 16 * warp;
            const float* dl_t = dl_s + st * kTile + 16 * warp;
            // S^T = k q^T and dP^T = v do^T, the 4 x 2 micro-tiles
            float sd[2][4][2] = {};
            const float* rows[2] = {k_s, v_s};
            const float* cols[2] = {qt, gt};
            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);
            // P^T = exp(S^T scale - lse) (-inf read as 0), kept where query
            // iw + c + 8 j sees key k0 + r + 4 i: at or after it, in its
            // segment (not pad), before S (a query past S has id 0)
            float p[4][2], ds[4][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float row_lse = lse_t[c + 8 * j];
                row_lse = row_lse == -CUDART_INF_F ? 0.0f : row_lse;
                const float dl = dl_t[c + 8 * j];
                const int qi = iw + c + 8 * j;
                const int qid = qid_t[c + 8 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int kid = kid_s[r + 4 * i];
                    const bool valid = kid > 0 && kid == qid && k0 + r + 4 * i <= qi;
                    p[i][j] = valid ? expf(__fmul_rn(sd[0][i][j], scale) - row_lse) : 0.0f;
                    ds[i][j] = p[i][j] * (sd[1][i][j] - dl);
                }
            }
            put_weights(pw, p, r, c);
            put_weights(dw, ds, r, c);
            __syncwarp();
            // dv += P^T do and dk += dS^T q over the warp's 16 queries, in order
            const float* w[2] = {pw, dw};
            const float* src[2] = {gt, qt};
            accumulate_rows<DP, 2>(acc, w, src, r, c);
        }
        __syncthreads();  // tile it (and the P^T, dS^T tiles) read before refilling
        it = nxt;
    }

    // combine the 4 warps' dk and dv in warp order; scale on dk once, at the store
    cp_async_wait<0>();
    __syncthreads();  // the ring's last reads are done before it becomes `part`
    float* part_v = part + kWarps * kRows * DP;
    write_partial<DP>(part + warp * kRows * DP, acc[1], r, c);
    write_partial<DP>(part_v + warp * kRows * DP, acc[0], r, c);
    __syncthreads();
    const long long base = (static_cast<long long>(b) * S * H + h) * D;
    constexpr int kOut = kRows * DP;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kOut; idx += kThreads) {
        const int row = idx / DP, col = idx % DP;
        if (col >= D || k0 + row >= S) continue;
        store(dk + base + (k0 + row) * do_stride + col, warp_order_sum<DP>(part, row, col) * scale);
        store(dv + base + (k0 + row) * do_stride + col, warp_order_sum<DP>(part_v, row, col));
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

// The 1-D grid's blocks (ceil(S / kRows) * H * B, refused past 2^31 - 1),
// after raising the kernel's dynamic shared memory limit where it needs more
// than 48 KB
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, const Args& a, unsigned& blocks) {
    const unsigned long long n = static_cast<unsigned long long>((a.S + mt::kRows - 1) /
                                                                 mt::kRows) *
                                 static_cast<unsigned long long>(a.H) *
                                 static_cast<unsigned long long>(a.B);
    if (n == 0 || n > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
    blocks = static_cast<unsigned>(n);
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int DP>
cudaError_t fwd(const Args& a, void* o, float* lse) {
    constexpr int kSmem = mt::fwd_smem_bytes<DP>();
    unsigned blocks;
    const cudaError_t err = prepare(mt::seg_fwd_kernel<T, DP>, kSmem, a, blocks);
    if (err != cudaSuccess) return err;
    mt::seg_fwd_kernel<T, DP><<<blocks, mt::kThreads, kSmem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<T*>(o), lse, a.S, a.H, a.B, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
                   float* delta) {
    constexpr int kSmem = mt::dq_smem_bytes<DP>();
    unsigned blocks;
    const cudaError_t err = prepare(mt::seg_bwd_dq_kernel<T, DP>, kSmem, a, blocks);
    if (err != cudaSuccess) return err;
    mt::seg_bwd_dq_kernel<T, DP><<<blocks, mt::kThreads, kSmem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(o), static_cast<const T*>(d_o), lse, static_cast<T*>(dq), delta,
        a.S, a.H, a.B, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta,
                    void* dk, void* dv) {
    constexpr int kSmem = mt::dkv_smem_bytes<DP>();
    unsigned blocks;
    const cudaError_t err = prepare(mt::seg_bwd_dkv_kernel<T, DP>, kSmem, a, blocks);
    if (err != cudaSuccess) return err;
    mt::seg_bwd_dkv_kernel<T, DP><<<blocks, mt::kThreads, kSmem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a.S,
        a.H, a.B, a.D, a.sq, a.sk, a.sv, a.scale);
    return cudaGetLastError();
}

template <typename T>
struct Type {
    using type = T;
};

// f(Type<T>{}, integral_constant<DP>) for the smallest built width DP >= D
template <typename T, int DP, int... REST, typename F>
int by_width(int D, F& f) {
    if (D >= 1 && D <= DP) {
        return static_cast<int>(f(Type<T>{}, std::integral_constant<int, DP>{}));
    }
    if constexpr (sizeof...(REST) > 0) {
        return by_width<T, REST...>(D, f);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dtype: 0 = float32, 1 = bfloat16; every kernel is built at DP = 32, 64
// and 128, and columns D..DP-1 ride as zeros
template <typename F>
int dispatch(int dtype, int D, F f) {
    if (dtype == 0) return by_width<float, 32, 64, 128>(D, f);
    if (dtype == 1) return by_width<__nv_bfloat16, 32, 64, 128>(D, f);
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
// Every kernel takes D <= 128.  The caller checks shapes, types and that o,
// lse, delta, do, dq, dk and dv are contiguous.

extern "C" int segment_attention_fwd_launch(const void* q, const void* k, const void* v,
                                            const int* seg, void* o, float* lse, int B, int S,
                                            int H, int D, const long long* strides, float scale,
                                            int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    return dispatch(dtype, D, [&](auto t, auto dp) {
        return fwd<typename decltype(t)::type, decltype(dp)::value>(a, o, lse);
    });
}

extern "C" int segment_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                               const int* seg, const void* o, const void* d_o,
                                               const float* lse, void* dq, float* delta, int B,
                                               int S, int H, int D, const long long* strides,
                                               float scale, int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    return dispatch(dtype, D, [&](auto t, auto dp) {
        return bwd_dq<typename decltype(t)::type, decltype(dp)::value>(a, o, d_o, lse, dq, delta);
    });
}

extern "C" int segment_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                                const int* seg, const void* d_o,
                                                const float* lse, const float* delta, void* dk,
                                                void* dv, int B, int S, int H, int D,
                                                const long long* strides, float scale, int dtype,
                                                void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
    return dispatch(dtype, D, [&](auto t, auto dp) {
        return bwd_dkv<typename decltype(t)::type, decltype(dp)::value>(a, d_o, lse, delta, dk,
                                                                         dv);
    });
}
