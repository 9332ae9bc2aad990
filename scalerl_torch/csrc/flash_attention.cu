// Exact blockwise attention: forward, dq and dk/dv.
//
// Replaces the three TPU kernels behind scalerl_tpu/ops/pallas_attention.py::
// flash_attention: _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel (the
// FlashAttention-2 split: dq over query tiles, dk and dv over key tiles, so
// no kernel sums across blocks).  Pallas puts the other axis innermost in
// its grid and carries the accumulators in VMEM scratch from one grid step
// to the next; here a block owns its rows and loops over the other axis.
//
// Contract (ops/attention.py::flash_attention_reference): q [B, Tq, H, D],
// k and v [B, Tk, H, D] (float32 or bfloat16, one type for all three),
// D <= 128.  Scores are scale * (q . k) in float32; with `causal` key j is
// visible to query i iff j <= i (top-left aligned, also when Tq != Tk).
// The output is in q's type and lse [B, H, Tq] in float32.  A query with
// no visible key gives exact zeros and lse = -inf.
//
// Two designs.  bfloat16 runs on the tensor cores (namespace tc) and
// float32 in register-blocked micro-tiles on the FMA units (namespace mt):
// the forward, dq and dk/dv each.  float32 stays off the tensor cores on
// purpose: the kernels compute exact float32 (FMAs, expf and logf), and a
// TF32 product would be another result.
//
// Micro-tile design (float32; an SGEMM's register blocking on the FMA units,
// for latency: a design with one row on D / 8 lanes of a warp ran a
// dependent chain of dot, butterfly, expf and axpy per pair and left an SM
// idle between its few warps).  A block of 4 warps owns 16 rows of one
// (batch row, head) -- queries in the forward and dq, keys in dk/dv --
// stages their operands once, and streams the other axis through a 2-stage
// cp.async ring of 64-row tiles; warp w takes rows 16 w .. 16 w + 15 of
// every tile.  Lane 8 r + c computes the 4 x 2 micro-tile of the block's
// rows r + 4 i (i < 4) against rows c and c + 8 of its warp's 16: float4
// reads of both sides from shared memory feed 32 independent FMAs per
// product and 4 columns of D, with no shuffle.  Shared rows are padded by 4
// floats, so the 4 rows of one side and the 8 of the other that a read
// touches fall in distinct bank groups.  The probabilities (and dS) pass
// through per-warp shared tiles into the accumulating products, which are
// micro-tiled the other way: the block's rows r + 4 i by D / 8 columns of
// lane c.  Each warp sums over its own rows of the streamed axis; at the
// end the 4 partials are combined through shared memory (the ring, done by
// then) in warp order, so repeats stay bit-equal.
//   Forward: S = q k^T times scale; a row's max closes once per tile over
//   its 8 lanes (3 shuffles); each warp keeps its own running (m, l, o),
//   and the combine rescales them to the block's max and divides o by the
//   row's sum element by element.
//   dq: q and do stay resident, with each row's lse (-inf read as 0) and
//   delta = sum_d do * o, which the block computes first from the staged
//   do and the stored o (8 lanes a row in a fixed order, 3 shuffles) and
//   writes for the dk/dv kernel.  Per key tile, S = q k^T and dP = do v^T
//   in one pass over D, P = exp(S scale - lse) (masked to 0), and dS = P
//   (dP - delta) through the warp's tile into dq += dS k; scale multiplies
//   dq once, at the store.
//   dk/dv: k and v stay resident; q, do, lse and delta tiles stream.  Per
//   query tile, S^T = k q^T and dP^T = v do^T, P^T = exp(S^T scale - lse),
//   dS^T = P^T (dP^T - delta), both through the warp's tiles into dv +=
//   P^T do and dk += dS^T q; scale multiplies dk once, at the store.  S^T
//   is dq's S, the same FMA chain, so both kernels see one P.
// The short tile gives [4, 256, 2, 64] 128 blocks on 132 SMs, and the split
// of the streamed axis gives each block 4 warps of independent work.
//
// Tensor-core design (bfloat16 forward, dq and dk/dv; FlashAttention-2 on
// mma.sync.m16n8k16 bf16 -> f32): each warp owns 16 rows of one (batch row,
// head) -- a forward or dq block of 8 warps 128 queries, a dk/dv block of 4
// warps 64 keys.  Its own rows' operands are
// staged once (q in the forward; q and do in dq; k and v in dk/dv) and the
// other axis streams through a 2-stage ring of 64-row tiles in shared
// memory, filled by cp.async 16-byte copies, so the copy of the next tile
// overlaps the products of this one.  Shared rows are padded by 16 bytes,
// so the 8 rows an ldmatrix reads fall in 8 distinct bank groups.  D is
// padded up to the mma depth of 16 (DP = 16, 32, 64, 128); columns past D
// and rows past the end stage as zeros (cp.async's src-size below its copy
// size zero-fills), and nothing is padded in memory.
//   Forward: S = q k^T on the tensor cores; the online softmax runs on the
//   accumulator fragments, a row's max closing over the 4 lanes that share
//   it (2 shuffles), and P = 2^(S scale log2 e - m) takes the scale in
//   float32 inside one FMA; P is rounded to bf16 in registers and is the A
//   operand of P v directly, v's B operand coming from ldmatrix.trans.  o
//   is stored in bf16, lse in float32.
//   dq: q and do stay resident (their A fragments in registers up to DP =
//   64, re-read from shared memory at 128), and so do each lane's lse and
//   delta of rows g and g + 8; delta = sum_d do * o is computed from the
//   stored bf16 o in float32 and written for the dk/dv kernel.  k and v
//   tiles stream; per 32-key half of a tile (which keeps S and dP at 16
//   registers each): S = q k^T, dP = do v^T, P = 2^(S scale log2 e - lse
//   log2 e) (the dk/dv kernel's formula, so both passes see one P), dS = P
//   (dP - delta) rounded to bf16 as the A operand of dq += dS k, k entering
//   through ldmatrix.trans; scale multiplies dq once, at the store.
//   dk/dv: k and v stay resident (their A fragments in registers up to
//   DP = 64, in shared memory at 128, where the dk and dv accumulators take
//   128 registers a thread); q, do, lse and delta tiles stream.  Per pass
//   of 32 queries (16 at DP = 128): S^T = k q^T, P^T = exp(S^T scale - lse),
//   dv += P^T do, dP^T = v do^T, dS^T = P^T (dP^T - delta), dk += dS^T q;
//   P^T and dS^T are rounded to bf16 as A operands, do and q enter
//   transposed through ldmatrix.trans, and scale multiplies dk once, at the
//   store.
//   Rounding P and dS to bf16 before their products is where these kernels
//   differ from the float32 designs (and from a TPU's float32 dots); the
//   products themselves are exact and accumulate in float32.
//   Row addresses: a (batch row, head) slice whose rows are not 16-byte
//   aligned (odd heads of a fused projection at D = 20) takes 8- or 4-byte
//   cp.async copies, and a 2-byte aligned one plain loads, all in the
//   kernel, never a copy in the wrapper.  The float32 kernels stage the
//   same way (float32 rows are 4-byte aligned at least).
//   Grid: one dimension, the longest causal walk first (the forward's and
//   dq's last query tiles, dk/dv's first key tiles), so the last wave is
//   not the diagonal's long tail.  Shared memory above 48 KB is dynamic,
//   allowed by cudaFuncSetAttribute, whose return code the launch returns.
//
// Causal tile skip (_causal_live): the forward and dq kernels stop at the
// last key tile that meets their block's last query; the dk/dv kernel
// starts at its block's first key.  Tiles above the diagonal are never
// loaded; the tensor-core and micro-tile kernels also skip a warp's tile
// (or pass) that lies wholly above its rows, mask element by element only
// the tiles that cross the diagonal or the end, and take an unmasked path
// below.  A mask is one limit per row compared with each element's column
// as an immediate (per-element index arithmetic, which ptxas hoists into
// registers, was the bf16 forward's largest avoidable cost).  Ragged
// lengths are masked in the kernel (q_len = Tq, k_len = Tk).
//
// Masking: a masked score is selected to -inf (forward) or its probability
// to 0 (backward) before it meets anything else; the running max is made
// safe (-inf -> 0) before any exp, so exp(-inf - -inf) never happens, and a
// row with no visible key keeps l = 0 -> o = 0, lse = -inf.  The backward
// reads lse = -inf as 0, where every probability of that row is masked.
//
// No atomics: every sum runs in a fixed order inside one block (8-lane
// butterflies, quad shuffles, mma accumulation, the float32 kernels'
// warp-order combine), dq over query tiles, dk and dv over key tiles, so
// values and gradients repeat bit for bit.  delta =
// sum_d do * o is computed by the dq kernel and written to a [B, H, Tq]
// buffer that the dk/dv kernel, launched after it on the same stream, reads
// (JAX computes it with an einsum before both).
//
// Addressing: q, k and v through their batch, token and head strides (unit
// stride along D), so the views a fused qkv projection hands over are read
// in place; o, lse, delta, do, dq, dk and dv are contiguous.
//
// Bound on an H100: at the learner's shapes ([8, 17, 16, 64]) the work is
// tiny; one launch and its latency cost more than the bytes (0.3-0.5 us).
// At long T the work is operations, 4 D flops per visible (i, j) pair
// forward, 6 D for dq and 8 D for dk/dv: on bf16 inputs the tensor cores'
// 989 TFLOP/s set the bound, which the tensor-core kernels approach through
// mma.sync (wgmma with TMA is the later step); the float32 kernels run
// outside the tensor cores (67 TFLOP/s), in FMAs.
//
// Numerics: expf and logf in the float32 kernels (no fast math); in the
// tensor-core kernels the special-function unit's ex2.approx (about 2 ulp,
// far inside the bf16 rounding of P that follows) and logf.  Sums over D
// and over the keys run in another order than the plain version's softmax
// and einsum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Strides {
    long long b, t, h;  // in elements; the stride along D is 1
};

// ---------------------------------------------------------------------------
// bfloat16 forward, dq and dk/dv on the tensor cores (the header's tensor-core
// design)
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // dk/dv: 4 warps
constexpr int kRows = 64;      // keys a dk/dv block owns, 16 a warp
constexpr int kTile = 64;      // rows of the streamed axis per ring stage
constexpr int kPad = 8;        // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
struct Dims {
    static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "head dim padded to the mma depth");
    static constexpr int kStride = DP + kPad;           // bf16 per shared row
    static constexpr int kTileElems = kTile * kStride;  // one [64][DP + 8] tile
    static constexpr int kK = DP / 16;                  // mma k-steps over D
    static constexpr int kN = DP / 8;                   // mma n-tiles over D
    static constexpr int kChunks = DP / 8;              // 16-byte chunks per row
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

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

// 2^x on the special-function unit (about 2 ulp; subnormal results flush to
// zero, far below any probability these kernels keep)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// c += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// --- end PTX wrappers

// two floats rounded to nearest even as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a register as floats, the low half first (exact)
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// The widest copy every row of a slice allows: its first row's address and
// its row stride, in bytes, share this power of two (16 at most).
template <typename T>
__device__ __forceinline__ int copy_width(const T* x, long long stride_t) {
    const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                    static_cast<unsigned long long>(stride_t) * sizeof(T);
    return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : (bits & 3) == 0 ? 4 : 2;
}

// 16 bytes of elements at src, of which `valid` are read and the rest zero,
// into 16 bytes of shared memory, in copies of `width` bytes (2 only for
// bf16, whose rows may sit 2 bytes off)
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int valid, int width) {
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
    } else if constexpr (sizeof(T) == 2) {  // 2-byte aligned bf16 rows: through registers
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

// Rows [r0, r0 + ROWS) of a slice (x at its row 0, rows stride_t apart)
// into a [ROWS][STRIDE] tile of DP columns, by a block of THREADS, its loop
// over a thread's chunks unrolled UNROLL times; rows at or past n and
// columns at or past D land as zeros.  The caller commits the cp.async group.
template <int DP, int ROWS = kTile, int THREADS = kThreads, int STRIDE = Dims<DP>::kStride,
          int UNROLL = 0, typename T>
__device__ __forceinline__ void stage_rows(T* tile, const T* __restrict__ x, long long stride_t,
                                           int r0, int n, int D, int width) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
    constexpr int kRowChunks = DP / kPer;
    constexpr int kChunks = ROWS * kRowChunks;
    constexpr int kIters = (kChunks + THREADS - 1) / THREADS;
    static_assert(DP % kPer == 0 && STRIDE % kPer == 0, "rows of whole 16-byte chunks");
#pragma unroll(UNROLL > 0 ? UNROLL : kIters)  // UNROLL = 0: wholly
    for (int i = 0; i < kIters; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        if (kChunks % THREADS != 0 && idx >= kChunks) break;
        const int r = idx / kRowChunks;
        const int c = idx - r * kRowChunks;
        const int row = r0 + r;
        T* dst = tile + r * STRIDE + kPer * c;
        if (width == 16 && D == DP) {  // whole, aligned 16-byte chunks
            cp_async_16(smem_u32(dst), row < n ? x + row * stride_t + kPer * c : x,
                        row < n ? 16 : 0);
        } else {
            const int valid = row < n ? min(kPer, max(0, D - kPer * c)) : 0;
            copy_chunk(dst, valid > 0 ? x + row * stride_t + kPer * c : x, valid, width);
        }
    }
}

// ROWS floats (lse or delta) from rows [r0, r0 + ROWS) of x, zero past n
// (threads 0..ROWS-1 of the block)
template <int ROWS = kTile>
__device__ __forceinline__ void stage_stats(float* dst, const float* __restrict__ x, int r0,
                                            int n) {
    if (threadIdx.x < ROWS) {
        const int row = r0 + threadIdx.x;
        cp_async_4(smem_u32(dst + threadIdx.x), row < n ? x + row : x, row < n ? 4 : 0);
    }
}

// The mma A operand (16 x 16) at (row0, col0) of a shared tile
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col0,
                                       int lane) {
    ldsm_x4(a, smem_u32(tile + (row0 + (lane & 15)) * Dims<DP>::kStride + col0 + (lane >> 4) * 8));
}

// B operands of two n-tiles whose n runs along the tile's rows n0..n0+15 and
// k along its columns k0..k0+15: {b[0], b[1]} for n0, {b[2], b[3]} for n0 + 8
template <int DP>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                       int lane) {
    ldsm_x4(b, smem_u32(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Dims<DP>::kStride + k0 +
                        ((lane >> 3) & 1) * 8));
}

// The same with k along the tile's rows k0..k0+15 and n along its columns
// n0..n0+15 (ldmatrix.trans)
template <int DP>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                        int lane) {
    ldsm_x4_t(b, smem_u32(tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * Dims<DP>::kStride +
                          n0 + (lane >> 4) * 8));
}

// The A operand of a 16 x 16 product from two n-tiles of f32 accumulators
// (columns 2 j .. 2 j + 1 of this k-step), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
    a[0] = pack_bf16(lo[0], lo[1]);
    a[1] = pack_bf16(lo[2], lo[3]);
    a[2] = pack_bf16(hi[0], hi[1]);
    a[3] = pack_bf16(hi[2], hi[3]);
}

// store a warp's 16 rows of f32 accumulators (times mul) as bf16 rows of a
// contiguous [., H, D] tensor: row r at out + r * row_stride
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, long long row_stride,
                                           const float (&acc)[DP / 8][4], const float (&mul)[2],
                                           int row0, int n, int D, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= n) continue;
        bf16* dst = out + row * row_stride;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
            const int col = 8 * j + 2 * t;
            const float x0 = acc[j][2 * r] * mul[r], x1 = acc[j][2 * r + 1] * mul[r];
            if (col + 1 < D && (D & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
            } else {
                if (col < D) dst[col] = __float2bfloat16_rn(x0);
                if (col + 1 < D) dst[col + 1] = __float2bfloat16_rn(x1);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The forward's tiling: 8 warps of 16 queries share every k and v tile a
// block stages.  (Two m-tiles a warp, which halve the ldmatrix reads per
// product, reached the register cap at DP = 64, one block an SM, and ran
// slower on the H100.)
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // queries a block owns

// forward: a 1-D grid of ceil(Tq / kFwdRows) * H * B blocks, the last query
// tiles first; warp w owns queries q0 + 16 w .. q0 + 16 w + 15
template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int H, int B, int D, Strides sq, Strides sk, Strides sv,
                 float scale, int causal) {
    using L = Dims<DP>;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kFwdRows][DP + kPad]
    bf16* k_s = q_s + kFwdRows * L::kStride;     // 2 stages
    bf16* v_s = k_s + 2 * L::kTileElems;         // 2 stages

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int q0 =
        ((Tq + kFwdRows - 1) / kFwdRows - 1 - static_cast<int>(blockIdx.x / slices)) * kFwdRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 16 * warp;  // this warp's first query

    const bf16* qx = q + b * sq.b + h * sq.h;
    const bf16* kx = k + b * sk.b + h * sk.h;
    const bf16* vx = v + b * sv.b + h * sv.h;
    const int wk = copy_width(kx, sk.t), wv = copy_width(vx, sv.t);
    // keys past the block's last query are above the diagonal of every row
    const int k_end = causal ? min(Tk, min(q0 + kFwdRows, Tq)) : Tk;
    const int n_tiles = (k_end + kTile - 1) / kTile;

    stage_rows<DP, kFwdRows, kFwdThreads>(q_s, qx, sq.t, q0, Tq, D, copy_width(qx, sq.t));
    stage_rows<DP, kTile, kFwdThreads>(k_s, kx, sk.t, 0, Tk, D, wk);
    stage_rows<DP, kTile, kFwdThreads>(v_s, vx, sv.t, 0, Tk, D, wv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[L::kK][4];
#pragma unroll
    for (int kk = 0; kk < L::kK; ++kk) load_a<DP>(qf[kk], q_s, 16 * warp, 16 * kk, lane);

    float acc[L::kN][4];
#pragma unroll
    for (int j = 0; j < L::kN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    // running max (log2 units) and this lane's part of the running sum of
    // rows wq0 + g and wq0 + g + 8
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
    const float scale_log2 = scale * kLog2e;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            const int nxt = (it + 1) & 1;
            stage_rows<DP, kTile, kFwdThreads>(k_s + nxt * L::kTileElems, kx, sk.t,
                                               (it + 1) * kTile, Tk, D, wk);
            stage_rows<DP, kTile, kFwdThreads>(v_s + nxt * L::kTileElems, vx, sv.t,
                                               (it + 1) * kTile, Tk, D, wv);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int k0 = it * kTile;
        const bf16* kt = k_s + (it & 1) * L::kTileElems;
        const bf16* vt = v_s + (it & 1) * L::kTileElems;
        // a warp past Tq, or wholly above the diagonal here, has nothing to do
        if (wq0 < Tq && (!causal || k0 <= wq0 + 15)) {
            float s[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < L::kK; ++kk) {
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    uint32_t bb[4];
                    load_b<DP>(bb, kt, 16 * np, 16 * kk, lane);
                    mma(s[2 * np], qf[kk], bb[0], bb[1]);
                    mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
                }
            }
            // element masks only where the tile crosses the end or the
            // diagonal: key k0 + 2 t + 8 j + (e & 1) is visible to row r iff
            // 8 j + (e & 1) <= lim[r] (a compare with an immediate)
            if (k0 + kTile > Tk || (causal && k0 + kTile - 1 > wq0)) {
                int lim[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int row = wq0 + g + 8 * r;
                    lim[r] = (causal ? min(row, Tk - 1) : Tk - 1) - (k0 + 2 * t);
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if (8 * j + (e & 1) > lim[e >> 1]) s[j][e] = -CUDART_INF_F;
                    }
                }
            }
            float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};  // of the raw scores
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
            float corr[2], safe[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r] * scale_log2);
                // no visible key yet: exp2(-inf - 0) = 0, never -inf - -inf
                safe[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
                corr[r] = ex2(m[r] - safe[r]);
                m[r] = m_new;
            }
            // P = 2^(s scale log2 e - m), the scale applied in float32
            float rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[j][e] = ex2(fmaf(s[j][e], scale_log2, -safe[e >> 1]));
                    rs[e >> 1] += s[j][e];
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
            for (int j = 0; j < L::kN; ++j) {
                acc[j][0] *= corr[0];
                acc[j][1] *= corr[0];
                acc[j][2] *= corr[1];
                acc[j][3] *= corr[1];
            }
            // o += P v, P rounded to bf16 as the A operand
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                uint32_t pa[4];
                acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
                for (int np = 0; np < L::kK; ++np) {
                    uint32_t bb[4];
                    load_bt<DP>(bb, vt, 16 * kk, 16 * np, lane);
                    mma(acc[2 * np], pa, bb[0], bb[1]);
                    mma(acc[2 * np + 1], pa, bb[2], bb[3]);
                }
            }
        }
        __syncthreads();  // tile it has been read before its stage is refilled
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    store_rows<DP>(o + (static_cast<long long>(b) * Tq * H + h) * D, static_cast<long long>(H) * D,
                   acc, inv, wq0, Tq, D, lane);
    if (t == 0) {
        float* lse_row = lse + (static_cast<long long>(b) * H + h) * Tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = wq0 + g + 8 * r;
            if (row < Tq) lse_row[row] = l[r] > 0.0f ? m[r] * kLn2 + logf(l[r]) : -CUDART_INF_F;
        }
    }
}

// ---------------------------------------------------------------------------
// dk and dv: a 1-D grid of ceil(Tk / kRows) * H * B blocks, the first key
// tiles first; warp w owns keys k0 + 16 w .. k0 + 16 w + 15
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H, int B,
                     int D, Strides sq, Strides sk, Strides sv, float scale, int causal) {
    using L = Dims<DP>;
    // queries per pass: 16 at DP = 128, where dk and dv take 128 registers
    constexpr int kSub = DP > 64 ? 16 : 32;
    // k and v fragments held in registers up to DP = 64, re-read from shared
    // memory at 128
    constexpr bool kKVRegs = DP <= 64;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* k_s = reinterpret_cast<bf16*>(smem);
    bf16* v_s = k_s + L::kTileElems;
    bf16* q_s = v_s + L::kTileElems;       // 2 stages
    bf16* do_s = q_s + 2 * L::kTileElems;  // 2 stages
    float* lse_s = reinterpret_cast<float*>(do_s + 2 * L::kTileElems);  // 2 stages
    float* dl_s = lse_s + 2 * kTile;                                     // 2 stages

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int k0 = static_cast<int>(blockIdx.x / slices) * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + 16 * warp;

    const bf16* qx = q + b * sq.b + h * sq.h;
    const bf16* kx = k + b * sk.b + h * sk.h;
    const bf16* vx = v + b * sv.b + h * sv.h;
    const long long do_stride = static_cast<long long>(H) * D;
    const bf16* dox = d_o + (static_cast<long long>(b) * Tq * H + h) * D;
    const float* lse_x = lse + (static_cast<long long>(b) * H + h) * Tq;
    const float* dl_x = delta + (static_cast<long long>(b) * H + h) * Tq;
    const int wq = copy_width(qx, sq.t), wdo = copy_width(dox, do_stride);
    // queries before the block's first key see none of its keys
    const int i_begin = causal ? k0 : 0;
    const int n_tiles = i_begin < Tq ? (Tq - i_begin + kTile - 1) / kTile : 0;

    auto stage_queries = [&](int stage, int i0) {
        stage_rows<DP>(q_s + stage * L::kTileElems, qx, sq.t, i0, Tq, D, wq);
        stage_rows<DP>(do_s + stage * L::kTileElems, dox, do_stride, i0, Tq, D, wdo);
        stage_stats(lse_s + stage * kTile, lse_x, i0, Tq);
        stage_stats(dl_s + stage * kTile, dl_x, i0, Tq);
    };
    stage_rows<DP>(k_s, kx, sk.t, k0, Tk, D, copy_width(kx, sk.t));
    stage_rows<DP>(v_s, vx, sv.t, k0, Tk, D, copy_width(vx, sv.t));
    if (n_tiles > 0) stage_queries(0, i_begin);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    uint32_t kf[kKVRegs ? L::kK : 1][4], vf[kKVRegs ? L::kK : 1][4];
    if constexpr (kKVRegs) {
#pragma unroll
        for (int kk = 0; kk < L::kK; ++kk) {
            load_a<DP>(kf[kk], k_s, 16 * warp, 16 * kk, lane);
            load_a<DP>(vf[kk], v_s, 16 * warp, 16 * kk, lane);
        }
    }
    float dk_acc[L::kN][4], dv_acc[L::kN][4];
#pragma unroll
    for (int j = 0; j < L::kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
    }
    const float scale_log2 = scale * kLog2e;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) stage_queries((it + 1) & 1, i_begin + (it + 1) * kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int i0 = i_begin + it * kTile;
        const bf16* qt = q_s + (it & 1) * L::kTileElems;
        const bf16* dot = do_s + (it & 1) * L::kTileElems;
        const float* lse_t = lse_s + (it & 1) * kTile;
        const float* dl_t = dl_s + (it & 1) * kTile;
#pragma unroll 1
        for (int sub = 0; sub < kTile; sub += kSub) {
            const int is0 = i0 + sub;
            // a warp past Tk, a pass past Tq, or a pass wholly before the
            // warp's first key has nothing to do
            if (wk0 >= Tk || is0 >= Tq || (causal && is0 + kSub - 1 < wk0)) continue;
            float st[kSub / 8][4], dp[kSub / 8][4];  // S^T and dP^T: 16 keys x kSub queries
#pragma unroll
            for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.0f;
            }
#pragma unroll
            for (int kk = 0; kk < L::kK; ++kk) {
                uint32_t ka[4], va[4];
                if constexpr (kKVRegs) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        ka[e] = kf[kk][e];
                        va[e] = vf[kk][e];
                    }
                } else {
                    load_a<DP>(ka, k_s, 16 * warp, 16 * kk, lane);
                    load_a<DP>(va, v_s, 16 * warp, 16 * kk, lane);
                }
#pragma unroll
                for (int np = 0; np < kSub / 16; ++np) {
                    uint32_t bb[4];
                    load_b<DP>(bb, qt, sub + 16 * np, 16 * kk, lane);
                    mma(st[2 * np], ka, bb[0], bb[1]);
                    mma(st[2 * np + 1], ka, bb[2], bb[3]);
                    load_b<DP>(bb, dot, sub + 16 * np, 16 * kk, lane);
                    mma(dp[2 * np], va, bb[0], bb[1]);
                    mma(dp[2 * np + 1], va, bb[2], bb[3]);
                }
            }
            // P^T into st, dS^T into dp; element masks only where the pass
            // crosses Tq or the diagonal: query is0 + 2 t + 8 j + (e & 1) sees
            // key r iff lo[r] <= 8 j + (e & 1) < hi (compares with immediates)
            const bool edge = is0 + kSub > Tq || (causal && is0 < wk0 + 15);
            const int hi = edge ? Tq - (is0 + 2 * t) : kSub;
            int lo[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) lo[r] = edge && causal ? wk0 + g + 8 * r - (is0 + 2 * t) : 0;
            const float* lse_c = lse_t + sub + 2 * t;
            const float* dl_c = dl_t + sub + 2 * t;
#pragma unroll
            for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = 8 * j + (e & 1);  // query column, past is0 + 2 t
                    const bool visible = c >= lo[e >> 1] && c < hi;
                    float row_lse = lse_c[c];
                    row_lse = row_lse == -CUDART_INF_F ? 0.0f : row_lse * kLog2e;
                    const float p = visible ? ex2(fmaf(st[j][e], scale_log2, -row_lse)) : 0.0f;
                    st[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - dl_c[c]);
                }
            }
            // dv += P^T do, dk += dS^T q over this pass's queries
#pragma unroll
            for (int kq = 0; kq < kSub / 16; ++kq) {
                uint32_t pa[4], da[4];
                acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
                acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
                for (int np = 0; np < L::kK; ++np) {
                    uint32_t bb[4];
                    load_bt<DP>(bb, dot, sub + 16 * kq, 16 * np, lane);
                    mma(dv_acc[2 * np], pa, bb[0], bb[1]);
                    mma(dv_acc[2 * np + 1], pa, bb[2], bb[3]);
                    load_bt<DP>(bb, qt, sub + 16 * kq, 16 * np, lane);
                    mma(dk_acc[2 * np], da, bb[0], bb[1]);
                    mma(dk_acc[2 * np + 1], da, bb[2], bb[3]);
                }
            }
        }
        __syncthreads();  // tile it has been read before its stage is refilled
    }

    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = (static_cast<long long>(b) * Tk * H + h) * D;
    const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.0f, 1.0f};
    store_rows<DP>(dk + base, row_stride, dk_acc, dk_mul, wk0, Tk, D, lane);
    store_rows<DP>(dv + base, row_stride, dv_acc, dv_mul, wk0, Tk, D, lane);
}

// ---------------------------------------------------------------------------
// dq's tiling: 8 warps of 16 queries share every k and v tile a block
// stages.  (4 warps, twice the blocks, ran 8% slower at [1, 4096, 8, 64]
// and at the learner's [8, 17, 16, 64], 4% faster at [4, 256, 2, 64], on
// an H100.)
constexpr int kDqWarps = 8;
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDqRows = 16 * kDqWarps;  // queries a block owns

// dq (and delta): a 1-D grid of ceil(Tq / kDqRows) * H * B blocks, the last
// query tiles first; warp w owns queries q0 + 16 w .. q0 + 16 w + 15
template <int DP>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ d_o, const float* __restrict__ lse,
                    bf16* __restrict__ dq, float* __restrict__ delta, int Tq, int Tk, int H,
                    int B, int D, Strides sq, Strides sk, Strides sv, float scale, int causal) {
    using L = Dims<DP>;
    // q and do fragments held in registers up to DP = 64, re-read from
    // shared memory at 128, where dq takes 64 registers a thread
    constexpr bool kQRegs = DP <= 64;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* q_s = reinterpret_cast<bf16*>(smem);   // [kDqRows][DP + kPad]
    bf16* do_s = q_s + kDqRows * L::kStride;      // [kDqRows][DP + kPad]
    bf16* k_s = do_s + kDqRows * L::kStride;      // 2 stages
    bf16* v_s = k_s + 2 * L::kTileElems;          // 2 stages
    float* dl_s = reinterpret_cast<float*>(v_s + 2 * L::kTileElems);  // [kDqRows] delta

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int q0 =
        ((Tq + kDqRows - 1) / kDqRows - 1 - static_cast<int>(blockIdx.x / slices)) * kDqRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 16 * warp;  // this warp's first query

    const bf16* qx = q + b * sq.b + h * sq.h;
    const bf16* kx = k + b * sk.b + h * sk.h;
    const bf16* vx = v + b * sv.b + h * sv.h;
    const long long row_stride = static_cast<long long>(H) * D;  // of o, do and dq
    const long long rows_base = (static_cast<long long>(b) * Tq * H + h) * D;
    const bf16* ox = o + rows_base;
    const bf16* dox = d_o + rows_base;
    const long long stat_base = (static_cast<long long>(b) * H + h) * Tq;
    const int wk = copy_width(kx, sk.t), wv = copy_width(vx, sv.t);
    // keys past the block's last query are above the diagonal of every row
    const int k_end = causal ? min(Tk, min(q0 + kDqRows, Tq)) : Tk;
    const int n_tiles = (k_end + kTile - 1) / kTile;

    stage_rows<DP, kDqRows, kDqThreads>(q_s, qx, sq.t, q0, Tq, D, copy_width(qx, sq.t));
    stage_rows<DP, kDqRows, kDqThreads>(do_s, dox, row_stride, q0, Tq, D,
                                        copy_width(dox, row_stride));
    stage_rows<DP, kTile, kDqThreads>(k_s, kx, sk.t, 0, Tk, D, wk);
    stage_rows<DP, kTile, kDqThreads>(v_s, vx, sv.t, 0, Tk, D, wv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // delta = sum_d do * o over the warp's 16 rows in float32, from the
    // staged do and the stored o: a row's DP / 8 chunks of 8 on as many
    // lanes, closed by a butterfly, into dl_s and the delta buffer
    {
        constexpr int kRowsPass = 32 / L::kChunks;  // rows per pass
        const int c = lane % L::kChunks;
        const bool whole = D == DP && copy_width(ox, row_stride) == 16;
#pragma unroll
        for (int pass = 0; pass < 16 / kRowsPass; ++pass) {
            const int rr = lane / L::kChunks + pass * kRowsPass;  // the warp's row
            const int row = wq0 + rr;
            float part = 0.0f;
            if (row < Tq) {
                const bf16* src = ox + row * row_stride + 8 * c;
                const uint4 dw = *reinterpret_cast<const uint4*>(
                    do_s + (16 * warp + rr) * L::kStride + 8 * c);
                uint4 ow;
                if (whole) {
                    ow = *reinterpret_cast<const uint4*>(src);
                } else {
                    const unsigned short* hs = reinterpret_cast<const unsigned short*>(src);
                    uint32_t w[4];
#pragma unroll
                    for (int p = 0; p < 4; ++p) {
                        const uint32_t lo = 8 * c + 2 * p < D ? hs[2 * p] : 0u;
                        const uint32_t hi = 8 * c + 2 * p + 1 < D ? hs[2 * p + 1] : 0u;
                        w[p] = lo | (hi << 16);
                    }
                    ow = make_uint4(w[0], w[1], w[2], w[3]);
                }
                const uint32_t dws[4] = {dw.x, dw.y, dw.z, dw.w};
                const uint32_t ows[4] = {ow.x, ow.y, ow.z, ow.w};
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const float2 df = unpack_bf16(dws[p]), of = unpack_bf16(ows[p]);
                    part += df.x * of.x;
                    part += df.y * of.y;
                }
            }
#pragma unroll
            for (int off = L::kChunks / 2; off > 0; off >>= 1) {
                part += __shfl_xor_sync(kFull, part, off);
            }
            if (c == 0) dl_s[16 * warp + rr] = part;
        }
        __syncwarp();
        if (lane < 16 && wq0 + lane < Tq) delta[stat_base + wq0 + lane] = dl_s[16 * warp + lane];
    }
    // rows g and g + 8 of the warp: lse in log2 units (-inf read as 0: every
    // probability of such a row is masked) and delta
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = wq0 + g + 8 * r;
        const float x = row < Tq ? lse[stat_base + row] : 0.0f;
        lse2[r] = x == -CUDART_INF_F ? 0.0f : x * kLog2e;
        dl[r] = dl_s[16 * warp + g + 8 * r];
    }

    uint32_t qf[kQRegs ? L::kK : 1][4], df[kQRegs ? L::kK : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
        for (int kk = 0; kk < L::kK; ++kk) {
            load_a<DP>(qf[kk], q_s, 16 * warp, 16 * kk, lane);
            load_a<DP>(df[kk], do_s, 16 * warp, 16 * kk, lane);
        }
    }
    float acc[L::kN][4];
#pragma unroll
    for (int j = 0; j < L::kN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const float scale_log2 = scale * kLog2e;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            const int nxt = (it + 1) & 1;
            stage_rows<DP, kTile, kDqThreads>(k_s + nxt * L::kTileElems, kx, sk.t,
                                              (it + 1) * kTile, Tk, D, wk);
            stage_rows<DP, kTile, kDqThreads>(v_s + nxt * L::kTileElems, vx, sv.t,
                                              (it + 1) * kTile, Tk, D, wv);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const bf16* kt = k_s + (it & 1) * L::kTileElems;
        const bf16* vt = v_s + (it & 1) * L::kTileElems;
        if (wq0 < Tq) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int kh = 32 * half;       // the half's first key in the tile
                const int k0 = it * kTile + kh;  // and in the slice
                // a half past Tk, or wholly above the warp's rows, adds nothing
                if (k0 >= Tk || (causal && k0 > wq0 + 15)) continue;
                float s[4][4], dp[4][4];  // S and dP: 16 queries x 32 keys
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
                }
#pragma unroll
                for (int kk = 0; kk < L::kK; ++kk) {
                    uint32_t qa[4], da[4];
                    if constexpr (kQRegs) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            qa[e] = qf[kk][e];
                            da[e] = df[kk][e];
                        }
                    } else {
                        load_a<DP>(qa, q_s, 16 * warp, 16 * kk, lane);
                        load_a<DP>(da, do_s, 16 * warp, 16 * kk, lane);
                    }
#pragma unroll
                    for (int np = 0; np < 2; ++np) {
                        uint32_t bb[4];
                        load_b<DP>(bb, kt, kh + 16 * np, 16 * kk, lane);
                        mma(s[2 * np], qa, bb[0], bb[1]);
                        mma(s[2 * np + 1], qa, bb[2], bb[3]);
                        load_b<DP>(bb, vt, kh + 16 * np, 16 * kk, lane);
                        mma(dp[2 * np], da, bb[0], bb[1]);
                        mma(dp[2 * np + 1], da, bb[2], bb[3]);
                    }
                }
                // element masks only where the half crosses the end or the
                // diagonal: key k0 + 2 t + 8 j + (e & 1) is visible to row r
                // iff 8 j + (e & 1) <= lim[r] (a compare with an immediate);
                // a masked score is -inf, whose ex2 is 0
                if (k0 + 32 > Tk || (causal && k0 + 31 > wq0)) {
                    int lim[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int row = wq0 + g + 8 * r;
                        lim[r] = (causal ? min(row, Tk - 1) : Tk - 1) - (k0 + 2 * t);
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            if (8 * j + (e & 1) > lim[e >> 1]) s[j][e] = -CUDART_INF_F;
                        }
                    }
                }
                // P = 2^(S scale log2 e - lse log2 e), dS = P (dP - delta), in s
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
                        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
                    }
                }
                // dq += dS k over the half's keys, dS rounded to bf16 as the A operand
#pragma unroll
                for (int kq = 0; kq < 2; ++kq) {
                    uint32_t da[4];
                    acc_to_a(da, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
                    for (int np = 0; np < L::kK; ++np) {
                        uint32_t bb[4];
                        load_bt<DP>(bb, kt, kh + 16 * kq, 16 * np, lane);
                        mma(acc[2 * np], da, bb[0], bb[1]);
                        mma(acc[2 * np + 1], da, bb[2], bb[3]);
                    }
                }
            }
        }
        __syncthreads();  // tile it has been read before its stage is refilled
    }

    const float mul[2] = {scale, scale};
    store_rows<DP>(dq + rows_base, row_stride, acc, mul, wq0, Tq, D, lane);
}

// ---------------------------------------------------------------------------
template <int DP>
constexpr int fwd_smem_bytes() {
    return (kFwdRows + 4 * kTile) * Dims<DP>::kStride * static_cast<int>(sizeof(bf16));
}
template <int DP>
constexpr int dq_smem_bytes() {
    return (2 * kDqRows + 4 * kTile) * Dims<DP>::kStride * static_cast<int>(sizeof(bf16)) +
           kDqRows * static_cast<int>(sizeof(float));
}
template <int DP>
constexpr int dkv_smem_bytes() {
    return 6 * Dims<DP>::kTileElems * static_cast<int>(sizeof(bf16)) +
           4 * kTile * static_cast<int>(sizeof(float));
}

// blocks for `rows` rows of every (batch row, head), `own` a block, or 0
// past the grid's limit
inline unsigned grid_of(int rows, int own, int H, int B) {
    const long long n = static_cast<long long>((rows + own - 1) / own) * H * B;
    return n <= 0x7fffffffLL && static_cast<long long>(H) * B <= 0x7fffffffLL
               ? static_cast<unsigned>(n) : 0u;
}

// dynamic shared memory above the default 48 KB needs the kernel's consent
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 forward, dq and dk/dv on the FMA units (the header's micro-tile
// design)
namespace mt {

// 4 warps a block.  (8, each taking 16 rows of 128-row tiles, ran the
// forward, dq and dk/dv 16-24% faster at [4, 256, 2, 64], one block an SM,
// but 8-9% slower at [2, 1024, 4, 64], 46-52% slower at the learner's
// [8, 17, 16, 64] and 49-51% slower inside its learn step, on an H100; the
// rings would not fit at D = 128.)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;           // rows a block owns (keys in dk/dv, else queries)
constexpr int kTile = 16 * kWarps;  // rows of the streamed axis per ring stage, 16 a warp
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kPStride = 16 + kPad;  // floats per row of a warp's P (or dS) tile
// Blocks per SM the register budget must allow (at most 255 registers a
// thread); a minimum keeps ptxas from trading registers for occupancy
constexpr int kMinBlocks = 2;
// Unrolling: the loops over D kDotUnroll times, those over a warp's 16 rows
// of a tile kRowUnroll times, a thread's chunks of a ring stage not at all.
// Wholly unrolled, 7,600-8,000 instructions a kernel at DP = 64 -- run once
// a block at the learner's T = 17 -- took twice their CUDA-graph replay time
// inside the learn step, where other kernels had evicted them from the
// instruction caches; most of it was the staging's three copy widths
// unrolled over 8 chunks a thread (tools/flash_study.py on an H100)
constexpr int kDotUnroll = 4;
constexpr int kRowUnroll = 4;
constexpr int kStageUnroll = 1;

template <int DP>
struct Dims {
    static_assert(DP % 8 == 0 && DP >= 8 && DP <= 128, "8 lanes share a row's columns");
    static constexpr int kStride = DP + kPad;           // floats per shared row
    static constexpr int kTileElems = kTile * kStride;  // one [64][DP + 4] tile
    static constexpr int kCols = DP / 8;                // accumulator columns a lane holds
    static constexpr int kVec = kCols < 4 ? kCols : 4;  // floats per vector read
};

// n consecutive floats from shared memory (n = 1, 2 or 4, aligned to n)
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

// rows [r0, r0 + kTile) of a slice into a ring stage (tc::stage_rows)
template <int DP>
__device__ __forceinline__ void stage_tile(float* tile, const float* __restrict__ x,
                                           long long stride_t, int r0, int n, int D, int width) {
    tc::stage_rows<DP, kTile, kThreads, Dims<DP>::kStride, kStageUnroll>(tile, x, stride_t, r0,
                                                                         n, D, width);
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

// forward: a 1-D grid of ceil(Tq / kRows) * H * B blocks, the last query
// tiles first.  Lane 8 r + c of warp w: scores of rows q0 + r + 4 i against
// keys 16 w + c + 8 j of each tile; o of rows q0 + r + 4 i at the columns
// col(u, e) = 8 kVec u + kVec c + e.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int H, int B, int D, Strides sq, Strides sk, Strides sv,
                 float scale, int causal) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
    constexpr int kU = L::kCols / L::kVec;  // vector reads per o row
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);  // [kRows][DP + 4]
    float* k_s = q_s + kRows * kS;                // 2 stages
    float* v_s = k_s + 2 * L::kTileElems;         // 2 stages
    float* p_s = v_s + 2 * L::kTileElems;         // [kWarps][16 keys][kPStride]
    float* m_s = p_s + kWarps * 16 * kPStride;    // [kWarps][kRows] running max
    float* l_s = m_s + kWarps * kRows;            // [kWarps][kRows] running sum
    float* den_s = l_s + kWarps * kRows;          // [kRows] the rows' sums
    float* part = k_s;  // [kWarps][kRows][DP]: the warps' o, once the ring is done

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int q0 = ((Tq + kRows - 1) / kRows - 1 - static_cast<int>(blockIdx.x / slices)) * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    const float* qx = q + b * sq.b + h * sq.h;
    const float* kx = k + b * sk.b + h * sk.h;
    const float* vx = v + b * sv.b + h * sv.h;
    const int wk = tc::copy_width(kx, sk.t), wv = tc::copy_width(vx, sv.t);
    // keys past the block's last query are above the diagonal of every row
    const int k_end = causal ? min(Tk, min(q0 + kRows, Tq)) : Tk;
    const int n_tiles = (k_end + kTile - 1) / kTile;

    tc::stage_rows<DP, kRows, kThreads, kS>(q_s, qx, sq.t, q0, Tq, D, tc::copy_width(qx, sq.t));
    stage_tile<DP>(k_s, kx, sk.t, 0, Tk, D, wk);
    stage_tile<DP>(v_s, vx, sv.t, 0, Tk, D, wv);
    tc::cp_async_commit();

    float acc[4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[i][n] = 0.0f;
    }
    // running max of this warp's visible scores and this lane's part of the
    // running sum of exp(score - m), rows q0 + r + 4 i
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F, l[i] = 0.0f;
    float* pw = p_s + warp * 16 * kPStride;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            const int nxt = (it + 1) & 1;
            stage_tile<DP>(k_s + nxt * L::kTileElems, kx, sk.t, (it + 1) * kTile, Tk, D, wk);
            stage_tile<DP>(v_s + nxt * L::kTileElems, vx, sv.t, (it + 1) * kTile, Tk, D, wv);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int kw = it * kTile + 16 * warp;  // the warp's first key
        const float* kt = k_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        const float* vt = v_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        // keys past Tk, or wholly above the block's rows, add nothing
        if (kw < Tk && (!causal || kw <= q0 + kRows - 1)) {
            // S = q k^T, the 4 x 2 micro-tile, summed over D in order
            float s[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
            micro_tiles<DP, kS, 1>(&s, &q_s, &kt, r, c);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][0] *= scale, s[i][1] *= scale;
            // element masks only where the warp's keys cross the end or the
            // diagonal: key kw + c + 8 j is visible to row i iff 8 j <= lim[i]
            if (kw + 16 > Tk || (causal && kw + 15 > q0)) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int row = q0 + r + 4 * i;
                    const int lim = (causal ? min(row, Tk - 1) : Tk - 1) - (kw + c);
                    if (0 > lim) s[i][0] = -CUDART_INF_F;
                    if (8 > lim) s[i][1] = -CUDART_INF_F;
                }
            }
            // online softmax: a row's max over its 8 lanes, then P = exp(s - m)
            float p[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float mx = fmaxf(s[i][0], s[i][1]);
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
                const float m_new = fmaxf(m[i], mx);
                // no visible key yet: exp(-inf - 0) = 0, never -inf - -inf
                const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
                const float corr = expf(m[i] - safe);
                p[i][0] = expf(s[i][0] - safe);
                p[i][1] = expf(s[i][1] - safe);
                l[i] = l[i] * corr + (p[i][0] + p[i][1]);
                m[i] = m_new;
#pragma unroll
                for (int n = 0; n < L::kCols; ++n) acc[i][n] *= corr;
            }
            // P to the warp's tile, key-major: row 4 r + i of key c + 8 j
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                *reinterpret_cast<float4*>(pw + (c + 8 * j) * kPStride + 4 * r) =
                    make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
            }
            __syncwarp();
            // o += P v over the warp's 16 keys, in key order
#pragma unroll(kRowUnroll)
            for (int key = 0; key < 16; ++key) {
                const float4 pv = *reinterpret_cast<const float4*>(pw + key * kPStride + 4 * r);
                const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    float vv[L::kVec];
                    load_f<L::kVec>(vv, vt + key * kS + 8 * L::kVec * u + L::kVec * c);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int e = 0; e < L::kVec; ++e) {
                            acc[i][L::kVec * u + e] = fmaf(pr[i], vv[e], acc[i][L::kVec * u + e]);
                        }
                    }
                }
            }
        }
        __syncthreads();  // tile it (and the P tiles) read before refilling
    }

    // combine the 4 warps' (m, l, o) in warp order
    tc::cp_async_wait<0>();
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
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r + 4 * i;
        float mx = m_s[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRows + row]);
        const float f = expf(m[i] - (mx == -CUDART_INF_F ? 0.0f : mx));
        float* dst = part + (warp * kRows + row) * DP;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) {
                dst[8 * L::kVec * u + L::kVec * c + e] = acc[i][L::kVec * u + e] * f;
            }
        }
    }
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
        if (q0 + row < Tq) {
            lse[(static_cast<long long>(b) * H + h) * Tq + q0 + row] =
                sum > 0.0f ? mx + logf(denom) : -CUDART_INF_F;
        }
    }
    __syncthreads();
    const long long row_stride = static_cast<long long>(H) * D;
    float* out = o + (static_cast<long long>(b) * Tq * H + h) * D;
    // the block's [kRows][DP] outputs, consecutive threads on consecutive
    // columns; DP is a constant, so the row and column cost no division
    constexpr int kOut = kRows * DP;
#pragma unroll
    for (int i = 0; i < (kOut + kThreads - 1) / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / DP, col = idx % DP;
        if ((kOut % kThreads != 0 && idx >= kOut) || col >= D || q0 + row >= Tq) continue;
        float x = part[row * DP + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) x += part[(w * kRows + row) * DP + col];
        // a division per element, as the plain version divides p by l: one
        // rounded reciprocal would give every element of a row the same error
        out[(q0 + row) * row_stride + col] = x / den_s[row];
    }
}

// dq (and delta): a 1-D grid of ceil(Tq / kRows) * H * B blocks, the last
// query tiles first.  Lane 8 r + c of warp w: S and dP of rows q0 + r + 4 i
// against keys 16 w + c + 8 j of each tile; dq of rows q0 + r + 4 i at the
// columns col(u, e) = 8 kVec u + kVec c + e.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ d_o, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ delta, int Tq, int Tk, int H,
                    int B, int D, Strides sq, Strides sk, Strides sv, float scale, int causal) {
    using L = Dims<DP>;
    constexpr int kS = L::kStride;
    constexpr int kU = L::kCols / L::kVec;  // vector reads per dq row
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);  // [kRows][DP + 4]
    float* do_s = q_s + kRows * kS;               // [kRows][DP + 4]
    float* k_s = do_s + kRows * kS;               // 2 stages
    float* v_s = k_s + 2 * L::kTileElems;         // 2 stages
    float* ds_s = v_s + 2 * L::kTileElems;        // [kWarps][16 keys][kPStride]
    float* lse_s = ds_s + kWarps * 16 * kPStride;  // [kRows]
    float* dl_s = lse_s + kRows;                  // [kRows] delta
    float* part = k_s;  // [kWarps][kRows][DP]: the warps' dq, once the ring is done

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int q0 = ((Tq + kRows - 1) / kRows - 1 - static_cast<int>(blockIdx.x / slices)) * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    const float* qx = q + b * sq.b + h * sq.h;
    const float* kx = k + b * sk.b + h * sk.h;
    const float* vx = v + b * sv.b + h * sv.h;
    const long long row_stride = static_cast<long long>(H) * D;  // of o, do and dq
    const long long rows_base = (static_cast<long long>(b) * Tq * H + h) * D;
    const long long stat_base = (static_cast<long long>(b) * H + h) * Tq;
    const float* dox = d_o + rows_base;
    const int wk = tc::copy_width(kx, sk.t), wv = tc::copy_width(vx, sv.t);
    // keys past the block's last query are above the diagonal of every row
    const int k_end = causal ? min(Tk, min(q0 + kRows, Tq)) : Tk;
    const int n_tiles = (k_end + kTile - 1) / kTile;

    tc::stage_rows<DP, kRows, kThreads, kS>(q_s, qx, sq.t, q0, Tq, D, tc::copy_width(qx, sq.t));
    tc::stage_rows<DP, kRows, kThreads, kS>(do_s, dox, row_stride, q0, Tq, D,
                                            tc::copy_width(dox, row_stride));
    tc::cp_async_commit();
    stage_tile<DP>(k_s, kx, sk.t, 0, Tk, D, wk);
    stage_tile<DP>(v_s, vx, sv.t, 0, Tk, D, wv);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // q and do
    __syncthreads();

    // delta = sum_d do * o of row threadIdx.x / 8 from the staged do and the
    // stored o: this lane's columns col(u, e) in order, then the row's 8
    // lanes (3 shuffles); with lse (-inf read as 0: every probability of
    // such a row is masked) into shared memory, and delta into its buffer
    for (int row = threadIdx.x >> 3; row < kRows; row += kThreads / 8) {
        const bool live = q0 + row < Tq;
        float sum = 0.0f;
        if (live) {
            const float* orow = o + rows_base + (q0 + row) * row_stride;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
#pragma unroll
                for (int e = 0; e < L::kVec; ++e) {
                    const int col = 8 * L::kVec * u + L::kVec * c + e;
                    if (col < D) sum = fmaf(do_s[row * kS + col], orow[col], sum);
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
    float lse_r[4], dl_r[4];  // rows q0 + r + 4 i
#pragma unroll
    for (int i = 0; i < 4; ++i) lse_r[i] = lse_s[r + 4 * i], dl_r[i] = dl_s[r + 4 * i];

    float acc[4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) acc[i][n] = 0.0f;
    }
    float* pw = ds_s + warp * 16 * kPStride;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            const int nxt = (it + 1) & 1;
            stage_tile<DP>(k_s + nxt * L::kTileElems, kx, sk.t, (it + 1) * kTile, Tk, D, wk);
            stage_tile<DP>(v_s + nxt * L::kTileElems, vx, sv.t, (it + 1) * kTile, Tk, D, wv);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int kw = it * kTile + 16 * warp;  // the warp's first key
        const float* kt = k_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        const float* vt = v_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        // keys past Tk, or wholly above the block's rows, add nothing
        if (kw < Tk && (!causal || kw <= q0 + kRows - 1)) {
            // S = q k^T and dP = do v^T, the 4 x 2 micro-tiles, in one pass over D
            float sd[2][4][2] = {};
            const float* rows[2] = {q_s, do_s};
            const float* cols[2] = {kt, vt};
            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);
            const float(&s)[4][2] = sd[0];
            const float(&dp)[4][2] = sd[1];
            // P = exp(S scale - lse), the scale rounded apart (as the
            // forward's scores), masked to 0 only where the warp's keys
            // cross the end or the diagonal: key kw + c + 8 j is visible to
            // row i iff 8 j <= lim[i]
            float p[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 2; ++j) p[i][j] = expf(__fmul_rn(s[i][j], scale) - lse_r[i]);
            }
            if (kw + 16 > Tk || (causal && kw + 15 > q0)) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int row = q0 + r + 4 * i;
                    const int lim = (causal ? min(row, Tk - 1) : Tk - 1) - (kw + c);
                    if (0 > lim) p[i][0] = 0.0f;
                    if (8 > lim) p[i][1] = 0.0f;
                }
            }
            // dS = P (dP - delta) to the warp's tile, key-major: row 4 r + i
            // of key c + 8 j
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float ds[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) ds[i] = p[i][j] * (dp[i][j] - dl_r[i]);
                *reinterpret_cast<float4*>(pw + (c + 8 * j) * kPStride + 4 * r) =
                    make_float4(ds[0], ds[1], ds[2], ds[3]);
            }
            __syncwarp();
            // dq += dS k over the warp's 16 keys, in key order
#pragma unroll(kRowUnroll)
            for (int key = 0; key < 16; ++key) {
                const float4 dv4 = *reinterpret_cast<const float4*>(pw + key * kPStride + 4 * r);
                const float dr[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    float kk[L::kVec];
                    load_f<L::kVec>(kk, kt + key * kS + 8 * L::kVec * u + L::kVec * c);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int e = 0; e < L::kVec; ++e) {
                            acc[i][L::kVec * u + e] = fmaf(dr[i], kk[e], acc[i][L::kVec * u + e]);
                        }
                    }
                }
            }
        }
        __syncthreads();  // tile it (and the dS tiles) read before refilling
    }

    // combine the 4 warps' dq in warp order; scale once, at the store
    tc::cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float* dst = part + (warp * kRows + r + 4 * i) * DP;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) {
                dst[8 * L::kVec * u + L::kVec * c + e] = acc[i][L::kVec * u + e];
            }
        }
    }
    __syncthreads();
    float* out = dq + rows_base;
    constexpr int kOut = kRows * DP;
#pragma unroll
    for (int i = 0; i < (kOut + kThreads - 1) / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / DP, col = idx % DP;
        if ((kOut % kThreads != 0 && idx >= kOut) || col >= D || q0 + row >= Tq) continue;
        float x = part[row * DP + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) x += part[(w * kRows + row) * DP + col];
        out[(q0 + row) * row_stride + col] = x * scale;
    }
}

// dk and dv: a 1-D grid of ceil(Tk / kRows) * H * B blocks, the first key
// tiles first.  Lane 8 r + c of warp w: S^T and dP^T of keys k0 + r + 4 i
// against queries 16 w + c + 8 j of each tile; dk and dv of keys
// k0 + r + 4 i at the columns col(u, e) = 8 kVec u + kVec c + e.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ d_o,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H,
                     int B, int D, Strides sq, Strides sk, Strides sv, float scale, int causal) {
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
    float* part = q_s;  // [2][kWarps][kRows][DP]: the warps' dk and dv, once the ring is done

    const int slices = H * B;
    const int bh = blockIdx.x % slices;
    const int h = bh % H, b = bh / H;
    const int k0 = static_cast<int>(blockIdx.x / slices) * kRows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 3, c = lane & 7;

    const float* qx = q + b * sq.b + h * sq.h;
    const float* kx = k + b * sk.b + h * sk.h;
    const float* vx = v + b * sv.b + h * sv.h;
    const long long do_stride = static_cast<long long>(H) * D;
    const float* dox = d_o + (static_cast<long long>(b) * Tq * H + h) * D;
    const float* lse_x = lse + (static_cast<long long>(b) * H + h) * Tq;
    const float* dl_x = delta + (static_cast<long long>(b) * H + h) * Tq;
    const int wq = tc::copy_width(qx, sq.t), wdo = tc::copy_width(dox, do_stride);
    // queries before the block's first key see none of its keys
    const int i_begin = causal ? k0 : 0;
    const int n_tiles = i_begin < Tq ? (Tq - i_begin + kTile - 1) / kTile : 0;

    auto stage_queries = [&](int stage, int i0) {
        stage_tile<DP>(q_s + stage * L::kTileElems, qx, sq.t, i0, Tq, D, wq);
        stage_tile<DP>(do_s + stage * L::kTileElems, dox, do_stride, i0, Tq, D, wdo);
        tc::stage_stats<kTile>(lse_s + stage * kTile, lse_x, i0, Tq);
        tc::stage_stats<kTile>(dl_s + stage * kTile, dl_x, i0, Tq);
    };
    tc::stage_rows<DP, kRows, kThreads, kS>(k_s, kx, sk.t, k0, Tk, D, tc::copy_width(kx, sk.t));
    tc::stage_rows<DP, kRows, kThreads, kS>(v_s, vx, sv.t, k0, Tk, D, tc::copy_width(vx, sv.t));
    if (n_tiles > 0) stage_queries(0, i_begin);
    tc::cp_async_commit();

    float dk_acc[4][L::kCols], dv_acc[4][L::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < L::kCols; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.0f;
    }
    float* pw = p_s + warp * 16 * kPStride;
    float* dw = ds_s + warp * 16 * kPStride;

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) stage_queries((it + 1) & 1, i_begin + (it + 1) * kTile);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
        __syncthreads();  // tile it has landed for every thread

        const int iw = i_begin + it * kTile + 16 * warp;  // the warp's first query
        const float* qt = q_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        const float* gt = do_s + (it & 1) * L::kTileElems + 16 * warp * kS;
        const float* lse_t = lse_s + (it & 1) * kTile + 16 * warp;
        const float* dl_t = dl_s + (it & 1) * kTile + 16 * warp;
        // queries past Tq add nothing (under causal no warp lies wholly
        // before the block's keys: the walk starts at k0)
        if (iw < Tq) {
            // S^T = k q^T and dP^T = v do^T, the 4 x 2 micro-tiles (S^T is
            // dq's S: the same products in the same order, and an FMA's
            // product is exact whichever factor comes first)
            float sd[2][4][2] = {};
            const float* rows[2] = {k_s, v_s};
            const float* cols[2] = {qt, gt};
            micro_tiles<DP, kS, 2>(sd, rows, cols, r, c);
            const float(&st)[4][2] = sd[0];
            const float(&dpt)[4][2] = sd[1];
            // P^T = exp(S^T scale - lse) (-inf read as 0), masked to 0 only
            // where the warp's queries cross Tq or the diagonal: query
            // iw + c + 8 j sees key k0 + r + 4 i iff lo[i] <= 8 j < hi
            float p[4][2], dl[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float row_lse = lse_t[c + 8 * j];
                row_lse = row_lse == -CUDART_INF_F ? 0.0f : row_lse;
                dl[j] = dl_t[c + 8 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) p[i][j] = expf(__fmul_rn(st[i][j], scale) - row_lse);
            }
            if (iw + 16 > Tq || (causal && iw < k0 + kRows - 1)) {
                const int hi = Tq - (iw + c);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int lo = causal ? k0 + r + 4 * i - (iw + c) : 0;
                    if (0 < lo || 0 >= hi) p[i][0] = 0.0f;
                    if (8 < lo || 8 >= hi) p[i][1] = 0.0f;
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
    }

    // combine the 4 warps' dk and dv in warp order; scale on dk once, at the store
    tc::cp_async_wait<0>();
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
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = (static_cast<long long>(b) * Tk * H + h) * D;
    const float* part_v = part + kWarps * kRows * DP;
    constexpr int kOut = kRows * DP;
#pragma unroll
    for (int i = 0; i < (kOut + kThreads - 1) / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / DP, col = idx % DP;
        if ((kOut % kThreads != 0 && idx >= kOut) || col >= D || k0 + row >= Tk) continue;
        float xk = part[row * DP + col], xv = part_v[row * DP + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            xk += part[(w * kRows + row) * DP + col];
            xv += part_v[(w * kRows + row) * DP + col];
        }
        dk[base + (k0 + row) * row_stride + col] = xk * scale;
        dv[base + (k0 + row) * row_stride + col] = xv;
    }
}

template <int DP>
constexpr int fwd_smem_bytes() {
    return ((kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride +
            (2 * kWarps + 1) * kRows) * static_cast<int>(sizeof(float));
}
template <int DP>
constexpr int dq_smem_bytes() {
    return ((2 * kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride + 2 * kRows) *
           static_cast<int>(sizeof(float));
}
template <int DP>
constexpr int dkv_smem_bytes() {
    return ((2 * kRows + 4 * kTile) * Dims<DP>::kStride + 2 * kWarps * 16 * kPStride +
            4 * kTile) * static_cast<int>(sizeof(float));
}

}  // namespace mt

// ---------------------------------------------------------------------------
struct Args {
    const void *q, *k, *v;
    int B, Tq, Tk, H, D;
    Strides sq, sk, sv;
    float scale;
    int causal;
    cudaStream_t stream;
};

namespace tc {

// the tensor-core head dim for a built DMAX: the mma depth is 16
constexpr int padded(int dmax) { return dmax < 16 ? 16 : dmax; }

template <int DP>
cudaError_t fwd(const Args& a, void* o, float* lse) {
    const unsigned blocks = grid_of(a.Tq, kFwdRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = allow_smem(flash_fwd_kernel<DP>, fwd_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<DP><<<blocks, kFwdThreads, fwd_smem_bytes<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(o), lse, a.Tq, a.Tk, a.H, a.B, a.D,
        a.sq, a.sk, a.sv, a.scale, a.causal);
    return cudaSuccess;
}

template <int DP>
cudaError_t bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
                   float* delta) {
    const unsigned blocks = grid_of(a.Tq, kDqRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP>, dq_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<DP><<<blocks, kDqThreads, dq_smem_bytes<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(o), static_cast<const bf16*>(d_o),
        lse, static_cast<bf16*>(dq), delta, a.Tq, a.Tk, a.H, a.B, a.D, a.sq, a.sk, a.sv, a.scale,
        a.causal);
    return cudaSuccess;
}

template <int DP>
cudaError_t bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta,
                    void* dk, void* dv) {
    const unsigned blocks = grid_of(a.Tk, kRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DP>, dkv_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<DP><<<blocks, kThreads, dkv_smem_bytes<DP>(), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(d_o), lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.Tq, a.Tk, a.H, a.B, a.D, a.sq, a.sk,
        a.sv, a.scale, a.causal);
    return cudaSuccess;
}

}  // namespace tc

namespace mt {

template <int DP>
cudaError_t fwd(const Args& a, void* o, float* lse) {
    const unsigned blocks = tc::grid_of(a.Tq, kRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = tc::allow_smem(flash_fwd_kernel<DP>, fwd_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<DP><<<blocks, kThreads, fwd_smem_bytes<DP>(), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(o), lse, a.Tq, a.Tk, a.H, a.B, a.D,
        a.sq, a.sk, a.sv, a.scale, a.causal);
    return cudaSuccess;
}

template <int DP>
cudaError_t bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
                   float* delta) {
    const unsigned blocks = tc::grid_of(a.Tq, kRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = tc::allow_smem(flash_bwd_dq_kernel<DP>, dq_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<DP><<<blocks, kThreads, dq_smem_bytes<DP>(), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(o),
        static_cast<const float*>(d_o), lse, static_cast<float*>(dq), delta, a.Tq, a.Tk, a.H,
        a.B, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
    return cudaSuccess;
}

template <int DP>
cudaError_t bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta,
                    void* dk, void* dv) {
    const unsigned blocks = tc::grid_of(a.Tk, kRows, a.H, a.B);
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    const cudaError_t err = tc::allow_smem(flash_bwd_dkv_kernel<DP>, dkv_smem_bytes<DP>());
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<DP><<<blocks, kThreads, dkv_smem_bytes<DP>(), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(d_o), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), a.Tq, a.Tk, a.H, a.B, a.D, a.sq, a.sk,
        a.sv, a.scale, a.causal);
    return cudaSuccess;
}

}  // namespace mt

// Pick the instantiation for the smallest built head dim DMAX >= D (8, 16,
// 32, 64, 128) and set err = CALL(DMAX).  Columns D..DMAX-1 ride as zeros.
#define FLASH_DISPATCH_D(a, err, CALL) \
    do {                               \
        if ((a).D <= 8) {              \
            err = CALL(8);             \
        } else if ((a).D <= 16) {      \
            err = CALL(16);            \
        } else if ((a).D <= 32) {      \
            err = CALL(32);            \
        } else if ((a).D <= 64) {      \
            err = CALL(64);            \
        } else {                       \
            err = CALL(128);           \
        }                              \
    } while (0)

// dtype 0 = float32 through CALL_F32, 1 = bfloat16 through CALL_BF16; a
// refused attribute or launch reaches the caller
#define FLASH_DISPATCH(a, dtype, CALL_F32, CALL_BF16)                        \
    do {                                                                     \
        if ((dtype) != 0 && (dtype) != 1) return (int)cudaErrorInvalidValue; \
        if ((a).D < 1 || (a).D > 128) return (int)cudaErrorInvalidValue;     \
        cudaError_t err_ = cudaSuccess;                                      \
        if ((dtype) == 0) {                                                  \
            FLASH_DISPATCH_D(a, err_, CALL_F32);                             \
        } else {                                                             \
            FLASH_DISPATCH_D(a, err_, CALL_BF16);                            \
        }                                                                    \
        if (err_ != cudaSuccess) return (int)err_;                           \
        return (int)cudaGetLastError();                                      \
    } while (0)

Args make_args(const void* q, const void* k, const void* v, int B, int Tq, int Tk, int H, int D,
               const long long* strides, float scale, int causal, void* stream) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.B = B;
    a.Tq = Tq;
    a.Tk = Tk;
    a.H = H;
    a.D = D;
    a.sq = Strides{strides[0], strides[1], strides[2]};
    a.sk = Strides{strides[3], strides[4], strides[5]};
    a.sv = Strides{strides[6], strides[7], strides[8]};
    a.scale = scale;
    a.causal = causal;
    a.stream = static_cast<cudaStream_t>(stream);
    return a;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (or the refused
// shared-memory attribute), so a refused launch reaches the caller; none
// synchronises.  `strides` holds the batch, token and head strides (in
// elements) of q, then k, then v, on the host.  The caller checks shapes
// (1 <= D <= 128, H and B <= 65535, Tq >= 1, and Tk >= 1 for dk/dv), types
// and that o, lse, delta, do, dq, dk and dv are contiguous.

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int Tq, int Tk, int H, int D,
                                          const long long* strides, float scale, int causal,
                                          int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_FWD(DMAX) mt::fwd<DMAX>(a, o, lse)
#define CALL_FWD_TC(DMAX) tc::fwd<tc::padded(DMAX)>(a, o, lse)
    FLASH_DISPATCH(a, dtype, CALL_FWD, CALL_FWD_TC);
#undef CALL_FWD
#undef CALL_FWD_TC
}

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* d_o, const float* lse,
                                             void* dq, float* delta, int B, int Tq, int Tk, int H,
                                             int D, const long long* strides, float scale,
                                             int causal, int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_DQ(DMAX) mt::bwd_dq<DMAX>(a, o, d_o, lse, dq, delta)
#define CALL_DQ_BF16(DMAX) tc::bwd_dq<tc::padded(DMAX)>(a, o, d_o, lse, dq, delta)
    FLASH_DISPATCH(a, dtype, CALL_DQ, CALL_DQ_BF16);
#undef CALL_DQ
#undef CALL_DQ_BF16
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* d_o, const float* lse,
                                              const float* delta, void* dk, void* dv, int B,
                                              int Tq, int Tk, int H, int D,
                                              const long long* strides, float scale, int causal,
                                              int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_DKV(DMAX) mt::bwd_dkv<DMAX>(a, d_o, lse, delta, dk, dv)
#define CALL_DKV_TC(DMAX) tc::bwd_dkv<tc::padded(DMAX)>(a, d_o, lse, delta, dk, dv)
    FLASH_DISPATCH(a, dtype, CALL_DKV, CALL_DKV_TC);
#undef CALL_DKV
#undef CALL_DKV_TC
}
