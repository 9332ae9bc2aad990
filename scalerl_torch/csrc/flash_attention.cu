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
// Three designs.  bfloat16 runs on the tensor cores (namespace tc): the
// forward, dq and dk/dv.  The float32 forward runs the micro-tile design
// (namespace mt); float32 dq and dk/dv run the lane design.  float32 stays
// off the tensor cores on purpose: the kernels compute exact float32 (FMAs,
// expf and logf), and a TF32 product would be another result.
//
// Lane design (float32 dq and dk/dv): a block of kThreads = 128 threads
// owns kRows consecutive rows of one (batch row, head) -- queries in the dq
// kernel, keys in the dk/dv kernel -- and splits each row's head dim over
// kLanes = DMAX / 8 neighbouring lanes of a warp, 8 elements a lane, so a
// row vector costs each thread 8 registers whatever D is (one thread per
// row spilled at D = 64 in csrc/segment_attention.cu).  A lane holds
// elements 4 * sub + {0..3} and DMAX / 2 + 4 * sub + {0..3}, so the lanes
// of a row read two runs of consecutive float4s from shared memory.  An
// inner product is 8 FMAs and a butterfly of log2(kLanes) shuffles; the
// butterfly adds the same two values on both lanes of every pair, so all
// lanes of a row hold the same score bit for bit and take the same masking
// and softmax decisions.  The other axis is walked in tiles of kTile = 32
// rows staged in shared memory as float32 (rows past the end and columns
// past D as zeros).  q enters both kernels multiplied by scale; dq gets the
// second factor when it is stored and dk gets none.
//
// Micro-tile design (float32 forward; an SGEMM's register blocking on the
// FMA units, for latency: the lane design's per-key chain of dot, butterfly,
// expf and axpy left an SM idle between its few warps).  A block of 4 warps
// owns 16 queries of one (batch row, head), stages them once, and streams
// the keys through a 2-stage cp.async ring of 64-key tiles; warp w takes
// keys 16 w .. 16 w + 15 of every tile.  Lane 8 r + c computes the 4 x 2
// micro-tile of scores of rows r + 4 i (i < 4) against keys c and c + 8 of
// its warp's 16: float4 reads of q and k rows from shared memory feed 32
// independent FMAs per 4 columns of D, with no shuffle.  Shared rows are
// padded by 4 floats, so the 4 q rows and 8 k rows a read touches fall in
// distinct bank groups.  A row's max closes once per tile over its 8 lanes
// (3 shuffles); P passes through a per-warp shared tile to the o += P v
// micro-tile (rows r + 4 i by D / 8 columns of lane c).  Each warp keeps
// its own running (m, l, o) over its keys; at the end the 4 partials are
// combined through shared memory in warp order (so repeats stay bit-equal)
// and o is divided by the row's sum element by element.
// The short query tile gives [4, 256, 2, 64] 128 blocks on 132 SMs, and the
// key split gives each block 4 warps of independent work along its walk.
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
//   kernel, never a copy in the wrapper.  The float32 forward stages the
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
// No atomics: every sum runs in a fixed order inside one block (lane
// butterflies, quad shuffles, mma accumulation, the float32 forward's
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
// outside the tensor cores (67 TFLOP/s), in FMAs (and shuffles in the lane
// design).
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

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // threads per block
// Blocks per SM the register budget must allow: 65536 / (4 * 128) = 128
// registers a thread.  With no minimum, ptxas cut one head-dim-16
// instantiation to 64 registers to keep 8 blocks resident, and spilled.
constexpr int kMinBlocks = 4;
constexpr int kVec = 8;        // elements of a row each lane holds
constexpr int kTile = 32;      // rows of the other axis per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile <= kThreads, "a tile's stats stage in one pass");

struct Strides {
    long long b, t, h;  // in elements; the stride along D is 1
};

template <int DMAX>
struct Layout {
    static constexpr int kLanes = DMAX / kVec;         // lanes per row
    static constexpr int kRows = kThreads / kLanes;    // rows a block owns
    static constexpr int kHalf = DMAX / 2;             // offset of a lane's second float4
    static_assert(DMAX % kVec == 0 && kLanes >= 1 && kLanes <= kWarp && kWarp % kLanes == 0,
                  "a row's lanes sit inside one warp");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the head-dim column of register slot r of lane `sub`
template <int DMAX>
__device__ __forceinline__ int col(int sub, int r) {
    return (r >> 2) * Layout<DMAX>::kHalf + sub * 4 + (r & 3);
}

// sum over the kLanes lanes of a row; every lane gets the same total
template <int LANES>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    return x;
}

// this lane's 8 elements of one row of x, times `mul` (zeros past D or off the end)
template <typename T, int DMAX>
__device__ __forceinline__ void load_vec(float (&reg)[kVec], const T* __restrict__ x,
                                         long long offset, int sub, bool live, int D, float mul) {
#pragma unroll
    for (int r = 0; r < kVec; ++r) {
        const int d = col<DMAX>(sub, r);
        reg[r] = (live && d < D) ? to_float(x[offset + d]) * mul : 0.0f;
    }
}

// rows [r0, r0 + kTile) of x into a float32 tile, times `mul`; rows past n
// and columns past D read as zero
template <typename T, int DMAX>
__device__ __forceinline__ void stage_tile(float (*tile)[DMAX], const T* __restrict__ x,
                                           long long base, long long stride_t, int r0, int n,
                                           int D, float mul) {
    for (int idx = threadIdx.x; idx < kTile * DMAX; idx += kThreads) {
        const int r = idx / DMAX;
        const int d = idx - r * DMAX;
        const int row = r0 + r;
        tile[r][d] = (row < n && d < D) ? to_float(x[base + row * stride_t + d]) * mul : 0.0f;
    }
}

// this lane's part of reg . row
template <int DMAX>
__device__ __forceinline__ float dot_part(const float (&reg)[kVec], const float* row, int sub) {
    const float4 a = *reinterpret_cast<const float4*>(row + sub * 4);
    const float4 c = *reinterpret_cast<const float4*>(row + Layout<DMAX>::kHalf + sub * 4);
    float acc = reg[0] * a.x;
    acc += reg[1] * a.y;
    acc += reg[2] * a.z;
    acc += reg[3] * a.w;
    acc += reg[4] * c.x;
    acc += reg[5] * c.y;
    acc += reg[6] * c.z;
    acc += reg[7] * c.w;
    return acc;
}

// reg += w * (this lane's part of row)
template <int DMAX>
__device__ __forceinline__ void axpy_part(float (&reg)[kVec], float w, const float* row, int sub) {
    const float4 a = *reinterpret_cast<const float4*>(row + sub * 4);
    const float4 c = *reinterpret_cast<const float4*>(row + Layout<DMAX>::kHalf + sub * 4);
    reg[0] += w * a.x;
    reg[1] += w * a.y;
    reg[2] += w * a.z;
    reg[3] += w * a.w;
    reg[4] += w * c.x;
    reg[5] += w * c.y;
    reg[6] += w * c.z;
    reg[7] += w * c.w;
}

// store this lane's 8 elements of a row (columns past D skipped)
template <typename T, int DMAX>
__device__ __forceinline__ void store_vec(T* __restrict__ out, const float (&reg)[kVec], int sub,
                                          int D, float mul) {
#pragma unroll
    for (int r = 0; r < kVec; ++r) {
        const int d = col<DMAX>(sub, r);
        if (d < D) store(out + d, reg[r] * mul);
    }
}

// ---------------------------------------------------------------------------
// float32 dq (and delta): grid (ceil(Tq / kRows), H, B), one query per kLanes lanes
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ d_o,
                    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
                    int Tq, int Tk, int H, int D, Strides sq, Strides sk, Strides sv, float scale,
                    int causal) {
    using L = Layout<DMAX>;
    __shared__ __align__(16) float k_s[kTile][DMAX];
    __shared__ __align__(16) float v_s[kTile][DMAX];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::kRows;
    const int sub = threadIdx.x % L::kLanes;
    const int i = q0 + threadIdx.x / L::kLanes;
    const bool live = i < Tq;

    // o, do and dq rows; lse and delta entries (recomputed at the stores, so
    // no 64-bit offset stays live through the key loop)
    auto row_of = [&] { return ((static_cast<long long>(b) * Tq + i) * H + h) * D; };
    auto stat_of = [&] { return (static_cast<long long>(b) * H + h) * Tq + i; };
    float q_r[kVec], do_r[kVec], dq_r[kVec];
    load_vec<T, DMAX>(q_r, q, b * sq.b + i * sq.t + h * sq.h, sub, live, D, scale);
    load_vec<T, DMAX>(do_r, d_o, row_of(), sub, live, D, 1.0f);
    float part = 0.0f;
    {
        float o_r[kVec];
        load_vec<T, DMAX>(o_r, o, row_of(), sub, live, D, 1.0f);
#pragma unroll
        for (int r = 0; r < kVec; ++r) {
            part += do_r[r] * o_r[r];
            dq_r[r] = 0.0f;
        }
    }
    const float my_delta = row_sum<L::kLanes>(part);
    float my_lse = live ? lse[stat_of()] : 0.0f;
    if (my_lse == -CUDART_INF_F) my_lse = 0.0f;  // no visible key: every p is masked anyway

    const long long k_base = b * sk.b + h * sk.h;
    const long long v_base = b * sv.b + h * sv.h;
    const int k_end = causal ? min(Tk, min(q0 + L::kRows, Tq)) : Tk;
    for (int k0 = 0; k0 < k_end; k0 += kTile) {
        __syncthreads();
        stage_tile<T, DMAX>(k_s, k, k_base, sk.t, k0, Tk, D, 1.0f);
        stage_tile<T, DMAX>(v_s, v, v_base, sv.t, k0, Tk, D, 1.0f);
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
            const int key = k0 + j;
            if (key >= k_end) break;  // the same in every thread
            const float s = row_sum<L::kLanes>(dot_part<DMAX>(q_r, k_s[j], sub));
            const float dp = row_sum<L::kLanes>(dot_part<DMAX>(do_r, v_s[j], sub));
            const bool visible = live && key < Tk && (!causal || key <= i);
            const float ds = visible ? expf(s - my_lse) * (dp - my_delta) : 0.0f;
            axpy_part<DMAX>(dq_r, ds, k_s[j], sub);
        }
    }

    if (!live) return;
    store_vec<T, DMAX>(dq + row_of(), dq_r, sub, D, scale);
    if (sub == 0) delta[stat_of()] = my_delta;
}

// ---------------------------------------------------------------------------
// float32 dk and dv: grid (ceil(Tk / kRows), H, B), one key per kLanes lanes
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ d_o, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Tq, int Tk, int H, int D, Strides sq, Strides sk, Strides sv,
                     float scale, int causal) {
    using L = Layout<DMAX>;
    __shared__ __align__(16) float q_s[kTile][DMAX];  // scale * q
    __shared__ __align__(16) float do_s[kTile][DMAX];
    __shared__ float lse_s[kTile];
    __shared__ float delta_s[kTile];

    const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * L::kRows;
    const int sub = threadIdx.x % L::kLanes;
    const int j = key0 + threadIdx.x / L::kLanes;
    const bool live = j < Tk;

    float k_r[kVec], v_r[kVec], dk_r[kVec], dv_r[kVec];
    load_vec<T, DMAX>(k_r, k, b * sk.b + j * sk.t + h * sk.h, sub, live, D, 1.0f);
    load_vec<T, DMAX>(v_r, v, b * sv.b + j * sv.t + h * sv.h, sub, live, D, 1.0f);
#pragma unroll
    for (int r = 0; r < kVec; ++r) {
        dk_r[r] = 0.0f;
        dv_r[r] = 0.0f;
    }

    const long long q_base = b * sq.b + h * sq.h;
    const long long do_base = (static_cast<long long>(b) * Tq * H + h) * D;  // token stride H * D
    const long long stat_base = (static_cast<long long>(b) * H + h) * Tq;
    // queries before the block's first key see none of its keys
    for (int i0 = causal ? (key0 / kTile) * kTile : 0; i0 < Tq; i0 += kTile) {
        __syncthreads();
        stage_tile<T, DMAX>(q_s, q, q_base, sq.t, i0, Tq, D, scale);
        stage_tile<T, DMAX>(do_s, d_o, do_base, static_cast<long long>(H) * D, i0, Tq, D, 1.0f);
        if (threadIdx.x < kTile) {
            const int i = i0 + threadIdx.x;
            float row_lse = i < Tq ? lse[stat_base + i] : 0.0f;
            if (row_lse == -CUDART_INF_F) row_lse = 0.0f;
            lse_s[threadIdx.x] = row_lse;
            delta_s[threadIdx.x] = i < Tq ? delta[stat_base + i] : 0.0f;
        }
        __syncthreads();

#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
            const int i = i0 + r;
            if (i >= Tq) break;  // the same in every thread
            const float s = row_sum<L::kLanes>(dot_part<DMAX>(k_r, q_s[r], sub));
            const float dp = row_sum<L::kLanes>(dot_part<DMAX>(v_r, do_s[r], sub));
            const bool visible = live && (!causal || j <= i);
            const float p = visible ? expf(s - lse_s[r]) : 0.0f;
            const float ds = visible ? p * (dp - delta_s[r]) : 0.0f;
            axpy_part<DMAX>(dv_r, p, do_s[r], sub);
            axpy_part<DMAX>(dk_r, ds, q_s[r], sub);  // q_s holds scale * q
        }
    }

    if (!live) return;
    const long long row = ((static_cast<long long>(b) * Tk + j) * H + h) * D;
    store_vec<T, DMAX>(dk + row, dk_r, sub, D, 1.0f);
    store_vec<T, DMAX>(dv + row, dv_r, sub, D, 1.0f);
}

// ---------------------------------------------------------------------------
// bfloat16 forward and dk/dv on the tensor cores (the header's second design)
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
// into a [ROWS][STRIDE] tile of DP columns, by a block of THREADS; rows at
// or past n and columns at or past D land as zeros.  The caller commits the
// cp.async group.
template <int DP, int ROWS = kTile, int THREADS = kThreads, int STRIDE = Dims<DP>::kStride,
          typename T>
__device__ __forceinline__ void stage_rows(T* tile, const T* __restrict__ x, long long stride_t,
                                           int r0, int n, int D, int width) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
    constexpr int kRowChunks = DP / kPer;
    constexpr int kChunks = ROWS * kRowChunks;
    static_assert(DP % kPer == 0 && STRIDE % kPer == 0, "rows of whole 16-byte chunks");
#pragma unroll
    for (int i = 0; i < (kChunks + THREADS - 1) / THREADS; ++i) {
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

// 64 floats (lse or delta) from rows [r0, r0 + kTile) of x, zero past n
// (threads 0..63 of the block)
__device__ __forceinline__ void stage_stats(float* dst, const float* __restrict__ x, int r0,
                                            int n) {
    if (threadIdx.x < kTile) {
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
// float32 forward on the FMA units (the header's micro-tile design)
namespace mt {

// 4 warps a block.  (8, each taking 16 keys of 128-key tiles, ran 25%
// faster at [4, 256, 2, 64], one block an SM, but 11% slower at [2, 1024,
// 4, 64] and 70% slower at the learner's [8, 17, 16, 64], on an H100; its
// ring would not fit at D = 128.)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;           // queries a block owns
constexpr int kTile = 16 * kWarps;  // keys per ring stage, 16 a warp
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kPStride = 16 + kPad;  // floats per row of a warp's P tile
// Blocks per SM the register budget must allow (at most 255 registers a
// thread); a minimum keeps ptxas from trading registers for occupancy
constexpr int kMinBlocks = 2;

template <int DP>
struct Dims {
    static_assert(DP % 8 == 0 && DP >= 8 && DP <= 128, "8 lanes share a row's columns");
    static constexpr int kStride = DP + kPad;           // floats per shared row
    static constexpr int kTileElems = kTile * kStride;  // one [64][DP + 4] tile
    static constexpr int kCols = DP / 8;                // o columns a lane holds
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
    tc::stage_rows<DP, kTile, kThreads, kS>(k_s, kx, sk.t, 0, Tk, D, wk);
    tc::stage_rows<DP, kTile, kThreads, kS>(v_s, vx, sv.t, 0, Tk, D, wv);
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
            tc::stage_rows<DP, kTile, kThreads, kS>(k_s + nxt * L::kTileElems, kx, sk.t,
                                                    (it + 1) * kTile, Tk, D, wk);
            tc::stage_rows<DP, kTile, kThreads, kS>(v_s + nxt * L::kTileElems, vx, sv.t,
                                                    (it + 1) * kTile, Tk, D, wv);
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
#pragma unroll
            for (int d = 0; d < DP; d += 4) {
                float4 qv[4], kv[2];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qv[i] = *reinterpret_cast<const float4*>(q_s + (r + 4 * i) * kS + d);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    kv[j] = *reinterpret_cast<const float4*>(kt + (c + 8 * j) * kS + d);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                    }
                }
            }
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
#pragma unroll 4
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

template <int DP>
constexpr int fwd_smem_bytes() {
    return ((kRows + 4 * kTile) * Dims<DP>::kStride + kWarps * 16 * kPStride +
            (2 * kWarps + 1) * kRows) * static_cast<int>(sizeof(float));
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

template <int DMAX>
dim3 grid_of(const Args& a, int rows) {
    const int own = Layout<DMAX>::kRows;
    return dim3(static_cast<unsigned>((rows + own - 1) / own), static_cast<unsigned>(a.H),
                static_cast<unsigned>(a.B));
}

// The lane kernels (float32 dq and dk/dv)
template <typename T, int DMAX>
cudaError_t bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
                   float* delta) {
    flash_bwd_dq_kernel<T, DMAX><<<grid_of<DMAX>(a, a.Tq), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(o), static_cast<const T*>(d_o), lse, static_cast<T*>(dq), delta,
        a.Tq, a.Tk, a.H, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
    return cudaSuccess;
}

template <typename T, int DMAX>
cudaError_t bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta,
                    void* dk, void* dv) {
    flash_bwd_dkv_kernel<T, DMAX><<<grid_of<DMAX>(a, a.Tk), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.Tq, a.Tk, a.H, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
    return cudaSuccess;
}

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
#define CALL_DQ(DMAX) bwd_dq<float, DMAX>(a, o, d_o, lse, dq, delta)
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
#define CALL_DKV(DMAX) bwd_dkv<float, DMAX>(a, d_o, lse, delta, dk, dv)
#define CALL_DKV_TC(DMAX) tc::bwd_dkv<tc::padded(DMAX)>(a, d_o, lse, delta, dk, dv)
    FLASH_DISPATCH(a, dtype, CALL_DKV, CALL_DKV_TC);
#undef CALL_DKV
#undef CALL_DKV_TC
}
