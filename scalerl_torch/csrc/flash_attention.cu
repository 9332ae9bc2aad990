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
// D <= 128.  Scores are (scale * q) . k in float32; with `causal` key j is
// visible to query i iff j <= i (top-left aligned, also when Tq != Tk).
// The output is in q's type and lse [B, H, Tq] in float32.  A query with
// no visible key gives exact zeros and lse = -inf.
//
// Design, the same in all three kernels: a block of kThreads = 128 threads
// owns kRows consecutive rows of one (batch row, head) -- queries in the
// forward and dq kernels, keys in the dk/dv kernel -- and splits each row's
// head dim over kLanes = DMAX / 8 neighbouring lanes of a warp, 8 elements
// a lane, so a row vector costs each thread 8 registers whatever D is (one
// thread per row spilled at D = 64 in csrc/segment_attention.cu).  A lane
// holds elements 4 * sub + {0..3} and DMAX / 2 + 4 * sub + {0..3}, so the
// lanes of a row read two runs of consecutive float4s from shared memory.
// An inner product is 8 FMAs and a butterfly of log2(kLanes) shuffles; the
// butterfly adds the same two values on both lanes of every pair, so all
// lanes of a row hold the same score bit for bit and take the same masking
// and softmax decisions.  The other axis is walked in tiles of kTile = 32
// rows staged in shared memory as float32 (rows past the end and columns
// past D as zeros).  q enters every kernel multiplied by scale; dq gets the
// second factor when it is stored and dk gets none.
//
// Causal tile skip (_causal_live): the forward and dq kernels stop at the
// last key tile that meets their block's last query; the dk/dv kernel
// starts at the query tile that holds its block's first key.  Tiles above
// the diagonal are never loaded.  Ragged lengths are masked in the kernel
// (q_len = Tq, k_len = Tk), nothing is padded.
//
// Masking: a masked score is selected to -inf (forward) or its probability
// to 0 (backward) before it meets anything else; the running max is made
// safe (-inf -> 0) before any exp, so exp(-inf - -inf) never happens, and a
// row with no visible key keeps l = 0 -> o = 0, lse = -inf.  The backward
// reads lse = -inf as 0, where every probability of that row is masked.
//
// No atomics: dq is summed by the lanes of its query, dk and dv by the
// lanes of their key, each in a fixed order, so values and gradients repeat
// bit for bit.  delta = sum_d do * o is computed by the dq kernel and
// written to a [B, H, Tq] buffer that the dk/dv kernel, launched after it on
// the same stream, reads (JAX computes it with an einsum before both).
//
// Addressing: q, k and v through their batch, token and head strides (unit
// stride along D), so the views a fused qkv projection hands over are read
// in place; o, lse, delta, do, dq, dk and dv are contiguous.
//
// Bound on an H100: at the learner's shapes ([8, 17, 16, 64]) the work is
// tiny and one launch costs more than the bytes; at long T the work is
// operations, 4 D flops per visible (i, j) pair forward and 10 D backward,
// which this version does in float32 FMAs outside the tensor cores (67
// TFLOP/s, not 989 in bf16).  No tensor cores, TMA or asynchronous copies
// yet: those are for a faster version.
//
// Numerics: expf and logf (no fast math).  Sums over D and over the keys
// run in another order than the plain version's softmax and einsum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // threads per block
// Blocks per SM the register budget must allow: 65536 / (4 * 128) = 128
// registers a thread.  With no minimum, ptxas cut one head-dim-16
// instantiation to 64 registers to keep 8 blocks resident, and spilled.
constexpr int kMinBlocks = 4;
constexpr int kVec = 8;        // elements of a row each lane holds
constexpr int kTile = 32;      // rows of the other axis per shared-memory tile
constexpr int kChunk = 8;      // forward scores held in registers at a time
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile % kChunk == 0 && kTile <= kThreads, "tile sizes");

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float32 -> bfloat16 cast rounds
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
// forward: grid (ceil(Tq / kRows), H, B), one query per kLanes lanes
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H, int D,
                 Strides sq, Strides sk, Strides sv, float scale, int causal) {
    using L = Layout<DMAX>;
    __shared__ __align__(16) float k_s[kTile][DMAX];
    __shared__ __align__(16) float v_s[kTile][DMAX];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::kRows;
    const int sub = threadIdx.x % L::kLanes;
    const int i = q0 + threadIdx.x / L::kLanes;
    const bool live = i < Tq;

    float q_r[kVec], acc[kVec];
    load_vec<T, DMAX>(q_r, q, b * sq.b + i * sq.t + h * sq.h, sub, live, D, scale);
#pragma unroll
    for (int r = 0; r < kVec; ++r) acc[r] = 0.0f;
    float m = -CUDART_INF_F;  // running max of the visible scores
    float l = 0.0f;           // running sum of exp(score - m)

    const long long k_base = b * sk.b + h * sk.h;
    const long long v_base = b * sv.b + h * sv.h;
    // keys past the block's last query are above the diagonal of every row
    const int k_end = causal ? min(Tk, min(q0 + L::kRows, Tq)) : Tk;
    for (int k0 = 0; k0 < k_end; k0 += kTile) {
        __syncthreads();  // the previous tile has been read
        stage_tile<T, DMAX>(k_s, k, k_base, sk.t, k0, Tk, D, 1.0f);
        stage_tile<T, DMAX>(v_s, v, v_base, sv.t, k0, Tk, D, 1.0f);
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < kTile && k0 + c < k_end; c += kChunk) {
            float s[kChunk];
            float m_chunk = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const int key = k0 + c + j;
                const float dot = row_sum<L::kLanes>(dot_part<DMAX>(q_r, k_s[c + j], sub));
                const bool visible = live && key < Tk && (!causal || key <= i);
                s[j] = visible ? dot : -CUDART_INF_F;
                m_chunk = fmaxf(m_chunk, s[j]);
            }
            const float m_new = fmaxf(m, m_chunk);
            // no visible key yet: exp(-inf - 0) = 0 everywhere, never -inf - -inf
            const float safe_m = m_new == -CUDART_INF_F ? 0.0f : m_new;
            const float corr = expf(m - safe_m);
            float p_sum = 0.0f;
#pragma unroll
            for (int r = 0; r < kVec; ++r) acc[r] *= corr;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                const float p = expf(s[j] - safe_m);
                p_sum += p;
                axpy_part<DMAX>(acc, p, v_s[c + j], sub);
            }
            l = l * corr + p_sum;
            m = m_new;
        }
    }

    if (!live) return;
    const float denom = fmaxf(l, 1e-30f);
    store_vec<T, DMAX>(o + ((static_cast<long long>(b) * Tq + i) * H + h) * D, acc, sub, D,
                       1.0f / denom);
    if (sub == 0) {
        lse[(static_cast<long long>(b) * H + h) * Tq + i] =
            l > 0.0f ? m + logf(denom) : -CUDART_INF_F;
    }
}

// ---------------------------------------------------------------------------
// dq (and delta): grid (ceil(Tq / kRows), H, B), one query per kLanes lanes
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
// dk and dv: grid (ceil(Tk / kRows), H, B), one key per kLanes lanes
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

template <typename T, int DMAX>
void fwd(const Args& a, void* o, float* lse) {
    flash_fwd_kernel<T, DMAX><<<grid_of<DMAX>(a, a.Tq), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(o), lse, a.Tq, a.Tk, a.H, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
}

template <typename T, int DMAX>
void bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
            float* delta) {
    flash_bwd_dq_kernel<T, DMAX><<<grid_of<DMAX>(a, a.Tq), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(o), static_cast<const T*>(d_o), lse, static_cast<T*>(dq), delta,
        a.Tq, a.Tk, a.H, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
}

template <typename T, int DMAX>
void bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta, void* dk,
             void* dv) {
    flash_bwd_dkv_kernel<T, DMAX><<<grid_of<DMAX>(a, a.Tk), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.Tq, a.Tk, a.H, a.D, a.sq, a.sk, a.sv, a.scale, a.causal);
}

// Pick the instantiation for the dtype (0 = float32, 1 = bfloat16) and the
// smallest built head dim DMAX >= D (8, 16, 32, 64, 128), and call
// CALL(T, DMAX).  Columns D..DMAX-1 ride as zeros.
#define FLASH_DISPATCH_D(a, T, CALL)                     \
    do {                                                 \
        if ((a).D <= 8) {                                \
            CALL(T, 8);                                  \
        } else if ((a).D <= 16) {                        \
            CALL(T, 16);                                 \
        } else if ((a).D <= 32) {                        \
            CALL(T, 32);                                 \
        } else if ((a).D <= 64) {                        \
            CALL(T, 64);                                 \
        } else {                                         \
            CALL(T, 128);                                \
        }                                                \
    } while (0)

#define FLASH_DISPATCH(a, dtype, CALL)                                       \
    do {                                                                     \
        if ((dtype) != 0 && (dtype) != 1) return (int)cudaErrorInvalidValue; \
        if ((a).D < 1 || (a).D > 128) return (int)cudaErrorInvalidValue;     \
        if ((dtype) == 0) {                                                  \
            FLASH_DISPATCH_D(a, float, CALL);                                \
        } else {                                                             \
            FLASH_DISPATCH_D(a, __nv_bfloat16, CALL);                        \
        }                                                                    \
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

// Each launches on `stream` and returns cudaGetLastError(), so a refused
// launch reaches the caller; none synchronises.  `strides` holds the batch,
// token and head strides (in elements) of q, then k, then v, on the host.
// The caller checks shapes (1 <= D <= 128, H and B <= 65535, Tq >= 1, and
// Tk >= 1 for dk/dv), types and that o, lse, delta, do, dq, dk and dv are
// contiguous.

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int Tq, int Tk, int H, int D,
                                          const long long* strides, float scale, int causal,
                                          int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_FWD(T, DMAX) fwd<T, DMAX>(a, o, lse)
    FLASH_DISPATCH(a, dtype, CALL_FWD);
#undef CALL_FWD
}

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* d_o, const float* lse,
                                             void* dq, float* delta, int B, int Tq, int Tk, int H,
                                             int D, const long long* strides, float scale,
                                             int causal, int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_DQ(T, DMAX) bwd_dq<T, DMAX>(a, o, d_o, lse, dq, delta)
    FLASH_DISPATCH(a, dtype, CALL_DQ);
#undef CALL_DQ
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* d_o, const float* lse,
                                              const float* delta, void* dk, void* dv, int B,
                                              int Tq, int Tk, int H, int D,
                                              const long long* strides, float scale, int causal,
                                              int dtype, void* stream) {
    const Args a = make_args(q, k, v, B, Tq, Tk, H, D, strides, scale, causal, stream);
#define CALL_DKV(T, DMAX) bwd_dkv<T, DMAX>(a, d_o, lse, delta, dk, dv)
    FLASH_DISPATCH(a, dtype, CALL_DKV);
#undef CALL_DKV
}
