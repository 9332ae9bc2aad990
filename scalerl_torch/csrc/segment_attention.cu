// Causal self-attention within packed segments: forward, dq and dk/dv.
//
// Replaces the three TPU kernels behind scalerl_tpu/ops/pallas_attention.py::
// segment_flash_attention: _seg_fwd_kernel, _seg_bwd_dq_kernel and
// _seg_bwd_dkv_kernel.  Their grids put the other axis innermost and carry
// the accumulators in VMEM scratch from one grid step to the next; here a
// block owns its tile and loops over the other axis itself.
//
// Contract (ops/attention.py::segment_attention_reference): q, k, v
// [B, S, H, D] (float32 or bfloat16, one type for all three), segment ids
// [B, S] int32 with 0 = pad.  Query i attends key j iff j <= i and
// seg[j] == seg[i] != 0; scores are scale * q.k in float32; the output is in
// q's type and lse [B, H, S] in float32.  A query with no live key gives
// exact zeros and lse = -inf; dq of such a query and dk, dv of a key that no
// query attends are exact zeros.
//
// Design, the same in all three kernels: a block of kOwn = 64 threads owns
// 64 consecutive rows of one (batch row, head), one row per thread, with that
// row's vectors (q and the output accumulator; q, do and dq; k, v, dk and dv)
// in registers.  It walks the other axis in tiles of kOther = 32 rows staged
// in shared memory as float32, so every inner product reads its second
// operand as a broadcast float4 from shared memory.  The forward takes
// scores kChunk = 8 at a time, to keep them in registers, and folds each
// chunk into an online softmax; the backward kernels, whose row vectors
// already fill the register file, take one row of the tile at a time.  q
// enters every kernel multiplied by scale; dq gets the second factor when
// it is stored and dk gets none.
//
// Tile skip: a warp reduces a tile's 32 ids to the range of its nonzero ids
// (one id per lane, two warp reductions).  A tile is skipped when its range
// cannot meet the range of the block's own rows, or when it lies wholly
// above the diagonal (the loop bounds).  The skip is conservative for any
// ids: the element mask decides, and a skipped tile would have contributed
// only masked elements.  Every warp of the block computes the same verdict,
// so the barriers around a live tile stay uniform.
//
// S need not be a multiple of either tile: rows past S load as zeros with
// id 0 and are never stored.  q, k and v are addressed through their batch,
// token and head strides (unit stride along D), so the views a fused qkv
// projection hands over are read in place.  o, lse, delta, do, dq, dk and dv
// are contiguous.
//
// No atomics: dq is summed by the thread that owns the query, dk and dv by
// the thread that owns the key, each in a fixed order, so results repeat bit
// for bit.  delta = sum_d do * o is computed by the dq kernel (each thread
// has its row of do and reads its row of o) and written to a [B, H, S]
// buffer that the dk/dv kernel, launched after it on the same stream, reads.
//
// Bound on an H100: bytes at the learner's shapes.  Forward moves q, k, v, o
// (4 * B*S*H*D elements), the ids and lse; backward as much again for do,
// dq, dk, dv.  The work is 4*D flops per live (i, j) pair forward and 10*D
// backward, in float32 FMAs outside the tensor cores.  This version makes
// no use of the tensor cores, TMA or asynchronous copies, and a thread's
// loads of its own row are strided; those are for a faster version.
//
// Numerics: expf and logf (no fast math).  Sums over D and over the keys run
// in another order than the plain version's softmax and einsum.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kOwn = 64;     // rows a block owns, one per thread
constexpr int kOther = 32;   // rows of the other axis per shared-memory tile
constexpr int kChunk = 8;    // scores held in registers at a time
constexpr int kMaxD = 32;    // largest head dim built (the row vectors' register length)
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
// dk and dv: grid (ceil(S / kOwn), H, B), one key per thread
template <typename T, int DMAX>
__global__ void __launch_bounds__(kOwn)
seg_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ seg, const T* __restrict__ d_o,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv,
                   int S, int H, int D, Strides sq, Strides sk, Strides sv, float scale) {
    __shared__ __align__(16) float q_s[kOther][DMAX];   // scale * q
    __shared__ __align__(16) float do_s[kOther][DMAX];
    __shared__ float lse_s[kOther];
    __shared__ float delta_s[kOther];
    __shared__ int seg_s[kOther];
    __shared__ int range_s[2 * (kOwn / kWarp)];

    const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kOwn;
    const int lane = threadIdx.x % kWarp;
    const int j = key0 + threadIdx.x;
    const bool in_range = j < S;
    const int* seg_row = seg + static_cast<long long>(b) * S;
    const int my_seg = in_range ? seg_row[j] : 0;
    int k_lo, k_hi;
    block_seg_range(my_seg, range_s, k_lo, k_hi);

    float k_r[DMAX], v_r[DMAX], dk_r[DMAX], dv_r[DMAX];
    load_row<T, DMAX>(k_r, k, b * sk.b + j * sk.t + h * sk.h, in_range, D, 1.0f);
    load_row<T, DMAX>(v_r, v, b * sv.b + j * sv.t + h * sv.h, in_range, D, 1.0f);
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        dk_r[d] = 0.0f;
        dv_r[d] = 0.0f;
    }

    const long long q_base = b * sq.b + h * sq.h;
    const long long do_base = (static_cast<long long>(b) * S * H + h) * D;  // token stride H * D
    const long long stat_base = (static_cast<long long>(b) * H + h) * S;
    // queries below the block's first key see none of its keys
    for (int i0 = (key0 / kOther) * kOther; i0 < S; i0 += kOther) {
        const int i_lane = i0 + lane;
        const int q_id = i_lane < S ? seg_row[i_lane] : 0;
        int q_lo, q_hi;
        warp_seg_range(q_id, q_lo, q_hi);
        if (!ranges_meet(q_lo, q_hi, k_lo, k_hi)) continue;

        __syncthreads();
        stage_tile<T, DMAX>(q_s, q, q_base, sq.t, i0, S, D, scale);
        stage_tile<T, DMAX>(do_s, d_o, do_base, static_cast<long long>(H) * D, i0, S, D, 1.0f);
        if (threadIdx.x < kOther) {
            float row_lse = i_lane < S ? lse[stat_base + i_lane] : 0.0f;
            if (row_lse == -CUDART_INF_F) row_lse = 0.0f;
            lse_s[threadIdx.x] = row_lse;
            delta_s[threadIdx.x] = i_lane < S ? delta[stat_base + i_lane] : 0.0f;
            seg_s[threadIdx.x] = q_id;
        }
        __syncthreads();

        // one query at a time: four row vectors already fill the registers
#pragma unroll 1
        for (int r = 0; r < kOther; ++r) {
            const bool valid = my_seg > 0 && j <= i0 + r && seg_s[r] == my_seg;
            const float s = dot_shared<DMAX>(k_r, q_s[r]);
            const float dp = dot_shared<DMAX>(v_r, do_s[r]);
            const float p = valid ? expf(s - lse_s[r]) : 0.0f;
            const float ds = valid ? p * (dp - delta_s[r]) : 0.0f;
            axpy_shared<DMAX>(dv_r, p, do_s[r]);
            axpy_shared<DMAX>(dk_r, ds, q_s[r]);  // q_s holds scale * q
        }
    }

    if (!in_range) return;
    const long long row = ((static_cast<long long>(b) * S + j) * H + h) * D;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
        if (d < D) {
            store(dk + row + d, dk_r[d]);
            store(dv + row + d, dv_r[d]);
        }
    }
}

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
void fwd(const Args& a, void* o, float* lse) {
    seg_fwd_kernel<T, DMAX><<<grid_of(a), kOwn, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<T*>(o), lse, a.S, a.H, a.D, a.sq, a.sk, a.sv, a.scale);
}

template <typename T, int DMAX>
void bwd_dq(const Args& a, const void* o, const void* d_o, const float* lse, void* dq,
            float* delta) {
    seg_bwd_dq_kernel<T, DMAX><<<grid_of(a), kOwn, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(o), static_cast<const T*>(d_o), lse, static_cast<T*>(dq), delta,
        a.S, a.H, a.D, a.sq, a.sk, a.sv, a.scale);
}

template <typename T, int DMAX>
void bwd_dkv(const Args& a, const void* d_o, const float* lse, const float* delta, void* dk,
             void* dv) {
    seg_bwd_dkv_kernel<T, DMAX><<<grid_of(a), kOwn, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.S, a.H, a.D, a.sq, a.sk, a.sv, a.scale);
}

// Pick the instantiation for the dtype and call `launch_one<T, kMaxD>`.
// dtype: 0 = float32, 1 = bfloat16.  Only head dims up to kMaxD = 32 are
// built, the width of every model the learner trains: a wider row vector
// (DMAX = 64) spills registers in the backward kernels, so it waits for a
// design that splits the row across threads.
#define SEG_DISPATCH(a, dtype, CALL)                                        \
    do {                                                                    \
        if ((dtype) != 0 && (dtype) != 1) return (int)cudaErrorInvalidValue; \
        if ((a).D < 1 || (a).D > kMaxD) return (int)cudaErrorInvalidValue;  \
        if ((dtype) == 0) {                                                 \
            CALL(float, kMaxD);                                             \
        } else {                                                            \
            CALL(__nv_bfloat16, kMaxD);                                     \
        }                                                                   \
        return (int)cudaGetLastError();                                     \
    } while (0)

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
// The caller checks shapes (D <= 32, H and B <= 65535), types and that o,
// lse, delta, do, dq, dk and dv are contiguous.

extern "C" int segment_attention_fwd_launch(const void* q, const void* k, const void* v,
                                            const int* seg, void* o, float* lse, int B, int S,
                                            int H, int D, const long long* strides, float scale,
                                            int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
#define CALL_FWD(T, DMAX) fwd<T, DMAX>(a, o, lse)
    SEG_DISPATCH(a, dtype, CALL_FWD);
#undef CALL_FWD
}

extern "C" int segment_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                               const int* seg, const void* o, const void* d_o,
                                               const float* lse, void* dq, float* delta, int B,
                                               int S, int H, int D, const long long* strides,
                                               float scale, int dtype, void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
#define CALL_DQ(T, DMAX) bwd_dq<T, DMAX>(a, o, d_o, lse, dq, delta)
    SEG_DISPATCH(a, dtype, CALL_DQ);
#undef CALL_DQ
}

extern "C" int segment_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                                const int* seg, const void* d_o,
                                                const float* lse, const float* delta, void* dk,
                                                void* dv, int B, int S, int H, int D,
                                                const long long* strides, float scale, int dtype,
                                                void* stream) {
    const Args a = make_args(q, k, v, seg, B, S, H, D, strides, scale, stream);
#define CALL_DKV(T, DMAX) bwd_dkv<T, DMAX>(a, d_o, lse, delta, dk, dv)
    SEG_DISPATCH(a, dtype, CALL_DKV);
#undef CALL_DKV
}
