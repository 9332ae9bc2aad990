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
// scores in float32 scaled by `scale`, positions >= length masked to -1e30,
// out = acc / max(l, 1e-30) in q's dtype.  float32 or bfloat16 inputs, all
// three the same type; V is accumulated in float32 either way.
//
// Design: one warp (one CTA of 32 threads) per (lane, head).  Each thread
// holds D/32 elements of q (pre-scaled, as the Pallas kernel scales q) and
// of the accumulator; the running max and sum sit in registers of every
// thread.  The warp walks the lane's live tokens in order, kTok at a time:
// it first issues every K and V load of the chunk (each token's head row is
// D contiguous values, read by neighbouring threads: coalesced), then
// reduces each score with warp shuffles and folds the chunk into the online
// softmax.  Tokens at or past the lane's length are never loaded, so no
// page past the length is read; table entries are clamped into [0, N) as a
// JAX gather clamps them.
//
// Bound on an H100: bytes.  The function must read every live token's K
// and V once, 2*H*D*4 bytes per token in float32 (2 KiB at H=8, D=32), plus
// q, the table, the lengths and the output; it does ~4*D flops per token
// and head, far below the float32 rate for those bytes.  At the generation
// engine's decode shape (256 lanes, contexts up to 384 tokens) that is
// tens of MB per call, tens of microseconds at 3.35 TB/s.  The design
// spends the bytes once and hides load latency by keeping one chunk's
// loads in flight per warp, with 2,048 warps (all resident at once on 132
// SMs) at that shape.  It does not overlap one chunk's loads with the
// previous chunk's arithmetic or split a long context across warps; that
// is work for a faster version.
//
// Numerics: expf (not __expf), no fast math; the float32 sums run in
// another order than the reference's softmax and einsum, within 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's float32 -> bfloat16 cast rounds
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// kPer: head elements per thread (D <= 32 * kPer); kTok: tokens per chunk.
template <typename T, int kPer, int kTok>
__global__ void __launch_bounds__(kWarp)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int D, int N, int ps, int M, float scale) {
    const int b = blockIdx.x / H;
    const int h = blockIdx.x - b * H;
    const int lane = threadIdx.x;
    const int* row = table + static_cast<long long>(b) * M;
    const int len = min(lengths[b], M * ps);
    const long long qo = (static_cast<long long>(b) * H + h) * D;
    const long long slot_stride = static_cast<long long>(H) * D;  // between token slots
    const long long head_off = static_cast<long long>(h) * D;

    float qr[kPer], acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int d = lane + i * kWarp;
        qr[i] = d < D ? to_float(q[qo + d]) * scale : 0.0f;
        acc[i] = 0.0f;
    }
    float m = kNegBig;  // running max of the scores seen so far
    float l = 0.0f;     // running sum of exp(score - m)

    for (int c = 0; c < len; c += kTok) {
        float kr[kTok][kPer], vr[kTok][kPer];
        // every load of the chunk first, so they are in flight together
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
            const int pos = c + j;
            const bool live = pos < len;
            long long base = 0;
            if (live) {
                const int page = min(max(row[pos / ps], 0), N - 1);
                base = (static_cast<long long>(page) * ps + pos % ps) * slot_stride + head_off;
            }
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int d = lane + i * kWarp;
                const bool ok = live && d < D;
                kr[j][i] = ok ? to_float(k_pages[base + d]) : 0.0f;
                vr[j][i] = ok ? to_float(v_pages[base + d]) : 0.0f;
            }
        }
        float s[kTok];
        float m_chunk = kNegBig;
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
            float part = 0.0f;
#pragma unroll
            for (int i = 0; i < kPer; ++i) part += qr[i] * kr[j][i];
            const float dot = warp_sum(part);  // every thread of the warp shuffles
            s[j] = c + j < len ? dot : kNegBig;
            m_chunk = fmaxf(m_chunk, s[j]);
        }
        // c < len, so token c is live and m_new is a real score
        const float m_new = fmaxf(m, m_chunk);
        const float corr = expf(m - m_new);
        float p_sum = 0.0f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
            const float p = expf(s[j] - m_new);  // 0 for a masked token
            p_sum += p;
#pragma unroll
            for (int i = 0; i < kPer; ++i) acc[i] += p * vr[j][i];
        }
        l = l * corr + p_sum;
        m = m_new;
    }
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) store(out + qo + d, acc[i] / denom);
    }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const int* table,
           const int* lengths, void* out, int B, int H, int D, int N, int ps, int M,
           float scale, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k_pages);
    const T* vt = static_cast<const T*>(v_pages);
    T* ot = static_cast<T*>(out);
    if (D <= 32) {
        paged_decode_kernel<T, 1, 16><<<grid, kWarp, 0, stream>>>(
            qt, kt, vt, table, lengths, ot, H, D, N, ps, M, scale);
    } else if (D <= 64) {
        paged_decode_kernel<T, 2, 8><<<grid, kWarp, 0, stream>>>(
            qt, kt, vt, table, lengths, ot, H, D, N, ps, M, scale);
    } else if (D <= 128) {
        paged_decode_kernel<T, 4, 4><<<grid, kWarp, 0, stream>>>(
            qt, kt, vt, table, lengths, ot, H, D, N, ps, M, scale);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller; it does not
// synchronise.  The caller checks shapes (D <= 128), types and contiguity.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* table, const int* lengths, void* out,
                                      int B, int H, int D, int N, int ps, int M,
                                      float scale, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch<float>(q, k_pages, v_pages, table, lengths, out, B, H, D, N, ps, M, scale, s);
    }
    if (dtype == 1) {
        return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, B, H, D, N, ps, M,
                                     scale, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
