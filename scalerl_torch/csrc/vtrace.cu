// V-trace targets over a [T, B] float32 trajectory, one thread per column.
//
// Replaces the TPU kernel scalerl_tpu/ops/pallas_vtrace.py::_vtrace_kernel
// (launched by vtrace_from_importance_weights_pallas), which holds the whole
// [T, B] plane in VMEM and runs the backward recursion as a loop of row ops.
//
// Here each thread owns one batch column b and walks t = T-1 ... 0 once,
// keeping the recursion's accumulator, V(x_{t+1}) and vs_{t+1} in registers,
// so the two outputs are written in the same pass that reads the inputs.
// Neighbouring threads own neighbouring columns, so every load and store of
// the row-major [T, B] planes is coalesced.
//
// Bound on an H100: the function moves 6*T*B*4 + 4*B bytes (four input
// planes, the bootstrap row, two output planes) and does ~16 operations per
// element, so it is bound by bytes; at the fused loop's [20, 512] that is
// ~0.25 MB, well under a microsecond at 3.35 TB/s, so in practice the launch
// latency bounds it.
//
// Numerics follow the reference op (scalerl_tpu/ops/vtrace.py) step by step
// in float32, each product and sum rounded on its own (no FMA contraction),
// with expf (not __expf): build without --use_fast_math.  The
// clip is written as (x > m ? m : x) so a NaN input stays NaN, as
// jnp.minimum and torch.clamp keep it (fminf would drop it).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float clip_max(float x, float m) {
    return x > m ? m : x;
}

// Round after every multiply and add, as the plain version's separate
// elementwise kernels do: nvcc would otherwise contract a * b + c into one
// FMA, whose single rounding drifts past 1e-5 on long recursions.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void vtrace_kernel(const float* __restrict__ log_rhos,
                              const float* __restrict__ discounts,
                              const float* __restrict__ rewards,
                              const float* __restrict__ values,
                              const float* __restrict__ bootstrap,
                              float* __restrict__ vs,
                              float* __restrict__ pg,
                              int T, int B,
                              float rho_clip, int has_rho_clip,
                              float pg_rho_clip, int has_pg_rho_clip,
                              float c_clip) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float boot = bootstrap[b];
    float acc = 0.0f;       // vs_{t+1} - V(x_{t+1}) of the recursion
    float v_next = boot;    // V(x_{t+1}), the bootstrap value past the end
    float vs_next = boot;   // vs_{t+1}, likewise
    for (int t = T - 1; t >= 0; --t) {
        const size_t i = static_cast<size_t>(t) * B + b;
        const float rho = expf(log_rhos[i]);
        const float clipped_rho = has_rho_clip ? clip_max(rho, rho_clip) : rho;
        const float c = clip_max(rho, c_clip);
        const float d = discounts[i];
        const float r = rewards[i];
        const float v = values[i];
        // delta = rho * (r + d * V_{t+1} - V_t); acc = delta + d * c * acc
        const float delta = mul(clipped_rho, sub(add(r, mul(d, v_next)), v));
        acc = add(delta, mul(mul(d, c), acc));
        const float vs_t = add(acc, v);
        const float pg_rho = has_pg_rho_clip ? clip_max(rho, pg_rho_clip) : rho;
        pg[i] = mul(pg_rho, sub(add(r, mul(d, vs_next)), v));
        vs[i] = vs_t;
        v_next = v;
        vs_next = vs_t;
    }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// reaches the caller; it does not synchronise.
extern "C" int vtrace_launch(const float* log_rhos, const float* discounts,
                             const float* rewards, const float* values,
                             const float* bootstrap, float* vs, float* pg,
                             int T, int B,
                             float rho_clip, int has_rho_clip,
                             float pg_rho_clip, int has_pg_rho_clip,
                             float c_clip, void* stream) {
    const int blocks = (B + kThreads - 1) / kThreads;
    vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, B,
        rho_clip, has_rho_clip, pg_rho_clip, has_pg_rho_clip, c_clip);
    return static_cast<int>(cudaGetLastError());
}
