// Capability self-checks of the constructs the fused kernels rely on.
//
// Replaces the TPU kernels of littlemcmc_tpu/ops/fused_probe.py, the six
// Mosaic capability probes (pallas_call at :77, :112, :165, :226, :302 and
// :381). Each probe here runs the JAX probe's computation on its inputs,
// written with the CUDA construct that the port's fused kernels use where
// the JAX kernels use the Mosaic one:
//
//   0 cos               cosf + sinf on fp32 rows (the Box-Muller momentum
//                       refresh of fused_common.cuh);
//   1 grid_scratch      state in shared memory carried across the T steps of
//                       one launch (the fused kernels' draw loop);
//   2 smem_accumulate   a shared-memory scalar read, modified and written
//                       across steps, and a rows contraction (R, N)^T (R, N)
//                       accumulated into an (N, N) block in dynamic shared
//                       memory past the 48 KB default (the pooled dense
//                       Welford update);
//   3 thin_factor       the low-rank metric's thin matvecs, one warp a row:
//                       c = V^T x by warp sums, then alpha x + V (c (lam -
//                       alpha)) (lowrank_velocity in nuts_transition.cuh);
//   4 stat_io_layout    the fused kernels' output layout in miniature: chain
//                       blocks of RW rows, T steps each, a (T, rows, Npad)
//                       trace, stats rows flattened as (t * B + block) * RW +
//                       row, a seed scalar, a grid-invariant constant block,
//                       final rows and stats;
//   5 block_outputs_3d  per-block (B, 8, N), (B, N, N) and (B, 8, N) outputs
//                       from an (N, N) accumulator in dynamic shared memory.
//
// ops/fused_probe.py holds each against its plain version and raises on a
// mismatch. The arithmetic is fp32 with fmaf explicit, as in the kernels.
//
// Build: as nuts_trajectory.cu. Plain C interface, loaded with ctypes.

#include "nuts_transition.cuh"

namespace {

using namespace lmc;

constexpr int kThreads = 256;

// pointer arguments (inputs first, then outputs; unused slots null)
enum { kP0, kP1, kP2, kP3, kP4, kP5, kP6, kP7, kNumPtrs };
// int arguments, in the order of ops/fused_probe.py::_INTS
enum { iProbe, iT, iB, iR, iN, iK, kNumInts };

__global__ void probe_cos_kernel(const float* __restrict__ x, float* __restrict__ o, int len) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) o[i] = cosf(x[i]) + sinf(x[i]);
}

__global__ void probe_grid_scratch_kernel(float* __restrict__ o, int T, int len) {
    extern __shared__ float acc[];
    for (int t = 0; t < T; ++t) {
        for (int i = threadIdx.x; i < len; i += blockDim.x)
            acc[i] = t == 0 ? 1.0f : fmaf(acc[i], 2.0f, 1.0f);
        __syncthreads();
    }
    for (int i = threadIdx.x; i < len; i += blockDim.x) o[i] = acc[i];
}

__global__ void probe_smem_accumulate_kernel(const float* __restrict__ x, float* __restrict__ o,
                                             float* __restrict__ cnt, int T, int R, int N) {
    extern __shared__ float smem[];
    float* acc = smem;                   // [N][N]
    float* xs = acc + (size_t)N * N;     // [R][N]
    __shared__ float wsc[4];
    for (int e = threadIdx.x; e < R * N; e += blockDim.x) xs[e] = x[e];
    for (int t = 0; t < T; ++t) {
        if (t == 0) {
            for (int e = threadIdx.x; e < N * N; e += blockDim.x) acc[e] = 0.f;
            if (threadIdx.x == 0) wsc[0] = 1.0f;
        }
        __syncthreads();
        const float w = wsc[0];
        for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
            const int i = e / N, j = e - i * N;
            float s = 0.f;
            for (int r = 0; r < R; ++r) s = fmaf(xs[r * N + i] * w, xs[r * N + j] * w, s);
            acc[e] += s;
        }
        __syncthreads();
        if (threadIdx.x == 0) wsc[0] = wsc[0] + 1.0f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) o[e] = acc[e];
    if (threadIdx.x == 0) cnt[0] = wsc[0];
}

// fac rows: V^T (K rows), lam in row K's first K columns, alpha in row K + 1
__global__ void probe_thin_factor_kernel(const float* __restrict__ x,
                                         const float* __restrict__ fac, float* __restrict__ o,
                                         int R, int N, int K) {
    const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (r >= R) return;
    const float* xr = x + (size_t)r * N;
    float c[kMaxRank];
    for (int k = 0; k < K; ++k) {
        float part = 0.f;
        for (int j = lane; j < N; j += 32) part = fmaf(xr[j], fac[(size_t)k * N + j], part);
        c[k] = warp_sum(part) * (fac[(size_t)K * N + k] - fac[(size_t)(K + 1) * N + k]);
    }
    for (int j = lane; j < N; j += 32) {
        float v = fac[(size_t)(K + 1) * N + j] * xr[j];
        for (int k = 0; k < K; ++k) v = fmaf(c[k], fac[(size_t)k * N + j], v);
        o[(size_t)r * N + j] = v;
    }
}

// one thread block a chain block of RW rows, T steps
__global__ void probe_stat_io_layout_kernel(const int* __restrict__ seed,
                                            const float* __restrict__ q0,
                                            const float* __restrict__ sin_,
                                            const float* __restrict__ cst, float* __restrict__ tr,
                                            float* __restrict__ st, float* __restrict__ qf,
                                            float* __restrict__ sout, int T, int B, int RW,
                                            int Npad, int W) {
    extern __shared__ float smem[];
    float* qs = smem;                      // [RW][Npad]
    float* sa = qs + (size_t)RW * Npad;    // [RW][W]
    const int i = blockIdx.x;
    const size_t row0 = (size_t)i * RW;
    const float sd = (float)seed[0];
    for (int t = 0; t < T; ++t) {
        if (t == 0) {
            for (int e = threadIdx.x; e < RW * Npad; e += blockDim.x) qs[e] = q0[row0 * Npad + e];
            for (int e = threadIdx.x; e < RW * W; e += blockDim.x) sa[e] = sin_[row0 * W + e];
        }
        __syncthreads();
        for (int e = threadIdx.x; e < RW * Npad; e += blockDim.x) {
            const float q = qs[e] + cst[e] + sd;
            qs[e] = q;
            tr[((size_t)t * B * RW + row0) * Npad + e] = q;
        }
        for (int r = threadIdx.x; r < RW; r += blockDim.x) {
            float* srow = st + (((size_t)t * B + i) * RW + r) * W;
            for (int c = 0; c < 3; ++c) srow[c] = sa[r * W + c] + 10.0f * c + (float)t;
        }
        __syncthreads();
        for (int r = threadIdx.x; r < RW; r += blockDim.x) sa[r * W] += 1.0f;
        __syncthreads();
    }
    for (int e = threadIdx.x; e < RW * Npad; e += blockDim.x) qf[row0 * Npad + e] = qs[e];
    for (int e = threadIdx.x; e < RW * W; e += blockDim.x) sout[row0 * W + e] = sa[e];
}

__global__ void probe_block_outputs_3d_kernel(float* __restrict__ mf, float* __restrict__ sqf,
                                              float* __restrict__ cf, int T, int N) {
    extern __shared__ float acc[];  // [N][N]
    const int i = blockIdx.x;
    for (int t = 0; t < T; ++t) {
        for (int e = threadIdx.x; e < N * N; e += blockDim.x)
            acc[e] = (t == 0 ? 0.f : acc[e]) + (float)(i + 1);
        __syncthreads();
    }
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) sqf[(size_t)i * N * N + e] = acc[e];
    for (int e = threadIdx.x; e < 8 * N; e += blockDim.x) {
        mf[(size_t)i * 8 * N + e] = acc[e];
        cf[(size_t)i * 8 * N + e] = acc[e] * 2.0f;
    }
}

template <typename K>
cudaError_t with_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ints: the
// probe's number, T, B, R, N, K; ptrs: its inputs, then its outputs, in the
// order of ops/fused_probe.py::PROBES; floats: none.
int fused_probe_launch(void* const* ptrs, const int* ints, const float* floats, void* stream) {
    (void)floats;
    const int T = ints[iT], B = ints[iB], R = ints[iR], N = ints[iN], K = ints[iK];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [&](int k) { return static_cast<float*>(ptrs[k]); };
    cudaError_t err = cudaSuccess;
    switch (ints[iProbe]) {
        case 0:
            probe_cos_kernel<<<1, kThreads, 0, s>>>(f(kP0), f(kP1), R * N);
            break;
        case 1: {
            const size_t bytes = (size_t)R * N * sizeof(float);
            if ((err = with_smem(probe_grid_scratch_kernel, bytes)) != cudaSuccess) return (int)err;
            probe_grid_scratch_kernel<<<1, kThreads, bytes, s>>>(f(kP0), T, R * N);
            break;
        }
        case 2: {
            const size_t bytes = ((size_t)N * N + (size_t)R * N) * sizeof(float);
            if ((err = with_smem(probe_smem_accumulate_kernel, bytes)) != cudaSuccess)
                return (int)err;
            probe_smem_accumulate_kernel<<<1, kThreads, bytes, s>>>(f(kP0), f(kP1), f(kP2), T, R,
                                                                   N);
            break;
        }
        case 3:
            if (K < 1 || K > kMaxRank || R * 32 > 1024) return (int)cudaErrorInvalidValue;
            probe_thin_factor_kernel<<<1, 32 * R, 0, s>>>(f(kP0), f(kP1), f(kP2), R, N, K);
            break;
        case 4: {
            const size_t bytes = ((size_t)R * N + (size_t)R * K) * sizeof(float);
            if ((err = with_smem(probe_stat_io_layout_kernel, bytes)) != cudaSuccess) return (int)err;
            probe_stat_io_layout_kernel<<<B, kThreads, bytes, s>>>(
                static_cast<const int*>(ptrs[kP0]), f(kP1), f(kP2), f(kP3), f(kP4), f(kP5),
                f(kP6), f(kP7), T, B, R, N, K);
            break;
        }
        case 5: {
            const size_t bytes = (size_t)N * N * sizeof(float);
            if ((err = with_smem(probe_block_outputs_3d_kernel, bytes)) != cudaSuccess)
                return (int)err;
            probe_block_outputs_3d_kernel<<<B, kThreads, bytes, s>>>(f(kP0), f(kP1), f(kP2), T, N);
            break;
        }
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
