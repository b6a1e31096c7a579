// Batched zero-mean Gaussian log density and gradient from its precision.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/gaussian_pallas.py::
// quadform_logp_grad (pallas_call in _quadform_padded at :53; kernel
// _kernel :40). For q (C, n) and the precision LAM (n, n):
//
//   grad = -(q LAM)                      (the JAX code's q @ prec order)
//   logp = sum_j q_j grad_j / 2
//
// The plain PyTorch version it is held against is
// ops/quadform.py::quadform_logp_grad_plain. Nothing is padded: the kernel
// masks chains past C and columns past n itself.
//
// Mapping. One thread block is a tile of 8 chains, one warp a chain, its q
// in shared memory. Row tiles of LAM (kTileK rows of n columns) stream
// through shared memory, loaded by the whole block; each warp multiplies
// its chain's q into them with lanes owning the columns lane, lane + 32,
// ... (up to 8 a lane, in registers, fmaf explicit) and q[i] broadcast.
// The epilogue (the sign, the row sum, the half) runs on those registers:
// the product never reaches device memory before grad is written.
//
// What bounds it on this card. 2 C n^2 + 2 C n fp32 operations against
// 4 (2 C n + n^2 + C) bytes: at C = 1024, n = 100, 20.5 MFLOP (0.31 us at
// 67 TFLOP/s) and 0.86 MB (0.26 us at 3.35 TB/s), so operations, with
// bytes close behind. A launch costs several us, so the kernel is
// launch-bound at these sizes; a wgmma GEMM with this epilogue is later
// work.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit). Plain C
// interface, loaded with ctypes.

#include "nuts_transition.cuh"

namespace {

using namespace lmc;

constexpr int kWarps = 8;   // chains per thread block
constexpr int kTileK = 32;  // rows of LAM per shared-memory tile

// pointer arguments, in the order of ops/quadform.py::_PTRS
enum { kQ, kPrec, kLogp, kGrad, kNumPtrs };
// int arguments, in the order of ops/quadform.py::_INTS
enum { iC, iN, kNumInts };

__global__ void __launch_bounds__(32 * kWarps) quadform_logp_grad_kernel(
    const float* __restrict__ q, const float* __restrict__ prec, float* __restrict__ logp,
    float* __restrict__ grad, int C, int n) {
    extern __shared__ float smem[];
    float* ls = smem;                     // [kTileK][n]
    float* qs = ls + (size_t)kTileK * n;  // [kWarps][n]
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * kWarps + w;
    const bool live = chain < C;
    float* qw = qs + (size_t)w * n;
    for (int i = lane; i < n; i += 32) qw[i] = live ? q[(size_t)chain * n + i] : 0.f;

    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
    for (int i0 = 0; i0 < n; i0 += kTileK) {
        const int m = min(kTileK, n - i0);
        __syncthreads();  // every warp is done with the previous tile
        const float* src = prec + (size_t)i0 * n;
        for (int k = threadIdx.x; k < m * n; k += blockDim.x) ls[k] = src[k];
        __syncthreads();
        for (int i = 0; i < m; ++i) {
            const float qi = qw[i0 + i];
            const float* row = ls + (size_t)i * n;
#pragma unroll
            for (int k = 0; k < kMaxCols; ++k) {
                const int j = lane + 32 * k;
                if (j < n) acc[k] = fmaf(qi, row[j], acc[k]);
            }
        }
    }
    if (!live) return;

    float part = 0.f;
    float* go = grad + (size_t)chain * n;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
        const int j = lane + 32 * k;
        if (j < n) {
            const float gj = -acc[k];
            go[j] = gj;
            part += qw[j] * gj;
        }
    }
    const float s = warp_sum(part);
    if (lane == 0) logp[chain] = 0.5f * s;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: q,
// the precision, logp, grad; ints: C, n; floats: none.
int quadform_logp_grad_launch(void* const* ptrs, const int* ints, const float* floats,
                              void* stream) {
    (void)floats;
    const int C = ints[iC], n = ints[iN];
    if (C < 1 || n < 1 || n > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
    const size_t bytes = ((size_t)kTileK * n + (size_t)kWarps * n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(quadform_logp_grad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    quadform_logp_grad_kernel<<<(C + kWarps - 1) / kWarps, 32 * kWarps, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptrs[kQ]), static_cast<const float*>(ptrs[kPrec]),
        static_cast<float*>(ptrs[kLogp]), static_cast<float*>(ptrs[kGrad]), C, n);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
