// Batched logistic-regression log density and gradient, with the logits on
// chip.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/logistic_pallas.py::
// make_logistic_logp_grad (pallas_call in _fused at :66; kernel _kernel
// :41). For q (C, n), the design Xb (N, n) with the intercept folded in,
// y (N,) and the prior precision:
//
//   logits = q Xb^T                                    (C, N), never stored
//   logp   = sum_r [y_r logit_r - softplus(logit_r)] - prior_prec q.q / 2
//   grad   = (y - sigma(logits)) Xb - prior_prec q
//
// The plain PyTorch version it is held against is
// ops/logistic.py::logistic_logp_grad_plain. Nothing is padded: the kernel
// masks the ragged edges (chains past C, rows past N, columns past n)
// itself, so the TPU code's (N_pad - N) log 2 correction has no
// counterpart.
//
// Mapping. One thread block is a tile of 8 chains, one warp a chain. Row
// tiles of Xb (kTileRows rows at the packed buffer's odd row stride) and
// of y stream through shared memory, loaded by the whole block; each warp
// runs its chain over the tile with logistic_rows (nuts_transition.cuh), the
// arithmetic of the logistic body the trajectory kernels inline: lanes own
// rows for the logits, the stable softplus and the sigmoid, then gradient
// columns, the residuals broadcast by shuffle. Xb is read in one
// orientation only.
//
// What bounds it on this card. 4 C N n fp32 operations (the two products)
// and 2 C N exponentials against about 4 (2 C n + N n + N) bytes: at the
// main path's C = 1024, N = 1000, n = 25, 102 MFLOP (1.5 us at 67 TFLOP/s)
// and 0.31 MB (0.09 us at 3.35 TB/s), so operations. Every block reads all
// of Xb (100 KB) through L2. A launch costs several us, so at these sizes
// the kernel is launch-bound; tensor cores (the products are small GEMMs)
// and a persistent grid are later work.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit). Plain C
// interface, loaded with ctypes.

#include "nuts_transition.cuh"

namespace {

using namespace lmc;

constexpr int kWarps = 8;       // chains per thread block
constexpr int kTileRows = 128;  // data rows per shared-memory tile

// pointer arguments, in the order of ops/logistic.py::_PTRS
enum { kQ, kConsts, kLogp, kGrad, kNumPtrs };
// int arguments, in the order of ops/logistic.py::_INTS
enum { iC, iN, iRows, kNumInts };

// consts: Xb (rows, n | 1: the last column zero where n is even), then y
// (rows), then the prior precision (nuts_transition.cuh::body_floats)
__global__ void __launch_bounds__(32 * kWarps) logistic_logp_grad_kernel(
    const float* __restrict__ q, const float* __restrict__ consts, float* __restrict__ logp,
    float* __restrict__ grad, int C, int n, int rows) {
    extern __shared__ float smem[];
    const int ldx = n | 1;
    float* xs = smem;                          // [kTileRows][ldx]
    float* ys = xs + (size_t)kTileRows * ldx;  // [kTileRows]
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * kWarps + w;
    const bool live = chain < C;
    float* qw = ys + kTileRows + (size_t)w * n;  // [kWarps][n]
    for (int i = lane; i < n; i += 32) qw[i] = live ? q[(size_t)chain * n + i] : 0.f;
    const float* y = consts + (size_t)rows * ldx;
    const float prior_prec = consts[(size_t)rows * ldx + rows];

    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
    float ll = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kTileRows) {
        const int m = min(kTileRows, rows - r0);
        __syncthreads();  // every warp is done with the previous tile
        const float* src = consts + (size_t)r0 * ldx;
        for (int k = threadIdx.x; k < m * ldx; k += blockDim.x) xs[k] = src[k];
        for (int k = threadIdx.x; k < m; k += blockDim.x) ys[k] = y[r0 + k];
        __syncthreads();
        ll += logistic_rows(qw, xs, ldx, ys, m, n, lane, acc);
    }
    if (!live) return;

    ll = warp_sum(ll);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
        const int j = lane + 32 * k;
        if (j < n) part += qw[j] * qw[j];
    }
    const float qq = warp_sum(part);
    float* go = grad + (size_t)chain * n;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
        const int j = lane + 32 * k;
        if (j < n) go[j] = acc[k] - prior_prec * qw[j];
    }
    if (lane == 0) logp[chain] = ll + -0.5f * prior_prec * qq;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: q,
// the packed constants, logp, grad; ints: C, n, rows; floats: none.
int logistic_logp_grad_launch(void* const* ptrs, const int* ints, const float* floats,
                              void* stream) {
    (void)floats;
    const int C = ints[iC], n = ints[iN], rows = ints[iRows];
    if (C < 1 || n < 1 || n > 32 * kMaxCols || rows < 1) return (int)cudaErrorInvalidValue;
    const size_t bytes = ((size_t)kTileRows * (n | 1) + kTileRows + (size_t)kWarps * n)
                         * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(logistic_logp_grad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    logistic_logp_grad_kernel<<<(C + kWarps - 1) / kWarps, 32 * kWarps, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ptrs[kQ]), static_cast<const float*>(ptrs[kConsts]),
        static_cast<float*>(ptrs[kLogp]), static_cast<float*>(ptrs[kGrad]), C, n, rows);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
