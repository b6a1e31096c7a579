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
// Mapping. A block of 8 warps takes a tile of TC chains. The block's q
// rows and row tiles of LAM (KT rows of n columns) come in by TMA bulk
// copies into a ring of S stages (tma_ring.cuh), all issued at the start
// where S KT >= n (n <= 224 at KT = 32 and 8 chains a block), so the
// later tiles are in flight while the first is computed; else a stage is
// refilled with tile t + S once tile t is done. The warps are WG = 4
// chain groups of RC = 2 chains by KS = 2 splits of LAM's rows (split s
// takes the rows i = s mod KS of each tile): TC = 8 chains a block, 128
// blocks at 1024 chains (1 x 1 and 2 x 1 were slower on the card, PERF.md
// row 5). A lane owns the NC column slots lane, lane + 32, ... (NC = n / 32
// rounded up, a template argument, so no slot is carried that n does not
// use) of its RC chains: per row of LAM, NC elements (lanes on consecutive
// columns) and RC broadcast q values feed RC NC FMAs, the accumulators in
// registers. The splits' partial sums meet in shared memory, added in a
// fixed order; the epilogue (the sign, the grad write, the row sum by a
// warp butterfly, the half) runs on the registers: the product never
// reaches device memory before grad is written. No atomics: the same bits
// on every call.
//
// Geometry. KT, S and the shared-memory bytes are chosen in Python
// (ops/quadform.py::plan_quadform) and checked here against this file's
// own count (QuadformLayout). A bulk copy needs 16-byte alignment
// and a multiple of 16 bytes: LAM's tiles start aligned (KT is a multiple
// of 4 and the precision is 16-byte aligned) and the last tile's last
// (m n) mod 4 floats are loaded plainly; the block's q rows start aligned
// where q itself is (TC n is a multiple of 4), their last few floats
// plainly, and all of them plainly where q is not (`q_bulk` 0).
//
// What bounds it on this card. 2 C n^2 + 3 C n fp32 operations against
// 4 (2 C n + n^2 + C) bytes: at C = 1024, n = 100, 20.5 MFLOP (0.31 us at
// 67 TFLOP/s) and 0.86 MB (0.26 us at 3.35 TB/s), so operations, with
// bytes close behind; each block reads LAM (40 KB) from L2 through the TMA.
// At these sizes latency and the launch bound it, so the product stays
// fp32 FFMA on the CUDA cores.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit). Plain C
// interface, loaded with ctypes.

#include "nuts_transition.cuh"  // warp_sum
#include "tma_ring.cuh"

namespace {

using namespace lmc_tma;
using lmc::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNdim = 256;
// the warps' tiling (ops/quadform.py::_CHAINS_PER_WARP, _SPLITS): WG chain
// groups of RC chains by KS splits of LAM's rows, TC chains a block
constexpr int RC = 2, KS = 2, WG = kWarps / KS, TC = RC * WG;

// pointer arguments, in the order of ops/quadform.py::_PTRS
enum { kQ, kPrec, kLogp, kGrad, kNumPtrs };
// int arguments, in the order of ops/quadform.py::_INTS
enum { iC, iN, iRowTile, iStages, iQBulk, iSmem, kNumInts };

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// floats of each shared-memory region (ops/quadform.py::plan_quadform
// counts the same)
struct QuadformLayout {
    int ls;   // a stage of LAM: KT rows of n
    int qs;   // the block's q rows, [TC][n]
    int red;  // the partial sums of splits 1 .. KS - 1, [KS - 1][TC][32 NC]
    __host__ __device__ QuadformLayout(int kt, int n)
        : ls(round4(kt * n)), qs(round4(TC * n)), red((KS - 1) * TC * 32 * ((n + 31) / 32)) {}
    __host__ __device__ size_t bytes(int stages) const {
        return kBarrierBytes + 4 * ((size_t)stages * ls + qs + red);
    }
};

template <int NC>
__global__ void __launch_bounds__(kThreads) quadform_logp_grad_kernel(
    const float* __restrict__ q, const float* __restrict__ prec, float* __restrict__ logp,
    float* __restrict__ grad, int C, int n, int KT, int S, int q_bulk) {
    extern __shared__ __align__(128) unsigned char smem[];
    const QuadformLayout L(KT, n);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* ls = reinterpret_cast<float*>(smem + kBarrierBytes);
    float* qs = ls + (size_t)S * L.ls;
    float* red = qs + L.qs;

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int c0 = blockIdx.x * TC, live = min(TC, C - c0);
    const float* qb = q + (size_t)c0 * n;
    const int ntiles = (n + KT - 1) / KT;
    const int qn = q_bulk ? bulk_floats(live * n) : 0;

    // tile t of LAM into stage s by TMA, with the block's q rows in tile 0
    auto issue = [&](int t, int s) {
        const int i0 = t * KT, m = min(KT, n - i0);
        const int ln = bulk_floats(m * n), extra = t == 0 ? qn : 0;
        arrive_expect_bytes(full + s, 4u * (ln + extra));
        if (ln) bulk_copy(ls + (size_t)s * L.ls, prec + (size_t)i0 * n, 4u * ln, full + s);
        if (extra) bulk_copy(qs, qb, 4u * extra, full + s);
    };

    if (tid == 0) {
        for (int s = 0; s < S; ++s) barrier_init(full + s);
        barrier_init_fence();
    }
    __syncthreads();
    if (tid == 0)
        for (int t = 0; t < min(S, ntiles); ++t) issue(t, t);
    copy_plain(qs, qb, qn, live * n);
    for (int k = live * n + tid; k < TC * n; k += kThreads) qs[k] = 0.f;  // chains past C

    const int cg = w % WG, split = w / WG;
    const float* qw = qs + (size_t)cg * RC * n;
    float acc[RC][NC];
#pragma unroll
    for (int rc = 0; rc < RC; ++rc)
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[rc][k] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        const int s = t % S, i0 = t * KT, m = min(KT, n - i0);
        float* lt = ls + (size_t)s * L.ls;
        copy_plain(lt, prec + (size_t)i0 * n, bulk_floats(m * n), m * n);
        barrier_wait(full + s, (uint32_t)(t / S) & 1u);
        __syncthreads();
        for (int i = split; i < m; i += KS) {
            const float* row = lt + (size_t)i * n;
            float qv[RC], lv[NC];
#pragma unroll
            for (int rc = 0; rc < RC; ++rc) qv[rc] = qw[rc * n + i0 + i];
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const int j = lane + 32 * k;
                lv[k] = (k < NC - 1 || j < n) ? row[j] : 0.f;
            }
#pragma unroll
            for (int rc = 0; rc < RC; ++rc)
#pragma unroll
                for (int k = 0; k < NC; ++k) acc[rc][k] = fmaf(qv[rc], lv[k], acc[rc][k]);
        }
        __syncthreads();  // every warp is done with stage s
        if (tid == 0 && t + S < ntiles) {
            fence_proxy_async();
            issue(t + S, s);
        }
    }

    // the splits' partial sums, added in order of split
    if (split > 0) {
#pragma unroll
        for (int rc = 0; rc < RC; ++rc)
#pragma unroll
            for (int k = 0; k < NC; ++k)
                red[(((size_t)(split - 1) * TC + cg * RC + rc) * NC + k) * 32 + lane] =
                    acc[rc][k];
    }
    __syncthreads();
    if (split == 0) {
        for (int sp = 1; sp < KS; ++sp)
#pragma unroll
            for (int rc = 0; rc < RC; ++rc)
#pragma unroll
                for (int k = 0; k < NC; ++k)
                    acc[rc][k] +=
                        red[(((size_t)(sp - 1) * TC + cg * RC + rc) * NC + k) * 32 + lane];
    }
    if (split != 0) return;
#pragma unroll
    for (int rc = 0; rc < RC; ++rc) {
        const int c = cg * RC + rc;
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const int j = lane + 32 * k;
            if (j < n) {
                const float gj = -acc[rc][k];
                if (c < live) grad[(size_t)(c0 + c) * n + j] = gj;
                part += qw[rc * n + j] * gj;
            }
        }
        const float sum = warp_sum(part);
        if (lane == 0 && c < live) logp[c0 + c] = 0.5f * sum;
    }
}

template <int NC>
int launch_tile(void* const* ptrs, const int* ints, size_t bytes, cudaStream_t stream) {
    // the dynamic shared memory this instance may use, set once per device
    // and size rather than at every launch
    static int granted[16] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 16) return (int)cudaErrorInvalidDevice;
    if ((int)bytes > granted[dev]) {
        err = cudaFuncSetAttribute(quadform_logp_grad_kernel<NC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        granted[dev] = (int)bytes;
    }
    const int C = ints[iC];
    quadform_logp_grad_kernel<NC><<<(C + TC - 1) / TC, kThreads, bytes, stream>>>(
        static_cast<const float*>(ptrs[kQ]), static_cast<const float*>(ptrs[kPrec]),
        static_cast<float*>(ptrs[kLogp]), static_cast<float*>(ptrs[kGrad]), C, ints[iN],
        ints[iRowTile], ints[iStages], ints[iQBulk]);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: q,
// the precision (16-byte aligned), logp, grad; ints: C, n, the rows of LAM
// a stage, the stages, whether q's rows come by TMA and the shared-memory
// bytes (ops/quadform.py::plan_quadform); floats: none.
int quadform_logp_grad_launch(void* const* ptrs, const int* ints, const float* floats,
                              void* stream) {
    (void)floats;
    const int C = ints[iC], n = ints[iN], kt = ints[iRowTile], S = ints[iStages];
    if (C < 1 || n < 1 || n > kMaxNdim || kt < 1 || S < 1 || S > kMaxStages)
        return (int)cudaErrorInvalidValue;
    if ((kt < n && kt % 4 != 0) || (reinterpret_cast<uintptr_t>(ptrs[kPrec]) & 15) != 0
        || (ints[iQBulk] && (reinterpret_cast<uintptr_t>(ptrs[kQ]) & 15) != 0))
        return (int)cudaErrorInvalidValue;
    const size_t bytes = QuadformLayout(kt, n).bytes(S);
    if (bytes != (size_t)ints[iSmem] || bytes > (size_t)kMaxSmemBytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch ((n + 31) / 32) {  // the column slots a lane carries
        case 1: return launch_tile<1>(ptrs, ints, bytes, st);
        case 2: return launch_tile<2>(ptrs, ints, bytes, st);
        case 3: return launch_tile<3>(ptrs, ints, bytes, st);
        case 4: return launch_tile<4>(ptrs, ints, bytes, st);
        case 5: return launch_tile<5>(ptrs, ints, bytes, st);
        case 6: return launch_tile<6>(ptrs, ints, bytes, st);
        case 7: return launch_tile<7>(ptrs, ints, bytes, st);
        case 8: return launch_tile<8>(ptrs, ints, bytes, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
