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
// masks the ragged edges (chains past C, rows past N) itself, so the TPU
// code's (N_pad - N) log 2 correction has no counterpart.
//
// Mapping. A block of 256 threads takes a tile of TC = 8 chains (their q
// transposed into shared memory, [n][TC]; 8 gives 128 blocks at 1024
// chains, and 4 and 16 were slower on the card, PERF.md row 6) and walks the design in row
// tiles of R rows. The row tiles of Xb (R rows at the packed buffer's odd
// row stride n | 1) and of y come in by TMA bulk copies into a ring of S
// stages (tma_ring.cuh), all S issued at the start, so the copies of the
// later tiles are in flight while the first is computed; a stage is
// refilled with tile t + S once tile t is done. Each tile is two
// register-tiled products:
//
// 1. Logits. Thread t owns row t % R of the tile and CPT = TC R / 256
//    chains (group t / R): per column k one Xb element (lanes on
//    consecutive rows of the odd stride: no bank conflict) and the CPT
//    chains' q (one broadcast vector load) feed CPT FMAs. The stable
//    softplus (jax.nn.softplus's max(x, 0) + log1p(exp(-|x|))) and the
//    sigmoid share one exponential; the log likelihood stays in
//    registers and the residuals y - sigma go to shared memory, [R][TC].
// 2. Gradient. Thread t owns column t % n and row slice t / n of the
//    256 / n slices, and TC accumulators: per row one Xb element and the
//    row's TC residuals (broadcast vector loads) feed TC FMAs. The
//    accumulators run across the row tiles in registers.
//
// At the end the slices' partial gradients and the warps' partial log
// likelihoods are summed through shared memory in a fixed order: no
// atomics, no split of rows across blocks, the same bits on every call.
//
// Geometry. R, S, the y offset and the shared-memory bytes are chosen
// in Python (ops/logistic.py::plan_logistic) and checked here against this
// file's own count (LogisticLayout). A bulk copy needs 16-byte alignment
// and a multiple of 16 bytes: a row tile's Xb starts aligned (R is a
// multiple of 4 and the buffer is 16-byte aligned) and its last m ldx mod 4
// floats are loaded plainly; y starts at rows * ldx floats, so its first
// y_head floats (to the next 16-byte boundary) and its last few are loaded
// plainly and the rest by TMA into a stage offset to match. The packed
// layout itself is body 3's (nuts_transition.cuh) and stays as it is.
//
// What bounds it on this card. 4 C N n fp32 operations (the two products)
// and 2 C N exponentials and logarithms against about 4 (2 C n + N n + N)
// bytes: at the main path's C = 1024, N = 1000, n = 25, 102 MFLOP
// (1.5 us at 67 TFLOP/s) and 0.31 MB (0.09 us at 3.35 TB/s), so
// operations; each block reads the whole design (100 KB) from L2 through
// the TMA. At these sizes latency and the launch bound it, not the FMA
// rate, so the products stay fp32 FFMA on the CUDA cores.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit). Plain C
// interface, loaded with ctypes.

#include "nuts_transition.cuh"  // warp_sum
#include "tma_ring.cuh"

namespace {

using namespace lmc_tma;
using lmc::warp_sum;

constexpr int kThreads = 256;
constexpr int kMaxNdim = 256;
constexpr int TC = 8;  // chains a block (ops/logistic.py::CHAIN_TILE)

// pointer arguments, in the order of ops/logistic.py::_PTRS
enum { kQ, kConsts, kLogp, kGrad, kNumPtrs };
// int arguments, in the order of ops/logistic.py::_INTS
enum { iC, iN, iRows, iRowTile, iStages, iYHead, iSmem, kNumInts };

// floats of each shared-memory region (ops/logistic.py::plan_logistic
// counts the same)
struct LogisticLayout {
    int xs;   // a stage of Xb: R rows at stride n | 1
    int ys;   // a stage of y: R floats and the alignment shift
    int qs;   // the chains' q, [n][TC]
    int red;  // the residuals [R][TC], then the partial gradients [256 / n][TC][n]
    int llp;  // the warps' partial log likelihoods
    __host__ __device__ LogisticLayout(int r, int n)
        : xs(r * (n | 1)), ys(r + 4), qs(n * TC), red(kThreads * TC),
          llp((kThreads / 32) * TC) {}
    __host__ __device__ size_t bytes(int stages) const {
        return kBarrierBytes + 4 * ((size_t)stages * (xs + ys) + qs + red + llp);
    }
};

// CPT floats of shared memory at p (aligned to their size) into v
template <int CPT>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[CPT]) {
    if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < CPT; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(p + i);
            v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
        }
    } else if constexpr (CPT % 2 == 0) {
#pragma unroll
        for (int i = 0; i < CPT; i += 2) {
            const float2 x = *reinterpret_cast<const float2*>(p + i);
            v[i] = x.x, v[i + 1] = x.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < CPT; ++i) v[i] = p[i];
    }
}

// consts: Xb (rows, n | 1: the last column zero where n is even), then y
// (rows), then the prior precision (nuts_transition.cuh::body_floats)
template <int R>
__global__ void __launch_bounds__(kThreads) logistic_logp_grad_kernel(
    const float* __restrict__ q, const float* __restrict__ consts, float* __restrict__ logp,
    float* __restrict__ grad, int C, int n, int rows, int S, int y_head) {
    constexpr int G = kThreads / R;  // chain groups of the logits
    constexpr int CPT = TC / G;      // chains a thread owns in the logits
    static_assert(R % 32 == 0 && R <= kThreads && CPT >= 1 && CPT * G == TC, "tile");
    extern __shared__ __align__(128) unsigned char smem[];
    const LogisticLayout L(R, n);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* xs = reinterpret_cast<float*>(smem + kBarrierBytes);
    float* ys = xs + (size_t)S * L.xs;
    float* qs = ys + (size_t)S * L.ys;
    float* red = qs + L.qs;
    float* llp = red + L.red;

    const int tid = threadIdx.x, c0 = blockIdx.x * TC;
    const int ldx = n | 1;
    const float* y = consts + (size_t)rows * ldx;
    const float prior_prec = consts[(size_t)rows * ldx + rows];
    const int ntiles = (rows + R - 1) / R;
    const int yoff = (4 - y_head) & 3;  // puts y[r0 + y_head] on a 16-byte boundary

    // tile t into stage s: the aligned part of its Xb and y by TMA
    auto issue = [&](int t, int s) {
        const int r0 = t * R, m = min(R, rows - r0);
        const int xn = bulk_floats(m * ldx);
        const int yh = min(y_head, m), yn = bulk_floats(m - yh);
        arrive_expect_bytes(full + s, 4u * (xn + yn));
        if (xn) bulk_copy(xs + (size_t)s * L.xs, consts + (size_t)r0 * ldx, 4u * xn, full + s);
        if (yn) bulk_copy(ys + (size_t)s * L.ys + yoff + yh, y + r0 + yh, 4u * yn, full + s);
    };

    if (tid == 0) {
        for (int s = 0; s < S; ++s) barrier_init(full + s);
        barrier_init_fence();
    }
    __syncthreads();
    if (tid == 0)
        for (int t = 0; t < min(S, ntiles); ++t) issue(t, t);
    for (int k = tid; k < TC * n; k += kThreads) {  // q, read coalesced, stored [n][TC]
        const int c = k / n, i = k - c * n;
        qs[i * TC + c] = c0 + c < C ? q[(size_t)c0 * n + k] : 0.f;
    }

    const int r = tid % R, g = tid / R;                      // the logits' row and group
    const int nsl = kThreads / n, j = tid % n, sl = tid / n;  // the gradient's column, slice
    float ll[CPT], gacc[TC];
#pragma unroll
    for (int i = 0; i < CPT; ++i) ll[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) gacc[c] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        const int s = t % S, r0 = t * R, m = min(R, rows - r0);
        float* xt = xs + (size_t)s * L.xs;
        float* yt = ys + (size_t)s * L.ys + yoff;
        {  // the floats the bulk copies leave out
            const int yh = min(y_head, m), yn = bulk_floats(m - yh);
            copy_plain(xt, consts + (size_t)r0 * ldx, bulk_floats(m * ldx), m * ldx);
            copy_plain(yt, y + r0, 0, yh);
            copy_plain(yt, y + r0, yh + yn, m);
        }
        barrier_wait(full + s, (uint32_t)(t / S) & 1u);
        __syncthreads();

        if (r < m) {  // 1. the logits of row r for the group's chains
            float lg[CPT], qv[CPT];
#pragma unroll
            for (int i = 0; i < CPT; ++i) lg[i] = 0.f;
            const float* xr = xt + (size_t)r * ldx;
            const float* qg = qs + g * CPT;
            for (int k = 0; k < n; ++k) {
                const float x = xr[k];
                load_vec<CPT>(qg + k * TC, qv);
#pragma unroll
                for (int i = 0; i < CPT; ++i) lg[i] = fmaf(qv[i], x, lg[i]);
            }
            const float yr = yt[r];
            float* rr = red + r * TC + g * CPT;
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                const float e = expf(-fabsf(lg[i]));
                const float softplus = fmaxf(lg[i], 0.f) + log1pf(e);
                const float inv = 1.f / (1.f + e);
                ll[i] += yr * lg[i] - softplus;
                qv[i] = yr - (lg[i] >= 0.f ? inv : e * inv);
            }
            if constexpr (CPT % 4 == 0) {
#pragma unroll
                for (int i = 0; i < CPT; i += 4)
                    *reinterpret_cast<float4*>(rr + i) =
                        make_float4(qv[i], qv[i + 1], qv[i + 2], qv[i + 3]);
            } else {
#pragma unroll
                for (int i = 0; i < CPT; ++i) rr[i] = qv[i];
            }
        }
        __syncthreads();

        if (sl < nsl) {  // 2. the gradient's column j over the slice's rows
            float res[TC];
            for (int row = sl; row < m; row += nsl) {
                const float x = xt[(size_t)row * ldx + j];
                load_vec<TC>(red + row * TC, res);
#pragma unroll
                for (int c = 0; c < TC; ++c) gacc[c] = fmaf(res[c], x, gacc[c]);
            }
        }
        __syncthreads();  // every thread is done with stage s and the residuals
        if (tid == 0 && t + S < ntiles) {
            fence_proxy_async();
            issue(t + S, s);
        }
    }

    // the partial sums, then their totals in a fixed order
    const int w = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const float v = warp_sum(ll[i]);
        if (lane == 0) llp[w * CPT + i] = v;
    }
    if (sl < nsl) {
#pragma unroll
        for (int c = 0; c < TC; ++c) red[((size_t)sl * TC + c) * n + j] = gacc[c];
    }
    __syncthreads();
    for (int k = tid; k < TC * n; k += kThreads) {  // grad, written coalesced
        const int c = k / n, jj = k - c * n;
        if (c0 + c >= C) break;
        float acc = red[k];
        for (int s2 = 1; s2 < nsl; ++s2) acc += red[(size_t)s2 * TC * n + k];
        grad[(size_t)c0 * n + k] = acc - prior_prec * qs[jj * TC + c];
    }
    if (tid < TC && c0 + tid < C) {
        constexpr int kGroupWarps = R / 32;
        const int gg = tid / CPT, i = tid - gg * CPT;
        float l = 0.f, qq = 0.f;
        for (int ww = gg * kGroupWarps; ww < (gg + 1) * kGroupWarps; ++ww) l += llp[ww * CPT + i];
        for (int k = 0; k < n; ++k) {
            const float qk = qs[k * TC + tid];
            qq += qk * qk;
        }
        logp[c0 + tid] = l + -0.5f * prior_prec * qq;
    }
}

template <int R>
int launch_tile(void* const* ptrs, const int* ints, size_t bytes, cudaStream_t stream) {
    // the dynamic shared memory this instance may use, set once per device
    // and size rather than at every launch
    static int granted[16] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 16) return (int)cudaErrorInvalidDevice;
    if ((int)bytes > granted[dev]) {
        err = cudaFuncSetAttribute(logistic_logp_grad_kernel<R>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        granted[dev] = (int)bytes;
    }
    const int C = ints[iC];
    logistic_logp_grad_kernel<R><<<(C + TC - 1) / TC, kThreads, bytes, stream>>>(
        static_cast<const float*>(ptrs[kQ]), static_cast<const float*>(ptrs[kConsts]),
        static_cast<float*>(ptrs[kLogp]), static_cast<float*>(ptrs[kGrad]), C, ints[iN],
        ints[iRows], ints[iStages], ints[iYHead]);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: q,
// the packed constants (16-byte aligned), logp, grad; ints: C, n, rows,
// the row tile, the stages, y's unaligned head and the shared-memory
// bytes (ops/logistic.py::plan_logistic); floats: none.
int logistic_logp_grad_launch(void* const* ptrs, const int* ints, const float* floats,
                              void* stream) {
    (void)floats;
    const int C = ints[iC], n = ints[iN], rows = ints[iRows], r = ints[iRowTile],
              S = ints[iStages];
    if (C < 1 || n < 1 || n > kMaxNdim || rows < 1 || S < 1 || S > kMaxStages)
        return (int)cudaErrorInvalidValue;
    if (ints[iYHead] != ((4 - (int)(((long long)rows * (n | 1)) & 3)) & 3)
        || (reinterpret_cast<uintptr_t>(ptrs[kConsts]) & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = LogisticLayout(r, n).bytes(S);
    if (bytes != (size_t)ints[iSmem] || bytes > (size_t)kMaxSmemBytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (r) {
        case 64: return launch_tile<64>(ptrs, ints, bytes, st);
        case 128: return launch_tile<128>(ptrs, ints, bytes, st);
        case 256: return launch_tile<256>(ptrs, ints, bytes, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
