// T classic-HMC transitions per launch: the fused multi-draw HMC kernel,
// for a shared dense metric, a per-chain inverse-mass diagonal or the
// pooled low-rank metric.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/fused_hmc_pallas.py::
// build_fused_hmc_op (kernel :161, pallas_call at :511) for metric="dense",
// static (draw chunks) and with adapt_dense (pooled dense adaptation in
// tune chunks), for metric="diag", static and with adapt_metric (the
// per-chain dual-window Welford adaptation in tune chunks), and for
// metric="lowrank" (:118-132, :258-277): the per-chain variances V adapted
// as kDiag's, the scales sqrt(V) recomputed each draw, the factor block
// frozen for the launch in shared memory (fused_nuts.cu's scheme). The plain
// PyTorch version it is held against is ops/fused_hmc.py::fused_hmc_plain.
//
// Mapping. fused_nuts.cu's layout: one thread block is one chain block of
// CB chains, one warp per chain; the block loops t = 0..T-1 inside the
// launch, where the TPU kernel's grid walks its sequential draw axis, and
// the chain state (q, grad and, for kDiag, V and the four Welford rows in
// shared memory; logp, the iteration counter, the dual-averaging state and
// the Welford counters in registers) stays on chip across draws. Per draw
// and chain, in the JAX body's order (:251-325):
//   1. the momentum p = z @ L^-1 (kDense), p = z / sqrt(V) (kDiag, V at
//      :257, :279) or the low-rank one (kLowRank, fused_common.cuh::
//      lowrank_momentum), z from calls 1 and 2 of the row stream (base word
//      seed0, lanes row * Npad + col);
//   2. path_u, call 3 of the chain's stream, and
//      n_steps = clamp(floor(path_u * path_length / eps), 1, max_steps);
//   3. the trajectory of hmc_transition.cuh from the chain's state, with
//      velocity p @ COV or V p, then the accept against call 4 of the
//      stream;
//   4. the stats (_H_* at :82-84);
//   5. dual averaging on the accept statistic, when adapting;
//   6. tune chunks, kDiag and kLowRank with adapt_metric: the chain's
//      Welford step on the selected state, which refreshes V for the next
//      draw (:311-313);
//      kDense with adapt_dense: the block-local pooled Welford adds of the
//      block's CB new positions to both windows, then the swap;
//   7. the trace row.
// The per-draw seed word is seed0 = w0 + block*7919 + t*15485863 (:251).
// The momenta, dual averaging and both Welford states are the helpers of
// fused_common.cuh, shared with fused_nuts.cu.
//
// Where the state lives. At n = 100 and CB = 8: the chain's q and grad, the
// trajectory's q, p, g and the momentum and velocity scratch (7 x CB x n
// floats, 22 KB; kDiag keeps V in the velocity's place and adds its four
// Welford rows, 11 x CB x n), the pooled Welford means and shifts (5 x n,
// kDense), the precision P and COV (40 KB each) in shared memory; L^-1
// (40 KB, read once a draw) in global memory behind L2, and the block's
// Welford raw scatters (2 x n x n) in the per-block outputs, as in
// fused_nuts.cu. Warps do not wait for each other inside a draw: each runs
// its own step count; only the adapt_dense adds synchronise the block once
// a draw.
//
// What bounds it on this card. Per chain and draw: the momentum (kDense
// 2n^2 FLOP, kDiag about 10n), the start and end energies (kDense 2n^2
// each for the velocity, kDiag 3n), per step the model body (2n^2 for the
// correlated Gaussian, about 15n for the eight schools), for kDense 2n^2
// for the velocity, plus about 10n elementwise, and in tune 4n^2 (kDense,
// pooled) or about 12n (kDiag) for the Welford adds; fp32 outside the
// tensor cores, against the trace and stats written once.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit in the matvecs).

#include "fused_common.cuh"
#include "hmc_transition.cuh"

namespace {

using namespace lmc;

// pointer arguments, in the order of ops/fused_hmc.py::_PTRS
enum {
    kQ, kG, kScal, kCov, kLinv, kVar, kConsts, kQOut, kGOut, kScalOut, kVarOut, kTrace, kStatF,
    kStatI, kStatB, kWSeed, kFgMean, kFgRaw, kBgMean, kBgRaw, kWOut, kNumPtrs
};
// int arguments, in the order of ops/fused_hmc.py::_INTS
enum {
    iC, iN, iT, iCb, iStages, iBody, iMetric, iTuning, iAdapting, iAdaptMetric, iAdaptDense,
    iMaxSteps, iSeed0, iSeed1, iNpad, iRows, kNumInts
};
// float arguments, in the order of ops/fused_hmc.py::_FLOATS
enum {
    fEmax, fB0, fA0 = fB0 + 4, fTarget = fA0 + 3, fGamma, fK, fT0, fMult, fPathLength,
    kNumFloats
};
// per-chain scalar columns of the (C, 16) state in/out, as fused_nuts.cu's
enum {
    sLogp, sIter, sLogStep, sLogBar, sHbar, sCount, sMu,
    sFw = 8, sFw2, sBw, sBw2, sPn, sWin, kNumScal = 16
};
// per-draw f32 stats, each (T, C), in the order of ops/fused_hmc.py::_STAT_F32
enum { oStep, oStepBar, oAccept, oEnergyErr, oEnergy, oPathLength, oLogp, kNumStatF };

struct Args {
    void* ptr[kNumPtrs];
    int C, T, cb, tuning, adapting, adapt_metric, adapt_dense, max_steps, Npad;
    uint32_t seed0, seed1;
    HmcConsts K;
    float target, gamma, k, t0, mult, path_length;
    int lam_in_smem, cov_in_smem;
};

template <typename T>
__device__ __forceinline__ T* arg(const Args& A, int k) {
    return static_cast<T*>(A.ptr[k]);
}

// vectors a warp keeps in shared memory: q, grad, the trajectory's q, p,
// g, the normals z and the velocity (kDense, kLowRank) or V (kDiag), then
// for kDiag and kLowRank the four Welford rows, and for kLowRank the scales
// and V
template <int METRIC>
__host__ __device__ constexpr int n_fused_vecs() {
    return METRIC == kDense ? 7 : METRIC == kDiag ? 11 : 13;
}

template <int BODY, int METRIC>
__global__ void __launch_bounds__(32 * kMaxChainBlock) fused_hmc_kernel(Args A) {
    extern __shared__ float smem[];
    const int n = A.K.n, cb = A.cb, C = A.C;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int blk = blockIdx.x;
    const int chain = blk * cb + w;

    // shared layout: the warp vectors [n_fused_vecs][cb][n]; the pooled
    // Welford means and scratch [5][n] (kDense); then the body's constants
    // (P, or the logistic Xb and y) and COV where they fit
    float* qs = warp_vec(smem, 0, cb, w, n);
    float* gs = warp_vec(smem, 1, cb, w, n);
    float* q = warp_vec(smem, 2, cb, w, n);
    float* p = warp_vec(smem, 3, cb, w, n);
    float* g = warp_vec(smem, 4, cb, w, n);
    float* z = warp_vec(smem, 5, cb, w, n);
    float* vel = warp_vec(smem, 6, cb, w, n);  // kDiag: V
    DiagWelford::Rows wrows{warp_vec(smem, 7, cb, w, n), warp_vec(smem, 8, cb, w, n),
                            warp_vec(smem, 9, cb, w, n), warp_vec(smem, 10, cb, w, n)};
    // kLowRank: the chain's scales and its variances V (kDiag keeps V in vel)
    float* scales = METRIC == kLowRank ? warp_vec(smem, 11, cb, w, n) : nullptr;
    float* vrow = METRIC == kLowRank ? warp_vec(smem, 12, cb, w, n) : vel;
    float* wel_sh = smem + (size_t)n_fused_vecs<METRIC>() * cb * n;
    float* after = wel_sh + (METRIC == kDense ? 5 * n : 0);

    HmcConsts K = A.K;
    K.lam = stage_body<BODY>(K.lam, n, K.rows, A.lam_in_smem ? after : nullptr);
    if (A.lam_in_smem) after += body_floats(BODY, n, K.rows);
    if (METRIC == kDense && A.cov_in_smem) {
        for (int k = tid; k < n * n; k += nthreads) after[k] = K.cov[k];
        K.cov = after;
    }
    if constexpr (METRIC == kLowRank) {  // the factor block, in kCov's place
        for (int k = tid; k < lowrank_fac_floats(n); k += nthreads) after[k] = K.cov[k];
        K.cov = after;
    }
    const float* linv = arg<const float>(A, kLinv);

    // the chain's state
    const size_t row = (size_t)chain * n, CN = (size_t)C * n;
    for (int i = lane; i < n; i += 32) {
        qs[i] = arg<const float>(A, kQ)[row + i];
        gs[i] = arg<const float>(A, kG)[row + i];
    }
    const float* sc = arg<const float>(A, kScal) + (size_t)chain * kNumScal;
    float lp = sc[sLogp], iter = sc[sIter];
    DualAverage da{sc[sLogStep], sc[sLogBar], sc[sHbar], sc[sCount], sc[sMu]};

    // kDiag, kLowRank: the chain's variances and, with adapt_metric, its
    // Welford state ([var, fg mean, fg raw, bg mean, bg raw] x (C, n) in
    // kVar) (kDense keeps no diag Welford counters: they would hold
    // registers across the draw loop)
    DiagWelford dw{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (METRIC != kDense)
        dw = {sc[sFw], sc[sFw2], sc[sBw], sc[sBw2], sc[sPn], sc[sWin]};
    if (METRIC != kDense) {
        const float* vin = arg<const float>(A, kVar) + row;
        for (int i = lane; i < n; i += 32) vrow[i] = vin[i];
        if (A.adapt_metric)
            for (int i = lane; i < n; i += 32) {
                wrows.fgm[i] = vin[CN + i];
                wrows.fgv[i] = vin[2 * CN + i];
                wrows.bgm[i] = vin[3 * CN + i];
                wrows.bgv[i] = vin[4 * CN + i];
            }
    }

    // the block-local pooled Welford state (adapt_dense)
    BlockWelford wel;
    if (A.adapt_dense) wel.load(wel_sh, arg<const float>(A, kWSeed), n, tid, nthreads);
    __syncthreads();  // P, COV and the Welford means are in shared memory

    const uint32_t s1u = A.seed1 * kGolden;
    float* trace = arg<float>(A, kTrace);
    float* stf = arg<float>(A, kStatF);
    int* sti = arg<int>(A, kStatI);
    bool* stb = arg<bool>(A, kStatB);
    const size_t TC = (size_t)A.T * C;

    for (int t = 0; t < A.T; ++t) {
        const uint32_t seed0 = A.seed0 + (uint32_t)blk * 7919u + (uint32_t)t * 15485863u;

        // 1. momentum: Box-Muller normals, then p = z @ L^-1, z / sqrt(V) or
        // the low-rank momentum from the scales sqrt(V)
        if constexpr (METRIC == kDense) {
            dense_momentum(seed0, s1u, w, A.Npad, linv, z, p, n, lane);
        } else if constexpr (METRIC == kLowRank) {
            for (int i = lane; i < n; i += 32) scales[i] = sqrtf(vrow[i]);
            lowrank_momentum(seed0, s1u, w, A.Npad, scales, K.cov, z, p, n, lane);
        } else {
            diag_momentum(seed0, s1u, w, A.Npad, vel, p, n, lane);
        }
        // 2. the jittered path length and the step count (hmc.py:141-143)
        const float eps = expf(A.adapting ? da.log_step : da.log_bar);
        const uint32_t salt = fmix32((seed0 + (uint32_t)w * 101027u) ^ s1u);
        const float path_length = counter_uniform(salt, 3u) * A.path_length;
        const float nst = fminf(fmaxf(floorf(path_length / eps), 1.0f), (float)A.max_steps);
        // 3. the trajectory from the chain's state, and the accept
        const float* vv = METRIC == kDiag ? vel : scales;
        float* vscratch = METRIC != kDiag ? vel : nullptr;
        const float E0 = half_kinetic<METRIC>(K, p, vv, vscratch, lane) - lp;
        for (int i = lane; i < n; i += 32) { q[i] = qs[i]; g[i] = gs[i]; }
        __syncwarp();
        const HmcResult r = hmc_trajectory<BODY, METRIC>(K, q, p, g, vv, vscratch, lp, E0, eps,
                                                         (int)nst, lane);
        const bool accepted = !r.div && counter_uniform(salt, 4u) < r.acc;
        // 5. dual averaging on the accept statistic (step_sizes.py:85-92)
        if (A.adapting) da.update(r.acc, A.target, A.gamma, A.k, A.t0);
        // advance the chain, 7. the trace row
        iter = iter + 1.0f;
        if (accepted) lp = r.lp;
        for (int i = lane; i < n; i += 32) {
            if (accepted) { qs[i] = q[i]; gs[i] = g[i]; }
            if (trace) trace[((size_t)t * C + chain) * n + i] = qs[i];
        }
        // 6a. kDiag with adapt_metric: the chain's Welford step on the
        // selected state (each lane reads its own columns of qs)
        if (METRIC != kDense && A.adapt_metric && A.tuning)
            dw.update(qs, wrows, vrow, n, A.mult, lane);
        // 4. per-draw stats
        if (lane == 0) {
            const size_t o = (size_t)t * C + chain;
            stf[oStep * TC + o] = expf(da.log_step);
            stf[oStepBar * TC + o] = expf(da.log_bar);
            stf[oAccept * TC + o] = r.acc;
            stf[oEnergyErr * TC + o] = r.dE;
            stf[oEnergy * TC + o] = r.en;
            stf[oPathLength * TC + o] = path_length;
            stf[oLogp * TC + o] = r.lp;
            sti[o] = (int)nst;
            stb[o] = r.div;
            stb[TC + o] = accepted;
        }
        // 6b. kDense with adapt_dense: the block-local pooled Welford adds
        // (_dense_welford_batch_add :246, both windows) and the shared swap
        // (:267)
        if (METRIC == kDense && A.adapt_dense)
            wel.add_and_swap(warp_vec(smem, 0, cb, 0, n), wel_sh,
                             arg<float>(A, kFgRaw) + (size_t)blk * n * n,
                             arg<float>(A, kBgRaw) + (size_t)blk * n * n, cb, n, A.mult, tid,
                             nthreads);
    }

    // the final state
    for (int i = lane; i < n; i += 32) {
        arg<float>(A, kQOut)[row + i] = qs[i];
        arg<float>(A, kGOut)[row + i] = gs[i];
    }
    if (lane == 0) {
        float* so = arg<float>(A, kScalOut) + (size_t)chain * kNumScal;
        for (int k = 0; k < kNumScal; ++k) so[k] = 0.f;
        so[sLogp] = lp; so[sIter] = iter; so[sLogStep] = da.log_step; so[sLogBar] = da.log_bar;
        so[sHbar] = da.hbar; so[sCount] = da.count; so[sMu] = da.mu;
        if constexpr (METRIC != kDense) {
            so[sFw] = dw.fw; so[sFw2] = dw.fw2; so[sBw] = dw.bw; so[sBw2] = dw.bw2;
            so[sPn] = dw.pn; so[sWin] = dw.win;
        }
    }
    if (METRIC != kDense && A.adapt_metric) {
        float* vout = arg<float>(A, kVarOut) + row;
        for (int i = lane; i < n; i += 32) {
            vout[i] = vrow[i];
            vout[CN + i] = wrows.fgm[i];
            vout[2 * CN + i] = wrows.fgv[i];
            vout[3 * CN + i] = wrows.bgm[i];
            vout[4 * CN + i] = wrows.bgv[i];
        }
    }
    if (METRIC == kDense && A.adapt_dense)
        wel.store(wel_sh, arg<float>(A, kFgMean) + (size_t)blk * n,
                  arg<float>(A, kBgMean) + (size_t)blk * n, arg<float>(A, kWOut) + (size_t)blk * 8,
                  n, tid, nthreads);
}

// 227 KB per block on Hopper
constexpr size_t kSmemLimit = 232448;

template <int BODY, int METRIC>
cudaError_t launch(const Args& A0, cudaStream_t stream) {
    Args A = A0;
    const int n = A.K.n;
    size_t bytes = ((size_t)n_fused_vecs<METRIC>() * A.cb * n
                    + (METRIC == kDense ? (size_t)5 * n : 0)
                    + (METRIC == kLowRank ? (size_t)lowrank_fac_floats(n) : 0)) * sizeof(float);
    const size_t sq_bytes = (size_t)n * n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, n, A.K.rows) * sizeof(float);
    A.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= kSmemLimit) ? 1 : 0;
    if (A.lam_in_smem) bytes += body_bytes;
    A.cov_in_smem = (METRIC == kDense && bytes + sq_bytes <= kSmemLimit) ? 1 : 0;
    if (A.cov_in_smem) bytes += sq_bytes;
    if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(fused_hmc_kernel<BODY, METRIC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    fused_hmc_kernel<BODY, METRIC><<<A.C / A.cb, 32 * A.cb, bytes, stream>>>(A);
    return cudaGetLastError();
}

template <int BODY>
cudaError_t launch_metric(const Args& A, int metric, cudaStream_t stream) {
    switch (metric) {
        case kDiag: return launch<BODY, kDiag>(A, stream);
        case kDense: return launch<BODY, kDense>(A, stream);
        case kLowRank: return launch<BODY, kLowRank>(A, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: the
// kNumPtrs device pointers (kTrace may be null: no trace; kConsts null for
// a body without constants; kCov and kLinv are read only for the dense
// metric, kCov the factor block for the low-rank one, kVar for the diag
// and low-rank ones, kVarOut with adapt_metric, the pooled Welford ones
// with adapt_dense); ints: kNumInts; floats: kNumFloats.
int fused_hmc_launch(void* const* ptrs, const int* ints, const float* floats, void* stream) {
    Args A;
    for (int k = 0; k < kNumPtrs; ++k) A.ptr[k] = ptrs[k];
    A.C = ints[iC]; A.T = ints[iT]; A.cb = ints[iCb];
    A.tuning = ints[iTuning]; A.adapting = ints[iAdapting];
    A.adapt_metric = ints[iAdaptMetric]; A.adapt_dense = ints[iAdaptDense];
    A.max_steps = ints[iMaxSteps]; A.Npad = ints[iNpad];
    A.seed0 = (uint32_t)ints[iSeed0]; A.seed1 = (uint32_t)ints[iSeed1];
    A.K.lam = static_cast<const float*>(ptrs[kConsts]);
    A.K.cov = static_cast<const float*>(ptrs[kCov]);
    A.K.n = ints[iN]; A.K.rows = ints[iRows]; A.K.n_stages = ints[iStages]; A.K.Emax = floats[fEmax];
    for (int k = 0; k < 4; ++k) A.K.b[k] = floats[fB0 + k];
    for (int k = 0; k < 3; ++k) A.K.a[k] = floats[fA0 + k];
    A.target = floats[fTarget]; A.gamma = floats[fGamma]; A.k = floats[fK];
    A.t0 = floats[fT0]; A.mult = floats[fMult]; A.path_length = floats[fPathLength];
    A.lam_in_smem = 0;
    A.cov_in_smem = 0;
    const int body = ints[iBody], metric = ints[iMetric];
    if (A.cb < 1 || A.cb > kMaxChainBlock || A.C % A.cb != 0 || A.K.n < 1
        || A.K.n > 32 * kMaxCols || A.T < 1 || A.K.n_stages < 1 || A.K.n_stages > 3
        || A.max_steps < 1 || (body == 2 && A.K.n != 10) || (body == 3 && A.K.rows < 1)
        || (body == 4 && (A.K.rows < 1 || A.K.rows > kMaxRank)) || (body == 5 && A.K.n < 2))
        return (int)cudaErrorInvalidValue;
    if (A.adapt_dense && (!A.tuning || metric != kDense)) return (int)cudaErrorInvalidValue;
    if (A.adapt_metric && metric == kDense) return (int)cudaErrorInvalidValue;
    if (metric == kLowRank && A.K.cov == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (body) {
#ifndef LMC_AUTOSPEC_ONLY  // a generated body's library holds its instances only
        case 0: return (int)launch_metric<0>(A, metric, s);
        case 1: return (int)launch_metric<1>(A, metric, s);
        case 2: return (int)launch_metric<2>(A, metric, s);
        case 3: return (int)launch_metric<3>(A, metric, s);
        case 4: return (int)launch_metric<4>(A, metric, s);
        case 5: return (int)launch_metric<5>(A, metric, s);
#endif
#ifdef LMC_AUTOSPEC_HEADER
        case kAutoBody: return (int)launch_metric<kAutoBody>(A, metric, s);
#endif
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
