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
// CB chains, one warp per chain (fused_hmc_kernel<BODY, METRIC, false>;
// body 1 with the dense metric in blocks of up to kBlockChains runs the
// instance <1, kDense, true>, on the block HMC transition of
// hmc_transition.cuh: the block's chains in lockstep to their longest
// count a draw, and the momenta z L^-1, the energies' velocities and each
// step's velocity and gradient one block product each, L^-1 read through
// L2; the same bits; body 4 with the low-rank metric in blocks of up to
// kBlockChains at n <= 128 runs fused_hmc_lowrank_kernel, one warp a chain
// with its vectors and both thin factors in registers, and eight schools
// with the diagonal metric fused_hmc_packed_kernel, kEsHmcChainsPerWarp
// chains a warp in registers: both below, the same bits as the warp
// instance); the block loops t = 0..T-1 inside the launch, where
// the TPU kernel's grid walks its sequential draw axis, and the chain state
// (q, grad and, for kDiag, V and the four Welford rows in shared memory;
// logp, the iteration counter, the dual-averaging state and the Welford
// counters in registers) stays on chip across draws. Per draw
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
// fused_nuts.cu; a generated body's scratch rows after all of it where
// they fit, else in its global scratch (the block instance adds its staged
// rows, n x 8 floats). In the warp instance warps do not wait for each
// other inside a draw: each runs its own step count; only the adapt_dense
// adds synchronise the block once a draw.
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

// the logistic body's register tile in this kernel (nuts_transition.cuh::
// kLogisticChunk): its draw loop's state leaves the body fewer registers.
// 8 columns x 2 rows is the tile with which ptxas spills in no instance
// (PERF.md, row 1b)
#ifndef LMC_LOGISTIC_CHUNK
#define LMC_LOGISTIC_CHUNK 8
#endif
#ifndef LMC_LOGISTIC_ROWS
#define LMC_LOGISTIC_ROWS 2
#endif
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
    int lam_in_smem, cov_in_smem, scratch_in_smem;
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

// The start energy and the trajectory of the draw: the warp's (half_kinetic,
// hmc_trajectory) or, on the block transition (BLOCK), the block's
// (block_half_kinetic, hmc_block_trajectory; qt the staged rows).
template <int METRIC, bool BLOCK>
__device__ __forceinline__ float start_energy(const HmcConsts& K, int cb, float* qt, int w,
                                              const float* p, const float* vv, float* vel,
                                              int lane LMC_HCLK_PARAM) {
    if constexpr (BLOCK)
        return block_half_kinetic(K, cb, smem_offset(qt), w, p, vel, lane LMC_HCLK_ARG);
    else
        return half_kinetic<METRIC>(K, p, vv, vel, lane LMC_HCLK_ARG);
}

template <int BODY, int METRIC, bool BLOCK>
__device__ __forceinline__ HmcResult trajectory_of(const HmcConsts& K, int cb, float* qt, int w,
                                                   float* q, float* p, float* g, const float* vv,
                                                   float* vel, float lp0, float E0, float eps,
                                                   int n_steps, int lane LMC_HCLK_PARAM) {
    if constexpr (BLOCK)
        return hmc_block_trajectory<METRIC>(K, cb, smem_offset(qt), w, q, p, g, vv, vel, lp0,
                                            E0, eps, n_steps, lane LMC_HCLK_ARG);
    else
        return hmc_trajectory<BODY, METRIC>(K, q, p, g, vv, vel, lp0, E0, eps, n_steps,
                                            lane LMC_HCLK_ARG);
}

// The draws of one chain block. BLOCK: body 1 with the dense metric on the
// block HMC transition (hmc_block_body), in chain blocks of up to
// kBlockChains compiled for kFusedHmcBlocksPerSm blocks an SM; every other
// instance compiles with no minimum of blocks (0), as it did before the
// block instance: one kernel with the body inline, since a minimum of 1,
// or the body in a device function called by two kernels, changed the
// registers ptxas gave several of the other instances.
template <int BODY, int METRIC, bool BLOCK>
__global__ void __launch_bounds__(32 * (BLOCK ? kBlockChains : kMaxChainBlock),
                                  BLOCK ? kFusedHmcBlocksPerSm : 0)
    fused_hmc_kernel(Args A) {
    extern __shared__ float smem[];
    const int n = A.K.n, cb = A.cb, C = A.C;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int blk = blockIdx.x;
    const int chain = blk * cb + w;
    LMC_CLK_BLOCK_START(C);

    // shared layout: the warp vectors [n_fused_vecs][cb][n]; the pooled
    // Welford means and scratch [5][n] (kDense); the block transition's
    // staged rows (on a 16-byte boundary); then the body's constants (P,
    // or the logistic Xb and y) and COV where they fit, the low-rank factor
    // block, and the generated body's scratch rows where they fit
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
    float* qt = nullptr;
    if constexpr (BLOCK) {
        qt = align16(after);
        after = qt + staged_floats<BODY>(n, cb);
    }

    HmcConsts K = A.K;
    K.lam = stage_body<BODY>(K.lam, n, K.rows, A.lam_in_smem ? after : nullptr);
    if (A.lam_in_smem) after += body_floats(BODY, n, K.rows);
    if (METRIC == kDense && A.cov_in_smem) {
        for (int k = tid; k < n * n; k += nthreads) after[k] = K.cov[k];
        K.cov = after;
        after += (size_t)n * n;
    }
    if constexpr (METRIC == kLowRank) {  // the factor block, in kCov's place
        for (int k = tid; k < lowrank_fac_floats(n); k += nthreads) after[k] = K.cov[k];
        K.cov = after;
        after += lowrank_fac_floats(n);
    }
    set_consts_scratch(K, warp_scratch<BODY>(A.scratch_in_smem ? after : nullptr, w));
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
    LMC_CLK_BEGIN();

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
        if constexpr (METRIC == kDense && BLOCK) {
            // the block's momenta z L^-1 as one block product, each z
            // staged as it is drawn
            const int qt_off = smem_offset(qt), stride = staged_stride(cb);
            for (int i = lane; i < n; i += 32)
                stage(qt_off, stride, w, i, boxmuller_normal(seed0, s1u, w, A.Npad, i));
            __syncthreads();  // every chain's z is staged
            block_matmul<false, false>(qt_off, linv, 0, smem_offset(p) - w * n, n, cb);
            __syncthreads();  // every momentum is written
        } else if constexpr (METRIC == kDense) {
            dense_momentum(seed0, s1u, w, A.Npad, linv, z, p, n, lane);
        } else if constexpr (METRIC == kLowRank) {
            for (int i = lane; i < n; i += 32) scales[i] = sqrtf(vrow[i]);
            lowrank_momentum(seed0, s1u, w, A.Npad, scales, K.cov, z, p, n, lane);
        } else {
            diag_momentum(seed0, s1u, w, A.Npad, vel, p, n, lane);
        }
        LMC_CLK(kHClkMomentum);
        // 2. the jittered path length and the step count (hmc.py:141-143)
        const float eps = expf(A.adapting ? da.log_step : da.log_bar);
        const uint32_t salt = fmix32((seed0 + (uint32_t)w * 101027u) ^ s1u);
        const float path_length = counter_uniform(salt, 3u) * A.path_length;
        const float nst = fminf(fmaxf(floorf(path_length / eps), 1.0f), (float)A.max_steps);
        // 3. the trajectory from the chain's state, and the accept
        const float* vv = METRIC == kDiag ? vel : scales;
        float* vscratch = METRIC != kDiag ? vel : nullptr;
        LMC_CLK(kHClkOther);
        const float E0 = start_energy<METRIC, BLOCK>(K, cb, qt, w, p, vv, vscratch,
                                                     lane LMC_HCLK_ARG) - lp;
        for (int i = lane; i < n; i += 32) { q[i] = qs[i]; g[i] = gs[i]; }
        __syncwarp();
        LMC_CLK(kHClkOther);
        const HmcResult r = trajectory_of<BODY, METRIC, BLOCK>(K, cb, qt, w, q, p, g, vv,
                                                               vscratch, lp, E0, eps, (int)nst,
                                                               lane LMC_HCLK_ARG);
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
        LMC_CLK(kHClkOther);
        if (METRIC != kDense && A.adapt_metric && A.tuning)
            dw.update(qs, wrows, vrow, n, A.mult, lane);
        LMC_CLK(kHClkWelford);
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
        LMC_CLK(kHClkOther);
        if (METRIC == kDense && A.adapt_dense) {
            LMC_HCLK_WAIT();
            wel.add_and_swap(warp_vec(smem, 0, cb, 0, n), wel_sh,
                             arg<float>(A, kFgRaw) + (size_t)blk * n * n,
                             arg<float>(A, kBgRaw) + (size_t)blk * n * n, cb, n, A.mult, tid,
                             nthreads);
            LMC_CLK(kHClkWelford);
        }
    }
    LMC_HCLK_WAIT();
    LMC_CLK_FLUSH(chain, lane);

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
    LMC_CLK_BLOCK_END(C);
}

// A chain's scalars in the register instances: its logp and iteration
// count, dual averaging and the diag Welford weights and counters, loaded
// from and stored to its row of the (C, 16) state. These helpers (and
// hmc_result, store_stats) serve the register instances only:
// fused_hmc_kernel keeps its own inline code, so that its instances
// compile to the registers they had before (their ptxas lines are held by
// tests/test_torch_cuda.py).
struct ChainScalars {
    float lp, iter;
    DualAverage da;
    DiagWelford dw;
};

__device__ __forceinline__ void store_scalars(const Args& A, int chain, const ChainScalars& S) {
    float* so = arg<float>(A, kScalOut) + (size_t)chain * kNumScal;
    for (int k = 0; k < kNumScal; ++k) so[k] = 0.f;
    so[sLogp] = S.lp; so[sIter] = S.iter; so[sLogStep] = S.da.log_step;
    so[sLogBar] = S.da.log_bar; so[sHbar] = S.da.hbar; so[sCount] = S.da.count; so[sMu] = S.da.mu;
    so[sFw] = S.dw.fw; so[sFw2] = S.dw.fw2; so[sBw] = S.dw.bw; so[sBw2] = S.dw.bw2;
    so[sPn] = S.dw.pn; so[sWin] = S.dw.win;
}

__device__ __forceinline__ ChainScalars load_scalars(const Args& A, int chain) {
    const float* sc = arg<const float>(A, kScal) + (size_t)chain * kNumScal;
    return {sc[sLogp], sc[sIter], {sc[sLogStep], sc[sLogBar], sc[sHbar], sc[sCount], sc[sMu]},
            {sc[sFw], sc[sFw2], sc[sBw], sc[sBw2], sc[sPn], sc[sWin]}};
}

// The draw's end as fused_hmc_kernel's: the energy error, the divergence
// and the accept statistic from the start and end energies (hmc.py:158).
__device__ __forceinline__ HmcResult hmc_result(float lp, float en, float E0, float Emax) {
    HmcResult r;
    r.lp = lp;
    r.en = en;
    float dE = E0 - r.en;
    if (isnan(dE)) dE = -CUDART_INF_F;
    r.dE = dE;
    r.div = !isfinite(r.en) || fabsf(dE) > Emax;
    r.acc = fminf(1.0f, expf(dE));
    return r;
}

// One draw's per-draw stats (4., at :82-84) for the chain at column o of
// the (T, C) rows.
__device__ __forceinline__ void store_stats(const Args& A, size_t o, const DualAverage& da,
                                            const HmcResult& r, float path_length, float nst,
                                            bool accepted) {
    const size_t TC = (size_t)A.T * A.C;
    float* stf = arg<float>(A, kStatF);
    stf[oStep * TC + o] = expf(da.log_step);
    stf[oStepBar * TC + o] = expf(da.log_bar);
    stf[oAccept * TC + o] = r.acc;
    stf[oEnergyErr * TC + o] = r.dE;
    stf[oEnergy * TC + o] = r.en;
    stf[oPathLength * TC + o] = path_length;
    stf[oLogp * TC + o] = r.lp;
    arg<int>(A, kStatI)[o] = (int)nst;
    arg<bool>(A, kStatB)[o] = r.div;
    arg<bool>(A, kStatB)[TC + o] = accepted;
}

// ---------------------------------------------------------------------------
// Row 4c: body 4 (the spiked Gaussian) with the pooled low-rank metric, one
// warp a chain and every vector of the chain in registers: lane l holds
// columns i = l + 32 k (k < kRegTrips, n <= 128) of q, p, the gradient,
// the chain's variances V and scales S = sqrt(V), the body's 1/s, the
// Welford rows, and both thin factors' columns (the metric's kMaxRank rows
// of V^T and the body's spike rows), read once a launch. A leapfrog stage
// is two passes over the registers and two butterflies, with no shared
// memory and no __syncwarp: (a) the drift velocity S(alpha x + V d) from
// the metric's dots d, the drift, and the spike dots' partials of q / s;
// their butterfly; (b) the gradient, the stage's kick (and after a step's
// last stage the next step's opening kick, a separate add) and the
// metric's dots' partials of S p; their butterfly. q.grad, which only the
// last evaluation's logp needs, is summed once after the last step, with
// the end energy. The momentum and the start energy run in three passes
// (lowrank_momentum and lowrank_velocity in registers), the third with the
// first opening kick. Each element's formula and each sum's order are
// lowrank_momentum's, lowrank_velocity's, model_eval<4>'s and
// hmc_trajectory's, so the bits are fused_hmc_kernel<4, kLowRank>'s. Each
// warp runs its own chain's step count. Chain blocks of up to
// kBlockChains, one block an SM (up to 255 registers); larger blocks and n
// above 128 run the warp instance.
template <int BODY>
__global__ void __launch_bounds__(32 * kBlockChains, 1) fused_hmc_lowrank_kernel(Args A) {
    static_assert(hmc_register_body<BODY, kLowRank>(), "body 4 with the low-rank metric");
    constexpr int R = kMaxRank, K = kRegTrips;
    // the factor's lam - alpha and lam^-1/2 - alpha^-1/2, the spikes' 1/lam - 1
    __shared__ float coef[3 * R];
    const int n = A.K.n, C = A.C, rows = A.K.rows, stages = A.K.n_stages;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int blk = blockIdx.x;
    const int chain = blk * A.cb + w;
    LMC_CLK_BLOCK_START(C);
    const float* fac = A.K.cov;
    const float* vk_g = A.K.lam;  // the spikes' V^T, rows x n
    const float* il = vk_g + (size_t)rows * n;
    const float* inv_s = il + rows;
    if (threadIdx.x < R) {
        const int j = threadIdx.x;
        coef[j] = fac[(size_t)R * n + j];
        coef[R + j] = fac[(size_t)R * (n + 1) + j];
        coef[2 * R + j] = j < rows ? il[j] : 0.f;
    }
    const float* cvel = coef;
    const float* cmom = coef + R;
    const float* cil = coef + 2 * R;
    const float alpha = fac[(size_t)R * (n + 2)], ah = fac[(size_t)R * (n + 2) + 1];
    float vt[K][R], vk[K][R], is[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k;
        const bool ok = i < n;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            vt[k][j] = ok ? fac[(size_t)j * n + i] : 0.f;
            vk[k][j] = ok && j < rows ? vk_g[(size_t)j * n + i] : 0.f;
        }
        is[k] = ok ? inv_s[i] : 0.f;
    }

    // the chain's state: q, grad, the variances and the Welford rows
    const size_t row = (size_t)chain * n, CN = (size_t)C * n;
    const float* vin = arg<const float>(A, kVar) + row;
    float qs[K], gs[K], V[K], fgm[K], fgv[K], bgm[K], bgv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k;
        const bool ok = i < n, wel = ok && A.adapt_metric;
        qs[k] = ok ? arg<const float>(A, kQ)[row + i] : 0.f;
        gs[k] = ok ? arg<const float>(A, kG)[row + i] : 0.f;
        V[k] = ok ? vin[i] : 1.f;
        fgm[k] = wel ? vin[CN + i] : 0.f;
        fgv[k] = wel ? vin[2 * CN + i] : 0.f;
        bgm[k] = wel ? vin[3 * CN + i] : 0.f;
        bgv[k] = wel ? vin[4 * CN + i] : 0.f;
    }
    ChainScalars S = load_scalars(A, chain);
    __syncthreads();  // coef
    LMC_CLK_BEGIN();

    const uint32_t s1u = A.seed1 * kGolden;
    float* trace = arg<float>(A, kTrace);
    const float b0 = A.K.b[0], b1 = A.K.b[1], b2 = A.K.b[2], b3 = A.K.b[3];
    const float a0 = A.K.a[0], a1 = A.K.a[1], a2 = A.K.a[2];

    for (int t = 0; t < A.T; ++t) {
        const uint32_t seed0 = A.seed0 + (uint32_t)blk * 7919u + (uint32_t)t * 15485863u;

        // 1. the momentum (lowrank_momentum): the scales, the normals z and
        // the dots V^T z; then p = S^-1 (alpha^-1/2 z + V c) and the dots
        // V^T (S p) of the start energy's velocity
        float s[K], z[K], p[K], c[R], d[R];
#pragma unroll
        for (int j = 0; j < R; ++j) c[j] = d[j] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int i = lane + 32 * k;
            s[k] = z[k] = p[k] = 0.f;
            if (i < n) {
                s[k] = sqrtf(V[k]);
                z[k] = boxmuller_normal(seed0, s1u, w, A.Npad, i);
#pragma unroll
                for (int j = 0; j < R; ++j) c[j] = c[j] + z[k] * vt[k][j];
            }
        }
        warp_sums(c);
#pragma unroll
        for (int j = 0; j < R; ++j) c[j] = c[j] * cmom[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (lane + 32 * k < n) {
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < R; ++j) acc = acc + vt[k][j] * c[j];
                p[k] = (ah * z[k] + acc) / s[k];
                const float x = p[k] * s[k];
#pragma unroll
                for (int j = 0; j < R; ++j) d[j] = d[j] + x * vt[k][j];
            }
        }
        warp_sums(d);
        LMC_CLK(kHClkMomentum);
        // 2. the jittered path length and the step count (hmc.py:141-143)
        const float eps = expf(A.adapting ? S.da.log_step : S.da.log_bar);
        const uint32_t salt = fmix32((seed0 + (uint32_t)w * 101027u) ^ s1u);
        const float path_length = counter_uniform(salt, 3u) * A.path_length;
        const float nst = fminf(fmaxf(floorf(path_length / eps), 1.0f), (float)A.max_steps);
        const int n_steps = (int)nst;
        const float kick0 = b0 * eps;
        // 3. the start energy p.(velocity of p), the first step's opening
        // kick and the metric's dots of the kicked p, in one pass
        float q[K], g[K], sums[1 + R];
#pragma unroll
        for (int j = 0; j <= R; ++j) sums[j] = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = d[j] * cvel[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            q[k] = qs[k];
            g[k] = gs[k];
            if (lane + 32 * k < n) {
                const float x = s[k] * p[k];
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < R; ++j) acc = acc + vt[k][j] * d[j];
                const float v = s[k] * (alpha * x + acc);
                sums[0] += p[k] * v;
                p[k] = p[k] + kick0 * g[k];
                const float xp = p[k] * s[k];
#pragma unroll
                for (int j = 0; j < R; ++j) sums[1 + j] = sums[1 + j] + xp * vt[k][j];
            }
        }
        warp_sums(sums);
        const float E0 = 0.5f * sums[0] - S.lp;
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = sums[1 + j];
        LMC_CLK(kHClkEnergy);

        // the trajectory: n_steps symplectic steps (integration.py:100-121)
        for (int st = 0; st < n_steps; ++st) {
            LMC_HCLK_STEP(true);
            for (int sg = 0; sg < stages; ++sg) {
                const float drift = (sg == 0 ? a0 : sg == 1 ? a1 : a2) * eps;
                // (a) the velocity, the drift, the spike dots of q / s
                float cs[R];
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    d[j] = d[j] * cvel[j];
                    cs[j] = 0.f;
                }
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    if (lane + 32 * k < n) {
                        const float x = s[k] * p[k];
                        float acc = 0.f;
#pragma unroll
                        for (int j = 0; j < R; ++j) acc = acc + vt[k][j] * d[j];
                        const float v = s[k] * (alpha * x + acc);
                        q[k] = q[k] + drift * v;
                        const float xb = q[k] * is[k];
#pragma unroll
                        for (int j = 0; j < R; ++j)
                            if (j < rows) cs[j] = cs[j] + xb * vk[k][j];
                    }
                }
                LMC_CLK(kHClkKickDrift);
                // the spike dots' butterfly, each dot with warp_sum's bits:
                // unconditional shuffles (the columns past `rows` are
                // zeros), 4 or 8 columns by one branch around them
                if (rows <= 4)
                    warp_sums_head<4>(cs);
                else
                    warp_sums_head<R>(cs);
#pragma unroll
                for (int j = 0; j < R; ++j)
                    if (j < rows) cs[j] = cs[j] * cil[j];
                LMC_CLK(kHClkBody);
                // (b) the gradient, the kick(s), the metric's dots of S p
                const float kick = (sg == 0 ? b1 : sg == 1 ? b2 : b3) * eps;
                const bool open = sg + 1 == stages && st + 1 < n_steps;
#pragma unroll
                for (int j = 0; j < R; ++j) d[j] = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    if (lane + 32 * k < n) {
                        const float x = q[k] * is[k];
                        float acc = 0.f;
#pragma unroll
                        for (int j = 0; j < R; ++j)
                            if (j < rows) acc = acc + vk[k][j] * cs[j];
                        const float gk = -(x + acc) * is[k];
                        g[k] = gk;
                        p[k] = p[k] + kick * gk;
                        if (open) p[k] = p[k] + kick0 * gk;
                        const float xp = p[k] * s[k];
#pragma unroll
                        for (int j = 0; j < R; ++j) d[j] = d[j] + xp * vt[k][j];
                    }
                }
                LMC_CLK(kHClkKickDrift);
                warp_sums(d);
                LMC_CLK(kHClkVelocity);
            }
        }
        // the end: logp = q.grad / 2 of the last evaluation, the end energy
        float ends[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = d[j] * cvel[j];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (lane + 32 * k < n) {
                ends[0] += q[k] * g[k];
                const float x = s[k] * p[k];
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < R; ++j) acc = acc + vt[k][j] * d[j];
                const float v = s[k] * (alpha * x + acc);
                ends[1] += p[k] * v;
            }
        }
        warp_sums(ends);
        const float lp_end = 0.5f * ends[0];
        const HmcResult r = hmc_result(lp_end, 0.5f * ends[1] - lp_end, E0, A.K.Emax);
        LMC_CLK(kHClkEnergy);
        const bool accepted = !r.div && counter_uniform(salt, 4u) < r.acc;
        // 5. dual averaging, the chain's advance, 7. the trace row
        if (A.adapting) S.da.update(r.acc, A.target, A.gamma, A.k, A.t0);
        S.iter = S.iter + 1.0f;
        if (accepted) S.lp = r.lp;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int i = lane + 32 * k;
            if (accepted) { qs[k] = q[k]; gs[k] = g[k]; }
            if (trace && i < n) trace[((size_t)t * C + chain) * n + i] = qs[k];
        }
        LMC_CLK(kHClkOther);
        // 6. with adapt_metric, the chain's Welford step on the selected state
        if (A.adapt_metric && A.tuning) {
            const bool swap = S.dw.swap_due();
#pragma unroll
            for (int k = 0; k < K; ++k)
                if (lane + 32 * k < n) S.dw.column(qs[k], fgm[k], fgv[k], bgm[k], bgv[k], V[k], swap);
            S.dw.advance(swap, A.mult);
        }
        LMC_CLK(kHClkWelford);
        // 4. per-draw stats
        if (lane == 0) store_stats(A, (size_t)t * C + chain, S.da, r, path_length, nst, accepted);
        LMC_CLK(kHClkOther);
    }
    LMC_HCLK_WAIT();
    LMC_CLK_FLUSH(chain, lane);

    // the final state
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k;
        if (i < n) {
            arg<float>(A, kQOut)[row + i] = qs[k];
            arg<float>(A, kGOut)[row + i] = gs[k];
            if (A.adapt_metric) {
                float* vout = arg<float>(A, kVarOut) + row;
                vout[i] = V[k];
                vout[CN + i] = fgm[k];
                vout[2 * CN + i] = fgv[k];
                vout[3 * CN + i] = bgm[k];
                vout[4 * CN + i] = bgv[k];
            }
        }
    }
    if (lane == 0) store_scalars(A, chain, S);
    LMC_CLK_BLOCK_END(C);
}

// ---------------------------------------------------------------------------
// Row 4b: eight schools (body 2, n = 10) with the per-chain diagonal metric,
// kEsHmcChainsPerWarp chains a warp (the JAX kernel's lane packing, `pack`
// at fused_hmc_pallas.py:132): the chain w of the chain block sits on the
// segment w % kEsHmcChainsPerWarp of warp w / kEsHmcChainsPerWarp, lane j of
// its segment holding column j's q, p, gradient, inverse mass V, the body's
// y_j and 1/sigma_j^2 and the four Welford rows in registers. A thread
// block is still the counter stream's chain block (its seed word and row
// stream), of ceil(cb / kEsHmcChainsPerWarp) warps; a segment past the
// block's chains computes with the rest and writes nothing. The warp's
// chains integrate in lockstep to their longest count, each frozen past its
// own. A stage: the kick (a step's first) and the drift in the lane's
// registers, mu and log_tau by two shuffles from the segment's lanes 0 and
// 1, the body's gradient sums (resid, resid tt) in one segmented butterfly
// (segment_sums), the gradient and the kick; the body's other two sums
// (tt^2, dy resid), which only the last evaluation's logp needs, with the
// end energy's, once after the last step, at the same q. Each element's
// formula and each sum's bits are model_eval<2>'s, half_kinetic's and
// hmc_trajectory's, so the bits are the warp instance's.
template <int BODY>
__global__ void __launch_bounds__(32 * kEsHmcMaxWarps, kEsHmcMinBlocks)
    fused_hmc_packed_kernel(Args A) {
    static_assert(hmc_packed_body<BODY, kDiag>(), "eight schools with the diagonal metric");
    constexpr int L = kEsHmcLanes, CPW = kEsHmcChainsPerWarp;
    const int n = A.K.n, cb = A.cb, C = A.C, stages = A.K.n_stages;
    const int lane = threadIdx.x & 31, seg = lane / L, i = lane - seg * L, base = lane - i;
    const int w = (threadIdx.x >> 5) * CPW + seg;
    const bool valid = seg < CPW && w < cb, own = valid && i < n;
    const int blk = blockIdx.x;
    const int chain = blk * cb + w;
    LMC_CLK_BLOCK_START(C);
    const float es_y = own ? A.K.lam[i] : 0.f, es_is2 = own ? A.K.lam[10 + i] : 0.f;

    const size_t row = (size_t)chain * n + i, CN = (size_t)C * n;
    const float* vin = arg<const float>(A, kVar);
    float qs = 0.f, gs = 0.f, V = 1.f, fgm = 0.f, fgv = 0.f, bgm = 0.f, bgv = 0.f;
    if (own) {
        qs = arg<const float>(A, kQ)[row];
        gs = arg<const float>(A, kG)[row];
        V = vin[row];
        if (A.adapt_metric) {
            fgm = vin[CN + row]; fgv = vin[2 * CN + row];
            bgm = vin[3 * CN + row]; bgv = vin[4 * CN + row];
        }
    }
    ChainScalars S{0.f, 0.f, {0.f, 0.f, 0.f, 1.f, 0.f}, {0.f, 0.f, 0.f, 0.f, 0.f, 1.f}};
    if (valid) S = load_scalars(A, chain);
    LMC_CLK_BEGIN();

    const uint32_t s1u = A.seed1 * kGolden;
    float* trace = arg<float>(A, kTrace);
    const float b0 = A.K.b[0], b1 = A.K.b[1], b2 = A.K.b[2], b3 = A.K.b[3];
    const float a0 = A.K.a[0], a1 = A.K.a[1], a2 = A.K.a[2];

    for (int t = 0; t < A.T; ++t) {
        const uint32_t seed0 = A.seed0 + (uint32_t)blk * 7919u + (uint32_t)t * 15485863u;
        // 1. the momentum p = z / sqrt(V) (diag_momentum)
        float p = own ? boxmuller_normal(seed0, s1u, w, A.Npad, i) / sqrtf(V) : 0.f;
        LMC_CLK(kHClkMomentum);
        // 2. the jittered path length and the step count (hmc.py:141-143)
        const float eps = expf(A.adapting ? S.da.log_step : S.da.log_bar);
        const uint32_t salt = fmix32((seed0 + (uint32_t)w * 101027u) ^ s1u);
        const float path_length = counter_uniform(salt, 3u) * A.path_length;
        const float nst = fminf(fmaxf(floorf(path_length / eps), 1.0f), (float)A.max_steps);
        // 3. the start energy p.(V p) / 2, then the trajectory to the warp's
        // longest count
        float e[1] = {0.f};
        if (own) e[0] += p * (V * p);
        segment_sums<L>(e, lane);
        const float E0 = 0.5f * e[0] - S.lp;
        float q = qs, g = gs;
        const int n_steps = valid ? (int)nst : 0;
        const int steps = (int)__reduce_max_sync(0xffffffffu, (unsigned)n_steps);
        const float kick0 = b0 * eps;
        LMC_CLK(kHClkEnergy);
        for (int st = 0; st < steps; ++st) {
            const bool live = st < n_steps;
            LMC_HCLK_STEP(live);
            if (live) p = p + kick0 * g;
            for (int sg = 0; sg < stages; ++sg) {
                const float drift = (sg == 0 ? a0 : sg == 1 ? a1 : a2) * eps;
                if (live) q = q + drift * (V * p);
                LMC_HCLK_LIVE(live, kHClkKickDrift);
                const float mu = __shfl_sync(0xffffffffu, q, base);
                const float log_tau = __shfl_sync(0xffffffffu, q, base + 1);
                const float tau = expf(log_tau);
                float sums[2] = {0.f, 0.f};  // resid, resid tt
                float dtt = 0.f;
                if (own) {
                    const float tt = i >= 2 ? q : 0.f;
                    const float theta = mu + tau * tt;
                    const float dy = es_y - theta;
                    const float resid = dy * es_is2;
                    sums[0] = resid;
                    sums[1] = resid * tt;
                    dtt = -tt + tau * resid;
                }
                segment_sums<L>(sums, lane);
                if (live && own)
                    g = i == 0 ? -mu / 25.0f + sums[0]
                      : i == 1 ? -log_tau / 25.0f + tau * sums[1] : dtt;
                const float kick = (sg == 0 ? b1 : sg == 1 ? b2 : b3) * eps;
                if (live) p = p + kick * g;
                LMC_HCLK_LIVE(live, kHClkBody);
            }
        }
        // the end: the last evaluation's logp (model_eval<2>'s tt^2 and dy
        // resid at the final q) and the end energy
        const float mu = __shfl_sync(0xffffffffu, q, base);
        const float log_tau = __shfl_sync(0xffffffffu, q, base + 1);
        const float tau = expf(log_tau);
        float ends[3] = {0.f, 0.f, 0.f};  // tt^2, dy resid, p.(V p)
        if (own) {
            const float tt = i >= 2 ? q : 0.f;
            const float theta = mu + tau * tt;
            const float dy = es_y - theta;
            const float resid = dy * es_is2;
            ends[0] = tt * tt;
            ends[1] = dy * resid;
            ends[2] += p * (V * p);
        }
        segment_sums<L>(ends, lane);
        const float m5 = mu / 5.0f, l5 = log_tau / 5.0f;
        const float lp_end = -0.5f * (m5 * m5) - 0.5f * (l5 * l5) - 0.5f * ends[0] - 0.5f * ends[1];
        const HmcResult r = hmc_result(lp_end, 0.5f * ends[2] - lp_end, E0, A.K.Emax);
        LMC_CLK(kHClkEnergy);
        const bool accepted = !r.div && counter_uniform(salt, 4u) < r.acc;
        // 5. dual averaging, the chain's advance, 7. the trace row
        if (A.adapting) S.da.update(r.acc, A.target, A.gamma, A.k, A.t0);
        S.iter = S.iter + 1.0f;
        if (accepted) { S.lp = r.lp; qs = q; gs = g; }
        if (trace && own) trace[((size_t)t * C + chain) * n + i] = qs;
        LMC_CLK(kHClkOther);
        // 6. with adapt_metric, the chain's Welford step on the selected state
        if (A.adapt_metric && A.tuning) {
            const bool swap = S.dw.swap_due();
            if (own) S.dw.column(qs, fgm, fgv, bgm, bgv, V, swap);
            S.dw.advance(swap, A.mult);
        }
        LMC_CLK(kHClkWelford);
        // 4. per-draw stats
        if (valid && i == 0)
            store_stats(A, (size_t)t * C + chain, S.da, r, path_length, nst, accepted);
        LMC_CLK(kHClkOther);
    }
    LMC_HCLK_WAIT();
    if (valid) LMC_CLK_FLUSH(chain, i);

    // the final state
    if (own) {
        arg<float>(A, kQOut)[row] = qs;
        arg<float>(A, kGOut)[row] = gs;
        if (A.adapt_metric) {
            float* vout = arg<float>(A, kVarOut);
            vout[row] = V;
            vout[CN + row] = fgm;
            vout[2 * CN + row] = fgv;
            vout[3 * CN + row] = bgm;
            vout[4 * CN + row] = bgv;
        }
    }
    if (valid && i == 0) store_scalars(A, chain, S);
    LMC_CLK_BLOCK_END(C);
}

// 227 KB per block on Hopper; the block instance's less 1 KB for the
// static shared int of block_max_steps
constexpr size_t kSmemLimit = 232448;

template <int BODY, int METRIC, bool BLOCK>
cudaError_t launch_instance(const Args& A0, cudaStream_t stream) {
    Args A = A0;
    const int n = A.K.n;
    constexpr size_t limit = BLOCK ? kSmemLimit - 1024 : kSmemLimit;
    size_t bytes = ((size_t)n_fused_vecs<METRIC>() * A.cb * n
                    + (METRIC == kDense ? (size_t)5 * n : 0)
                    + (METRIC == kLowRank ? (size_t)lowrank_fac_floats(n) : 0)) * sizeof(float);
    if (BLOCK)  // the staged positions, moved up to 12 bytes to a 16-byte boundary
        bytes += 12 + staged_floats<BODY>(n, A.cb) * sizeof(float);
    const size_t sq_bytes = (size_t)n * n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, n, A.K.rows) * sizeof(float);
    A.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= limit) ? 1 : 0;
    if (A.lam_in_smem) bytes += body_bytes;
    A.cov_in_smem = (METRIC == kDense && bytes + sq_bytes <= limit) ? 1 : 0;
    if (A.cov_in_smem) bytes += sq_bytes;
    A.scratch_in_smem = scratch_fits<BODY>(bytes, A.cb, limit) ? 1 : 0;
    if (A.scratch_in_smem) bytes += (size_t)body_scratch_floats<BODY>() * A.cb * sizeof(float);
    if (bytes > limit) return cudaErrorInvalidConfiguration;
    const auto kernel = fused_hmc_kernel<BODY, METRIC, BLOCK>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    err = record_residency<BODY, METRIC, BLOCK>(kernel, 32 * A.cb, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<A.C / A.cb, 32 * A.cb, bytes, stream>>>(A);
    return cudaGetLastError();
}

// A register instance (fused_hmc_lowrank_kernel, fused_hmc_packed_kernel):
// `threads` a block, no dynamic shared memory.
template <int BODY, int METRIC, class Kernel>
cudaError_t launch_registers(Kernel kernel, const Args& A, int threads, cudaStream_t stream) {
    cudaError_t err = record_residency<BODY, METRIC, true>(kernel, threads, 0);
    if (err != cudaSuccess) return err;
    kernel<<<A.C / A.cb, threads, 0, stream>>>(A);
    return cudaGetLastError();
}

// Body 1 with the dense metric in chain blocks of up to kBlockChains runs
// the block instance, in larger blocks the warp one; body 4 with the
// low-rank metric the register instance where it fits (hmc_register_fits),
// else the warp one; eight schools with the diagonal metric the packed
// instance (its warp instance is not compiled).
template <int BODY, int METRIC>
cudaError_t launch(const Args& A, cudaStream_t stream) {
    if constexpr (hmc_block_body<BODY, METRIC, true>())
        if (A.cb <= kBlockChains) return launch_instance<BODY, METRIC, true>(A, stream);
    if constexpr (hmc_register_body<BODY, METRIC>())
        if (hmc_register_fits(A.cb, A.K.n))
            return launch_registers<BODY, METRIC>(fused_hmc_lowrank_kernel<BODY>, A, 32 * A.cb,
                                                  stream);
    if constexpr (hmc_packed_body<BODY, METRIC>())
        return launch_registers<BODY, METRIC>(
            fused_hmc_packed_kernel<BODY>, A,
            32 * ((A.cb + kEsHmcChainsPerWarp - 1) / kEsHmcChainsPerWarp), stream);
    else
        return launch_instance<BODY, METRIC, false>(A, stream);
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
    A.scratch_in_smem = 0;
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

// Blocks an SM of the last launch (nuts_transition.cuh, last_blocks_per_sm).
int fused_hmc_last_blocks_per_sm(void) {
    return lmc::last_blocks_per_sm;
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LMC_TRANSITION_CLOCKS
// The instrumented build's side buffer (nuts_transition.cuh, clock_buf).
int transition_clocks_bind(void* buf) {
    return (int)cudaMemcpyToSymbol(lmc::clock_buf, &buf, sizeof(buf));
}
#endif

}  // extern "C"
