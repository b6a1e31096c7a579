// T NUTS transitions per launch: the fused multi-draw kernel, for a
// shared dense metric, a per-chain inverse-mass diagonal or the pooled
// low-rank metric.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/fused_nuts_pallas.py::
// build_fused_nuts_op (kernel :561, pallas_call at :978) for metric="dense",
// static (draw chunks) and with adapt_dense (pooled dense adaptation in
// tune chunks), for metric="diag", static and with adapt_metric (the
// per-chain dual-window Welford adaptation in tune chunks), and for
// metric="lowrank" (:493-531, :669-710): the per-chain variance rows V
// adapted as kDiag's, the chain's scales sqrt(V) recomputed each draw, and
// one factor block frozen for the launch and staged in shared memory. The plain
// PyTorch version it is held against is ops/fused_nuts.py::fused_nuts_plain.
//
// Mapping. One thread block is one chain block of CB chains, one warp per
// chain, as in the per-draw kernel; the block loops t = 0..T-1 inside the
// launch, where the TPU kernel's grid walks its sequential draw axis. The
// chain state (q, grad in shared memory; logp, the iteration counter, the
// dual-averaging state and the diag Welford counters in registers, the
// same bits in every lane of the warp) stays on chip across draws, as the
// TPU kernel keeps it in VMEM scratch (:635-657, :773-795). Per draw and
// chain:
//   1. Box-Muller normals z from the momentum stream, salted seed0 +
//      1013904223 with lane_r = row * Npad + col (:700-705);
//   2. the momentum p = z @ L^-1 (kDense, row convention, :154-166),
//      p = z / sqrt(V) (kDiag, :143-151, :712) or the low-rank
//      S^-1 (alpha^-1/2 z + V((lam^-1/2 - alpha^-1/2).(V^T z))) (kLowRank,
//      :169-192, S = sqrt(V));
//   3. E0 = p.(p @ COV)/2 - logp, p.(V p)/2 - logp, or with the low-rank
//      velocity;
//   4. the step size and depth cap from the iteration counter (:716-723);
//   5. the transition of nuts_transition.cuh, with its counter restarted;
//   6. the gradient recomputed at the proposal (:731);
//   7. mean_tree_accept, then dual averaging (:734-750);
//   8. tune chunks, kDiag and kLowRank with adapt_metric: the chain's
//      Welford step on its proposal, which refreshes V for the next draw
//      from the pre-swap foreground (:753-757); kDense with adapt_dense: the block's CB new
//      positions are Chan-combined into the block-local pooled Welford
//      state of both windows, then the shared window swap (:758-764);
//   9. the trace row and the per-draw stats, written to (T, C) outputs.
// The per-draw seed word is seed0 = w0 + block*7919 + t*15485863 (:662).
//
// Where the state lives, and why. kDense at n = 100 and CB = 8: the
// transition's 16 vectors and the chain's q and grad (18 x CB x n floats,
// 58 KB), the slot scalars (1.3 KB), the Welford means and shifts (5 x n
// floats), the precision P (40 KB) and COV (40 KB) sit in shared memory:
// 141 KB of the 227 KB a block may use. L^-1 (40 KB) is read once per
// draw, so it stays in global memory, where L2 holds it. The block-local
// raw scatters of the two windows (2 x n x n floats a block, 10 MB at 128
// blocks) live in the per-block output tensors, which the wrapper seeds
// with 1/B of the global state and the kernel updates in place; they too
// stay in L2. kDiag: the transition's 12 vectors (V among them), q, grad,
// the start momentum and the chain's four Welford rows, 19 x CB x n
// floats (2.4 KB a block at the eight-schools n = 10, 61 KB at n = 100),
// read from device memory once a launch and written back once. kLowRank:
// the transition's 17 vectors (the scales among them), q, grad, the start
// momentum, the four Welford rows and V, 25 x CB x n floats (80 KB at
// n = 100 and CB = 8), and the factor block (3.3 KB).
//
// What bounds it on this card. Per chain and draw: the momentum (kDense
// 2n^2 FLOP, kDiag about 10n with the Box-Muller transcendentals), per
// leaf the model body (2n^2 for the correlated Gaussian, about 15n for the
// eight schools) and for kDense 2n^2 for the velocity, plus about 20n
// elementwise, the final gradient, and in tune 4n^2 (kDense, pooled) or
// about 12n (kDiag) for the Welford adds; all fp32 outside the tensor
// cores, against the state read once and the trace and stats written once
// to device memory. The design keeps the state on chip across the T
// draws, so device memory sees only the trace.
//
// The momenta, dual averaging and both Welford states are the helpers of
// fused_common.cuh, which the fused HMC kernel shares.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit in the matvecs).

#include "fused_common.cuh"
#include "nuts_transition.cuh"

namespace {

using namespace lmc;

// pointer arguments, in the order of ops/fused_nuts.py::_PTRS
enum {
    kQ, kG, kScal, kCov, kLinv, kVar, kConsts, kStack,
    kQOut, kGOut, kScalOut, kVarOut, kTrace, kStatF, kStatI, kStatB,
    kWSeed, kFgMean, kFgRaw, kBgMean, kBgRaw, kWOut, kNumPtrs
};
// int arguments, in the order of ops/fused_nuts.py::_INTS
enum {
    iC, iN, iD, iT, iCb, iStages, iBody, iMetric, iTuning, iAdapting, iAdaptMetric,
    iAdaptDense, iEarlyWindow, iEarlyMax, iMaxDepth, iSeed0, iSeed1, iNpad, iRows, kNumInts
};
// float arguments, in the order of ops/fused_nuts.py::_FLOATS
enum {
    fEmax, fB0, fB1, fB2, fB3, fA0, fA1, fA2, fTarget, fGamma, fK, fT0, fMult, kNumFloats
};
// per-chain scalar columns of the (C, 16) state in/out: the chain, dual
// averaging, and the diag Welford weights and counters (adapt_metric)
enum {
    sLogp, sIter, sLogStep, sLogBar, sHbar, sCount, sMu,
    sFw = 8, sFw2, sBw, sBw2, sPn, sWin, kNumScal = 16
};
// per-draw f32 stats, each (T, C)
enum { oEnergy, oLogp, oEnergyErr, oAccept, oStep, oStepBar, oMaxErr, kNumStatF };

struct Args {
    const float* ptr_f[kNumPtrs];
    int C, n, D, T, cb, n_stages, tuning, adapting, adapt_metric, adapt_dense;
    int early_window, early_max, max_depth, Npad, rows;
    uint32_t seed0, seed1;
    float Emax, b[4], a[3], target, gamma, k, t0, mult;
    int lam_in_smem, cov_in_smem;
};

// log(1 - exp(-x)) for x > 0, the fused JAX kernel's formula (:113-131)
__device__ __forceinline__ float log1mexp_fused(float x) {
    if (x < 0.683f) {
        if (x < 1e-4f) return logf(fmaxf(x, 1e-30f)) - 0.5f * x;
        return logf(fmaxf(1.0f - expf(-x), 1e-30f));
    }
    return logf(1.0f - expf(-x));
}

// vectors a warp keeps in shared memory: the transition's, then the
// chain's q and grad, then for kDiag and kLowRank the start momentum and
// the four Welford rows, and for kLowRank the variances V (kDiag keeps V in
// the transition's vv; for kDense the momentum is a transition scratch
// vector)
template <int METRIC>
__host__ __device__ constexpr int n_fused_vecs() {
    return n_warp_vecs<METRIC>() + (METRIC == kDense ? 2 : METRIC == kDiag ? 7 : 8);
}

// kLowRank instances take 8 warps a block (max_chain_block,
// nuts_transition.cuh), so that ptxas may give a thread more than 128
// registers
template <int BODY, int METRIC>
__global__ void __launch_bounds__(32 * max_chain_block<METRIC>()) fused_nuts_kernel(Args A) {
    extern __shared__ float smem[];
    const int n = A.n, cb = A.cb, D = A.D, C = A.C;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int blk = blockIdx.x;
    const int chain = blk * cb + w;
    constexpr int NV = n_warp_vecs<METRIC>();

    // shared layout: the warp vectors [n_fused_vecs][cb][n], the slot
    // scalars [4][D][cb], the pooled Welford fg and bg means, the batch
    // mean and the two mean shifts [5][n] (kDense), then the body's constants
    // (P, or the logistic Xb and y) and COV where they fit
    const WarpVecs V = warp_vecs<METRIC>(smem, cb, w, n);
    float* qs = warp_vec(smem, NV, cb, w, n);
    float* gs = warp_vec(smem, NV + 1, cb, w, n);
    // the start momentum: a velocity scratch vector (kDense) or its own
    float* p0 = METRIC == kDense ? V.vb : warp_vec(smem, NV + 2, cb, w, n);
    DiagWelford::Rows wrows{warp_vec(smem, NV + 3, cb, w, n), warp_vec(smem, NV + 4, cb, w, n),
                            warp_vec(smem, NV + 5, cb, w, n), warp_vec(smem, NV + 6, cb, w, n)};
    // the chain's variances: kDiag's inverse mass, or kLowRank's V, whose
    // square roots are the scales in vv
    float* vrow = METRIC == kLowRank ? warp_vec(smem, NV + 7, cb, w, n) : V.vv;
    float* slot_sc = smem + (size_t)n_fused_vecs<METRIC>() * cb * n;
    float* wel_sh = slot_sc + (size_t)4 * D * cb;
    float* after = wel_sh + (METRIC == kDense ? 5 * n : 0);

    TreeConsts T;
    T.lam = stage_body<BODY>(A.ptr_f[kConsts], n, A.rows, A.lam_in_smem ? after : nullptr);
    T.cov = A.ptr_f[kCov];
    T.stack = const_cast<float*>(A.ptr_f[kStack]);
    T.C = C; T.n = n; T.D = D; T.cb = cb; T.n_stages = A.n_stages; T.rows = A.rows;
    T.Emax = A.Emax;
    for (int k = 0; k < 4; ++k) T.b[k] = A.b[k];
    for (int k = 0; k < 3; ++k) T.a[k] = A.a[k];
    if (A.lam_in_smem) after += body_floats(BODY, n, A.rows);
    if (METRIC == kDense && A.cov_in_smem) {
        for (int k = tid; k < n * n; k += nthreads) after[k] = A.ptr_f[kCov][k];
        T.cov = after;
    }
    if constexpr (METRIC == kLowRank) {  // the factor block, in kCov's place
        for (int k = tid; k < lowrank_fac_floats(n); k += nthreads) after[k] = A.ptr_f[kCov][k];
        T.cov = after;
    }
    const float* linv = A.ptr_f[kLinv];

    // the chain's state
    const size_t row = (size_t)chain * n, CN = (size_t)C * n;
    for (int i = lane; i < n; i += 32) {
        qs[i] = A.ptr_f[kQ][row + i];
        gs[i] = A.ptr_f[kG][row + i];
    }
    const float* sc = A.ptr_f[kScal] + (size_t)chain * kNumScal;
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
        const float* vin = A.ptr_f[kVar] + row;
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
    if (A.adapt_dense) wel.load(wel_sh, A.ptr_f[kWSeed], n, tid, nthreads);
    __syncthreads();  // P, COV and the Welford means are in shared memory

    const uint32_t s1u = A.seed1 * kGolden;
    float* trace = const_cast<float*>(A.ptr_f[kTrace]);
    float* stf = const_cast<float*>(A.ptr_f[kStatF]);
    int* sti = reinterpret_cast<int*>(const_cast<float*>(A.ptr_f[kStatI]));
    bool* stb = reinterpret_cast<bool*>(const_cast<float*>(A.ptr_f[kStatB]));
    const size_t TC = (size_t)A.T * C;

    for (int t = 0; t < A.T; ++t) {
        const uint32_t seed0 = A.seed0 + (uint32_t)blk * 7919u + (uint32_t)t * 15485863u;

        // 1-2. momentum: Box-Muller normals, then p = z @ L^-1 (kDense),
        // p = z / sqrt(V) (kDiag) or the low-rank momentum (kLowRank)
        float part = 0.f;
        if constexpr (METRIC == kDense) {
            dense_momentum(seed0 + 1013904223u, s1u, w, A.Npad, linv, V.va, p0, n, lane);
            // 3. start energy
            matvec(p0, T.cov, V.vc, n, lane);
            for (int i = lane; i < n; i += 32) part += p0[i] * V.vc[i];
        } else if constexpr (METRIC == kLowRank) {
            for (int i = lane; i < n; i += 32) V.vv[i] = sqrtf(vrow[i]);
            lowrank_momentum(seed0 + 1013904223u, s1u, w, A.Npad, V.vv, T.cov, V.va, p0, n,
                             lane);
            velocity<kLowRank>(T.cov, V.vv, p0, V.vc, n, lane);
            for (int i = lane; i < n; i += 32) part += p0[i] * V.vc[i];
        } else {
            diag_momentum(seed0 + 1013904223u, s1u, w, A.Npad, V.vv, p0, n, lane);
            for (int i = lane; i < n; i += 32) part += p0[i] * (V.vv[i] * p0[i]);
        }
        const float E0 = 0.5f * warp_sum(part) - lp;
        // 4. step size and depth cap
        const float eps = expf(A.adapting ? da.log_step : da.log_bar);
        const int mdc = (A.tuning && iter < (float)A.early_window) ? A.early_max : A.max_depth;
        // 5. the transition, on the stream salted with seed0
        const uint32_t salt = fmix32((seed0 + (uint32_t)w * 101027u) ^ s1u);
        const TreeResult r = transition<BODY, METRIC>(T, V, slot_sc, chain, w, lane, qs, p0,
                                                      gs, lp, E0, eps, mdc, salt);
        // 6. the proposal's gradient
        model_eval<BODY>(V.prq, V.cg, T.lam, n, A.rows, lane);
        // 7. mean tree accept and dual averaging (step_sizes.py:85-92)
        const float ls = r.log_size;
        const float mta = ls > 0.f ? expf(r.lwas - (ls + log1mexp_fused(ls))) : 0.f;
        if (A.adapting) da.update(mta, A.target, A.gamma, A.k, A.t0);
        // 8a. kDiag tune chunks with adapt_metric: the chain's Welford step
        // on its proposal, which refreshes V for the next draw (:753-757)
        if (METRIC != kDense && A.adapt_metric && A.tuning)
            dw.update(V.prq, wrows, vrow, n, A.mult, lane);
        // advance the chain
        iter = iter + 1.0f;
        lp = r.pr_lp;
        for (int i = lane; i < n; i += 32) {
            const float qi = V.prq[i];
            qs[i] = qi;
            gs[i] = V.cg[i];
            if (trace) trace[((size_t)t * C + chain) * n + i] = qi;
        }
        // 9. per-draw stats
        if (lane == 0) {
            const size_t o = (size_t)t * C + chain;
            stf[oEnergy * TC + o] = r.pr_e;
            stf[oLogp * TC + o] = r.pr_lp;
            stf[oEnergyErr * TC + o] = r.pr_e - E0;
            stf[oAccept * TC + o] = mta;
            stf[oStep * TC + o] = expf(da.log_step);
            stf[oStepBar * TC + o] = expf(da.log_bar);
            stf[oMaxErr * TC + o] = r.mec;
            sti[o] = r.depth;
            sti[TC + o] = r.n_leaves;
            stb[o] = r.diverging;
            stb[TC + o] = r.turning;
        }
        // 8b. kDense with adapt_dense: the block-local pooled Welford adds
        // (_dense_welford_batch_add :246, both windows) and the shared swap
        // (:267)
        if (METRIC == kDense && A.adapt_dense)
            wel.add_and_swap(warp_vec(smem, NV, cb, 0, n), wel_sh,
                             const_cast<float*>(A.ptr_f[kFgRaw]) + (size_t)blk * n * n,
                             const_cast<float*>(A.ptr_f[kBgRaw]) + (size_t)blk * n * n, cb, n,
                             A.mult, tid, nthreads);
    }

    // the final state
    for (int i = lane; i < n; i += 32) {
        const_cast<float*>(A.ptr_f[kQOut])[row + i] = qs[i];
        const_cast<float*>(A.ptr_f[kGOut])[row + i] = gs[i];
    }
    if (lane == 0) {
        float* so = const_cast<float*>(A.ptr_f[kScalOut]) + (size_t)chain * kNumScal;
        for (int k = 0; k < kNumScal; ++k) so[k] = 0.f;
        so[sLogp] = lp; so[sIter] = iter; so[sLogStep] = da.log_step; so[sLogBar] = da.log_bar;
        so[sHbar] = da.hbar; so[sCount] = da.count; so[sMu] = da.mu;
        if constexpr (METRIC != kDense) {
            so[sFw] = dw.fw; so[sFw2] = dw.fw2; so[sBw] = dw.bw; so[sBw2] = dw.bw2;
            so[sPn] = dw.pn; so[sWin] = dw.win;
        }
    }
    if (METRIC != kDense && A.adapt_metric) {
        float* vout = const_cast<float*>(A.ptr_f[kVarOut]) + row;
        for (int i = lane; i < n; i += 32) {
            vout[i] = vrow[i];
            vout[CN + i] = wrows.fgm[i];
            vout[2 * CN + i] = wrows.fgv[i];
            vout[3 * CN + i] = wrows.bgm[i];
            vout[4 * CN + i] = wrows.bgv[i];
        }
    }
    if (METRIC == kDense && A.adapt_dense)
        wel.store(wel_sh, const_cast<float*>(A.ptr_f[kFgMean]) + (size_t)blk * n,
                  const_cast<float*>(A.ptr_f[kBgMean]) + (size_t)blk * n,
                  const_cast<float*>(A.ptr_f[kWOut]) + (size_t)blk * 8, n, tid, nthreads);
}

// 227 KB per block on Hopper, less room for the static shared int
constexpr size_t kSmemLimit = 232448 - 1024;

template <int BODY, int METRIC>
cudaError_t launch(const Args& A0, cudaStream_t stream) {
    Args A = A0;
    size_t bytes = ((size_t)n_fused_vecs<METRIC>() * A.cb * A.n + (size_t)4 * A.D * A.cb
                    + (METRIC == kDense ? (size_t)5 * A.n : 0)
                    + (METRIC == kLowRank ? (size_t)lowrank_fac_floats(A.n) : 0)) * sizeof(float);
    const size_t sq_bytes = (size_t)A.n * A.n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, A.n, A.rows) * sizeof(float);
    A.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= kSmemLimit) ? 1 : 0;
    if (A.lam_in_smem) bytes += body_bytes;
    A.cov_in_smem = (METRIC == kDense && bytes + sq_bytes <= kSmemLimit) ? 1 : 0;
    if (A.cov_in_smem) bytes += sq_bytes;
    if (bytes > kSmemLimit || A.cb > max_chain_block<METRIC>())
        return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(fused_nuts_kernel<BODY, METRIC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    fused_nuts_kernel<BODY, METRIC><<<A.C / A.cb, 32 * A.cb, bytes, stream>>>(A);
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
// kNumPtrs device pointers (kTrace may be null: no trace; kCov and kLinv
// are read only for the dense metric, kCov the factor block for the
// low-rank one, kVar for the diag and low-rank ones, kVarOut with
// adapt_metric, the pooled Welford ones with adapt_dense); ints: kNumInts;
// floats: kNumFloats.
int fused_nuts_launch(void* const* ptrs, const int* ints, const float* floats, void* stream) {
    Args A;
    for (int k = 0; k < kNumPtrs; ++k) A.ptr_f[k] = static_cast<const float*>(ptrs[k]);
    A.C = ints[iC]; A.n = ints[iN]; A.D = ints[iD]; A.T = ints[iT]; A.cb = ints[iCb];
    A.n_stages = ints[iStages];
    const int body = ints[iBody], metric = ints[iMetric];
    A.tuning = ints[iTuning]; A.adapting = ints[iAdapting];
    A.adapt_metric = ints[iAdaptMetric]; A.adapt_dense = ints[iAdaptDense];
    A.early_window = ints[iEarlyWindow]; A.early_max = ints[iEarlyMax];
    A.max_depth = ints[iMaxDepth];
    A.seed0 = (uint32_t)ints[iSeed0]; A.seed1 = (uint32_t)ints[iSeed1];
    A.Npad = ints[iNpad]; A.rows = ints[iRows];
    A.Emax = floats[fEmax];
    for (int k = 0; k < 4; ++k) A.b[k] = floats[fB0 + k];
    for (int k = 0; k < 3; ++k) A.a[k] = floats[fA0 + k];
    A.target = floats[fTarget]; A.gamma = floats[fGamma]; A.k = floats[fK];
    A.t0 = floats[fT0]; A.mult = floats[fMult];
    A.lam_in_smem = 0;
    A.cov_in_smem = 0;
    if (A.cb < 1 || A.cb > kMaxChainBlock || A.C % A.cb != 0 || A.n < 1 || A.n > 32 * kMaxCols
        || A.D < 1 || A.T < 1 || A.n_stages < 1 || A.n_stages > 3 || A.max_depth > A.D
        || A.early_max > A.D || (body == 2 && A.n != 10) || (body == 3 && A.rows < 1)
        || (body == 4 && (A.rows < 1 || A.rows > kMaxRank)) || (body == 5 && A.n < 2))
        return (int)cudaErrorInvalidValue;
    if (A.adapt_dense && (!A.tuning || metric != kDense)) return (int)cudaErrorInvalidValue;
    if (A.adapt_metric && metric == kDense) return (int)cudaErrorInvalidValue;
    if (metric == kLowRank && A.ptr_f[kCov] == nullptr) return (int)cudaErrorInvalidValue;
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
