// Device helpers the fused multi-draw kernels share (fused_nuts.cu and
// fused_hmc.cu): the dense, diag and low-rank momenta (the low-rank one
// also in the block transition's passes), dual averaging, the
// block-local pooled dense Welford state and the per-chain diag Welford
// state.
//
// Counterparts of the JAX fused kernels' helpers in
// littlemcmc_tpu/ops/fused_nuts_pallas.py, which fused_hmc_pallas.py
// imports from there: _boxmuller_std (:134) with _dense_momentum (:154),
// _boxmuller_momentum (:143) and _lowrank_momentum (:169), _da_update_cols (:399),
// _dense_welford_batch_add (:246), _dense_welford_swap_and_count (:267)
// and _welford_update_rows (:418).

#pragma once

#include "nuts_transition.cuh"

namespace lmc {

constexpr float kTwoPi = 6.283185307179586f;

// The Box-Muller normal of column i of the chain of warp w: calls 1 and 2
// of the row stream with base word mbase (the draw's seed word plus the
// kernel's stream offset) and lane lane_r = w * Npad + i
// (nuts_trajectory_pallas.py:354-358).
__device__ __forceinline__ float boxmuller_normal(uint32_t mbase, uint32_t s1u, int w, int Npad,
                                                  int i) {
    const uint32_t lane_r = (uint32_t)w * (uint32_t)Npad + (uint32_t)i;
    const uint32_t salt_row = fmix32((mbase + lane_r * 65063u + 17u) ^ s1u);
    const float u1 = counter_uniform(salt_row, 1u);
    const float u2 = counter_uniform(salt_row, 2u);
    return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

// The momentum p = z @ L^-1 of the chain of warp w. z and p are vectors of
// length n in shared memory.
__device__ __forceinline__ void dense_momentum(uint32_t mbase, uint32_t s1u, int w, int Npad,
                                               const float* linv, float* z, float* p, int n,
                                               int lane) {
    for (int i = lane; i < n; i += 32) z[i] = boxmuller_normal(mbase, s1u, w, Npad, i);
    matvec(z, linv, p, n, lane);
}

// The momentum p = z / sqrt(V) for the chain's inverse-mass diagonal V
// (_boxmuller_momentum :143-151). Each lane writes its own columns.
__device__ __forceinline__ void diag_momentum(uint32_t mbase, uint32_t s1u, int w, int Npad,
                                              const float* V, float* p, int n, int lane) {
    for (int i = lane; i < n; i += 32) p[i] = boxmuller_normal(mbase, s1u, w, Npad, i) / sqrtf(V[i]);
}

// The low-rank metric's momentum p = S^-1 (alpha^-1/2 z + sum_j V_j d_j),
// d_j = (V^T z)_j (lam_j^-1/2 - alpha^-1/2) (_lowrank_momentum :169-192),
// for the chain's scales s and the factor block fac (nuts_transition.cuh,
// kLowRank): the normals z of diag_momentum's stream into the scratch
// vector z, then the thin matvecs of lowrank_velocity.
__device__ __forceinline__ void lowrank_momentum(uint32_t mbase, uint32_t s1u, int w, int Npad,
                                                 const float* s, const float* fac, float* z,
                                                 float* p, int n, int lane) {
    for (int i = lane; i < n; i += 32) z[i] = boxmuller_normal(mbase, s1u, w, Npad, i);
    __syncwarp();
    float c[kMaxRank];
    thin_dots<false>(z, nullptr, fac, kMaxRank, n, lane, c);
    const float* cmom = fac + (size_t)kMaxRank * (n + 1);
    const float ah = fac[(size_t)kMaxRank * (n + 2) + 1];
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) c[j] = c[j] * cmom[j];
    for (int i = lane; i < n; i += 32) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j) acc = acc + fac[(size_t)j * n + i] * c[j];
        p[i] = (ah * z[i] + acc) / s[i];
    }
}

// lowrank_momentum and the momentum's velocity (lowrank_velocity) for the
// block transition's fused instance, to the bit, in three passes over
// shared memory by 32-bit offsets, K trips at a time (lane_trips): the
// factor block at fac_o, the chain's variances at vrow_o; its scales S =
// sqrt(V) into s_o, the normals into z_o, the momentum into p_o and its
// velocity into v_o. The scales, the normals and the dots V^T z in one
// pass; the momentum and the dots V^T (S p) in the second; the velocity
// and p.velocity in the third. Returns the lane's part of p.velocity (the
// caller adds it across the warp).
template <int K>
__device__ __forceinline__ float lowrank_momentum_block(uint32_t mbase, uint32_t s1u, int w,
                                                        int Npad, int fac_o, int vrow_o, int s_o,
                                                        int z_o, int p_o, int v_o, int n,
                                                        int lane) {
    float* sm = dyn_smem();
    const int cvel_o = fac_o + kMaxRank * n, cmom_o = cvel_o + kMaxRank;
    const float alpha = sm[fac_o + kMaxRank * (n + 2)], ah = sm[fac_o + kMaxRank * (n + 2) + 1];
    float c[kMaxRank];  // V^T z, then times lam^-1/2 - alpha^-1/2
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) c[j] = 0.f;
    {
        float vr[K], vt[K][kMaxRank];
        lane_trips<K>(
            n, lane,
            [&](int k, int i) {
                vr[k] = sm[vrow_o + i];
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) vt[k][j] = sm[fac_o + j * n + i];
            },
            [&](int k, int i) {
                sm[s_o + i] = sqrtf(vr[k]);
                const float z = boxmuller_normal(mbase, s1u, w, Npad, i);
                sm[z_o + i] = z;
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) c[j] = c[j] + z * vt[k][j];  // thin_dots<false>
            });
    }
    warp_sums(c);
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) c[j] = c[j] * sm[cmom_o + j];
    float d[kMaxRank];  // V^T (S p), then times lam - alpha
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) d[j] = 0.f;
    {
        float z[K], sc[K], vt[K][kMaxRank];
        lane_trips<K>(
            n, lane,
            [&](int k, int i) {
                z[k] = sm[z_o + i]; sc[k] = sm[s_o + i];
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) vt[k][j] = sm[fac_o + j * n + i];
            },
            [&](int k, int i) {
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) acc = acc + vt[k][j] * c[j];
                const float p = (ah * z[k] + acc) / sc[k];
                sm[p_o + i] = p;
                const float x = p * sc[k];  // thin_dots<true>
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) d[j] = d[j] + x * vt[k][j];
            });
    }
    warp_sums(d);
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) d[j] = d[j] * sm[cvel_o + j];
    float part = 0.f;
    {
        float p[K], sc[K], vt[K][kMaxRank];
        lane_trips<K>(
            n, lane,
            [&](int k, int i) {
                p[k] = sm[p_o + i]; sc[k] = sm[s_o + i];
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) vt[k][j] = sm[fac_o + j * n + i];
            },
            [&](int k, int i) {
                const float x = sc[k] * p[k];
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < kMaxRank; ++j) acc = acc + vt[k][j] * d[j];
                const float v = sc[k] * (alpha * x + acc);
                sm[v_o + i] = v;
                part += p[k] * v;
            });
    }
    return part;
}

// One chain's dual-averaging state (reference step_sizes.py:85-92), the
// same bits in every lane of its warp.
struct DualAverage {
    float log_step, log_bar, hbar, count, mu;

    __device__ __forceinline__ void update(float accept, float target, float gamma, float k,
                                           float t0) {
        const float wgt = 1.0f / (count + t0);
        hbar = (1.0f - wgt) * hbar + wgt * (target - accept);
        log_step = mu - hbar * sqrtf(count) / gamma;
        const float mk = expf(-k * logf(count));
        log_bar = mk * log_step + (1.0f - mk) * log_bar;
        count = count + 1.0f;
    }
};

// The pooled dense Welford state of one chain block: both windows and the
// shared counters. Its weights and counters are these five floats, the
// same in every thread of the block; the means and the adds' scratch sit
// in 5n floats of shared memory `sh` ([fg mean, bg mean, batch mean, fg
// shift, bg shift] x n), the raw scatters (n x n each) in the block's
// slice of the per-block outputs, which the wrapper seeds with 1/B of the
// global state. The pointers are passed to each call, not kept, so that
// they cost no registers across the draws.
struct BlockWelford {
    float wf, wb, ns, pu, win;

    // From seed = [fg mean (n), bg mean (n), fg weight / B, bg weight / B,
    // n_samples, prev_update, window].
    __device__ void load(float* sh, const float* seed, int n, int tid, int nthreads) {
        for (int i = tid; i < n; i += nthreads) { sh[i] = seed[i]; sh[n + i] = seed[n + i]; }
        wf = seed[2 * n]; wb = seed[2 * n + 1];
        ns = seed[2 * n + 2]; pu = seed[2 * n + 3]; win = seed[2 * n + 4];
    }

    // Chan-combine the block's cb new positions X ([cb][n], shared memory)
    // into both windows (raw scatters fgr and bgr), then the shared window
    // swap. Every thread of the block calls it.
    __device__ void add_and_swap(const float* X, float* sh, float* fgr, float* bgr, int cb,
                                 int n, float mult, int tid, int nthreads) {
        float *fgm = sh, *bgm = sh + n, *xm = sh + 2 * n, *dfg = sh + 3 * n, *dbg = sh + 4 * n;
        __syncthreads();  // every chain's new position is in X
        const float cbf = (float)cb;
        const float wf_n = wf + cbf, wb_n = wb + cbf;
        for (int i = tid; i < n; i += nthreads) {
            float s = 0.f;
            for (int r = 0; r < cb; ++r) s += X[(size_t)r * n + i];
            const float xmi = s * (1.0f / cbf);
            xm[i] = xmi;
            const float df = xmi - fgm[i], db = xmi - bgm[i];
            dfg[i] = df;
            dbg[i] = db;
            fgm[i] = fgm[i] + df * (cbf / wf_n);
            bgm[i] = bgm[i] + db * (cbf / wb_n);
        }
        __syncthreads();
        const float cf = wf * cbf / wf_n, cg = wb * cbf / wb_n;
        for (int e = tid; e < n * n; e += nthreads) {
            const int i = e / n, j = e - i * n;
            float rb = 0.f;
            for (int r = 0; r < cb; ++r) {
                const float* x = X + (size_t)r * n;
                rb += (x[i] - xm[i]) * (x[j] - xm[j]);
            }
            fgr[e] = (fgr[e] + rb) + cf * (dfg[i] * dfg[j]);
            bgr[e] = (bgr[e] + rb) + cg * (dbg[i] * dbg[j]);
        }
        wf = wf_n;
        wb = wb_n;
        if (ns - pu >= win) {  // the same decision in every thread
            for (int e = tid; e < n * n; e += nthreads) { fgr[e] = bgr[e]; bgr[e] = 0.f; }
            for (int i = tid; i < n; i += nthreads) { fgm[i] = bgm[i]; bgm[i] = 0.f; }
            wf = wb;
            wb = 0.f;
            pu = ns;
            win = floorf(win * mult);
        }
        ns = ns + 1.0f;
    }

    // The block's means into rows of the (B, n) outputs and its weights and
    // counters into wout[0..7].
    __device__ void store(const float* sh, float* fg_mean, float* bg_mean, float* wout, int n,
                          int tid, int nthreads) const {
        __syncthreads();
        for (int i = tid; i < n; i += nthreads) { fg_mean[i] = sh[i]; bg_mean[i] = sh[n + i]; }
        if (tid == 0) {
            wout[0] = wf; wout[1] = wb; wout[2] = ns; wout[3] = pu; wout[4] = win;
            wout[5] = 0.f; wout[6] = 0.f; wout[7] = 0.f;
        }
    }
};

// One chain's dual-window diag Welford state (_welford_update_rows
// :418-458): the weights and counters, the same bits in every lane of its
// warp, in registers; the foreground and background means and raw
// variances are four vectors of length n in shared memory (Rows), each
// lane owning its columns.
struct DiagWelford {
    float fw, fw2, bw, bw2, pn, win;

    struct Rows {
        float *fgm, *fgv, *bgm, *bgv;
    };

    // Adds x to both windows and writes the variance of the pre-swap
    // foreground into V; swaps fg <- bg where pn - win floor(pn / win) == 0
    // and pn > 0, and then win <- floor(win mult). Call after the
    // adaptation of the draw's step size, on the draw's new position.
    __device__ __forceinline__ void update(const float* x, const Rows& R, float* V, int n,
                                           float mult, int lane) {
        const float fw_n = fw + 1.0f, bw_n = bw + 1.0f;
        const float rf = 1.0f / fw_n, rb = 1.0f / bw_n;
        // float modulo via floor: the counts stay far below 2^24 (exact)
        const bool swap = pn > 0.f && (pn - win * floorf(pn / win)) == 0.f;
        for (int i = lane; i < n; i += 32) {
            const float xi = x[i];
            const float old_diff = xi - R.fgm[i];
            const float fmean = R.fgm[i] + rf * old_diff;
            const float fraw = R.fgv[i] + old_diff * (xi - fmean);
            const float bold = xi - R.bgm[i];
            const float bmean = R.bgm[i] + rb * bold;
            const float braw = R.bgv[i] + bold * (xi - bmean);
            V[i] = fraw * rf;
            R.fgm[i] = swap ? bmean : fmean;
            R.fgv[i] = swap ? braw : fraw;
            R.bgm[i] = swap ? 0.f : bmean;
            R.bgv[i] = swap ? 0.f : braw;
        }
        const float fw2_n = fw2 + 1.0f, bw2_n = bw2 + 1.0f;
        fw = swap ? bw_n : fw_n;
        fw2 = swap ? bw2_n : fw2_n;
        bw = swap ? 0.f : bw_n;
        bw2 = swap ? 0.f : bw2_n;
        win = swap ? floorf(win * mult) : win;
        pn = pn + 1.0f;
        __syncwarp();
    }

    // update for a chain whose columns live in registers (the fused HMC
    // kernel's register instances): swap_due() once, column() on each of
    // the lane's columns x (its means, raw variances and V), then advance().
    // The same arithmetic as update, column by column; update keeps its own
    // code, so that the shared-memory instances of both fused kernels
    // compile as before.
    __device__ __forceinline__ bool swap_due() const {
        return pn > 0.f && (pn - win * floorf(pn / win)) == 0.f;
    }
    __device__ __forceinline__ void column(float x, float& fgm, float& fgv, float& bgm,
                                           float& bgv, float& v, bool swap) const {
        const float rf = 1.0f / (fw + 1.0f), rb = 1.0f / (bw + 1.0f);
        const float old_diff = x - fgm;
        const float fmean = fgm + rf * old_diff;
        const float fraw = fgv + old_diff * (x - fmean);
        const float bold = x - bgm;
        const float bmean = bgm + rb * bold;
        const float braw = bgv + bold * (x - bmean);
        v = fraw * rf;
        fgm = swap ? bmean : fmean;
        fgv = swap ? braw : fraw;
        bgm = swap ? 0.f : bmean;
        bgv = swap ? 0.f : braw;
    }
    __device__ __forceinline__ void advance(bool swap, float mult) {
        const float fw_n = fw + 1.0f, bw_n = bw + 1.0f;
        const float fw2_n = fw2 + 1.0f, bw2_n = bw2 + 1.0f;
        fw = swap ? bw_n : fw_n;
        fw2 = swap ? bw2_n : fw2_n;
        bw = swap ? 0.f : bw_n;
        bw2 = swap ? 0.f : bw2_n;
        win = swap ? floorf(win * mult) : win;
        pn = pn + 1.0f;
    }
};

}  // namespace lmc
