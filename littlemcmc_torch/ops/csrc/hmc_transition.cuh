// One classic-HMC trajectory of one chain, run by one warp, with the model
// inlined: the device function shared by the per-draw HMC kernel
// (hmc_trajectory.cu) and the fused multi-draw HMC kernel (fused_hmc.cu).
//
// Counterpart of run_hmc_trajectory_values in
// littlemcmc_tpu/ops/hmc_trajectory_pallas.py (:58-110), which the JAX
// package's two HMC kernels also share. Templated on the model body (BODY,
// model_eval of nuts_transition.cuh) and on the metric (METRIC): kDiag reads
// a per-chain inverse-mass diagonal vv, kDense computes the velocity p @ COV
// into a scratch vector with one warp matvec, kLowRank the low-rank
// velocity (lowrank_velocity; vv the chain's scales, K.cov the factor).
//
// Unlike the NUTS transition, chains share nothing here: no counter stream
// moves inside the trajectory, so each warp runs its own step count and
// leaves its loop when that is done, with no block-wide synchronisation.
// Every lane of a warp holds the same per-chain scalars (xor-butterfly
// sums give every lane the same bits), so per-chain branches are
// warp-uniform.

#pragma once

#include "nuts_transition.cuh"

namespace lmc {

// What a trajectory reads that is the same for every chain of a launch.
struct HmcConsts {
    const float* lam;  // the model body's constants (body_floats), shared or global
    const float* cov;  // kDense: the shared covariance, shared or global; kLowRank: the factor
    int n, n_stages;
    float Emax;
    float b[4];
    float a[3];
    // body 3's data rows (body 4's spikes): last but for the generated
    // body's scratch, and passed to model_eval for bodies 3 and up only;
    // otherwise ptxas gives
    // hmc_trajectory<1> 40 registers and a spill, and the kernel runs at
    // half the speed
    int rows;
#ifdef LMC_AUTOSPEC_HEADER
    float* scratch;  // the warp's scratch row for the generated body (warp_scratch)
#endif
};

struct HmcResult {
    float lp, en, dE, acc;  // end logp and energy, E0 - E, min(1, exp(E0 - E))
    bool div;
};

// p.(M^-1 p) / 2 for one chain; kDense and kLowRank write the velocity
// into vel.
template <int METRIC>
__device__ __forceinline__ float half_kinetic(const HmcConsts& K, const float* p,
                                              const float* vv, float* vel, int lane) {
    float part = 0.f;
    if (METRIC != kDiag) {
        velocity<METRIC>(K.cov, vv, p, vel, K.n, lane);
        for (int i = lane; i < K.n; i += 32) part += p[i] * vel[i];
    } else {
        for (int i = lane; i < K.n; i += 32) part += p[i] * (vv[i] * p[i]);
    }
    return 0.5f * warp_sum(part);
}

// n_steps symplectic steps (reference integration.py:100-121) of one chain
// from (q, p, g) in shared memory, in place, then the end energy and the
// accept statistic against the start energy E0. A chain that diverges
// integrates on to its count, as in the JAX body; the divergence is read
// at the end (hmc_trajectory_pallas.py:99-103).
template <int BODY, int METRIC>
__device__ HmcResult hmc_trajectory(const HmcConsts& K, float* q, float* p, float* g,
                                    const float* vv, float* vel, float lp0, float E0, float eps,
                                    int n_steps, int lane) {
    const int n = K.n;
    float lp = lp0;
    const float kick0 = K.b[0] * eps;
    for (int t = 0; t < n_steps; ++t) {
        for (int i = lane; i < n; i += 32) p[i] = p[i] + kick0 * g[i];
        for (int s = 0; s < K.n_stages; ++s) {
            const float drift = K.a[s] * eps;
            if (METRIC != kDiag) {
                velocity<METRIC>(K.cov, vv, p, vel, n, lane);
                for (int i = lane; i < n; i += 32) q[i] = q[i] + drift * vel[i];
            } else {
                for (int i = lane; i < n; i += 32) q[i] = q[i] + drift * (vv[i] * p[i]);
            }
            __syncwarp();
            lp = model_eval<BODY>(q, g, K.lam, n, BODY >= 3 ? K.rows : 0, lane,
                                  consts_scratch(K));
            const float kick = K.b[s + 1] * eps;
            for (int i = lane; i < n; i += 32) p[i] = p[i] + kick * g[i];
        }
    }
    HmcResult r;
    r.lp = lp;
    r.en = half_kinetic<METRIC>(K, p, vv, vel, lane) - lp;
    float dE = E0 - r.en;  // reference: energy_change = start - end (hmc.py:158)
    if (isnan(dE)) dE = -CUDART_INF_F;
    r.dE = dE;
    r.div = !isfinite(r.en) || fabsf(dE) > K.Emax;
    r.acc = fminf(1.0f, expf(dE));
    return r;
}

}  // namespace lmc
