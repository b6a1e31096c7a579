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
// moves inside the trajectory, so each warp of hmc_trajectory runs its own
// step count and leaves its loop when that is done, with no block-wide
// synchronisation. Body 1 in the per-draw kernel and with the dense metric
// in the fused one runs hmc_block_trajectory below instead: the block's
// chains in lockstep, each n x n product one of the whole block. Every
// lane of a warp holds the same per-chain scalars (xor-butterfly sums give
// every lane the same bits), so per-chain branches are
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

// Section clocks of the HMC kernels, compiled only into the instrumented
// builds of scripts/torch_transition_clocks.py (LMC_TRANSITION_CLOCKS, the
// SectionClock of nuts_transition.cuh): each warp charges its cycles to
// these slots, from the start of its launch's work to the block-wide wait
// at its end, and counts in the step slots the steps its block ran in
// lockstep (the warp transition: its own) and its own live steps.
constexpr int kHClkBody = 0;       // the body's product (a warp's model_eval, or the block's)
constexpr int kHClkVelocity = 1;   // the dense metric's velocity products
constexpr int kHClkKickDrift = 2;  // the kick and drift loops, with the staging
constexpr int kHClkEnergy = 3;     // the energies' sums
constexpr int kHClkMomentum = 4;   // the fused draw's normals and momentum
constexpr int kHClkWelford = 5;    // the pooled Welford adds and the window swap
constexpr int kHClkWait = 6;       // a chain past its count, and waits for the block's longest
constexpr int kHClkOther = 7;      // the accept, dual averaging, stats, trace and state
#ifdef LMC_TRANSITION_CLOCKS
#define LMC_HCLK_PARAM , ::lmc::SectionClock& clk_
#define LMC_HCLK_ARG , clk_
#define LMC_HCLK_STEP(live) (++clk_.steps, clk_.built += (live) ? 1u : 0u)
#define LMC_HCLK_WAIT() (__syncthreads(), clk_.mark<::lmc::kHClkWait>())
#define LMC_HCLK_LIVE(live, K) ((live) ? clk_.mark<K>() : clk_.mark<::lmc::kHClkWait>())
#else
#define LMC_HCLK_PARAM
#define LMC_HCLK_ARG
#define LMC_HCLK_STEP(live) ((void)0)
#define LMC_HCLK_WAIT() ((void)0)
#define LMC_HCLK_LIVE(live, K) ((void)(live))
#endif

// p.(M^-1 p) / 2 for one chain; kDense and kLowRank write the velocity
// into vel.
template <int METRIC>
__device__ __forceinline__ float half_kinetic(const HmcConsts& K, const float* p,
                                              const float* vv, float* vel,
                                              int lane LMC_HCLK_PARAM) {
    float part = 0.f;
    if (METRIC != kDiag) {
        velocity<METRIC>(K.cov, vv, p, vel, K.n, lane);
        LMC_CLK(kHClkVelocity);
        for (int i = lane; i < K.n; i += 32) part += p[i] * vel[i];
    } else {
        for (int i = lane; i < K.n; i += 32) part += p[i] * (vv[i] * p[i]);
    }
    const float e = 0.5f * warp_sum(part);
    LMC_CLK(kHClkEnergy);
    return e;
}

// n_steps symplectic steps (reference integration.py:100-121) of one chain
// from (q, p, g) in shared memory, in place, then the end energy and the
// accept statistic against the start energy E0. A chain that diverges
// integrates on to its count, as in the JAX body; the divergence is read
// at the end (hmc_trajectory_pallas.py:99-103).
template <int BODY, int METRIC>
__device__ HmcResult hmc_trajectory(const HmcConsts& K, float* q, float* p, float* g,
                                    const float* vv, float* vel, float lp0, float E0, float eps,
                                    int n_steps, int lane LMC_HCLK_PARAM) {
    const int n = K.n;
    float lp = lp0;
    const float kick0 = K.b[0] * eps;
    for (int t = 0; t < n_steps; ++t) {
        LMC_HCLK_STEP(true);
        for (int i = lane; i < n; i += 32) p[i] = p[i] + kick0 * g[i];
        for (int s = 0; s < K.n_stages; ++s) {
            const float drift = K.a[s] * eps;
            if (METRIC != kDiag) {
                LMC_CLK(kHClkKickDrift);
                velocity<METRIC>(K.cov, vv, p, vel, n, lane);
                LMC_CLK(kHClkVelocity);
                for (int i = lane; i < n; i += 32) q[i] = q[i] + drift * vel[i];
            } else {
                for (int i = lane; i < n; i += 32) q[i] = q[i] + drift * (vv[i] * p[i]);
            }
            __syncwarp();
            LMC_CLK(kHClkKickDrift);
            lp = model_eval<BODY>(q, g, K.lam, n, BODY >= 3 ? K.rows : 0, lane,
                                  consts_scratch(K));
            LMC_CLK(kHClkBody);
            const float kick = K.b[s + 1] * eps;
            for (int i = lane; i < n; i += 32) p[i] = p[i] + kick * g[i];
        }
    }
    LMC_CLK(kHClkKickDrift);
    HmcResult r;
    r.lp = lp;
    r.en = half_kinetic<METRIC>(K, p, vv, vel, lane LMC_HCLK_ARG) - lp;
    float dE = E0 - r.en;  // reference: energy_change = start - end (hmc.py:158)
    if (isnan(dE)) dE = -CUDART_INF_F;
    r.dE = dE;
    r.div = !isfinite(r.en) || fabsf(dE) > K.Emax;
    r.acc = fminf(1.0f, expf(dE));
    return r;
}

// ---------------------------------------------------------------------------
// The block HMC transition (hmc_block_trajectory below): body 1 (the
// correlated Gaussian) in the per-draw kernel with the diagonal metric
// (HMC's main path) and in the fused kernel with the dense metric in
// chain blocks of up to kBlockChains (HMC `adapt_full`). Every thread of
// the block works on every n x n product: the block's chains integrate in
// lockstep for as many steps as the longest of them asks for (the JAX
// kernel's loop to max_sched with `live = t < nst_v`,
// hmc_trajectory_pallas.py:72-94, and the plain version's), each chain
// frozen past its own count, and each product is one block_matmul of
// nuts_transition.cuh over the block's staged rows: the body's gradient
// -q P, and with the dense metric the drift's velocity p COV. The fused
// kernel's momentum z L^-1 and the energies' velocities are block
// products too (fused_hmc.cu). Each output is one fmaf chain over i from
// 0, as matvec's and model_eval<1>'s, and each sum adds a lane's elements
// in order and then the warp's in one butterfly, as warp_sum: the bits of
// hmc_trajectory above.
//
// A frozen chain stages nothing, so its column of the staged rows keeps
// the position its last live step staged (the dense metric stages a
// momentum only before a product within a step, never after the step's
// last stage); each later product of the block gives its gradient row
// the bits it already holds, and its velocity row goes unread. The
// per-draw kernel's thread block is not its counter stream's chain block
// (the accept uniform is salted by the logical block), so its chains a
// block are free: kHmcBlockChains; the fused kernel's thread block is its
// stream's chain block.
constexpr int kHmcBlockChains = 8;
// __launch_bounds__' minimum of blocks an SM of the two block kernels
constexpr int kHmcBlocksPerSm = 1;
constexpr int kFusedHmcBlocksPerSm = 1;

// Whether an HMC kernel's instance runs the block transition: the
// per-draw kernel's (FUSED false, the diagonal metric) and the fused
// kernel's dense one (in chain blocks of up to kBlockChains; the launch
// checks that), both for body 1 only.
template <int BODY, int METRIC, bool FUSED>
__host__ __device__ constexpr bool hmc_block_body() {
    return BODY == 1 && METRIC == (FUSED ? kDense : kDiag);
}

// ---------------------------------------------------------------------------
// The fused kernel's two instances with the chain's state in registers
// (fused_hmc.cu): body 4 with the pooled low-rank metric (row 4c, one warp
// a chain, lane l holding columns l, l + 32, ... < 32 * kRegTrips of every
// vector and of both thin factors) and body 2 with the diagonal metric
// (row 4b, eight schools: kEsHmcChainsPerWarp chains a warp, each on a
// segment of kEsHmcLanes lanes, lane j of a segment holding column j).

// columns a lane holds in the low-rank register instance: n <= 128
constexpr int kRegTrips = 4;
// eight schools' packed instance: chains a warp (2: segments of 16 lanes;
// 3: segments of 10, lanes 30 and 31 spare) and __launch_bounds__' minimum
// of blocks an SM at its largest block (kMaxChainBlock chains)
constexpr int kEsHmcChainsPerWarp = 3;
constexpr int kEsHmcLanes = kEsHmcChainsPerWarp == 2 ? 16 : 10;
constexpr int kEsHmcMaxWarps = (kMaxChainBlock + kEsHmcChainsPerWarp - 1) / kEsHmcChainsPerWarp;
constexpr int kEsHmcMinBlocks = 5;

// Whether the fused HMC kernel's instance for BODY and METRIC keeps the
// chain's state in registers (the launch checks the chain block and n:
// hmc_register_fits): body 4 with the low-rank metric, and eight schools
// (body 2) with the diagonal one, packed several chains a warp.
template <int BODY, int METRIC>
__host__ __device__ constexpr bool hmc_register_body() {
    return BODY == 4 && METRIC == kLowRank;
}
template <int BODY, int METRIC>
__host__ __device__ constexpr bool hmc_packed_body() {
    return BODY == 2 && METRIC == kDiag;
}
inline bool hmc_register_fits(int cb, int n) { return cb <= kBlockChains && n <= 32 * kRegTrips; }

// warp_sums of the first K of v's sums (the rest untouched).
template <int K, int N>
__device__ __forceinline__ void warp_sums_head(float (&v)[N]) {
    static_assert(K <= N, "K of N sums");
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
}

// K sums over the segment of L lanes that holds one chain (L = 16: lanes
// 16s.., L = 10: lanes 10s.., lanes 30 and 31 of no segment), each with
// the bits of warp_sum over a warp whose lanes past its chain's 10 columns
// hold zeros. warp_sum's first round adds each of lanes 0-15 its zero
// partner in lanes 16-31: here an explicit + 0.0f, which turns a -0 into
// +0 as that round does; then the 16-lane butterfly. With L = 10 its lanes
// 10-15 are virtual: they hold +0 until the round of offset 8, which gives
// lanes 2-7 their + 0 and leaves every virtual lane j with the bits of lane
// j - 8 (0 + x against x + 0, x not -0); the later rounds keep lanes j and
// j ^ 8 equal, so a lane whose partner is virtual reads lane (partner - 8).
// tests/test_torch_hmc.py proves both forms against warp_sum in float32.
// Every lane of the warp calls it.
template <int L, int K>
__device__ __forceinline__ void segment_sums(float (&v)[K], int lane) {
    static_assert(L == 16 || L == 10, "segments of 16 or 10 lanes");
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v[k] + 0.0f;
    if constexpr (L == 16) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
        }
    } else {
        const int seg = lane / 10, i = lane - 10 * seg, base = lane - i;
        const bool in = seg < 3;
        {
            const int j = i ^ 8;  // lanes 2-7: a virtual partner, +0
            const int src = in && j < 10 ? base + j : lane;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float x = __shfl_sync(0xffffffffu, v[k], src);
                v[k] = v[k] + (j < 10 ? x : 0.0f);
            }
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
            const int j = i ^ o;
            const int src = in ? base + (j < 10 ? j : j - 8) : lane;
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] += __shfl_sync(0xffffffffu, v[k], src);
        }
    }
}

// out_c = x_c M (NEG: -x_c M) for the block's staged rows at qt_off, M
// where the launch put it (shared or global memory), into the [cb][n]
// rows at out_off: block_matmul.
template <bool NEG>
__device__ __forceinline__ void block_product_of(const float* M, int qt_off, int out_off, int n,
                                                 int cb) {
    if (__isShared(M))
        block_matmul<true, NEG>(qt_off, nullptr, smem_offset(M), out_off, n, cb);
    else
        block_matmul<false, NEG>(qt_off, M, 0, out_off, n, cb);
}

// The longest step count of the block's chains (n_steps 0 for a warp
// without a chain). Every thread of the block calls it.
__device__ __forceinline__ int block_max_steps(int n_steps, int lane) {
    __shared__ int max_steps_sh;
    __syncthreads();  // the previous call's readers are done
    if (threadIdx.x == 0) max_steps_sh = 0;
    __syncthreads();
    if (lane == 0) atomicMax(&max_steps_sh, n_steps);
    __syncthreads();
    return max_steps_sh;
}

// half_kinetic<kDense> of the block's chains: the velocities p COV
// into the [cb][n] rows of vel as one block product, each chain's p
// staged at qt_off. Every thread of the block calls it.
__device__ __forceinline__ float block_half_kinetic(const HmcConsts& K, int cb, int qt_off, int w,
                                                    const float* p, float* vel,
                                                    int lane LMC_HCLK_PARAM) {
    const int n = K.n, stride = staged_stride(cb);
    for (int i = lane; i < n; i += 32) stage(qt_off, stride, w, i, p[i]);
    __syncthreads();  // every chain's p is staged
    block_product_of<false>(K.cov, qt_off, smem_offset(vel) - w * n, n, cb);
    __syncthreads();  // every velocity is written
    LMC_CLK(kHClkVelocity);
    float part = 0.f;
    for (int i = lane; i < n; i += 32) part += p[i] * vel[i];
    const float e = 0.5f * warp_sum(part);
    LMC_CLK(kHClkEnergy);
    return e;
}

// hmc_trajectory for body 1 with METRIC kDiag or kDense, every chain of
// the block at once: q, p, g (and vel, kDense's velocity scratch) are this
// warp's rows of [cb][n] layouts in shared memory, the staged rows at
// qt_off ([n][staged_stride(cb)], 16-byte aligned). Every thread of the
// block calls it; a warp without a chain passes n_steps 0.
template <int METRIC>
__device__ HmcResult hmc_block_trajectory(const HmcConsts& K, int cb, int qt_off, int w,
                                          float* q, float* p, float* g, const float* vv,
                                          float* vel, float lp0, float E0, float eps,
                                          int n_steps, int lane LMC_HCLK_PARAM) {
    static_assert(METRIC == kDiag || METRIC == kDense,
                  "the block HMC transition takes the diagonal and the dense metric");
    constexpr bool DENSE = METRIC == kDense;
    constexpr int TRIPS = DENSE ? kDenseTrips : kTrips;
    const int n = K.n, stride = staged_stride(cb), stages = K.n_stages;
    float* sm = dyn_smem();
    const int q_o = smem_offset(q), p_o = smem_offset(p), g_o = smem_offset(g);
    const int vv_o = DENSE ? 0 : smem_offset(vv), vel_o = DENSE ? smem_offset(vel) : 0;
    const float b0 = K.b[0], b1 = K.b[1], b2 = K.b[2], b3 = K.b[3];
    const float a0 = K.a[0], a1 = K.a[1], a2 = K.a[2];
    const float kick0 = b0 * eps;
    const int steps = block_max_steps(n_steps, lane);
    float lp = lp0;
    for (int t = 0; t < steps; ++t) {
        const bool live = t < n_steps;
        LMC_HCLK_STEP(live);
        for (int s = 0; s < stages; ++s) {
            const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * eps;
            if constexpr (DENSE) {
                // the first stage's kick and the momentum's staging; the
                // block's velocities p COV; the drift and the position's
                // staging
                if (live && s == 0) {
                    float pv[TRIPS], gv[TRIPS];
                    lane_trips<TRIPS>(
                        n, lane, [&](int k, int i) { pv[k] = sm[p_o + i]; gv[k] = sm[g_o + i]; },
                        [&](int k, int i) {
                            const float pk = pv[k] + kick0 * gv[k];
                            sm[p_o + i] = pk;
                            stage(qt_off, stride, w, i, pk);
                        });
                }
                LMC_HCLK_LIVE(live, kHClkKickDrift);
                __syncthreads();  // every chain's p is staged, and its last velocity read
                block_product_of<false>(K.cov, qt_off, vel_o - w * n, n, cb);
                __syncthreads();  // every velocity is written
                LMC_HCLK_LIVE(live, kHClkVelocity);
                if (live) {
                    float qv[TRIPS], vl[TRIPS];
                    lane_trips<TRIPS>(
                        n, lane, [&](int k, int i) { qv[k] = sm[q_o + i]; vl[k] = sm[vel_o + i]; },
                        [&](int k, int i) {
                            const float qk = qv[k] + drift * vl[k];
                            sm[q_o + i] = qk;
                            stage(qt_off, stride, w, i, qk);
                        });
                }
            } else {
                // the first stage's kick, the drift and the position's
                // staging in one pass
                if (live) {
                    const bool first = s == 0;
                    float pv[TRIPS], gv[TRIPS], qv[TRIPS], iv[TRIPS];
                    lane_trips<TRIPS>(
                        n, lane,
                        [&](int k, int i) {
                            pv[k] = sm[p_o + i]; qv[k] = sm[q_o + i]; iv[k] = sm[vv_o + i];
                            if (first) gv[k] = sm[g_o + i];
                        },
                        [&](int k, int i) {
                            float pk = pv[k];
                            if (first) {
                                pk = pk + kick0 * gv[k];
                                sm[p_o + i] = pk;
                            }
                            const float qk = qv[k] + drift * (iv[k] * pk);
                            sm[q_o + i] = qk;
                            stage(qt_off, stride, w, i, qk);
                        });
                }
            }
            LMC_HCLK_LIVE(live, kHClkKickDrift);
            __syncthreads();  // every chain's q is staged, and its last gradient read
            block_product_of<true>(K.lam, qt_off, g_o - w * n, n, cb);
            __syncthreads();  // every gradient is written
            LMC_HCLK_LIVE(live, kHClkBody);
            // the log density q.grad / 2 (model_eval<1>'s sum), the kick,
            // and with the dense metric the momentum's staging for the next
            // stage's velocity
            if (live) {
                const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * eps;
                const bool again = DENSE && s + 1 < stages;
                float sums[1] = {0.f};
                float pv[TRIPS], gv[TRIPS], qv[TRIPS];
                lane_trips<TRIPS>(
                    n, lane,
                    [&](int k, int i) {
                        qv[k] = sm[q_o + i]; pv[k] = sm[p_o + i]; gv[k] = sm[g_o + i];
                    },
                    [&](int k, int i) {
                        sums[0] += qv[k] * gv[k];
                        const float pk = pv[k] + kick * gv[k];
                        sm[p_o + i] = pk;
                        if (again) stage(qt_off, stride, w, i, pk);
                    });
                warp_sums(sums);
                lp = 0.5f * sums[0];
            }
            LMC_HCLK_LIVE(live, kHClkKickDrift);
        }
    }
    // the end energy, with the dense metric from the block's velocities
    HmcResult r;
    r.lp = lp;
    if constexpr (DENSE)
        r.en = block_half_kinetic(K, cb, qt_off, w, p, vel, lane LMC_HCLK_ARG) - lp;
    else
        r.en = half_kinetic<kDiag>(K, p, vv, nullptr, lane LMC_HCLK_ARG) - lp;
    float dE = E0 - r.en;  // reference: energy_change = start - end (hmc.py:158)
    if (isnan(dE)) dE = -CUDART_INF_F;
    r.dE = dE;
    r.div = !isfinite(r.en) || fabsf(dE) > K.Emax;
    r.acc = fminf(1.0f, expf(dE));
    return r;
}

}  // namespace lmc
