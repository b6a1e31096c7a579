// One whole NUTS transition of one chain, run by one warp, with the model
// inlined: the device function shared by the per-draw trajectory kernel
// (nuts_trajectory.cu) and the fused multi-draw kernel (fused_nuts.cu).
//
// Counterpart of _run_transition in littlemcmc_tpu/ops/nuts_trajectory_pallas.py
// (:374-697), which the JAX package's per-draw and fused kernels also share.
// Templated on the model body (BODY) and on the metric (METRIC):
//
// - kDiag: a per-chain inverse-mass diagonal `vv` (shared memory); the
//   velocity of a momentum p is vv * p, computed where it is used.
// - kDense: one (n, n) covariance COV shared by every chain
//   (make_velocities(V, "dense"), nuts_trajectory_pallas.py:309-333); the
//   velocity is p @ COV in the energy, the drift and every U-turn check.
//   Each velocity is one warp matvec (matvec below: COV read from shared
//   or global memory, p[i] broadcast across the warp, up to kMaxCols output
//   columns per lane in registers, fmaf explicit) into one of five scratch
//   vectors (vv, va, vb, vc, vd), before the loop that reads it.
// - kLowRank: the pooled low-rank metric (_make_lowrank_velocities,
//   nuts_trajectory_pallas.py:717-753): per-chain scales S in vv and one
//   factor block shared by every chain (T.cov: V^T as kMaxRank rows of n,
//   then lam - alpha, lam^-1/2 - alpha^-1/2, alpha and alpha^-1/2; the
//   layout of ops/nuts_trajectory.py::build_lowrank_fac). The velocity
//   S(alpha x + V((lam - alpha).(V^T x))), x = S p, is two thin matvecs
//   (lowrank_velocity below: the kMaxRank dots V^T x as lane partials and
//   one xor butterfly for all of them, then each lane's columns from the
//   shared V), 4 n k + 5 n operations against kDense's 2 n^2, into the
//   scratch vectors va, vb, vc, vd and ve where kDense writes its own.
//
// Control flow runs in lockstep per thread block: the depth, leaf and merge
// loops continue while ANY chain of the block needs them (__syncthreads_or),
// because the counter PRNG advances once per block-wide call. Every lane of
// a warp holds the same per-chain scalars (xor-butterfly sums give every
// lane the same bits), so per-chain branches are warp-uniform.
//
// Randomness: the JAX kernel's counter stream (_fmix32 :152-165,
// _make_counter_uniform :336-371): a per-chain salt and a call counter that
// starts at 0 on entry.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace lmc {

constexpr int kMaxCols = 8;         // register tile of a warp matvec: n <= 256
constexpr int kMaxChainBlock = 16;  // warps per block: 512 threads x 128 registers
constexpr int kMaxRank = 8;         // columns of the low-rank factor and of body 4's V
// kLowRank instances of the NUTS kernels take at most 8 warps a block: the
// thin matvecs' kMaxRank partial sums beside the transition's state need
// more than the 128 registers a thread has at 16 warps (ptxas spilled up to
// 328 bytes there), and 8 warps of 255 registers fill the register file
constexpr int kMaxLowRankChainBlock = 8;
constexpr int kDiag = 0;
constexpr int kDense = 1;
constexpr int kLowRank = 2;
// the body generated from a traced user model (ops/autospec.py): compiled
// only into the libraries built with its generated header
// (LMC_AUTOSPEC_HEADER), one library per generated body
constexpr int kAutoBody = 6;
#ifdef LMC_AUTOSPEC_HEADER
constexpr bool kHaveAutoBody = true;
#else
constexpr bool kHaveAutoBody = false;
#endif
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// U(0, 1) of call number `call` of the stream `salt`
__device__ __forceinline__ float counter_uniform(uint32_t salt, uint32_t call) {
    const uint32_t x = fmix32(salt ^ (call * kGolden));
    return ((float)(x >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// jnp.logaddexp's formula, so all three implementations round alike
__device__ __forceinline__ float logaddexp(float a, float b) {
    float d = a - b;
    if (isnan(d)) return a + b;
    return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

// out = x M for one chain: M is (n, n) row-major, x and out length n. Lanes
// own the columns lane, lane+32, ...; x may be in shared or global memory.
__device__ __forceinline__ void matvec(const float* x, const float* M, float* out, int n,
                                       int lane) {
    float acc[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
    __syncwarp();  // every lane's part of x is written
    for (int i = 0; i < n; ++i) {
        const float xi = x[i];
        const float* row = M + (size_t)i * n;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
            int j = lane + 32 * k;
            if (j < n) acc[k] = fmaf(xi, row[j], acc[k]);
        }
    }
    __syncwarp();  // every lane has read x before anyone writes out
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
        int j = lane + 32 * k;
        if (j < n) out[j] = acc[k];
    }
}

// c[j] = sum_i x_i Vt[j n + i] for j < k (k <= kMaxRank), x_i = a[i] b[i]
// (SCALED) or a[i]: lane partials over i = lane, lane + 32, ..., then one
// xor butterfly for all k dots, so every lane holds the same bits, the
// order of ops/nuts_trajectory.py::thin_dots (which the plain versions
// use). The caller syncs the warp after writing a.
template <bool SCALED>
__device__ __forceinline__ void thin_dots(const float* a, const float* b, const float* Vt, int k,
                                          int n, int lane, float (&c)[kMaxRank]) {
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) c[j] = 0.f;
    for (int i = lane; i < n; i += 32) {
        const float x = SCALED ? a[i] * b[i] : a[i];
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
            if (j < k) c[j] = c[j] + x * Vt[(size_t)j * n + i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
            if (j < k) c[j] += __shfl_xor_sync(0xffffffffu, c[j], o);
    }
}

// The low-rank metric's velocity of p for one chain with scales s and the
// factor block fac (see kLowRank above): out = S (alpha x + sum_j V_j d_j),
// x = S p, d_j = (V^T x)_j (lam_j - alpha), the columns added in turn from
// 0 as thin_combine of the plain versions adds them. Lanes own columns
// lane, lane + 32, ... of out.
__device__ __forceinline__ void lowrank_velocity(const float* p, const float* s, const float* fac,
                                                 float* out, int n, int lane) {
    float c[kMaxRank];
    __syncwarp();  // every lane's part of p is written
    thin_dots<true>(p, s, fac, kMaxRank, n, lane, c);
    const float* cvel = fac + (size_t)kMaxRank * n;
    const float alpha = fac[(size_t)kMaxRank * (n + 2)];
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) c[j] = c[j] * cvel[j];
    for (int i = lane; i < n; i += 32) {
        const float x = s[i] * p[i];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j) acc = acc + fac[(size_t)j * n + i] * c[j];
        out[i] = s[i] * (alpha * x + acc);
    }
}

// Floats of the low-rank factor block (ops/nuts_trajectory.py::lowrank_fac_size).
__host__ __device__ inline int lowrank_fac_floats(int n) { return kMaxRank * (n + 2) + 2; }

// A model body's constants, as the wrappers pass them in one packed buffer
// (TrajectorySpec.kernel_consts): body 1 the (n, n) precision P; body 2
// [y; 1/sigma^2], (2, 10); body 3, the logistic regression over `rows`
// data rows, the design Xb at the odd row stride n | 1 (lanes reading one
// row each hit 32 different banks of shared memory), then y (rows), then
// the prior precision; body 4, the spiked Gaussian with `rows` = k spikes,
// V^T (k rows of n), then 1/lam - 1 (k), then 1/s (n); body 5, the
// funnel, [1/scale^2]; the generated body, its `rows` constant floats
// (index vectors as int32 bits). body_floats counts the floats of P, of
// bodies 3 and 4 and of the generated body, which stage_body copies into
// shared memory where the launch found room (eight schools' 20 floats and
// the funnel's one stay in global memory, in L1).
__host__ __device__ inline size_t body_floats(int body, int n, int rows) {
    if (body == 1) return (size_t)n * n;
    if (body == 3) return (size_t)rows * (n | 1) + rows + 1;
    if (body == 4) return (size_t)rows * (n + 1) + n;
    if (body == kAutoBody) return (size_t)rows;
    return 0;
}

// The body's constants for model_eval: `consts`, or with `stage` non-null
// their copy there, made by every thread of the block (bodies 1 and 3;
// the caller syncs the block before the first model_eval).
template <int BODY>
__device__ const float* stage_body(const float* consts, int n, int rows, float* stage) {
    const int count = (int)body_floats(BODY, n, rows);
    if (stage == nullptr || count == 0) return consts;
    for (int k = threadIdx.x; k < count; k += blockDim.x) stage[k] = consts[k];
    return stage;
}

// Logistic regression over `rows` data rows for one chain at q (shared
// memory, read as a broadcast): X (rows, ldx) and y are relative to the
// rows' first. Lanes own the rows lane, lane + 32, ...: each takes its
// row's logit with fp32 FMAs, the stable softplus of jax.nn.softplus
// (max(x, 0) + log1p(exp(-|x|))) and the sigmoid, and adds its row's
// y * logit - softplus to the lane's part of the log likelihood, which it
// returns. Then each 32-row group's residuals y - sigma are broadcast by
// shuffle and the lanes own the gradient columns lane, lane + 32, ...
// (acc, added to). No per-row reduction across the warp.
__device__ __forceinline__ float logistic_rows(const float* q, const float* X, int ldx,
                                               const float* y, int rows, int n, int lane,
                                               float (&acc)[kMaxCols]) {
    float ll = 0.f;
    for (int base = 0; base < rows; base += 32) {
        const int r = base + lane;
        float resid = 0.f;
        if (r < rows) {
            const float* x = X + (size_t)r * ldx;
            float logit = 0.f;
            for (int k = 0; k < n; ++k) logit = fmaf(q[k], x[k], logit);
            const float yr = y[r];
            const float softplus = fmaxf(logit, 0.f) + log1pf(expf(-fabsf(logit)));
            ll += yr * logit - softplus;
            resid = yr - 1.f / (1.f + expf(-logit));
        }
        const int m = min(32, rows - base);
        for (int t = 0; t < m; ++t) {
            const float rt = __shfl_sync(0xffffffffu, resid, t);
            const float* xt = X + (size_t)(base + t) * ldx;
#pragma unroll
            for (int k = 0; k < kMaxCols; ++k) {
                const int j = lane + 32 * k;
                if (j < n) acc[k] = fmaf(rt, xt[j], acc[k]);
            }
        }
    }
    return ll;
}

}  // namespace lmc

// The generated body: namespace lmc::autobody, with eval(q, g, lam, n,
// lane, scratch), kScratchFloats and the global scratch pointer
#ifdef LMC_AUTOSPEC_HEADER
#include LMC_AUTOSPEC_HEADER
#endif

namespace lmc {

// The model body at q (shared memory, one chain): writes grad into g
// (shared memory) and returns logp. lam: the body's constants (body_floats);
// rows: body 3's data rows, body 4's spikes. Lanes own columns lane,
// lane+32, ... (body 3: rows first, see logistic_rows). Body ids match
// ops/nuts_trajectory.py::BODY_IDS; any other id does not compile, and
// every launch switch refuses it at run time.
template <int BODY>
__device__ float model_eval(const float* q, float* g, const float* lam, int n, int rows,
                           int lane) {
    static_assert((BODY >= 0 && BODY <= 5) || (BODY == kAutoBody && kHaveAutoBody),
                  "unknown model body");
    float part = 0.f;
    if constexpr (BODY == 0) {  // standard normal: logp = -q.q/2, grad = -q
        for (int i = lane; i < n; i += 32) {
            float qi = q[i];
            part += qi * qi;
            g[i] = -qi;
        }
        __syncwarp();
        return -0.5f * warp_sum(part);
    } else if constexpr (BODY == 1) {  // correlated Gaussian: grad = -q P, logp = q.grad/2
        float acc[kMaxCols];
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
        for (int i = 0; i < n; ++i) {
            const float qi = q[i];
            const float* row = lam + (size_t)i * n;
#pragma unroll
            for (int k = 0; k < kMaxCols; ++k) {
                int j = lane + 32 * k;
                if (j < n) acc[k] = fmaf(qi, row[j], acc[k]);
            }
        }
        __syncwarp();  // every lane has read q before anyone writes g
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
            int j = lane + 32 * k;
            if (j < n) {
                float gj = -acc[k];
                g[j] = gj;
                part += q[j] * gj;
            }
        }
        __syncwarp();
        return 0.5f * warp_sum(part);
    } else if constexpr (BODY == 2) {
        // non-centred eight schools, n = 10 (models/eight_schools.py:80-101):
        // q = [mu, log_tau, theta_tilde_1..8]; lam = [y; 1/sigma^2], (2, 10),
        // zero in columns 0 and 1. Lane j < 10 owns column j; four warp sums
        // give logp and the gradients of mu and log_tau.
        __syncwarp();  // q is written
        const float mu = q[0], log_tau = q[1];
        const float tau = expf(log_tau);
        float s_tt2 = 0.f, s_dr = 0.f, s_r = 0.f, s_rtt = 0.f, dtt = 0.f;
        if (lane < 10) {
            const float tt = lane >= 2 ? q[lane] : 0.f;
            const float theta = mu + tau * tt;
            const float dy = lam[lane] - theta;
            const float resid = dy * lam[10 + lane];
            s_tt2 = tt * tt;
            s_dr = dy * resid;
            s_r = resid;
            s_rtt = resid * tt;
            dtt = -tt + tau * resid;
        }
        s_tt2 = warp_sum(s_tt2);
        s_dr = warp_sum(s_dr);
        s_r = warp_sum(s_r);
        s_rtt = warp_sum(s_rtt);
        const float m5 = mu / 5.0f, l5 = log_tau / 5.0f;
        if (lane < 10)
            g[lane] = lane == 0 ? -mu / 25.0f + s_r
                    : lane == 1 ? -log_tau / 25.0f + tau * s_rtt : dtt;
        __syncwarp();
        return -0.5f * (m5 * m5) - 0.5f * (l5 * l5) - 0.5f * s_tt2 - 0.5f * s_dr;
    } else if constexpr (BODY == 3) {
        // logistic regression (models/logistic.py:90-136): logp = sum over
        // rows of y * logit - softplus(logit) - prior_prec * q.q / 2,
        // grad = (y - sigma(logit)) Xb - prior_prec * q
        __syncwarp();  // q is written
        const int ldx = n | 1;
        const float prior_prec = lam[(size_t)rows * ldx + rows];
        float acc[kMaxCols];
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
        const float ll = warp_sum(logistic_rows(q, lam, ldx, lam + (size_t)rows * ldx, rows, n,
                                                lane, acc));
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
            const int j = lane + 32 * k;
            if (j < n) {
                const float qj = q[j];
                part += qj * qj;
            }
        }
        const float qq = warp_sum(part);
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
            const int j = lane + 32 * k;
            if (j < n) g[j] = acc[k] - prior_prec * q[j];
        }
        __syncwarp();
        return ll + -0.5f * prior_prec * qq;
    } else if constexpr (BODY == 5) {
        // Neal's centred funnel (models/funnel.py:54-86): q = [v, x],
        // lam = [1/scale^2]. sq sums x_i^2 over i >= 1 only: q.q - v^2
        // would cancel in the neck (v < -2), where v^2 dwarfs sq
        __syncwarp();  // q is written
        const float inv_s2 = lam[0];
        const float v = q[0];
        for (int i = lane; i < n; i += 32) {
            if (i >= 1) {
                const float x = q[i];
                part += x * x;
            }
        }
        const float sq = warp_sum(part);
        const float e = expf(-v);
        const float nx = (float)(n - 1);
        for (int i = lane; i < n; i += 32)
            g[i] = i == 0 ? -inv_s2 * v - 0.5f * nx + 0.5f * sq * e : -q[i] * e;
        __syncwarp();
        return -0.5f * inv_s2 * v * v - 0.5f * nx * v - 0.5f * sq * e;
    } else if constexpr (BODY == kAutoBody) {
#ifdef LMC_AUTOSPEC_HEADER
        // the generated body: its intermediates in this warp's row of the
        // global scratch (one row per warp of the grid)
        __syncwarp();  // q is written
        float* scratch = autobody::scratch
                         + ((size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))
                               * autobody::kScratchFloats;
        return autobody::eval(q, g, lam, n, lane, scratch);
#else
        return part;
#endif
    } else {
        // the spiked Gaussian (models/gaussian.py:204-237): x = q / s,
        // g = -(x + V((1/lam - 1).(V^T x))) / s, logp = q.g / 2, with the
        // thin matvecs of the low-rank metric (rows = k spikes)
        __syncwarp();  // q is written
        const float* il = lam + (size_t)rows * n;
        const float* inv_s = il + rows;
        float c[kMaxRank];
        thin_dots<true>(q, inv_s, lam, rows, n, lane, c);
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
            if (j < rows) c[j] = c[j] * il[j];
        for (int i = lane; i < n; i += 32) {
            const float x = q[i] * inv_s[i];
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < kMaxRank; ++j)
                if (j < rows) acc = acc + lam[(size_t)j * n + i] * c[j];
            const float gi = -(x + acc) * inv_s[i];
            g[i] = gi;
            part += q[i] * gi;
        }
        __syncwarp();
        return 0.5f * warp_sum(part);
    }
}

// What a transition reads that is the same for every chain of a launch.
struct TreeConsts {
    const float* lam;  // the model body's constants (body_floats), shared or global
    const float* cov;  // kDense: the shared covariance, shared or global; kLowRank: the factor
    float* stack;      // [4][D][C][n]: left p, right p, p sum, proposal q
    int C, n, D, cb, n_stages, rows;
    float Emax;
    float b[4];
    float a[3];
};

// One warp's working vectors, each of length n in shared memory.
struct WarpVecs {
    float *lq, *lp, *lg, *rq, *rp, *rg, *cq, *cp, *cg, *prq, *psum;
    float* vv;  // kDiag: inverse-mass diagonal; kDense: velocity scratch; kLowRank: scales
    float *va, *vb, *vc, *vd;  // kDense, kLowRank: velocity scratch (unused for kDiag)
};

// Vector v of warp w in a [NV][cb][n] shared layout.
__device__ __forceinline__ float* warp_vec(float* smem, int v, int cb, int w, int n) {
    return smem + ((size_t)v * cb + w) * n;
}

// The transition's vectors at the start of `smem`: 12 for kDiag, 16 for
// kDense, 17 for kLowRank (its 17th, the velocity scratch where kDense
// uses vv, follows vd: lowrank_scratch).
template <int METRIC>
__device__ __forceinline__ WarpVecs warp_vecs(float* smem, int cb, int w, int n) {
    WarpVecs V;
    V.lq = warp_vec(smem, 0, cb, w, n);  V.lp = warp_vec(smem, 1, cb, w, n);
    V.lg = warp_vec(smem, 2, cb, w, n);  V.rq = warp_vec(smem, 3, cb, w, n);
    V.rp = warp_vec(smem, 4, cb, w, n);  V.rg = warp_vec(smem, 5, cb, w, n);
    V.cq = warp_vec(smem, 6, cb, w, n);  V.cp = warp_vec(smem, 7, cb, w, n);
    V.cg = warp_vec(smem, 8, cb, w, n);  V.prq = warp_vec(smem, 9, cb, w, n);
    V.psum = warp_vec(smem, 10, cb, w, n);
    V.vv = warp_vec(smem, 11, cb, w, n);
    if (METRIC != kDiag) {
        V.va = warp_vec(smem, 12, cb, w, n);  V.vb = warp_vec(smem, 13, cb, w, n);
        V.vc = warp_vec(smem, 14, cb, w, n);  V.vd = warp_vec(smem, 15, cb, w, n);
    } else {
        V.va = V.vb = V.vc = V.vd = nullptr;
    }
    return V;
}

// kLowRank's fifth velocity scratch vector, vector 16 of warp_vecs' layout
__device__ __forceinline__ float* lowrank_scratch(const WarpVecs& V, int cb, int n) {
    return V.vd + (size_t)cb * n;
}

// The most warps (chains) a block of a NUTS kernel instance takes.
template <int METRIC>
__host__ __device__ constexpr int max_chain_block() {
    return METRIC == kLowRank ? kMaxLowRankChainBlock : kMaxChainBlock;
}

template <int METRIC>
__host__ __device__ constexpr int n_warp_vecs() {
    return METRIC == kLowRank ? 17 : METRIC == kDense ? 16 : 12;
}

// The velocity of p into out for kDense (p @ COV) or kLowRank (s the
// chain's scales); kDiag computes its velocity where it is used.
template <int METRIC>
__device__ __forceinline__ void velocity(const float* cov, const float* s, const float* p,
                                         float* out, int n, int lane) {
    if constexpr (METRIC == kDense) matvec(p, cov, out, n, lane);
    else lowrank_velocity(p, s, cov, out, n, lane);
}

struct TreeResult {
    float pr_e, pr_lp, log_size, lwas, mec;
    int depth, n_leaves;
    bool diverging, turning;
};

// One transition of chain `chain` (warp w of its block) from (q0, p0, g0,
// lp0) with start energy E0, step eps and depth cap mdc. Every thread of
// the block must call it. slot_sc: [4][D][cb] floats of shared memory for
// the merge stack's per-slot scalars. On return the proposal is in V.prq
// and the tree's edges in V.lq..V.rg; V.cg holds the last leaf's gradient.
template <int BODY, int METRIC>
__device__ TreeResult transition(const TreeConsts& T, const WarpVecs& V, float* slot_sc,
                                 int chain, int w, int lane, const float* q0,
                                 const float* p0, const float* g0, float lp0, float E0,
                                 float eps, int mdc, uint32_t salt) {
    const int n = T.n, cb = T.cb, D = T.D, C = T.C;
    float *lq = V.lq, *lp = V.lp, *lg = V.lg, *rq = V.rq, *rp = V.rp, *rg = V.rg;
    float *cq = V.cq, *cp = V.cp, *cg = V.cg, *prq = V.prq, *psum = V.psum, *vv = V.vv;
    const float* cov = T.cov;
    // the velocity scratch that kDense keeps in vv (kLowRank's scales)
    float* vs = METRIC == kLowRank ? lowrank_scratch(V, cb, n) : vv;

    float* s_e = slot_sc;                        // [D][cb] proposal energy
    float* s_lpp = slot_sc + (size_t)D * cb;     // proposal logp
    float* s_ls = slot_sc + (size_t)2 * D * cb;  // log size
    float* s_lw = slot_sc + (size_t)3 * D * cb;  // log weighted accept sum
    __shared__ int max_sched_sh;

    const size_t stride_k = (size_t)D * C * n;  // between the 4 stacks
    auto slot = [&](int k, int s) -> float* {
        return T.stack + k * stride_k + ((size_t)s * C + chain) * n;
    };
    auto ssc = [&](float* arr, int s) -> float& { return arr[s * cb + w]; };

    for (int i = lane; i < n; i += 32) {
        const float q = q0[i], p = p0[i], g = g0[i];
        lq[i] = q; rq[i] = q; prq[i] = q;
        lp[i] = p; rp[i] = p; psum[i] = p;
        lg[i] = g; rg[i] = g;
    }

    __syncthreads();  // the previous call's readers of max_sched_sh are done
    if (threadIdx.x == 0) max_sched_sh = 0;
    __syncthreads();
    if (lane == 0) atomicMax(&max_sched_sh, mdc);
    __syncthreads();
    const int max_sched = min(max_sched_sh, D);

    uint32_t calls = 0;
    auto uniform = [&]() -> float { return counter_uniform(salt, ++calls); };

    float acc_ls = 0.f, acc_lw = -CUDART_INF_F, mec = 0.f;
    int depth_c = 0, nlv = 0;
    bool div = false, trn = false;
    float pr_e = E0, pr_lp = lp0, c_e = E0, c_lp = lp0;
    float part;

    int depth = 0;
    bool cont = max_sched > 0;
    while (cont) {
        const bool active = !div && !trn && depth_c < mdc;
        const bool go_right = uniform() < 0.5f;
        const float epss = go_right ? eps : -eps;
        {
            const float *sq = go_right ? rq : lq, *sp = go_right ? rp : lp,
                        *sg = go_right ? rg : lg;
            for (int i = lane; i < n; i += 32) { cq[i] = sq[i]; cp[i] = sp[i]; cg[i] = sg[i]; }
            __syncwarp();
        }
        bool bld = active, sdv = false, stn = false;
        const int n_total = 1 << depth;
        int leaf = 0, h = 0;
        bool go_l = __syncthreads_or(bld);
        while (leaf < n_total && go_l) {
            float dE = 0.f, lpaw = 0.f;
            bool div_leaf = false;
            if (bld) {
                // one symplectic step (reference integration.py:100-121)
                const float kick0 = T.b[0] * epss;
                for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick0 * cg[i];
                for (int s = 0; s < T.n_stages; ++s) {
                    const float drift = T.a[s] * epss;
                    if (METRIC != kDiag) {
                        velocity<METRIC>(cov, vv, cp, vs, n, lane);
                        for (int i = lane; i < n; i += 32) cq[i] = cq[i] + drift * vs[i];
                    } else {
                        for (int i = lane; i < n; i += 32) cq[i] = cq[i] + drift * (vv[i] * cp[i]);
                    }
                    __syncwarp();
                    c_lp = model_eval<BODY>(cq, cg, T.lam, n, T.rows, lane);
                    const float kick = T.b[s + 1] * epss;
                    for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick * cg[i];
                }
                part = 0.f;
                if (METRIC != kDiag) {
                    velocity<METRIC>(cov, vv, cp, vs, n, lane);
                    for (int i = lane; i < n; i += 32) part += cp[i] * vs[i];
                } else {
                    for (int i = lane; i < n; i += 32) part += cp[i] * (vv[i] * cp[i]);
                }
                c_e = 0.5f * warp_sum(part) - c_lp;

                dE = c_e - E0;
                if (isnan(dE)) dE = CUDART_INF_F;
                if (fabsf(dE) > fabsf(mec)) mec = dE;
                div_leaf = !(fabsf(dE) < T.Emax);
                ++nlv;
                lpaw = -dE + fminf(0.f, -dE);
            }
            bool mrg = bld && !div_leaf;
            const bool is_odd = leaf & 1;
            const bool go_m0 = __syncthreads_or(mrg);
            if (!is_odd) {
                if (mrg) {  // a leaf slot has left p == right p == p sum
                    float *dps = slot(2, h), *dq = slot(3, h);
                    for (int i = lane; i < n; i += 32) { dps[i] = cp[i]; dq[i] = cq[i]; }
                    if (lane == 0) {
                        ssc(s_e, h) = c_e; ssc(s_lpp, h) = c_lp;
                        ssc(s_ls, h) = -dE; ssc(s_lw, h) = lpaw;
                    }
                }
            } else if (go_m0) {
                // leaf (+) leaf, peeled (nuts_trajectory_pallas.py:505-538)
                const float u = uniform();
                if (mrg) {
                    __syncwarp();
                    const int s = h - 1;
                    const float t2_ls = -dE;
                    const float ls = logaddexp(ssc(s_ls, s), t2_ls);
                    const float lw = logaddexp(ssc(s_lw, s), lpaw);
                    const bool take2 = logf(u) < t2_ls - ls;
                    float *slp = slot(0, s), *srp = slot(1, s), *sps = slot(2, s),
                          *sq = slot(3, s);
                    if (METRIC != kDiag) {
                        velocity<METRIC>(cov, vv, sps, V.va, n, lane);  // the even leaf's
                        velocity<METRIC>(cov, vv, cp, V.vb, n, lane);   // and this leaf's
                    }
                    float d1 = 0.f, d2 = 0.f;
                    for (int i = lane; i < n; i += 32) {
                        const float t1p = sps[i], t2p = cp[i];
                        const float ps = t1p + t2p;
                        if (METRIC != kDiag) {
                            d1 += ps * V.va[i];
                            d2 += ps * V.vb[i];
                        } else {
                            const float v = vv[i];
                            d1 += ps * (v * t1p);
                            d2 += ps * (v * t2p);
                        }
                        slp[i] = t1p; srp[i] = t2p; sps[i] = ps;
                        if (take2) sq[i] = cq[i];
                    }
                    d1 = warp_sum(d1);
                    d2 = warp_sum(d2);
                    if (lane == 0) {
                        if (take2) { ssc(s_e, s) = c_e; ssc(s_lpp, s) = c_lp; }
                        ssc(s_ls, s) = ls; ssc(s_lw, s) = lw;
                    }
                    mrg = !(d1 <= 0.f || d2 <= 0.f);
                }
            }
            __syncwarp();

            // one in-place merge per trailing one-bit of leaf past bit 0
            int j = 1, hh = h - (is_odd ? 1 : 0);
            bool go_m = __syncthreads_or(mrg) && is_odd;
            while (((leaf >> j) & 1) && go_m) {
                const float u = uniform();
                if (mrg) {
                    const int s1 = hh - 1, s2 = hh;
                    const float ls = logaddexp(ssc(s_ls, s1), ssc(s_ls, s2));
                    const float lw = logaddexp(ssc(s_lw, s1), ssc(s_lw, s2));
                    const bool take2 = logf(u) < ssc(s_ls, s2) - ls;
                    float *a_lp = slot(0, s1), *a_rp = slot(1, s1), *a_ps = slot(2, s1),
                          *a_q = slot(3, s1);
                    const float *b_lp = slot(0, s2), *b_rp = slot(1, s2), *b_ps = slot(2, s2),
                                *b_q = slot(3, s2);
                    if (METRIC != kDiag) {
                        velocity<METRIC>(cov, vv, a_lp, V.va, n, lane);
                        velocity<METRIC>(cov, vv, a_rp, V.vb, n, lane);
                        velocity<METRIC>(cov, vv, b_lp, V.vc, n, lane);
                        velocity<METRIC>(cov, vv, b_rp, V.vd, n, lane);
                    }
                    float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                    for (int i = lane; i < n; i += 32) {
                        const float t1lp = a_lp[i], t1rp = a_rp[i], t1ps = a_ps[i];
                        const float t2lp = b_lp[i], t2rp = b_rp[i], t2ps = b_ps[i];
                        float vt1lp, vt1rp, vt2lp, vt2rp;
                        if (METRIC != kDiag) {
                            vt1lp = V.va[i]; vt1rp = V.vb[i]; vt2lp = V.vc[i]; vt2rp = V.vd[i];
                        } else {
                            const float v = vv[i];
                            vt1lp = v * t1lp; vt1rp = v * t1rp;
                            vt2lp = v * t2lp; vt2rp = v * t2rp;
                        }
                        const float ps = t1ps + t2ps;
                        d[0] += ps * vt1lp;
                        d[1] += ps * vt2rp;
                        const float ps1 = t1ps + t2lp;
                        d[2] += ps1 * vt1lp;
                        d[3] += ps1 * vt2lp;
                        const float ps2 = t1rp + t2ps;
                        d[4] += ps2 * vt1rp;
                        d[5] += ps2 * vt2rp;
                        a_rp[i] = t2rp;
                        a_ps[i] = ps;
                        if (take2) a_q[i] = b_q[i];
                    }
                    bool turn = false;
#pragma unroll
                    for (int k = 0; k < 6; ++k) turn |= warp_sum(d[k]) <= 0.f;
                    if (lane == 0) {
                        if (take2) { ssc(s_e, s1) = ssc(s_e, s2); ssc(s_lpp, s1) = ssc(s_lpp, s2); }
                        ssc(s_ls, s1) = ls; ssc(s_lw, s1) = lw;
                    }
                    __syncwarp();
                    mrg = mrg && !turn;
                }
                go_m = __syncthreads_or(mrg);
                ++j;
                --hh;
            }

            const bool turned = bld && !div_leaf && !mrg;
            sdv = sdv || div_leaf;
            stn = stn || turned;
            bld = bld && !div_leaf && !turned;
            go_l = __syncthreads_or(bld);
            ++leaf;
            h = hh + 1;
        }
        __syncwarp();

        // the finished subtree is slot 0; a depth-0 subtree is one leaf
        const float u = uniform();
        const bool ok = active && !sdv && !stn;
        bool turning_new = false;
        if (ok) {
            // multinomial swap against the old tree (reference nuts.py:321-323)
            const float n_ls = ssc(s_ls, 0), n_lw = ssc(s_lw, 0);
            const bool take_new = logf(u) < n_ls - acc_ls;
            if (take_new) { pr_e = ssc(s_e, 0); pr_lp = ssc(s_lpp, 0); }
            acc_ls = logaddexp(acc_ls, n_ls);
            acc_lw = logaddexp(acc_lw, n_lw);
            const float *nlp = slot(depth == 0 ? 2 : 0, 0), *nrp = slot(depth == 0 ? 2 : 1, 0),
                        *nps = slot(2, 0), *nq = slot(3, 0);
            if (METRIC != kDiag) {
                // velocities of the five edge momenta the U-turn checks use
                velocity<METRIC>(cov, vv, lp, V.va, n, lane);  // old left edge
                velocity<METRIC>(cov, vv, rp, V.vb, n, lane);  // old right edge
                velocity<METRIC>(cov, vv, cp, V.vc, n, lane);  // the new subtree's outer edge
                velocity<METRIC>(cov, vv, nlp, V.vd, n, lane);
                velocity<METRIC>(cov, vv, nrp, vs, n, lane);
            }
            float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int i = lane; i < n; i += 32) {
                const float n_ps = nps[i], n_lp = nlp[i], n_rp = nrp[i];
                if (take_new) prq[i] = nq[i];
                const float old_ps = psum[i];
                const float pst = old_ps + n_ps;
                psum[i] = pst;
                const float old_l_p = lp[i], old_r_p = rp[i];
                float new_l_p = old_l_p, new_r_p = old_r_p;
                if (go_right) {
                    rq[i] = cq[i]; rp[i] = cp[i]; rg[i] = cg[i]; new_r_p = cp[i];
                } else {
                    lq[i] = cq[i]; lp[i] = cp[i]; lg[i] = cg[i]; new_l_p = cp[i];
                }
                // 3-way U-turn on the merged span (reference nuts.py:332-340)
                const float ps1 = go_right ? old_ps + n_lp : n_ps + old_l_p;
                const float ps2 = go_right ? old_r_p + n_ps : n_lp + old_ps;
                if (METRIC != kDiag) {
                    const float v_ol = V.va[i], v_or = V.vb[i], v_c = V.vc[i];
                    const float v_nl = V.vd[i], v_nr = vs[i];
                    d[0] += pst * (go_right ? v_ol : v_c);
                    d[1] += pst * (go_right ? v_c : v_or);
                    d[2] += ps1 * (go_right ? v_ol : v_nr);
                    d[3] += ps1 * (go_right ? v_nl : v_ol);
                    d[4] += ps2 * (go_right ? v_or : v_nl);
                    d[5] += ps2 * (go_right ? v_nr : v_or);
                } else {
                    const float v = vv[i];
                    d[0] += pst * (v * new_l_p);
                    d[1] += pst * (v * new_r_p);
                    const float p1a = go_right ? old_l_p : n_rp;
                    const float p1b = go_right ? n_lp : old_l_p;
                    d[2] += ps1 * (v * p1a);
                    d[3] += ps1 * (v * p1b);
                    const float p2a = go_right ? old_r_p : n_lp;
                    const float p2b = go_right ? n_rp : old_r_p;
                    d[4] += ps2 * (v * p2a);
                    d[5] += ps2 * (v * p2b);
                }
            }
#pragma unroll
            for (int k = 0; k < 6; ++k) turning_new |= warp_sum(d[k]) <= 0.f;
        }
        const bool sel_turn = ok ? turning_new : stn;
        if (active) {
            trn = trn || sel_turn;
            div = div || sdv;
            ++depth_c;
        }
        const bool nxt = !div && !trn && depth_c < mdc;
        const bool any_nxt = __syncthreads_or(nxt);
        cont = (depth + 1) < max_sched && any_nxt;
        ++depth;
    }
    __syncwarp();

    TreeResult r;
    r.pr_e = pr_e; r.pr_lp = pr_lp; r.log_size = acc_ls; r.lwas = acc_lw; r.mec = mec;
    r.depth = depth_c; r.n_leaves = nlv; r.diverging = div; r.turning = trn;
    return r;
}

}  // namespace lmc
