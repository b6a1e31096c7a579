// One whole NUTS transition per chain, diag metric, model inlined.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/nuts_trajectory_pallas.py::
// build_trajectory_op (pallas_call at :1023; body _build_kernel_body :755
// and _run_transition :374-697) for metric="diag", pack=1. The plain
// PyTorch version it is held against is ops/nuts_trajectory.py::
// trajectory_plain.
//
// Mapping. One thread block is one chain block of CB chains, one warp per
// chain. The block runs the JAX kernel's control flow in lockstep: the
// depth, leaf and merge loops and the first-merge branch continue while
// ANY chain of the block needs them (__syncthreads_or), because the
// counter PRNG advances once per block-wide call. Every lane of a warp
// holds the same per-chain scalars (xor-butterfly sums give every lane
// the same bits), so per-chain branches are warp-uniform.
//
// Randomness: the JAX kernel's counter stream (_fmix32 :152-165,
// _make_counter_uniform :336-371) with block_id = blockIdx.x and the
// chain's row within its block, so this kernel, the plain version and the
// JAX kernel under interpret=True draw the same numbers.
//
// What bounds it on this card. Per leaf and chain: the model body (for
// the correlated Gaussian a 2n^2-FLOP matvec, g = -q P) plus about 20n
// elementwise operations for the kick, drift, energy and U-turn dots; per
// merge about 20n more. That is fp32 work outside the tensor cores, so
// the bound is operations over the 67 TFLOP/s fp32 peak. Device memory
// is touched only for the inputs, the outputs and the merge stack.
// What the design does about it: the working states (left, right and
// current edge, proposal, momentum sum, inverse mass) and the precision
// matrix P live in shared memory, so the matvec reads P from shared
// memory, broadcast q[i] across the warp and keeps up to 8 output columns
// per lane in registers. The merge stack lives in a global scratch tensor
// (4 x D x C x n floats, 16 MB at the main path's shapes) that stays in
// the 50 MB L2. Chains that stopped building skip the leapfrog and the
// merges. Each block waits for its own deepest tree only: small blocks
// shrink the lockstep tail.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no contraction of a*b+c, so elementwise rounding matches
// the plain PyTorch version; the matvec uses fmaf explicitly). Plain C
// interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 8;  // register tile of the dense body: n <= 256

struct Params {
    const float* q;
    const float* p;
    const float* g;
    const float* var;
    const float* logp;
    const float* eps;
    const int* mdc;
    const float* consts;  // body constants (correlated Gaussian: P, n x n)
    float* stack;         // [4][D][C][n]: left p, right p, p sum, proposal q
    float* q_out;
    float* g_out;
    float* energy;
    float* logp_out;
    float* log_size;
    float* lwas;
    float* mec;
    int* depth;
    int* n_leaves;
    bool* diverging;
    bool* turning;
    uint32_t seed0, seed1;
    int C, n, D, cb, n_stages;
    float Emax;
    float b[4];
    float a[3];
    int lam_in_smem;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
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

// The model body at q (shared memory, one chain): writes grad into g
// (shared memory) and returns logp. Lanes own columns lane, lane+32, ...
template <int BODY>
__device__ float model_eval(const float* q, float* g, const float* lam, int n, int lane) {
    float part = 0.f;
    if (BODY == 0) {  // standard normal: logp = -q.q/2, grad = -q
        for (int i = lane; i < n; i += 32) {
            float qi = q[i];
            part += qi * qi;
            g[i] = -qi;
        }
        __syncwarp();
        return -0.5f * warp_sum(part);
    } else {  // correlated Gaussian: grad = -q P, logp = q.grad/2
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
    }
}

constexpr int kMaxChainBlock = 16;  // warps per block: 512 threads x 128 registers

template <int BODY>
__global__ void __launch_bounds__(32 * kMaxChainBlock) nuts_trajectory_kernel(Params P) {
    extern __shared__ float smem[];
    const int n = P.n, cb = P.cb, D = P.D, C = P.C;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * cb + w;

    // shared layout: 12 vectors x [cb][n], then P (n x n) when it fits,
    // then the stack slots' scalars [4][D][cb]
#define VEC(k) (smem + ((size_t)(k) * cb + w) * n)
    float *lq = VEC(0), *lp = VEC(1), *lg = VEC(2);
    float *rq = VEC(3), *rp = VEC(4), *rg = VEC(5);
    float *cq = VEC(6), *cp = VEC(7), *cg = VEC(8);
    float *prq = VEC(9), *psum = VEC(10), *vv = VEC(11);
#undef VEC
    float* after_vec = smem + (size_t)12 * cb * n;
    const float* lam = P.consts;
    float* slot_sc = after_vec;
    if (BODY == 1 && P.lam_in_smem) {
        for (int k = threadIdx.x; k < n * n; k += blockDim.x) after_vec[k] = P.consts[k];
        lam = after_vec;
        slot_sc = after_vec + (size_t)n * n;
    }
    float* s_e = slot_sc;                       // [D][cb] proposal energy
    float* s_lpp = slot_sc + (size_t)D * cb;    // proposal logp
    float* s_ls = slot_sc + (size_t)2 * D * cb; // log size
    float* s_lw = slot_sc + (size_t)3 * D * cb; // log weighted accept sum
    __shared__ int max_sched_sh;

    const size_t stride_k = (size_t)D * C * n;  // between the 4 stacks
    auto slot = [&](int k, int s) -> float* {
        return P.stack + k * stride_k + ((size_t)s * C + chain) * n;
    };
    auto ssc = [&](float* arr, int s) -> float& { return arr[s * cb + w]; };

    const float* qin = P.q + (size_t)chain * n;
    const float* pin = P.p + (size_t)chain * n;
    const float* gin = P.g + (size_t)chain * n;
    const float* vin = P.var + (size_t)chain * n;
    float part = 0.f;
    for (int i = lane; i < n; i += 32) {
        float q = qin[i], p = pin[i], g = gin[i], v = vin[i];
        lq[i] = q; rq[i] = q; prq[i] = q;
        lp[i] = p; rp[i] = p; psum[i] = p;
        lg[i] = g; rg[i] = g;
        vv[i] = v;
        part += p * (v * p);
    }
    const float lp0 = P.logp[chain];
    const float eps = P.eps[chain];
    const int mdc = P.mdc[chain];
    const float E0 = 0.5f * warp_sum(part) - lp0;

    if (threadIdx.x == 0) max_sched_sh = 0;
    __syncthreads();  // also publishes P in shared memory
    if (lane == 0) atomicMax(&max_sched_sh, mdc);
    __syncthreads();
    const int max_sched = min(max_sched_sh, D);

    // counter PRNG: salt per chain, one call counter per block
    const uint32_t salt = fmix32((P.seed0 + blockIdx.x * 7919u + (uint32_t)w * 101027u)
                                 ^ (P.seed1 * 0x9E3779B9u));
    uint32_t calls = 0;
    auto uniform = [&]() -> float {
        ++calls;
        uint32_t x = fmix32(salt ^ (calls * 0x9E3779B9u));
        return ((float)(x >> 8) + 0.5f) * (1.0f / 16777216.0f);
    };

    float acc_ls = 0.f, acc_lw = -CUDART_INF_F, mec = 0.f;
    int depth_c = 0, nlv = 0;
    bool div = false, trn = false;
    float pr_e = E0, pr_lp = lp0, c_e = E0, c_lp = lp0;

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
                const float kick0 = P.b[0] * epss;
                for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick0 * cg[i];
                for (int s = 0; s < P.n_stages; ++s) {
                    const float drift = P.a[s] * epss;
                    for (int i = lane; i < n; i += 32) cq[i] = cq[i] + drift * (vv[i] * cp[i]);
                    __syncwarp();
                    c_lp = model_eval<BODY>(cq, cg, lam, n, lane);
                    const float kick = P.b[s + 1] * epss;
                    for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick * cg[i];
                }
                part = 0.f;
                for (int i = lane; i < n; i += 32) part += cp[i] * (vv[i] * cp[i]);
                c_e = 0.5f * warp_sum(part) - c_lp;

                dE = c_e - E0;
                if (isnan(dE)) dE = CUDART_INF_F;
                if (fabsf(dE) > fabsf(mec)) mec = dE;
                div_leaf = !(fabsf(dE) < P.Emax);
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
                    float d1 = 0.f, d2 = 0.f;
                    for (int i = lane; i < n; i += 32) {
                        const float t1p = sps[i], t2p = cp[i], v = vv[i];
                        const float ps = t1p + t2p;
                        d1 += ps * (v * t1p);
                        d2 += ps * (v * t2p);
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
                    float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                    for (int i = lane; i < n; i += 32) {
                        const float v = vv[i];
                        const float t1lp = a_lp[i], t1rp = a_rp[i], t1ps = a_ps[i];
                        const float t2lp = b_lp[i], t2rp = b_rp[i], t2ps = b_ps[i];
                        const float vt1lp = v * t1lp, vt1rp = v * t1rp;
                        const float vt2lp = v * t2lp, vt2rp = v * t2rp;
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
            float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int i = lane; i < n; i += 32) {
                const float v = vv[i];
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
                d[0] += pst * (v * new_l_p);
                d[1] += pst * (v * new_r_p);
                const float ps1 = go_right ? old_ps + n_lp : n_ps + old_l_p;
                const float p1a = go_right ? old_l_p : n_rp;
                const float p1b = go_right ? n_lp : old_l_p;
                d[2] += ps1 * (v * p1a);
                d[3] += ps1 * (v * p1b);
                const float ps2 = go_right ? old_r_p + n_ps : n_lp + old_ps;
                const float p2a = go_right ? old_r_p : n_lp;
                const float p2b = go_right ? n_rp : old_r_p;
                d[4] += ps2 * (v * p2a);
                d[5] += ps2 * (v * p2b);
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

    // the proposal's gradient is recomputed, not carried (:810-813)
    model_eval<BODY>(prq, cg, lam, n, lane);
    float* qo = P.q_out + (size_t)chain * n;
    float* go = P.g_out + (size_t)chain * n;
    for (int i = lane; i < n; i += 32) { qo[i] = prq[i]; go[i] = cg[i]; }
    if (lane == 0) {
        P.energy[chain] = pr_e;
        P.logp_out[chain] = pr_lp;
        P.log_size[chain] = acc_ls;
        P.lwas[chain] = acc_lw;
        P.mec[chain] = mec;
        P.depth[chain] = depth_c;
        P.n_leaves[chain] = nlv;
        P.diverging[chain] = div;
        P.turning[chain] = trn;
    }
}

// 227 KB per block on Hopper, less room for the static shared int
constexpr size_t kSmemLimit = 232448 - 1024;

template <int BODY>
cudaError_t launch(const Params& P, cudaStream_t stream) {
    size_t vec_bytes = (size_t)12 * P.cb * P.n * sizeof(float);
    size_t sc_bytes = (size_t)4 * P.D * P.cb * sizeof(float);
    size_t lam_bytes = BODY == 1 ? (size_t)P.n * P.n * sizeof(float) : 0;
    Params Q = P;
    Q.lam_in_smem = (vec_bytes + sc_bytes + lam_bytes <= kSmemLimit) ? 1 : 0;
    size_t bytes = vec_bytes + sc_bytes + (Q.lam_in_smem ? lam_bytes : 0);
    if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(nuts_trajectory_kernel<BODY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    nuts_trajectory_kernel<BODY><<<P.C / P.cb, 32 * P.cb, bytes, stream>>>(Q);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int nuts_trajectory_launch(
    const float* q, const float* p, const float* g, const float* var,
    const float* logp, const float* eps, const int* mdc,
    unsigned int seed0, unsigned int seed1, int body, const float* consts,
    int C, int n, int D, float Emax, int cb, int n_stages, const float* coef,
    float* stack, float* q_out, float* g_out, float* energy, float* logp_out,
    float* log_size, float* lwas, float* mec, int* depth, int* n_leaves,
    bool* diverging, bool* turning, void* stream) {
    if (cb < 1 || cb > kMaxChainBlock || C % cb != 0 || n < 1 || D < 1 || n_stages < 1 || n_stages > 3)
        return (int)cudaErrorInvalidValue;
    Params P;
    P.q = q; P.p = p; P.g = g; P.var = var; P.logp = logp; P.eps = eps; P.mdc = mdc;
    P.consts = consts; P.stack = stack;
    P.q_out = q_out; P.g_out = g_out; P.energy = energy; P.logp_out = logp_out;
    P.log_size = log_size; P.lwas = lwas; P.mec = mec; P.depth = depth;
    P.n_leaves = n_leaves; P.diverging = diverging; P.turning = turning;
    P.seed0 = seed0; P.seed1 = seed1;
    P.C = C; P.n = n; P.D = D; P.cb = cb; P.n_stages = n_stages; P.Emax = Emax;
    for (int k = 0; k < 4; ++k) P.b[k] = coef[k];
    for (int k = 0; k < 3; ++k) P.a[k] = coef[4 + k];
    P.lam_in_smem = 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (body) {
        case 0: return (int)launch<0>(P, s);
        case 1:
            if (n > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
            return (int)launch<1>(P, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
