// One whole NUTS transition per chain, diag, dense or low-rank metric, model
// inlined.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/nuts_trajectory_pallas.py::
// build_trajectory_op (pallas_call at :1023; body _build_kernel_body :755
// and _run_transition :374-697) for metric="diag", "dense" and "lowrank",
// pack=1. The plain PyTorch version it is held against is
// ops/nuts_trajectory.py::trajectory_plain. The transition itself is
// nuts_transition.cuh, which the fused kernel (fused_nuts.cu) shares.
//
// Mapping. One thread block is one chain block of CB chains, one warp per
// chain, run in lockstep (see nuts_transition.cuh). Randomness: the JAX
// kernel's counter stream with block_id = blockIdx.x and the chain's row
// within its block, so this kernel, the plain version and the JAX kernel
// under interpret=True draw the same numbers.
//
// What bounds it on this card. Per leaf and chain: the model body (for
// the correlated Gaussian a 2n^2-FLOP matvec, g = -q P) plus about 20n
// elementwise operations for the kick, drift, energy and U-turn dots; the
// dense metric adds velocity matvecs (p @ COV, 2n^2 FLOP each). That is
// fp32 work outside the tensor cores, so the bound is operations over the
// 67 TFLOP/s fp32 peak. Device memory is touched only for the inputs, the
// outputs and the merge stack.
// What the design does about it: the working states (left, right and
// current edge, proposal, momentum sum, inverse mass or velocity scratch),
// the precision matrix P and, for the dense metric, COV live in shared
// memory when they fit (P and COV are read from global memory, where L2
// holds them, when they do not), so the matvecs read their matrix from
// shared memory, broadcast q[i] across the warp and keep up to 8 output
// columns per lane in registers. The merge stack lives in a global scratch
// tensor (4 x D x C x n floats, 16 MB at the main path's shapes) that
// stays in the 50 MB L2. The logistic body (3) stages its design matrix
// Xb (1000 x 25 floats, 100 KB, at an odd row stride) and y in shared
// memory beside the vectors when they fit, else reads them through L2;
// its leaf costs 2 N n FMAs and 2 N exponentials a chain (lanes own data
// rows for the logits, then gradient columns; nuts_transition.cuh::
// logistic_rows). Chains that stopped building skip the leapfrog
// and the merges. Each block waits for its own deepest tree only: small
// blocks shrink the lockstep tail. The dense metric recomputes each
// velocity where the U-turn checks need it, as the JAX kernel does; caching
// (p, p @ COV) pairs in the stack would halve those matvecs and is left to
// a later change. The low-rank metric (the pooled QuadPotentialLowRankAdapt)
// keeps each chain's scales where kDiag keeps its diagonal and stages the
// shared factor block (8 rows of V^T, the coefficients and alpha: 3.3 KB
// at n = 100) in shared memory once a launch, beside the merge stack's
// scalars; each velocity is two thin matvecs from it (4 n k + 5 n
// operations, k = 8), nuts_transition.cuh::lowrank_velocity. The spiked
// Gaussian body (4) reads its V the same way.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no contraction of a*b+c, so elementwise rounding matches
// the plain PyTorch version; the matvecs use fmaf explicitly). Plain C
// interface, loaded with ctypes.

#include "nuts_transition.cuh"

namespace {

using namespace lmc;

struct Params {
    const float* q;
    const float* p;
    const float* g;
    const float* var;  // kDiag: (C, n) inverse-mass diagonals; kDense: (n, n) COV;
                       // kLowRank: (C, n) scales
    const float* fac;  // kLowRank: the factor block (lowrank_fac_size floats)
    const float* logp;
    const float* eps;
    const int* mdc;
    const float* consts;  // the body's packed constants (body_floats, nuts_transition.cuh)
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
    int C, n, D, cb, n_stages, rows;
    float Emax;
    float b[4];
    float a[3];
    int lam_in_smem, cov_in_smem;
};

// One chain block's transitions: the body of the kernels below.
template <int BODY, int METRIC>
__device__ __forceinline__ void run_block(const Params& P) {
    extern __shared__ float smem[];
    const int n = P.n, cb = P.cb, D = P.D;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * cb + w;

    // shared layout: the transition's vectors [NV][cb][n], the stack slots'
    // scalars [4][D][cb], then the body's constants (body_floats), COV
    // where they fit and the low-rank factor block
    const WarpVecs V = warp_vecs<METRIC>(smem, cb, w, n);
    float* slot_sc = smem + (size_t)n_warp_vecs<METRIC>() * cb * n;
    float* after = slot_sc + (size_t)4 * D * cb;
    TreeConsts T;
    T.lam = stage_body<BODY>(P.consts, n, P.rows, P.lam_in_smem ? after : nullptr);
    T.cov = P.var; T.stack = P.stack;
    T.C = P.C; T.n = n; T.D = D; T.cb = cb; T.n_stages = P.n_stages; T.rows = P.rows;
    T.Emax = P.Emax;
    for (int k = 0; k < 4; ++k) T.b[k] = P.b[k];
    for (int k = 0; k < 3; ++k) T.a[k] = P.a[k];
    if (P.lam_in_smem) after += body_floats(BODY, n, P.rows);
    if (METRIC == kDense && P.cov_in_smem) {
        for (int k = threadIdx.x; k < n * n; k += blockDim.x) after[k] = P.var[k];
        T.cov = after;
    }
    if constexpr (METRIC == kLowRank) {
        for (int k = threadIdx.x; k < lowrank_fac_floats(n); k += blockDim.x) after[k] = P.fac[k];
        T.cov = after;
    }

    const float* qin = P.q + (size_t)chain * n;
    const float* pin = P.p + (size_t)chain * n;
    const float* gin = P.g + (size_t)chain * n;
    if (METRIC != kDense) {  // the diagonal, or the low-rank scales
        const float* vin = P.var + (size_t)chain * n;
        for (int i = lane; i < n; i += 32) V.vv[i] = vin[i];
    }
    __syncthreads();  // the body's constants, COV and the factor are in shared memory

    float part = 0.f;
    if (METRIC != kDiag) {
        velocity<METRIC>(T.cov, V.vv, pin, V.va, n, lane);
        for (int i = lane; i < n; i += 32) part += pin[i] * V.va[i];
    } else {
        for (int i = lane; i < n; i += 32) {
            const float p = pin[i];
            part += p * (V.vv[i] * p);
        }
    }
    const float lp0 = P.logp[chain];
    const float E0 = 0.5f * warp_sum(part) - lp0;

    // counter PRNG: salt per chain, one call counter per block
    const uint32_t salt = fmix32((P.seed0 + blockIdx.x * 7919u + (uint32_t)w * 101027u)
                                 ^ (P.seed1 * kGolden));
    const TreeResult r = transition<BODY, METRIC>(T, V, slot_sc, chain, w, lane, qin, pin, gin,
                                                  lp0, E0, P.eps[chain], P.mdc[chain], salt);

    // the proposal's gradient is recomputed, not carried (:810-813)
    model_eval<BODY>(V.prq, V.cg, T.lam, n, P.rows, lane);
    float* qo = P.q_out + (size_t)chain * n;
    float* go = P.g_out + (size_t)chain * n;
    for (int i = lane; i < n; i += 32) { qo[i] = V.prq[i]; go[i] = V.cg[i]; }
    if (lane == 0) {
        P.energy[chain] = r.pr_e;
        P.logp_out[chain] = r.pr_lp;
        P.log_size[chain] = r.log_size;
        P.lwas[chain] = r.lwas;
        P.mec[chain] = r.mec;
        P.depth[chain] = r.depth;
        P.n_leaves[chain] = r.n_leaves;
        P.diverging[chain] = r.diverging;
        P.turning[chain] = r.turning;
    }
}

template <int BODY, int METRIC>
__global__ void __launch_bounds__(32 * kMaxChainBlock) nuts_trajectory_kernel(Params P) {
    run_block<BODY, METRIC>(P);
}

// kLowRank: 8 warps a block, one block an SM, so ptxas may give each
// thread up to 255 registers (max_chain_block, nuts_transition.cuh)
template <int BODY>
__global__ void __launch_bounds__(32 * kMaxLowRankChainBlock, 1)
    nuts_trajectory_lowrank_kernel(Params P) {
    run_block<BODY, kLowRank>(P);
}

template <int BODY, int METRIC>
constexpr auto kernel_of() {
    if constexpr (METRIC == kLowRank) return nuts_trajectory_lowrank_kernel<BODY>;
    else return nuts_trajectory_kernel<BODY, METRIC>;
}

// 227 KB per block on Hopper, less room for the static shared int
constexpr size_t kSmemLimit = 232448 - 1024;

template <int BODY, int METRIC>
cudaError_t launch(const Params& P, cudaStream_t stream) {
    size_t bytes = (size_t)n_warp_vecs<METRIC>() * P.cb * P.n * sizeof(float)
                   + (size_t)4 * P.D * P.cb * sizeof(float)
                   + (METRIC == kLowRank ? (size_t)lowrank_fac_floats(P.n) * sizeof(float) : 0);
    const size_t sq_bytes = (size_t)P.n * P.n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, P.n, P.rows) * sizeof(float);
    Params Q = P;
    Q.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= kSmemLimit) ? 1 : 0;
    if (Q.lam_in_smem) bytes += body_bytes;
    Q.cov_in_smem = (METRIC == kDense && bytes + sq_bytes <= kSmemLimit) ? 1 : 0;
    if (Q.cov_in_smem) bytes += sq_bytes;
    if (bytes > kSmemLimit || P.cb > max_chain_block<METRIC>())
        return cudaErrorInvalidConfiguration;
    const auto kernel = kernel_of<BODY, METRIC>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<P.C / P.cb, 32 * P.cb, bytes, stream>>>(Q);
    return cudaGetLastError();
}

template <int BODY>
cudaError_t launch_metric(const Params& P, int metric, cudaStream_t stream) {
    switch (metric) {
        case kDiag: return launch<BODY, kDiag>(P, stream);
        case kDense: return launch<BODY, kDense>(P, stream);
        case kLowRank: return launch<BODY, kLowRank>(P, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). metric: 0
// diag (var is (C, n)), 1 dense (var is the shared (n, n) covariance), 2
// low-rank (var is the (C, n) scales, fac the shared factor block);
// consts: the body's packed constants, rows its data rows (body 3) or
// spikes (body 4).
int nuts_trajectory_launch(
    const float* q, const float* p, const float* g, const float* var, const float* fac,
    const float* logp, const float* eps, const int* mdc,
    unsigned int seed0, unsigned int seed1, int body, int metric, const float* consts,
    int rows, int C, int n, int D, float Emax, int cb, int n_stages, const float* coef,
    float* stack, float* q_out, float* g_out, float* energy, float* logp_out,
    float* log_size, float* lwas, float* mec, int* depth, int* n_leaves,
    bool* diverging, bool* turning, void* stream) {
    if (cb < 1 || cb > kMaxChainBlock || C % cb != 0 || n < 1 || D < 1 || n_stages < 1 || n_stages > 3)
        return (int)cudaErrorInvalidValue;
    if ((body == 1 || body == 3 || metric == kDense) && n > 32 * kMaxCols)
        return (int)cudaErrorInvalidValue;
    if ((body == 2 && n != 10) || (body == 3 && rows < 1)
        || (body == 4 && (rows < 1 || rows > kMaxRank)) || (metric == kLowRank && fac == nullptr)
        || (body == 5 && n < 2) || (body == kAutoBody && n > 32 * kMaxCols))
        return (int)cudaErrorInvalidValue;
    Params P;
    P.q = q; P.p = p; P.g = g; P.var = var; P.fac = fac;
    P.logp = logp; P.eps = eps; P.mdc = mdc;
    P.consts = consts; P.stack = stack;
    P.q_out = q_out; P.g_out = g_out; P.energy = energy; P.logp_out = logp_out;
    P.log_size = log_size; P.lwas = lwas; P.mec = mec; P.depth = depth;
    P.n_leaves = n_leaves; P.diverging = diverging; P.turning = turning;
    P.seed0 = seed0; P.seed1 = seed1;
    P.C = C; P.n = n; P.D = D; P.cb = cb; P.n_stages = n_stages; P.rows = rows; P.Emax = Emax;
    for (int k = 0; k < 4; ++k) P.b[k] = coef[k];
    for (int k = 0; k < 3; ++k) P.a[k] = coef[4 + k];
    P.lam_in_smem = 0;
    P.cov_in_smem = 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (body) {
#ifndef LMC_AUTOSPEC_ONLY  // a generated body's library holds its instances only
        case 0: return (int)launch_metric<0>(P, metric, s);
        case 1: return (int)launch_metric<1>(P, metric, s);
        case 2: return (int)launch_metric<2>(P, metric, s);
        case 3: return (int)launch_metric<3>(P, metric, s);
        case 4: return (int)launch_metric<4>(P, metric, s);
        case 5: return (int)launch_metric<5>(P, metric, s);
#endif
#ifdef LMC_AUTOSPEC_HEADER
        case kAutoBody: return (int)launch_metric<kAutoBody>(P, metric, s);
#endif
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
