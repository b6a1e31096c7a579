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
// chain, run in lockstep (see nuts_transition.cuh). Bodies 0, 1, 2, 4 and
// 5 with the diagonal metric, body 1 with the dense metric and body 4 with
// the low-rank metric in blocks of up to 8 chains (the main path's, the
// `adapt_full` twin's, eight schools' per-draw twin's, F1's, L0's and
// L2's) run the block transition (nuts_transition.cuh, block_transition)
// in instances compiled for 8 warps; everything else runs `transition`.
// Randomness: the JAX
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
// stays in the 50 MB L2. The block transition (the main path's instance,
// nuts_transition.cuh at kBlockChains) instead evaluates the correlated
// Gaussian for its 8 chains in one product a leaf, P read once a group of
// 4 chains rather than once a chain, keeps the stack's lower slots in
// shared memory (all 9 of depth 10 at n = 100: 115 KB beside 38 KB of
// vectors, P and the 3.2 KB of staged positions), and issues each pass's
// loads for 4 trips at once. The section clocks
// (scripts/torch_transition_clocks.py, PERF.md) found a chain's leaf there
// latency-bound: 13,400 cycles of its 19,500 in the per-warp product, with
// one warp a chain and eight an SM. The logistic body (3) stages its
// design matrix Xb (1000 x 25 floats, 100 KB, at an odd row stride) and y
// in shared memory beside the vectors when they fit, else reads them
// through L2;
// its leaf costs 2 N n FMAs and 2 N exponentials a chain. Lanes own data
// rows through both passes, four rows a lane at once, and the gradient's
// column sums come out of one reduce-scatter a 32-column chunk
// (nuts_transition.cuh::logistic_rows): no dependent chain longer than n
// FMAs, where one warp a chain (eight an SM) leaves no other warps to hide
// it. A generated body (ops/autospec.py) keeps its values in registers
// within a fused loop and the rest in the warp's scratch row, in shared
// memory after everything else where it fits (else in a global scratch
// that L2 holds). Chains that stopped building skip the leapfrog
// and the merges. Each block waits for its own deepest tree only: small
// blocks shrink the lockstep tail. The warp transition recomputes each
// dense velocity where the U-turn checks need it, as the JAX kernel does
// (46 matvecs a chain-draw at 7 leaves, 13,700 cycles each on one warp:
// PERF.md). The dense block transition (body 1) computes a leaf's three
// products for the block's chains at once (the start velocity too) and
// caches each leaf's velocity p @ COV beside p in the stack (6 vectors a
// slot: the global stack is [6][D][C][n] there) and at the tree's edges,
// so that its merges and U-turn checks do no product: 21 block products a
// draw at 7 leaves. The low-rank metric (the pooled QuadPotentialLowRankAdapt)
// keeps each chain's scales where kDiag keeps its diagonal and stages the
// shared factor block (8 rows of V^T, the coefficients and alpha: 3.3 KB
// at n = 100) in shared memory once a launch, beside the merge stack's
// scalars; each velocity is two thin matvecs from it (4 n k + 5 n
// operations, k = 8), nuts_transition.cuh::lowrank_velocity. The spiked
// Gaussian body (4) reads its V the same way. With the low-rank metric
// body 4 runs the block transition: the velocities' thin dots ride in the
// leapfrog's passes beside the body's, and each leaf's velocity is cached
// in the stack as the dense metric's is (2 velocities a leaf, none in the
// merges and U-turn checks, where the warp transition recomputes them).
// Eight schools (body 2, n = 10: ten lanes of each chain's warp work) runs
// the block transition with the body inside the leapfrog's two passes,
// each lane's column, inverse mass and two constants in registers through
// a leaf and the body's four sums in one butterfly, the whole merge stack
// in shared memory; its cells' 10,240 chains make 1,280 blocks, several
// times the card's 132 SMs, so its instance is compiled for more than one
// block an SM (nuts_trajectory_es_block_kernel).
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
    float* stack;         // [4][D][C][n]: left p, right p, p sum, proposal q; the
                          // dense and low-rank block transitions' [6][D][C][n] add
                          // their velocities
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
    int lam_in_smem, cov_in_smem, scratch_in_smem, smem_slots;
};

// One chain block's transitions: the body of the kernels below; BLOCK: the
// block transition.
template <int BODY, int METRIC, bool BLOCK>
__device__ __forceinline__ void run_block(const Params& P) {
    extern __shared__ float smem[];
    const int n = P.n, cb = P.cb, D = P.D;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * cb + w;
    LMC_CLK_BLOCK_START(P.C);

    // shared layout: the transition's vectors [NV][cb][n], the stack slots'
    // scalars [4][D][cb], the block transition's staged rows (body 1, on a
    // 16-byte boundary), then the body's constants (body_floats), COV
    // where they fit, the low-rank factor block, the generated body's
    // scratch rows [cb][body_scratch_floats] where they fit, and the block
    // transition's lower stack slots [smem_slots][slot_vecs][cb][n]
    const WarpVecs V = warp_vecs<METRIC>(smem, cb, w, n);
    float* slot_sc = smem + (size_t)n_warp_vecs<METRIC>() * cb * n;
    float* after = slot_sc + (size_t)4 * D * cb;
    float* qt = nullptr;
    if constexpr (BLOCK && BODY == 1) {
        qt = align16(after);
        after = qt + staged_floats<BODY>(n, cb);
    }
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
        after += (size_t)n * n;
    }
    if constexpr (METRIC == kLowRank) {
        for (int k = threadIdx.x; k < lowrank_fac_floats(n); k += blockDim.x) after[k] = P.fac[k];
        T.cov = after;
        after += lowrank_fac_floats(n);
    }
    set_consts_scratch(T, warp_scratch<BODY>(P.scratch_in_smem ? after : nullptr, w));
    const BlockState BS{after, qt, P.smem_slots};

    const float* qin = P.q + (size_t)chain * n;
    const float* pin = P.p + (size_t)chain * n;
    const float* gin = P.g + (size_t)chain * n;
    if (METRIC != kDense) {  // the diagonal, or the low-rank scales
        const float* vin = P.var + (size_t)chain * n;
        for (int i = lane; i < n; i += 32) V.vv[i] = vin[i];
    }
    __syncthreads();  // the body's constants, COV and the factor are in shared memory

    float part = 0.f;
    if constexpr (BLOCK && METRIC == kDense) {
        // the block's start velocities p0 COV in one product, into V.vc
        // (where the block transition takes them)
        const int qt_off = smem_offset(qt), stride = staged_stride(cb);
        for (int i = lane; i < n; i += 32) stage(qt_off, stride, w, i, pin[i]);
        __syncthreads();  // every chain's p0 is staged
        block_velocity(T, qt_off, smem_offset(V.vc) - w * n);
        __syncthreads();  // every velocity is written
        for (int i = lane; i < n; i += 32) part += pin[i] * V.vc[i];
    } else if (METRIC != kDiag) {
        // the block transition takes the start velocity in V.vc
        float* v0 = BLOCK ? V.vc : V.va;
        velocity<METRIC>(T.cov, V.vv, pin, v0, n, lane);
        for (int i = lane; i < n; i += 32) part += pin[i] * v0[i];
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
    const TreeResult r = any_transition<BODY, METRIC, BLOCK>(T, BS, V, slot_sc, chain, w, lane,
                                                             qin, pin, gin, lp0, E0,
                                                             P.eps[chain], P.mdc[chain], salt);

    // the proposal's gradient is recomputed, not carried (:810-813)
    if constexpr (BLOCK) proposal_grad<BODY>(T, BS, V.prq, V.cg, w, lane);
    else model_eval<BODY>(V.prq, V.cg, T.lam, n, P.rows, lane, consts_scratch(T));
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
    LMC_CLK_BLOCK_END(P.C);
}

// BLOCK: the block transition's instances, 8 warps a block, so ptxas may
// give a thread up to 255 registers
template <int BODY, int METRIC, bool BLOCK>
__global__ void __launch_bounds__(32 * (BLOCK ? kBlockChains : kMaxChainBlock))
    nuts_trajectory_kernel(Params P) {
    run_block<BODY, METRIC, BLOCK>(P);
}

// kLowRank: 8 warps a block, one block an SM, so ptxas may give each
// thread up to 255 registers (max_chain_block, nuts_transition.cuh); body
// 4's instance runs the block transition (nuts_trajectory_lowrank_block_kernel)
template <int BODY>
__global__ void __launch_bounds__(32 * kMaxLowRankChainBlock, 1)
    nuts_trajectory_lowrank_kernel(Params P) {
    run_block<BODY, kLowRank, false>(P);
}

// Body 4 with the low-rank metric on the block transition, one block an SM
template <int BODY>
__global__ void __launch_bounds__(32 * kBlockChains, 1)
    nuts_trajectory_lowrank_block_kernel(Params P) {
    run_block<BODY, kLowRank, true>(P);
}

// Body 1 with the dense metric on the block transition, one block an SM
// (its shared memory holds one anyway): with room for a second block
// ptxas may hold it to 128 registers and spill
template <int BODY>
__global__ void __launch_bounds__(32 * kBlockChains, 1)
    nuts_trajectory_dense_block_kernel(Params P) {
    run_block<BODY, kDense, true>(P);
}

// Body 2 (eight schools, n = 10) on the block transition, compiled for
// kEsBlocksPerSm blocks an SM (nuts_transition.cuh)
template <int BODY>
__global__ void __launch_bounds__(32 * kBlockChains, kEsBlocksPerSm)
    nuts_trajectory_es_block_kernel(Params P) {
    run_block<BODY, kDiag, true>(P);
}

template <int BODY, int METRIC, bool BLOCK>
constexpr auto kernel_of() {
    if constexpr (BLOCK && METRIC == kLowRank) return nuts_trajectory_lowrank_block_kernel<BODY>;
    else if constexpr (BLOCK && BODY == 2) return nuts_trajectory_es_block_kernel<BODY>;
    else if constexpr (METRIC == kLowRank) return nuts_trajectory_lowrank_kernel<BODY>;
    else if constexpr (BLOCK && METRIC == kDense) return nuts_trajectory_dense_block_kernel<BODY>;
    else return nuts_trajectory_kernel<BODY, METRIC, BLOCK>;
}

// 227 KB per block on Hopper, less room for the static shared int
constexpr size_t kSmemLimit = 232448 - 1024;

template <int BODY, int METRIC, bool BLOCK>
cudaError_t launch_instance(const Params& P, cudaStream_t stream) {
    size_t bytes = (size_t)n_warp_vecs<METRIC>() * P.cb * P.n * sizeof(float)
                   + (size_t)4 * P.D * P.cb * sizeof(float);
    if (BLOCK && BODY == 1)  // the staged positions, moved up to 12 bytes to a 16-byte boundary
        bytes += 12 + staged_floats<BODY>(P.n, P.cb) * sizeof(float);
    if (METRIC == kLowRank) bytes += (size_t)lowrank_fac_floats(P.n) * sizeof(float);
    const size_t sq_bytes = (size_t)P.n * P.n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, P.n, P.rows) * sizeof(float);
    Params Q = P;
    Q.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= kSmemLimit) ? 1 : 0;
    if (Q.lam_in_smem) bytes += body_bytes;
    // the block transition reads body 4's constants as shared memory: where
    // they do not fit there, the warp transition runs (with the low-rank
    // metric, which has no warp instance of body 4, the launch is refused)
    if constexpr (BLOCK && BODY == 4 && METRIC == kLowRank) {
        if (!Q.lam_in_smem) return cudaErrorInvalidConfiguration;
    } else if constexpr (BLOCK && BODY == 4) {
        if (!Q.lam_in_smem) return launch_instance<BODY, METRIC, false>(P, stream);
    }
    Q.cov_in_smem = (METRIC == kDense && bytes + sq_bytes <= kSmemLimit) ? 1 : 0;
    if (Q.cov_in_smem) bytes += sq_bytes;
    Q.scratch_in_smem = scratch_fits<BODY>(bytes, P.cb, kSmemLimit) ? 1 : 0;
    if (Q.scratch_in_smem) bytes += (size_t)body_scratch_floats<BODY>() * P.cb * sizeof(float);
    if (bytes > kSmemLimit || P.cb > (BLOCK ? kBlockChains : max_chain_block<METRIC>()))
        return cudaErrorInvalidConfiguration;
    if (BLOCK) {
        constexpr int vecs = slot_vecs<METRIC>();
        Q.smem_slots = smem_stack_slots(bytes, P.cb, P.n, P.D, kSmemLimit, vecs);
        bytes += (size_t)Q.smem_slots * vecs * P.cb * P.n * sizeof(float);
    }
    const auto kernel = kernel_of<BODY, METRIC, BLOCK>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    err = record_residency<BODY, METRIC, BLOCK>(kernel, 32 * P.cb, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<P.C / P.cb, 32 * P.cb, bytes, stream>>>(Q);
    return cudaGetLastError();
}

// An instance on the block transition whose blocks never take more than
// kBlockChains chains (body 4 with kLowRank) has no warp instance.
template <int BODY, int METRIC>
cudaError_t launch(const Params& P, cudaStream_t stream) {
    if constexpr (block_body<BODY, METRIC>() && max_chain_block<METRIC>() <= kBlockChains) {
        if (P.cb > kBlockChains) return cudaErrorInvalidConfiguration;
        return launch_instance<BODY, METRIC, true>(P, stream);
    } else {
        if constexpr (block_body<BODY, METRIC>())
            if (P.cb <= kBlockChains) return launch_instance<BODY, METRIC, true>(P, stream);
        return launch_instance<BODY, METRIC, false>(P, stream);
    }
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
    P.scratch_in_smem = 0;
    P.smem_slots = 0;
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

// Blocks an SM of the last launch (nuts_transition.cuh, last_blocks_per_sm).
int nuts_trajectory_last_blocks_per_sm(void) {
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

// The side rows (nuts_transition.cuh, side_buf): the transition's products.
int side_clocks_bind(void* buf) {
    return (int)cudaMemcpyToSymbol(lmc::side_buf, &buf, sizeof(buf));
}
#endif

}  // extern "C"
