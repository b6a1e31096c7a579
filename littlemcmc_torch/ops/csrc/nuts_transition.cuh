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
//   Body 4 with this metric runs block_transition below, which computes
//   the same velocities inside its per-element passes and caches each
//   leaf's, as it does kDense's.
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

// Where the last launch of this library put the generated body's scratch
// rows: 1 shared memory, 0 the global scratch (scratch_fits sets it; the
// generated header exports it as autospec_scratch_in_smem). Static: one
// flag a library (an inline variable would be one symbol that the dynamic
// loader shares among every library of the process).
static int last_scratch_in_smem = 0;

// Blocks an SM of the last launch of this library's NUTS kernel:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's threads
// and dynamic shared memory (record_residency; the library exports it).
static int last_blocks_per_sm = 0;

// Records the blocks an SM of a launch of `kernel` (last_blocks_per_sm),
// asking the runtime once an instance (the template arguments) and launch
// shape, so that the per-draw path adds no host work a launch. Static, as
// last_blocks_per_sm: its counters are this library's own. A readout for
// chip_smoke.py and the scripts: the launch itself does not use it.
template <int BODY, int METRIC, bool BLOCK, class Kernel>
static cudaError_t record_residency(Kernel kernel, int threads, size_t bytes) {
    static int seen_threads = 0, blocks = 0;
    static size_t seen_bytes = 0;
    if (threads != seen_threads || bytes != seen_bytes) {
        const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
        if (err != cudaSuccess) return err;
        seen_threads = threads;
        seen_bytes = bytes;
    }
    last_blocks_per_sm = blocks;
    return cudaSuccess;
}

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

// Section clocks of the transition, compiled only into the instrumented
// builds of scripts/torch_transition_clocks.py (LMC_TRANSITION_CLOCKS; the
// package's own build never sets it). Each warp charges the SM cycles
// since its last mark to the section a mark names, in registers, and adds
// them to its chain's row of clock_buf at the end of each transition;
// each block records its start and end on the global timer and its SM.
// clock_buf: [C][kClkSlots] per chain, then [blocks][4] (start ns, end ns,
// SM id, unused), bound by transition_clocks_bind. The marks sit in both
// transitions: transition's measured the main path's instance before it
// moved to block_transition (PERF.md).
constexpr int kClkBody = 0;         // the model body
constexpr int kClkLeapfrog = 1;     // the leapfrog's element-wise loops (kick, drift, energy)
constexpr int kClkLeafStore = 2;    // an even leaf's stack stores
constexpr int kClkMerge = 3;        // the merges' and the depth's passes over the slots
constexpr int kClkWarpSums = 4;     // the warp sums (energy, merges, U-turn checks)
constexpr int kClkSync = 5;         // block-wide votes while this chain builds
constexpr int kClkWait = 6;         // block-wide votes while it waits for the block's deepest
constexpr int kClkOther = 7;        // scalar work (uniforms, log-sum-exps), the depth's set-up
constexpr int kClkSections = 8;
constexpr int kClkSlots = 10;       // the sections, then leaf steps and leaves built
// The side rows ([C][kSideSlots] per chain, bound by side_clocks_bind):
// the fused kernel's per-draw work around the transition, each a chain's
// SM cycles (the normals and the momentum, the start velocity and energy,
// the transition, the work after it up to the pooled Welford adds, those
// adds and the window swap), its draws, and the n x n products (a warp's
// matvec, or a block-wide product counted once for each chain of the
// block) that the transition and the fused kernel's draw run, for
// kLowRank its velocities (and the fused momentum's thin matvecs).
constexpr int kSideMomentum = 0;
constexpr int kSideStart = 1;
constexpr int kSideTree = 2;
constexpr int kSideAfter = 3;
constexpr int kSideWelford = 4;
constexpr int kSideDraws = 5;
constexpr int kSideProducts = 6;
constexpr int kSideSlots = 7;
#ifdef LMC_TRANSITION_CLOCKS
__device__ unsigned long long* clock_buf;
__device__ unsigned long long* side_buf;

__device__ __forceinline__ void side_add(int chain, int lane, int slot, unsigned long long v) {
    if (side_buf != nullptr && lane == 0) atomicAdd(side_buf + (size_t)chain * kSideSlots + slot, v);
}

struct SectionClock {
    unsigned int t, acc[kClkSections], steps, built, products;
    __device__ __forceinline__ void begin() {
        t = (unsigned int)clock();
#pragma unroll
        for (int k = 0; k < kClkSections; ++k) acc[k] = 0u;
        steps = built = products = 0u;
    }
    template <int K>
    __device__ __forceinline__ void mark() {
        const unsigned int now = (unsigned int)clock();
        acc[K] += now - t;
        t = now;
    }
    __device__ __forceinline__ void vote(bool building) {
        if (building) mark<kClkSync>();
        else mark<kClkWait>();
    }
    __device__ __forceinline__ void flush(int chain, int lane) {
        if (clock_buf == nullptr || lane != 0) return;
        unsigned long long* row = clock_buf + (size_t)chain * kClkSlots;
#pragma unroll
        for (int k = 0; k < kClkSections; ++k) atomicAdd(row + k, (unsigned long long)acc[k]);
        atomicAdd(row + kClkSections, (unsigned long long)steps);
        atomicAdd(row + kClkSections + 1, (unsigned long long)built);
        side_add(chain, lane, kSideProducts, products);
    }
};

// The fused kernel's clock of a chain's draws (kSide* above): mark<K>
// charges the cycles since the last mark to slot K.
struct DrawClock {
    long long t;
    unsigned long long acc[kSideDraws], draws, products;
    __device__ __forceinline__ void begin() {
        t = clock64();
#pragma unroll
        for (int k = 0; k < kSideDraws; ++k) acc[k] = 0ull;
        draws = products = 0ull;
    }
    template <int K>
    __device__ __forceinline__ void mark() {
        const long long now = clock64();
        acc[K] += (unsigned long long)(now - t);
        t = now;
    }
    __device__ __forceinline__ void flush(int chain, int lane) {
#pragma unroll
        for (int k = 0; k < kSideDraws; ++k) side_add(chain, lane, k, acc[k]);
        side_add(chain, lane, kSideDraws, draws);
        side_add(chain, lane, kSideProducts, products);
    }
};

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Block b's start (END false) or end on the global timer, and its SM.
template <bool END>
__device__ __forceinline__ void clock_block(int C) {
    if (clock_buf == nullptr || threadIdx.x != 0) return;
    unsigned long long* row = clock_buf + (size_t)C * kClkSlots + (size_t)blockIdx.x * 4;
    row[END ? 1 : 0] = global_ns();
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    row[2] = sm;
}

#define LMC_CLK_BEGIN() ::lmc::SectionClock clk_; clk_.begin()
#define LMC_CLK(K) clk_.mark<K>()
#define LMC_CLK_VOTE(building) clk_.vote(building)
#define LMC_CLK_LEAF(building) (++clk_.steps, clk_.built += (building) ? 1u : 0u)
#define LMC_CLK_FLUSH(chain, lane) clk_.flush(chain, lane)
#define LMC_CLK_BLOCK_START(C) ::lmc::clock_block<false>(C)
#define LMC_CLK_BLOCK_END(C) (__syncthreads(), ::lmc::clock_block<true>(C))
#define LMC_CLK_PRODUCT() (++clk_.products)
#define LMC_DCLK_BEGIN() ::lmc::DrawClock dclk_; dclk_.begin()
#define LMC_DCLK(K) dclk_.mark<K>()
#define LMC_DCLK_DRAW() (++dclk_.draws)
#define LMC_DCLK_PRODUCT() (++dclk_.products)
#define LMC_DCLK_FLUSH(chain, lane) dclk_.flush(chain, lane)
#else
#define LMC_CLK_BEGIN() ((void)0)
#define LMC_CLK(K) ((void)0)
#define LMC_CLK_VOTE(building) ((void)(building))
#define LMC_CLK_LEAF(building) ((void)(building))
#define LMC_CLK_FLUSH(chain, lane) ((void)0)
#define LMC_CLK_BLOCK_START(C) ((void)0)
#define LMC_CLK_BLOCK_END(C) ((void)0)
#define LMC_CLK_PRODUCT() ((void)0)
#define LMC_DCLK_BEGIN() ((void)0)
#define LMC_DCLK(K) ((void)0)
#define LMC_DCLK_DRAW() ((void)0)
#define LMC_DCLK_PRODUCT() ((void)0)
#define LMC_DCLK_FLUSH(chain, lane) ((void)0)
#endif

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

// The logistic body's register tile, set by each kernel's source before
// it includes this header (default: the per-draw kernels'): the rows a
// lane takes at once (their logits are independent FMA chains, and each
// gradient chunk reads the group's rows) and the gradient columns it
// accumulates at once (one partial sum a column in registers). The fused
// kernels, at 16 warps of 128 registers with the draw loop's state live,
// take a smaller tile.
#ifndef LMC_LOGISTIC_ROWS
#define LMC_LOGISTIC_ROWS 4
#endif
#ifndef LMC_LOGISTIC_CHUNK
#define LMC_LOGISTIC_CHUNK 32
#endif
constexpr int kLogisticRows = LMC_LOGISTIC_ROWS;
constexpr int kLogisticChunk = LMC_LOGISTIC_CHUNK;

// One stage of reduce_scatter: lanes with bit H set keep the upper half of
// the columns they hold and send the lower half to their partner, which
// keeps the lower half, each adding what it receives.
template <int H, int W>
__device__ __forceinline__ void reduce_scatter_stage(float (&v)[W], int lane) {
    const bool upper = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    if constexpr (H > 1) reduce_scatter_stage<H / 2, W>(v, lane);
}

// The transpose butterfly: each lane's W partial sums v in (v is spent),
// the warp's total of column lane % W out. W = 32 takes 16 + 8 + 4 + 2 + 1
// shuffles; a narrower W adds the lanes' copies with xor W, ..., 16.
template <int W>
__device__ __forceinline__ float reduce_scatter(float (&v)[W], int lane) {
    static_assert(W == 4 || W == 8 || W == 16 || W == 32,
                  "reduce_scatter takes 4, 8, 16 or 32 columns");
    reduce_scatter_stage<W / 2, W>(v, lane);
    float s = v[0];
#pragma unroll
    for (int o = W; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// Logistic regression over `rows` data rows for one chain at q (shared
// memory, read as a broadcast): X (rows, ldx) and y are relative to the
// rows' first. Lanes own rows through both passes, a lane taking
// kLogisticRows rows (lane, lane + 32, ...) of each block of
// 32 kLogisticRows: their logits as independent fp32 FMA chains, the
// stable softplus of jax.nn.softplus (max(x, 0) + log1p(exp(-|x|))) and
// the sigmoid from one exp(-|x|), y * logit - softplus into the lane's
// part of the log likelihood (returned). Then for each chunk of
// kLogisticChunk gradient columns every lane adds its rows' residuals
// y - sigma times x into one partial sum per column, and reduce_scatter
// turns the lanes' partial sums into the chunk's column totals: once at
// the end where n fits one chunk, after each row block otherwise, the
// lane owning the column adding it into g. No loop runs a dependent chain
// longer than n FMAs. On return g holds the likelihood's gradient, each
// column written by its owning lane (the caller syncs the warp).
__device__ __forceinline__ float logistic_rows(const float* q, const float* X, int ldx,
                                               const float* y, int rows, int n, int lane,
                                               float* g) {
    constexpr int R = kLogisticRows, W = kLogisticChunk;
    const int chunks = (n + W - 1) / W;
    for (int c = 0; c < chunks; ++c)
        if (lane < W && c * W + lane < n) g[c * W + lane] = 0.f;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
    float ll = 0.f;
    for (int base = 0; base < rows; base += 32 * R) {
        // a lane past the last row reads the last row, with a zero residual
        int xo[R];
        float lg[R], res[R];
#pragma unroll
        for (int t = 0; t < R; ++t) {
            xo[t] = min(base + 32 * t + lane, rows - 1) * ldx;
            lg[t] = 0.f;
        }
        for (int k = 0; k < n; ++k) {
            const float qk = q[k];
#pragma unroll
            for (int t = 0; t < R; ++t) lg[t] = fmaf(qk, X[xo[t] + k], lg[t]);
        }
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const int r = base + 32 * t + lane;
            res[t] = 0.f;
            if (r < rows) {
                const float yr = y[r];
                const float e = expf(-fabsf(lg[t]));
                const float softplus = fmaxf(lg[t], 0.f) + log1pf(e);
                ll += yr * lg[t] - softplus;
                const float sigma = lg[t] >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
                res[t] = yr - sigma;
            }
        }
        for (int c = 0; c < chunks; ++c) {
            const int j0 = c * W;
#pragma unroll
            for (int t = 0; t < R; ++t) {
#pragma unroll
                for (int j = 0; j < W; ++j)
                    if (j0 + j < n) acc[j] = fmaf(res[t], X[xo[t] + j0 + j], acc[j]);
            }
            if (chunks > 1) {
                const float s = reduce_scatter<W>(acc, lane);
                if (lane < W && j0 + lane < n) g[j0 + lane] += s;
#pragma unroll
                for (int j = 0; j < W; ++j) acc[j] = 0.f;
            }
        }
    }
    if (chunks == 1) {
        const float s = reduce_scatter<W>(acc, lane);
        if (lane < W && lane < n) g[lane] = s;
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

// Floats of one warp's scratch row: the generated body's intermediates
// that another lane or a later loop of it reads (ops/autospec.py), 0 for
// the hand-written bodies.
template <int BODY>
__host__ __device__ constexpr int body_scratch_floats() {
#ifdef LMC_AUTOSPEC_HEADER
    return BODY == kAutoBody ? autobody::kScratchFloats : 0;
#else
    return 0;
#endif
}

// Warp w's scratch row for model_eval: in `smem` ([warps][floats], where
// the launch found room in shared memory), else this warp's row of the
// global scratch (one row per warp of the grid); null for a body without
// scratch.
template <int BODY>
__device__ __forceinline__ float* warp_scratch(float* smem, int w) {
    constexpr int floats = body_scratch_floats<BODY>();
    if constexpr (floats == 0) {
        return nullptr;
    } else {
        if (smem != nullptr) return smem + (size_t)w * floats;
#ifdef LMC_AUTOSPEC_HEADER
        return autobody::scratch + ((size_t)blockIdx.x * (blockDim.x >> 5) + w) * floats;
#else
        return nullptr;
#endif
    }
}

// Whether a launch with `bytes` of dynamic shared memory in use also takes
// `warps` scratch rows of the body there; records the placement of a
// generated body's scratch for autospec_scratch_in_smem.
template <int BODY>
inline bool scratch_fits(size_t bytes, int warps, size_t limit) {
    const size_t need = (size_t)body_scratch_floats<BODY>() * warps * sizeof(float);
    const bool fits = need > 0 && bytes + need <= limit;
    if (BODY == kAutoBody) last_scratch_in_smem = fits ? 1 : 0;
    return fits;
}

// The model body at q (shared memory, one chain): writes grad into g
// (shared memory) and returns logp. lam: the body's constants (body_floats);
// rows: body 3's data rows, body 4's spikes; scratch: the warp's scratch
// row (warp_scratch; the generated body's only). Lanes own columns lane,
// lane+32, ... (body 3: rows first, see logistic_rows). Body ids match
// ops/nuts_trajectory.py::BODY_IDS; any other id does not compile, and
// every launch switch refuses it at run time.
template <int BODY>
__device__ float model_eval(const float* q, float* g, const float* lam, int n, int rows,
                           int lane, float* scratch) {
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
        const float ll = warp_sum(logistic_rows(q, lam, ldx, lam + (size_t)rows * ldx, rows, n,
                                                lane, g));
        for (int j = lane; j < n; j += 32) {
            const float qj = q[j];
            part += qj * qj;
        }
        const float qq = warp_sum(part);
        __syncwarp();  // every column of g is written
        for (int j = lane; j < n; j += 32) g[j] = g[j] - prior_prec * q[j];
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
        // the generated body: its intermediates in registers and in the
        // warp's scratch row
        __syncwarp();  // q is written
        return autobody::eval(q, g, lam, n, lane, scratch);
#else
        (void)scratch;
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
#ifdef LMC_AUTOSPEC_HEADER
    float* scratch;  // the warp's scratch row for the generated body (warp_scratch)
#endif
};

// The warp's scratch row a TreeConsts or HmcConsts carries, and setting
// it: only a generated body's build has the field (another member would
// shift the hand-written instances' register allocation, which sits at
// the 128-register cap).
template <class K>
__device__ __forceinline__ float* consts_scratch(const K& k) {
#ifdef LMC_AUTOSPEC_HEADER
    return k.scratch;
#else
    (void)k;
    return nullptr;
#endif
}

template <class K>
__device__ __forceinline__ void set_consts_scratch(K& k, float* scratch) {
#ifdef LMC_AUTOSPEC_HEADER
    k.scratch = scratch;
#else
    (void)k;
    (void)scratch;
#endif
}

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

// ---------------------------------------------------------------------------
// The block transition (block_transition below): bodies 0, 1, 2, 4 and 5
// with the diagonal metric, body 1 with the dense metric and body 4 with
// the low-rank metric, in chain blocks of up to kBlockChains chains: the
// instances of the 100-d main path (body 1, per-draw and fused), of
// `adapt_full` (body 1 dense, fused and its per-draw twin), of eight
// schools at 10,240 chains (body 2, fused and per draw), of F1 (the
// centred funnel, body 5, fused), of L0 (the spiked Gaussian, body 4,
// per-draw) and of L1 and L2 (body 4 with the pooled low-rank metric,
// fused and per-draw; kLowRank instances take at most kBlockChains chains,
// so body 4's never runs `transition`). Every other instance, and these
// in blocks of more chains, runs `transition`. Against `transition` it
// - evaluates body 1 for every chain of the block in one product a leaf
//   (block_matmul): a thread takes kBodyChains chains at two columns of
//   P, so each column is read once a chain group and leaf (not once a
//   chain), the group's q_c[i] coming as one 16-byte broadcast from the
//   staged rows qt ([n][staged_stride(cb)], each building warp writes its
//   q there in its drift pass), kProductDepth steps of i with their loads
//   issued together, indexed as shared memory; a chain that does not build
//   this leaf is evaluated all the same, at whatever q it staged last, and
//   its gradient goes unread;
// - with the dense metric, computes the drift's and the kinetic energy's
//   velocities p COV the same way (3 block products a leaf with the
//   leapfrog, against transition's 3 warp products a leaf and a chain), and
//   caches each leaf's energy velocity beside its momentum in the merge
//   stack (slot_vecs: 6 vectors a slot) and the tree's edges, so that the
//   merges and the U-turn checks do no product (transition: 2 a pair
//   merge, 4 a deeper one, 5 a depth);
// - with the low-rank metric, computes the drift's and the kinetic
//   energy's velocities S(alpha x + V((lam - alpha).(V^T x))) inside its
//   passes: the dots V^T x of a momentum as lane partials in the pass that
//   writes it (the first stage's kick, or the previous stage's), added
//   across the warp in one butterfly with whatever else is due there, the
//   velocity in the pass that reads them (the drift's, or the energy's
//   own); the factor block in shared memory, read by 32-bit offsets; and
//   caches each leaf's energy velocity as kDense does (transition: 2
//   velocities a leaf, 2 a pair merge, 4 a deeper one, 5 a depth);
// - keeps the merge stack's lower slots in shared memory (smem_stack_slots:
//   as many as fit beside everything else), the rest in the global stack;
// - runs every per-element pass kTrips trips at a time, the loads of all
//   trips first (lane_trips): one chain's lanes wait on shared memory once
//   a group, not once a trip, with no other warps on the SM to hide it;
// - fuses the leapfrog's passes: a stage's kick, drift and staging in one,
//   then the log density, the next kick and the kinetic energy in one;
//   bodies 2, 4 and 5 are evaluated inside these two passes, each chain's
//   warp on its own (body 2's four sums as lane partials after the first,
//   mu and log_tau broadcast by two shuffles, body 4's spike dots V^T x
//   and body 5's sum of the x columns' squares as lane partials in the
//   first, added across the warp between the two, the gradient in the
//   second), so their leaf makes no shared-memory round trip of its own;
//   body 2 (n = 10, lane j < 10 owning column j) keeps its column's p, q,
//   gradient, inverse mass and its two constants y_j and 1/sigma_j^2 in
//   registers through the leaf, the constants loaded once a transition;
// - sums the U-turn dots in one butterfly (warp_sums);
// - reads the integrator's coefficients with constant indices, so the
//   launch's constants stay in registers;
// and its kernels are compiled for kBlockChains warps a block, so ptxas may
// give a thread up to 255 registers. Each element's arithmetic and each
// sum's order are transition's, so both give the same bits.
constexpr int kBlockChains = 8;
constexpr int kBodyChains = 4;
constexpr int kTrips = 4;
constexpr int kProductDepth = 4;
// kDense: its passes' trips at a time (at 4 the merges' cached velocities
// beside the fused kernel's draw state spilled; 1 was the fastest of 1, 2
// and 4 on the card, PERF.md)
constexpr int kDenseTrips = 1;
// body 4 with kLowRank: its passes' trips at a time (at 2 and 4 the
// metric's and the body's columns of V beside the fused kernel's draw
// state spilled; 1 was the fastest of 1, 2 and 4 on the card, PERF.md)
constexpr int kLowRankTrips = 1;

// Blocks an SM that body 2's block instances are compiled for
// (nuts_trajectory_es_block_kernel, fused_nuts_es_block_kernel): eight
// schools' cells run 1,280 blocks of 8 chains; a block's 16.6 KB (per
// draw) or 18.9 KB (fused) of shared memory at depth 10 and the SM's
// 2,048 threads leave room for 8 an SM, so the registers set how many run
// at once, at most 65,536 / (256 k) a thread for k blocks. 2 was the
// fastest of 1, 2, 3 and 4 on the card whose instances do not spill (3
// and 4 spill in both kernels; PERF.md). A re-sweep edits this constant
// in a copy of the tree.
constexpr int kEsBlocksPerSm = 2;

template <int BODY, int METRIC>
__host__ __device__ constexpr bool block_body() {
    return ((BODY == 0 || BODY == 1 || BODY == 2 || BODY == 4 || BODY == 5) && METRIC == kDiag)
           || (BODY == 1 && METRIC == kDense) || (BODY == 4 && METRIC == kLowRank);
}

// Vectors of n floats a slot of the block transition's merge stack holds:
// left p, right p, p sum and proposal q, and for kDense and kLowRank the
// velocities of the left and right p.
template <int METRIC>
__host__ __device__ constexpr int slot_vecs() {
    return METRIC == kDiag ? 4 : 6;
}

__host__ __device__ constexpr int staged_stride(int cb) {
    return (cb + kBodyChains - 1) / kBodyChains * kBodyChains;
}

// Floats of the block transition's staged positions (body 1's product).
template <int BODY>
__host__ __device__ constexpr size_t staged_floats(int n, int cb) {
    return BODY == 1 ? (size_t)n * staged_stride(cb) : 0;
}

// The block transition's shared-memory state beside TreeConsts.
struct BlockState {
    float* sstack;   // [smem_slots][slot_vecs][cb][n]: the merge stack's lower slots
    float* qt;       // body 1's staged rows, [n][staged_stride(cb)]
    int smem_slots;
};

// Slots of the merge stack a launch keeps in shared memory: as many as fit
// beside `bytes` in `limit`, up to the max(D - 1, 1) that trees of depth
// cap D use (an even leaf at depth d < D writes slot popcount(leaf) <=
// d - 1); the slots above stay in the global stack. `vecs`: slot_vecs.
inline int smem_stack_slots(size_t bytes, int cb, int n, int D, size_t limit, int vecs) {
    const size_t slot_bytes = (size_t)vecs * cb * n * sizeof(float);
    const int used = D > 1 ? D - 1 : 1;
    const size_t room = bytes < limit ? (limit - bytes) / slot_bytes : 0;
    return room < (size_t)used ? (int)room : used;
}

// A 16-byte boundary at or after p.
__device__ __forceinline__ float* align16(float* p) {
    return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 15) & ~(uintptr_t)15);
}

// The calling kernel's dynamic shared memory, indexed with 32-bit offsets
// so that the compiler emits shared-memory loads (a pointer that went
// through a struct or an integer is generic: 64-bit addressing and generic
// loads), and the offset of a pointer into it.
__device__ __forceinline__ float* dyn_smem() {
    extern __shared__ float lmc_dyn_smem[];
    return lmc_dyn_smem;
}

__device__ __forceinline__ int smem_offset(const float* p) {
    return (int)(p - dyn_smem());
}

// y_c = x_c M (NEG: -x_c M) for the block's chains c < cb, M (n, n)
// row-major: the staged rows x at qt_off ([n][staged_stride(cb)]) and y
// (the first chain's row of a [cb][n] layout) at g_off in shared memory,
// M there at p_off (P_SHARED) or in global memory at Pg. A thread takes
// kBodyChains chains at two columns, j and j + ceil(n/2), so each step of
// i reads two values of M and one 16-byte broadcast of the group's x for
// 8 FMAs, kProductDepth steps with their loads issued together; every
// thread of the block calls it. Each output is one fmaf chain over i from
// 0, as matvec's and model_eval<1>'s, so it has their bits: body 1's
// gradient -q P, and the dense metric's velocities p COV and momentum
// z L^-1.
template <bool P_SHARED, bool NEG = true>
__device__ __forceinline__ void block_matmul(int qt_off, const float* __restrict__ Pg,
                                             int p_off, int g_off, int n, int cb) {
    constexpr int U = kProductDepth;
    float* sm = dyn_smem();
    const int groups = staged_stride(cb) / kBodyChains, half = (n + 1) / 2;
    for (int t = threadIdx.x; t < groups * half; t += blockDim.x) {
        const int grp = t / half, j = t - grp * half, j2 = j + half;
        const bool two = j2 < n;
        const int j2c = two ? j2 : j;  // a lone last column reads its own twice
        const float4* qp = reinterpret_cast<const float4*>(sm + qt_off) + grp;
        const float* pp = P_SHARED ? sm + p_off : Pg;
        float a[kBodyChains] = {0.f, 0.f, 0.f, 0.f}, b[kBodyChains] = {0.f, 0.f, 0.f, 0.f};
        int i = 0, row = 0;
        for (; i + U <= n; i += U) {
            float p1[U], p2[U];
            float4 q[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                p1[u] = pp[row + u * n + j];
                p2[u] = pp[row + u * n + j2c];
                q[u] = qp[(i + u) * groups];
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                a[0] = fmaf(q[u].x, p1[u], a[0]); b[0] = fmaf(q[u].x, p2[u], b[0]);
                a[1] = fmaf(q[u].y, p1[u], a[1]); b[1] = fmaf(q[u].y, p2[u], b[1]);
                a[2] = fmaf(q[u].z, p1[u], a[2]); b[2] = fmaf(q[u].z, p2[u], b[2]);
                a[3] = fmaf(q[u].w, p1[u], a[3]); b[3] = fmaf(q[u].w, p2[u], b[3]);
            }
            row += U * n;
        }
        for (; i < n; ++i, row += n) {
            const float p1 = pp[row + j], p2 = pp[row + j2c];
            const float4 q = qp[i * groups];
            a[0] = fmaf(q.x, p1, a[0]); b[0] = fmaf(q.x, p2, b[0]);
            a[1] = fmaf(q.y, p1, a[1]); b[1] = fmaf(q.y, p2, b[1]);
            a[2] = fmaf(q.z, p1, a[2]); b[2] = fmaf(q.z, p2, b[2]);
            a[3] = fmaf(q.w, p1, a[3]); b[3] = fmaf(q.w, p2, b[3]);
        }
        const int c0 = grp * kBodyChains;
#pragma unroll
        for (int r = 0; r < kBodyChains; ++r) {
            if (c0 + r < cb) {
                float* gc = sm + g_off + (c0 + r) * n;
                gc[j] = NEG ? -a[r] : a[r];
                if (two) gc[j2] = NEG ? -b[r] : b[r];
            }
        }
    }
}

// block_matmul's -q P for the block transition's kernels: P where
// stage_body put it (T.lam, shared or global memory).
__device__ __forceinline__ void block_product(const TreeConsts& T, int qt_off, int g_off) {
    if (__isShared(T.lam))
        block_matmul<true>(qt_off, nullptr, smem_offset(T.lam), g_off, T.n, T.cb);
    else
        block_matmul<false>(qt_off, T.lam, 0, g_off, T.n, T.cb);
}

// The dense metric's velocities p_c COV of the staged momenta: COV where
// the launch put it (T.cov, shared or global memory).
__device__ __forceinline__ void block_velocity(const TreeConsts& T, int qt_off, int v_off) {
    if (__isShared(T.cov))
        block_matmul<true, false>(qt_off, nullptr, smem_offset(T.cov), v_off, T.n, T.cb);
    else
        block_matmul<false, false>(qt_off, T.cov, 0, v_off, T.n, T.cb);
}

// Row i of warp w's column of the staged rows: x into the block's next
// product.
__device__ __forceinline__ void stage(int qt_off, int stride, int w, int i, float x) {
    dyn_smem()[qt_off + i * stride + w] = x;
}

// The lane's elements i = lane, lane + 32, ... < n, TRIPS at a time: in
// each group load(k, i) for every trip k, then use(k, i) for every trip,
// in order (a lane's sums add its elements in the order of a plain loop).
template <int TRIPS = kTrips, class Load, class Use>
__device__ __forceinline__ void lane_trips(int n, int lane, Load&& load, Use&& use) {
    for (int base = lane; base < n; base += 32 * TRIPS) {
#pragma unroll
        for (int k = 0; k < TRIPS; ++k)
            if (base + 32 * k < n) load(k, base + 32 * k);
#pragma unroll
        for (int k = 0; k < TRIPS; ++k)
            if (base + 32 * k < n) use(k, base + 32 * k);
    }
}

// K warp sums at once: one xor butterfly, each round's K shuffles
// independent; each sum has warp_sum's bits.
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
}

// The block transition's gradient at each chain's proposal q (this warp's
// row of a [cb][n] layout in shared memory) into g (likewise); every
// thread of the block calls it. Body 1 stages every warp's q and
// evaluates the block in one product.
template <int BODY>
__device__ __forceinline__ void proposal_grad(const TreeConsts& T, const BlockState& BS,
                                              const float* q, float* g, int w, int lane) {
    if constexpr (BODY == 1) {
        const int n = T.n, stride = staged_stride(T.cb), qt_off = smem_offset(BS.qt);
        float* sm = dyn_smem();
        for (int i = lane; i < n; i += 32) sm[qt_off + i * stride + w] = q[i];
        __syncthreads();  // every warp's q is staged, and done reading its last g
        block_product(T, qt_off, smem_offset(g) - w * n);
        __syncthreads();  // every g is written
    } else {
        (void)BS;
        (void)w;
        model_eval<BODY>(q, g, T.lam, T.n, T.rows, lane, consts_scratch(T));
    }
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

    LMC_CLK_BEGIN();
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
        LMC_CLK(kClkOther);
        bool go_l = __syncthreads_or(bld);
        LMC_CLK_VOTE(bld);
        while (leaf < n_total && go_l) {
            float dE = 0.f, lpaw = 0.f;
            bool div_leaf = false;
            const bool was_bld = bld;
            LMC_CLK_LEAF(bld);
            if (bld) {
                // one symplectic step (reference integration.py:100-121)
                const float kick0 = T.b[0] * epss;
                for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick0 * cg[i];
                for (int s = 0; s < T.n_stages; ++s) {
                    const float drift = T.a[s] * epss;
                    if (METRIC != kDiag) {
                        velocity<METRIC>(cov, vv, cp, vs, n, lane);
                        LMC_CLK_PRODUCT();
                        for (int i = lane; i < n; i += 32) cq[i] = cq[i] + drift * vs[i];
                    } else {
                        for (int i = lane; i < n; i += 32) cq[i] = cq[i] + drift * (vv[i] * cp[i]);
                    }
                    __syncwarp();
                    LMC_CLK(kClkLeapfrog);
                    c_lp = model_eval<BODY>(cq, cg, T.lam, n, T.rows, lane, consts_scratch(T));
                    if (BODY == 1) LMC_CLK_PRODUCT();
                    LMC_CLK(kClkBody);
                    const float kick = T.b[s + 1] * epss;
                    for (int i = lane; i < n; i += 32) cp[i] = cp[i] + kick * cg[i];
                }
                part = 0.f;
                if (METRIC != kDiag) {
                    velocity<METRIC>(cov, vv, cp, vs, n, lane);
                    LMC_CLK_PRODUCT();
                    for (int i = lane; i < n; i += 32) part += cp[i] * vs[i];
                } else {
                    for (int i = lane; i < n; i += 32) part += cp[i] * (vv[i] * cp[i]);
                }
                LMC_CLK(kClkLeapfrog);
                c_e = 0.5f * warp_sum(part) - c_lp;
                LMC_CLK(kClkWarpSums);

                dE = c_e - E0;
                if (isnan(dE)) dE = CUDART_INF_F;
                if (fabsf(dE) > fabsf(mec)) mec = dE;
                div_leaf = !(fabsf(dE) < T.Emax);
                ++nlv;
                lpaw = -dE + fminf(0.f, -dE);
            }
            bool mrg = bld && !div_leaf;
            const bool is_odd = leaf & 1;
            LMC_CLK(kClkOther);
            const bool go_m0 = __syncthreads_or(mrg);
            LMC_CLK_VOTE(was_bld);
            if (!is_odd) {
                if (mrg) {  // a leaf slot has left p == right p == p sum
                    float *dps = slot(2, h), *dq = slot(3, h);
                    for (int i = lane; i < n; i += 32) { dps[i] = cp[i]; dq[i] = cq[i]; }
                    LMC_CLK(kClkLeafStore);
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
                        LMC_CLK_PRODUCT();
                        LMC_CLK_PRODUCT();
                    }
                    LMC_CLK(kClkOther);
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
                    LMC_CLK(kClkMerge);
                    d1 = warp_sum(d1);
                    d2 = warp_sum(d2);
                    LMC_CLK(kClkWarpSums);
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
            LMC_CLK(kClkOther);
            bool go_m = __syncthreads_or(mrg) && is_odd;
            LMC_CLK_VOTE(was_bld);
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
                        for (int k = 0; k < 4; ++k) LMC_CLK_PRODUCT();
                    }
                    LMC_CLK(kClkOther);
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
                    LMC_CLK(kClkMerge);
                    bool turn = false;
#pragma unroll
                    for (int k = 0; k < 6; ++k) turn |= warp_sum(d[k]) <= 0.f;
                    LMC_CLK(kClkWarpSums);
                    if (lane == 0) {
                        if (take2) { ssc(s_e, s1) = ssc(s_e, s2); ssc(s_lpp, s1) = ssc(s_lpp, s2); }
                        ssc(s_ls, s1) = ls; ssc(s_lw, s1) = lw;
                    }
                    __syncwarp();
                    mrg = mrg && !turn;
                }
                LMC_CLK(kClkOther);
                go_m = __syncthreads_or(mrg);
                LMC_CLK_VOTE(was_bld);
                ++j;
                --hh;
            }

            const bool turned = bld && !div_leaf && !mrg;
            sdv = sdv || div_leaf;
            stn = stn || turned;
            bld = bld && !div_leaf && !turned;
            LMC_CLK(kClkOther);
            go_l = __syncthreads_or(bld);
            LMC_CLK_VOTE(was_bld);
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
                for (int k = 0; k < 5; ++k) LMC_CLK_PRODUCT();
            }
            LMC_CLK(kClkOther);
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
            LMC_CLK(kClkMerge);
#pragma unroll
            for (int k = 0; k < 6; ++k) turning_new |= warp_sum(d[k]) <= 0.f;
            LMC_CLK(kClkWarpSums);
        }
        const bool sel_turn = ok ? turning_new : stn;
        if (active) {
            trn = trn || sel_turn;
            div = div || sdv;
            ++depth_c;
        }
        const bool nxt = !div && !trn && depth_c < mdc;
        LMC_CLK(kClkOther);
        const bool any_nxt = __syncthreads_or(nxt);
        LMC_CLK_VOTE(active);
        cont = (depth + 1) < max_sched && any_nxt;
        ++depth;
    }
    __syncwarp();
    LMC_CLK(kClkOther);
    LMC_CLK_FLUSH(chain, lane);

    TreeResult r;
    r.pr_e = pr_e; r.pr_lp = pr_lp; r.log_size = acc_ls; r.lwas = acc_lw; r.mec = mec;
    r.depth = depth_c; r.n_leaves = nlv; r.diverging = div; r.turning = trn;
    return r;
}

// `transition` for bodies 0, 1, 2, 4 and 5 with the diagonal metric, body
// 1 with the dense metric and body 4 with the low-rank metric in blocks of
// up to kBlockChains chains, redesigned for Hopper (see kBlockChains
// above): the same arguments, with BS the block's shared-memory state; the
// same result, to the bit. kDense and kLowRank take the start velocity of
// p0 in V.vc (vl below).
template <int BODY, int METRIC>
__device__ TreeResult block_transition(const TreeConsts& T, const BlockState& BS,
                                       const WarpVecs& V, float* slot_sc, int chain, int w,
                                       int lane, const float* q0, const float* p0,
                                       const float* g0, float lp0, float E0, float eps, int mdc,
                                       uint32_t salt) {
    static_assert(block_body<BODY, METRIC>(),
                  "the block transition takes bodies 0, 1, 2, 4 and 5 with the diagonal metric, "
                  "body 1 with the dense metric and body 4 with the low-rank metric");
    // kDense: every n x n product of a leaf is block-wide (the drift's and
    // the kinetic energy's velocities p COV, as body 1's gradient), into
    // the velocity scratch vv; each leaf's energy velocity travels with
    // its momentum into the stack (a slot's left and right p's velocities)
    // and the tree's edges (vl, vr: v(lp), v(rp)), so that the merges and
    // the U-turn checks do no product at all. A cached velocity is the same
    // fmaf chain of the same momentum as transition's recomputed one.
    // kLowRank: each leaf's two velocities inside the leapfrog's passes,
    // the energy's into the velocity scratch vlf, cached likewise (CACHED).
    constexpr bool DENSE = METRIC == kDense;
    constexpr bool LOWRANK = METRIC == kLowRank;
    constexpr bool CACHED = DENSE || LOWRANK;
    constexpr int NSV = slot_vecs<METRIC>();
    float *vl = V.vc, *vr = V.vd;
    float* vlf = LOWRANK ? lowrank_scratch(V, T.cb, T.n) : V.vv;  // a leaf's velocity
    // trips at a time: eight schools' and the funnel's few columns take
    // one, so that their passes carry no code for trips that never run;
    // body 4 two, so that its spike dots' constants fit in registers beside
    // the fused kernel's state without spilling
    constexpr int K = BODY == 2 || BODY == 5 ? 1
                      : BODY == 4 ? (LOWRANK ? kLowRankTrips : 2)
                      : DENSE ? kDenseTrips : kTrips;
    const int n = T.n, cb = T.cb, D = T.D, C = T.C, S = BS.smem_slots;
    const int stride = staged_stride(cb);
    float *lq = V.lq, *lp = V.lp, *lg = V.lg, *rq = V.rq, *rp = V.rp, *rg = V.rg;
    float *cq = V.cq, *cp = V.cp, *cg = V.cg, *prq = V.prq, *psum = V.psum;
    const float* vv = V.vv;
    // body 1's staged positions and the block's gradients, as offsets into
    // shared memory (block_matmul)
    float* sm = dyn_smem();
    const int qt_off = BODY == 1 ? smem_offset(BS.qt) : 0, g_off = smem_offset(cg) - w * n;
    // kDense: the block's velocity scratch rows ([cb][n], vv each chain's)
    const int vs_off = smem_offset(vv) - w * n;
    const int stages = T.n_stages;
    const float b0 = T.b[0], b1 = T.b[1], b2 = T.b[2], b3 = T.b[3];
    const float a0 = T.a[0], a1 = T.a[1], a2 = T.a[2];
    // bodies 4 and 5: the working vectors as offsets into shared memory;
    // body 4's constants there too (the launch stages them: V^T, rows
    // spikes of n, then 1/lam - 1, then 1/s), body 5's 1/scale^2 and the
    // x columns' count, as model_eval reads them
    const int rows = T.rows;
    const int cq_o = smem_offset(cq), cp_o = smem_offset(cp), cg_o = smem_offset(cg),
              vv_o = smem_offset(vv);
    const int vt_o = BODY == 4 ? smem_offset(T.lam) : 0, il_o = vt_o + rows * n,
              is_o = il_o + rows;
    // kLowRank: the factor block (V^T as kMaxRank rows of n, lam - alpha,
    // then alpha at ...) and the leaf's velocity, as offsets into shared
    // memory
    const int fac_o = LOWRANK ? smem_offset(T.cov) : 0, cvel_o = fac_o + kMaxRank * n,
              vlf_o = LOWRANK ? smem_offset(vlf) : 0;
    const float alpha = LOWRANK ? sm[fac_o + kMaxRank * (n + 2)] : 0.f;
    const float inv_s2 = BODY == 5 ? T.lam[0] : 0.f, nx = (float)(n - 1);
    // body 2: lane j < 10's column of the constants [y; 1/sigma^2] (zero in
    // columns 0 and 1), in registers for the transition
    const bool es_own = BODY == 2 && lane < 10;
    const float es_y = es_own ? T.lam[lane] : 0.f, es_is2 = es_own ? T.lam[10 + lane] : 0.f;

    float* s_e = slot_sc;                        // [D][cb] proposal energy
    float* s_lpp = slot_sc + (size_t)D * cb;     // proposal logp
    float* s_ls = slot_sc + (size_t)2 * D * cb;  // log size
    float* s_lw = slot_sc + (size_t)3 * D * cb;  // log weighted accept sum
    __shared__ int max_sched_sh;

    // slot s's NSV vectors (left p, right p, p sum, proposal q, and for
    // kDense and kLowRank the left and right p's velocities): the shared
    // slots laid out
    // [S][NSV][cb][n], the global ones [D][NSV][C][n] (the global stack's
    // [NSV][D][C][n] floats, as this transition's own scratch)
    struct Slot { float *lp, *rp, *ps, *q, *vl, *vr; };
    auto slot = [&](int s) -> Slot {
        float* base;
        size_t k;
        if (s < S) {
            base = BS.sstack + ((size_t)s * NSV * cb + w) * n;
            k = (size_t)cb * n;
        } else {
            base = T.stack + ((size_t)s * NSV * C + chain) * n;
            k = (size_t)C * n;
        }
        return {base, base + k, base + 2 * k, base + 3 * k, base + 4 * k, base + 5 * k};
    };
    auto ssc = [&](float* arr, int s) -> float& { return arr[s * cb + w]; };

    LMC_CLK_BEGIN();
    if constexpr (CACHED) {  // the tree's edges' velocities: both the start's
        float q[K], p[K], g[K], v[K];
        lane_trips<K>(n, lane,
                   [&](int k, int i) { q[k] = q0[i]; p[k] = p0[i]; g[k] = g0[i]; v[k] = vl[i]; },
                   [&](int k, int i) {
                       lq[i] = q[k]; rq[i] = q[k]; prq[i] = q[k];
                       lp[i] = p[k]; rp[i] = p[k]; psum[i] = p[k];
                       lg[i] = g[k]; rg[i] = g[k];
                       vr[i] = v[k];
                   });
    } else {
        float q[K], p[K], g[K];
        lane_trips<K>(n, lane, [&](int k, int i) { q[k] = q0[i]; p[k] = p0[i]; g[k] = g0[i]; },
                   [&](int k, int i) {
                       lq[i] = q[k]; rq[i] = q[k]; prq[i] = q[k];
                       lp[i] = p[k]; rp[i] = p[k]; psum[i] = p[k];
                       lg[i] = g[k]; rg[i] = g[k];
                   });
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

    int depth = 0;
    bool cont = max_sched > 0;
    while (cont) {
        const bool active = !div && !trn && depth_c < mdc;
        const bool go_right = uniform() < 0.5f;
        const float epss = go_right ? eps : -eps;
        {
            const float *sq = go_right ? rq : lq, *sp = go_right ? rp : lp,
                        *sg = go_right ? rg : lg;
            float q[K], p[K], g[K];
            lane_trips<K>(n, lane, [&](int k, int i) { q[k] = sq[i]; p[k] = sp[i]; g[k] = sg[i]; },
                       [&](int k, int i) { cq[i] = q[k]; cp[i] = p[k]; cg[i] = g[k]; });
            __syncwarp();
        }
        bool bld = active, sdv = false, stn = false;
        const int n_total = 1 << depth;
        int leaf = 0, h = 0;
        LMC_CLK(kClkOther);
        bool go_l = __syncthreads_or(bld);
        LMC_CLK_VOTE(bld);
        while (leaf < n_total && go_l) {
            float dE = 0.f, lpaw = 0.f;
            bool div_leaf = false;
            const bool was_bld = bld;
            LMC_CLK_LEAF(bld);
            if constexpr (LOWRANK) {
                // one symplectic step (reference integration.py:100-121)
                // for body 4 with the low-rank metric, each chain's warp on
                // its own: the first stage's kick with the metric's dots
                // V^T (S p) of the kicked p in one pass; each stage's
                // drift velocity S(alpha x + V d), x = S p, d the dots
                // times lam - alpha, with the drift and the body's spike
                // dots V^T (q / s) in one pass; the body's gradient, the
                // kick, q.grad and the dots of the kicked p in one pass,
                // q.grad and the dots in one butterfly; after the last
                // stage the energy velocity (the leaf's, cached) and
                // p.velocity in one pass. Each element's arithmetic and
                // each sum's order are lowrank_velocity's, model_eval's and
                // transition's.
                if (bld) {
                    float d[kMaxRank];  // the metric's dots of the stage's p
                    {
                        const float kick0 = b0 * epss;
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j) d[j] = 0.f;
                        float p[K], g[K], sc[K], vtm[K][kMaxRank];
                        lane_trips<K>(
                            n, lane,
                            [&](int k, int i) {
                                p[k] = sm[cp_o + i]; g[k] = sm[cg_o + i]; sc[k] = sm[vv_o + i];
#pragma unroll
                                for (int j = 0; j < kMaxRank; ++j) vtm[k][j] = sm[fac_o + j * n + i];
                            },
                            [&](int k, int i) {
                                const float pk = p[k] + kick0 * g[k];
                                sm[cp_o + i] = pk;
                                const float x = pk * sc[k];  // thin_dots<true>
#pragma unroll
                                for (int j = 0; j < kMaxRank; ++j) d[j] = d[j] + x * vtm[k][j];
                            });
                        LMC_CLK(kClkLeapfrog);
                        warp_sums(d);
                        LMC_CLK(kClkWarpSums);
                    }
                    for (int s = 0; s < stages; ++s) {
                        const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * epss;
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j) d[j] = d[j] * sm[cvel_o + j];
                        float c[kMaxRank];  // body 4's spike dots
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j) c[j] = 0.f;
                        {
                            float p[K], q[K], sc[K], is[K], vtm[K][kMaxRank], vtk[K][kMaxRank];
                            lane_trips<K>(
                                n, lane,
                                [&](int k, int i) {
                                    p[k] = sm[cp_o + i]; q[k] = sm[cq_o + i];
                                    sc[k] = sm[vv_o + i]; is[k] = sm[is_o + i];
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j) {
                                        vtm[k][j] = sm[fac_o + j * n + i];
                                        if (j < rows) vtk[k][j] = sm[vt_o + j * n + i];
                                    }
                                },
                                [&](int k, int i) {
                                    const float x = sc[k] * p[k];  // lowrank_velocity
                                    float acc = 0.f;
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j) acc = acc + vtm[k][j] * d[j];
                                    const float v = sc[k] * (alpha * x + acc);
                                    const float qk = q[k] + drift * v;
                                    sm[cq_o + i] = qk;
                                    const float xb = qk * is[k];  // model_eval<4>'s thin_dots
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) c[j] = c[j] + xb * vtk[k][j];
                                });
                        }
                        LMC_CLK_PRODUCT();
                        LMC_CLK(kClkLeapfrog);
                        warp_sums(c);  // every spike's column, those past `rows` zeros
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j)
                            if (j < rows) c[j] = c[j] * sm[il_o + j];
                        LMC_CLK(kClkWarpSums);
                        const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * epss;
                        float sums[1 + kMaxRank];  // q.grad, then the dots of the kicked p
#pragma unroll
                        for (int j = 0; j <= kMaxRank; ++j) sums[j] = 0.f;
                        {
                            float p[K], q[K], sc[K], is[K], vtm[K][kMaxRank], vtk[K][kMaxRank];
                            lane_trips<K>(
                                n, lane,
                                [&](int k, int i) {
                                    q[k] = sm[cq_o + i]; p[k] = sm[cp_o + i];
                                    sc[k] = sm[vv_o + i]; is[k] = sm[is_o + i];
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j) {
                                        vtm[k][j] = sm[fac_o + j * n + i];
                                        if (j < rows) vtk[k][j] = sm[vt_o + j * n + i];
                                    }
                                },
                                [&](int k, int i) {
                                    const float x = q[k] * is[k];
                                    float acc = 0.f;
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) acc = acc + vtk[k][j] * c[j];
                                    const float gk = -(x + acc) * is[k];
                                    sums[0] += q[k] * gk;
                                    sm[cg_o + i] = gk;
                                    const float pk = p[k] + kick * gk;
                                    sm[cp_o + i] = pk;
                                    const float xp = pk * sc[k];  // thin_dots<true>
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        sums[1 + j] = sums[1 + j] + xp * vtm[k][j];
                                });
                        }
                        LMC_CLK(kClkLeapfrog);
                        warp_sums(sums);
                        LMC_CLK(kClkWarpSums);
                        c_lp = 0.5f * sums[0];
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j) d[j] = sums[1 + j];
                    }
#pragma unroll
                    for (int j = 0; j < kMaxRank; ++j) d[j] = d[j] * sm[cvel_o + j];
                    float e[1] = {0.f};  // p.(the energy velocity)
                    {
                        float p[K], sc[K], vtm[K][kMaxRank];
                        lane_trips<K>(
                            n, lane,
                            [&](int k, int i) {
                                p[k] = sm[cp_o + i]; sc[k] = sm[vv_o + i];
#pragma unroll
                                for (int j = 0; j < kMaxRank; ++j) vtm[k][j] = sm[fac_o + j * n + i];
                            },
                            [&](int k, int i) {
                                const float x = sc[k] * p[k];
                                float acc = 0.f;
#pragma unroll
                                for (int j = 0; j < kMaxRank; ++j) acc = acc + vtm[k][j] * d[j];
                                const float v = sc[k] * (alpha * x + acc);
                                sm[vlf_o + i] = v;
                                e[0] += p[k] * v;
                            });
                    }
                    LMC_CLK_PRODUCT();
                    LMC_CLK(kClkLeapfrog);
                    warp_sums(e);
                    LMC_CLK(kClkWarpSums);
                    c_e = 0.5f * e[0] - c_lp;
                }
            } else if constexpr (BODY == 2) {
                // one symplectic step (reference integration.py:100-121) for
                // eight schools (n = 10), each chain's warp on its own, lane
                // j < 10 holding column j's p, q, gradient and inverse mass
                // in registers through the leaf: a stage's kick (the first
                // stage's) and drift; mu and log_tau from lanes 0 and 1 by
                // two shuffles and the body's four sums (model_eval<2>'s
                // tt^2, dy resid, resid and resid tt) in one butterfly; the
                // gradient, the next kick and after the last stage the
                // kinetic energy; cq, cp and cg stored once, at the leaf's
                // end. Each element's arithmetic and each sum's order are
                // model_eval<2>'s and transition's (lanes 10-31 add exact
                // zeros), so the bits are theirs.
                if (bld) {
                    float p = 0.f, q = 0.f, g = 0.f, v = 0.f;
                    if (es_own) {
                        p = sm[cp_o + lane]; q = sm[cq_o + lane]; g = sm[cg_o + lane];
                        v = sm[vv_o + lane];
                    }
                    for (int s = 0; s < stages; ++s) {
                        if (s == 0) {
                            const float kick0 = b0 * epss;
                            p = p + kick0 * g;
                        }
                        const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * epss;
                        q = q + drift * (v * p);
                        LMC_CLK(kClkLeapfrog);
                        const float mu = __shfl_sync(0xffffffffu, q, 0);
                        const float log_tau = __shfl_sync(0xffffffffu, q, 1);
                        const float tau = expf(log_tau);
                        float sums[4] = {0.f, 0.f, 0.f, 0.f};  // tt^2, dy resid, resid, resid tt
                        float dtt = 0.f;
                        if (es_own) {
                            const float tt = lane >= 2 ? q : 0.f;
                            const float theta = mu + tau * tt;
                            const float dy = es_y - theta;
                            const float resid = dy * es_is2;
                            sums[0] = tt * tt;
                            sums[1] = dy * resid;
                            sums[2] = resid;
                            sums[3] = resid * tt;
                            dtt = -tt + tau * resid;
                        }
                        LMC_CLK(kClkBody);
                        warp_sums(sums);
                        LMC_CLK(kClkWarpSums);
                        const float m5 = mu / 5.0f, l5 = log_tau / 5.0f;
                        g = lane == 0 ? -mu / 25.0f + sums[2]
                          : lane == 1 ? -log_tau / 25.0f + tau * sums[3] : dtt;
                        c_lp = -0.5f * (m5 * m5) - 0.5f * (l5 * l5) - 0.5f * sums[0]
                               - 0.5f * sums[1];
                        const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * epss;
                        p = p + kick * g;
                        LMC_CLK(kClkLeapfrog);
                    }
                    float e[1] = {0.f};  // p.(vv p)
                    if (es_own) {
                        e[0] += p * (v * p);
                        sm[cq_o + lane] = q; sm[cp_o + lane] = p; sm[cg_o + lane] = g;
                    }
                    LMC_CLK(kClkLeapfrog);
                    warp_sums(e);
                    LMC_CLK(kClkWarpSums);
                    c_e = 0.5f * e[0] - c_lp;
                }
            } else if constexpr (BODY == 4 || BODY == 5) {
                // one symplectic step (reference integration.py:100-121) for
                // bodies 4 and 5, each chain's warp on its own: a stage's
                // kick (the first stage's), drift and the body's first sums
                // (body 4's spike dots V^T x, body 5's squares of the x
                // columns) in one pass, the sums added across the warp, then
                // the gradient, the next kick and after the last stage the
                // kinetic energy in one pass; the working vectors and body
                // 4's constants indexed as shared memory by 32-bit offsets.
                // Each element's arithmetic and each sum's order are
                // model_eval's and transition's.
                for (int s = 0; s < stages; ++s) {
                    const bool first = s == 0, last = s + 1 == stages;
                    if (!bld) continue;
                    const float kick0 = b0 * epss;
                    const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * epss;
                    float c[kMaxRank];  // body 4's spike dots; body 5's sum of squares in c[0]
#pragma unroll
                    for (int j = 0; j < kMaxRank; ++j) c[j] = 0.f;
                    float v0 = 0.f;  // body 5: v = q[0], lane 0's
                    {
                        float p[K], g[K], q[K], v[K], is[K], vtk[K][kMaxRank];
                        lane_trips<K>(
                            n, lane,
                            [&](int k, int i) {
                                p[k] = sm[cp_o + i]; q[k] = sm[cq_o + i]; v[k] = sm[vv_o + i];
                                if (first) g[k] = sm[cg_o + i];
                                if constexpr (BODY == 4) {
                                    is[k] = sm[is_o + i];
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) vtk[k][j] = sm[vt_o + j * n + i];
                                }
                            },
                            [&](int k, int i) {
                                float pk = p[k];
                                if (first) {
                                    pk = pk + kick0 * g[k];
                                    sm[cp_o + i] = pk;
                                }
                                const float qk = q[k] + drift * (v[k] * pk);
                                sm[cq_o + i] = qk;
                                if constexpr (BODY == 4) {  // thin_dots<true>
                                    const float x = qk * is[k];
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) c[j] = c[j] + x * vtk[k][j];
                                } else {
                                    if (i >= 1) c[0] += qk * qk;
                                    else v0 = qk;
                                }
                            });
                    }
                    LMC_CLK(kClkLeapfrog);
                    float v5 = 0.f, e5 = 0.f;  // body 5: v and exp(-v)
                    if constexpr (BODY == 4) {
                        // every spike's column in the butterfly, those past
                        // `rows` zeros: a shuffle under a guard the compiler
                        // cannot prove uniform costs a convergence barrier
#pragma unroll
                        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
                            for (int j = 0; j < kMaxRank; ++j)
                                c[j] += __shfl_xor_sync(0xffffffffu, c[j], o);
                        }
#pragma unroll
                        for (int j = 0; j < kMaxRank; ++j)
                            if (j < rows) c[j] = c[j] * sm[il_o + j];
                    } else {
                        c[0] = warp_sum(c[0]);
                        v5 = __shfl_sync(0xffffffffu, v0, 0);
                        e5 = expf(-v5);
                    }
                    LMC_CLK(kClkWarpSums);
                    const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * epss;
                    float sums[2] = {0.f, 0.f};  // body 4's q.grad, p.(vv p) after the last stage
                    {
                        float p[K], q[K], v[K], is[K], vtk[K][kMaxRank];
                        lane_trips<K>(
                            n, lane,
                            [&](int k, int i) {
                                q[k] = sm[cq_o + i]; p[k] = sm[cp_o + i]; v[k] = sm[vv_o + i];
                                if constexpr (BODY == 4) {
                                    is[k] = sm[is_o + i];
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) vtk[k][j] = sm[vt_o + j * n + i];
                                }
                            },
                            [&](int k, int i) {
                                float gk;
                                if constexpr (BODY == 4) {
                                    const float x = q[k] * is[k];
                                    float acc = 0.f;
#pragma unroll
                                    for (int j = 0; j < kMaxRank; ++j)
                                        if (j < rows) acc = acc + vtk[k][j] * c[j];
                                    gk = -(x + acc) * is[k];
                                    sums[0] += q[k] * gk;
                                } else {
                                    gk = i == 0 ? -inv_s2 * v5 - 0.5f * nx + 0.5f * c[0] * e5
                                                : -q[k] * e5;
                                }
                                sm[cg_o + i] = gk;
                                const float pk = p[k] + kick * gk;
                                sm[cp_o + i] = pk;
                                if (last) sums[1] += pk * (v[k] * pk);
                            });
                    }
                    LMC_CLK(kClkLeapfrog);
                    warp_sums(sums);
                    LMC_CLK(kClkWarpSums);
                    c_lp = BODY == 4 ? 0.5f * sums[0]
                                     : -0.5f * inv_s2 * v5 * v5 - 0.5f * nx * v5 - 0.5f * c[0] * e5;
                    if (last) c_e = 0.5f * sums[1] - c_lp;
                }
            } else if constexpr (DENSE) {
                // one symplectic step (reference integration.py:100-121) for
                // body 1 with the dense metric: the first stage's kick and
                // the momentum's staging in one pass; then each stage's
                // drift velocity (the block's product), the drift and the
                // position's staging in one pass, the gradient (the block's
                // product), the log density, the kick and the momentum's
                // staging in one pass; after the last stage the kinetic
                // energy's velocity (the block's product) and the energy;
                // the working vectors indexed as shared memory by 32-bit
                // offsets. Each chain's products run whether it builds or
                // not.
                if (bld) {
                    const float kick0 = b0 * epss;
                    float p[K], g[K];
                    lane_trips<K>(n, lane,
                               [&](int k, int i) { p[k] = sm[cp_o + i]; g[k] = sm[cg_o + i]; },
                               [&](int k, int i) {
                                   const float pk = p[k] + kick0 * g[k];
                                   sm[cp_o + i] = pk;
                                   stage(qt_off, stride, w, i, pk);
                               });
                }
                LMC_CLK(kClkLeapfrog);
                for (int s = 0; s < stages; ++s) {
                    __syncthreads();  // every chain's p is staged, and its last velocity read
                    block_velocity(T, qt_off, vs_off);
                    __syncthreads();  // every velocity is written
                    LMC_CLK_PRODUCT();
                    LMC_CLK(kClkBody);
                    if (bld) {
                        const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * epss;
                        float q[K], v[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) { q[k] = sm[cq_o + i]; v[k] = sm[vv_o + i]; },
                                   [&](int k, int i) {
                                       const float qk = q[k] + drift * v[k];
                                       sm[cq_o + i] = qk;
                                       stage(qt_off, stride, w, i, qk);
                                   });
                    }
                    LMC_CLK(kClkLeapfrog);
                    __syncthreads();  // every chain's q is staged
                    block_product(T, qt_off, g_off);
                    __syncthreads();  // every g is written
                    LMC_CLK_PRODUCT();
                    LMC_CLK(kClkBody);
                    if (bld) {
                        const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * epss;
                        float sums[1] = {0.f};  // the body's sum q.grad
                        float p[K], g[K], q[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       q[k] = sm[cq_o + i]; p[k] = sm[cp_o + i];
                                       g[k] = sm[cg_o + i];
                                   },
                                   [&](int k, int i) {
                                       sums[0] += q[k] * g[k];
                                       const float pk = p[k] + kick * g[k];
                                       sm[cp_o + i] = pk;
                                       stage(qt_off, stride, w, i, pk);
                                   });
                        LMC_CLK(kClkLeapfrog);
                        warp_sums(sums);
                        LMC_CLK(kClkWarpSums);
                        c_lp = 0.5f * sums[0];
                    }
                }
                __syncthreads();  // every chain's p is staged
                block_velocity(T, qt_off, vs_off);
                __syncthreads();  // every velocity is written
                LMC_CLK_PRODUCT();
                LMC_CLK(kClkBody);
                if (bld) {
                    float sums[1] = {0.f};  // p.(p COV)
                    float p[K], v[K];
                    lane_trips<K>(n, lane,
                               [&](int k, int i) { p[k] = sm[cp_o + i]; v[k] = sm[vv_o + i]; },
                               [&](int k, int i) { sums[0] += p[k] * v[k]; });
                    LMC_CLK(kClkLeapfrog);
                    warp_sums(sums);
                    LMC_CLK(kClkWarpSums);
                    c_e = 0.5f * sums[0] - c_lp;
                }
            } else {
                // one symplectic step (reference integration.py:100-121): each
                // stage's kick (the first stage's), drift and staging in one
                // pass, the block's product, then the log density, the next kick
                // and after the last stage the kinetic energy in one pass
                for (int s = 0; s < stages; ++s) {
                    const bool first = s == 0, last = s + 1 == stages;
                    if (bld) {
                        const float kick0 = b0 * epss;
                        const float drift = (s == 0 ? a0 : s == 1 ? a1 : a2) * epss;
                        float p[K], g[K], q[K], v[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       p[k] = cp[i]; q[k] = cq[i]; v[k] = vv[i];
                                       if (first) g[k] = cg[i];
                                   },
                                   [&](int k, int i) {
                                       float pk = p[k];
                                       if (first) {
                                           pk = pk + kick0 * g[k];
                                           cp[i] = pk;
                                       }
                                       const float qk = q[k] + drift * (v[k] * pk);
                                       cq[i] = qk;
                                       if (BODY == 1) sm[qt_off + i * stride + w] = qk;
                                   });
                    }
                    LMC_CLK(kClkLeapfrog);
                    if constexpr (BODY == 1) {
                        __syncthreads();  // every chain's q is staged, and its last g read
                        block_product(T, qt_off, g_off);
                        __syncthreads();  // every g is written
                        LMC_CLK_PRODUCT();
                    }
                    LMC_CLK(kClkBody);
                    if (bld) {
                        const float kick = (s == 0 ? b1 : s == 1 ? b2 : b3) * epss;
                        float sums[2] = {0.f, 0.f};  // the body's sum, p.(vv p) after the last one
                        float p[K], g[K], q[K], v[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       q[k] = cq[i]; p[k] = cp[i]; v[k] = vv[i];
                                       if (BODY == 1) g[k] = cg[i];
                                   },
                                   [&](int k, int i) {
                                       // body 0: logp = -q.q/2, grad = -q; body 1: logp = q.grad/2
                                       float gk;
                                       if (BODY == 1) {
                                           gk = g[k];
                                           sums[0] += q[k] * gk;
                                       } else {
                                           gk = -q[k];
                                           sums[0] += q[k] * q[k];
                                           cg[i] = gk;
                                       }
                                       const float pk = p[k] + kick * gk;
                                       cp[i] = pk;
                                       if (last) sums[1] += pk * (v[k] * pk);
                                   });
                        LMC_CLK(kClkLeapfrog);
                        warp_sums(sums);
                        LMC_CLK(kClkWarpSums);
                        c_lp = BODY == 1 ? 0.5f * sums[0] : -0.5f * sums[0];
                        if (last) c_e = 0.5f * sums[1] - c_lp;
                    }
                }
            }
            if (bld) {
                dE = c_e - E0;
                if (isnan(dE)) dE = CUDART_INF_F;
                if (fabsf(dE) > fabsf(mec)) mec = dE;
                div_leaf = !(fabsf(dE) < T.Emax);
                ++nlv;
                lpaw = -dE + fminf(0.f, -dE);
            }
            bool mrg = bld && !div_leaf;
            const bool is_odd = leaf & 1;
            LMC_CLK(kClkOther);
            const bool go_m0 = __syncthreads_or(mrg);
            LMC_CLK_VOTE(was_bld);
            if (!is_odd) {
                if (mrg) {  // a leaf slot has left p == right p == p sum
                    const Slot sl = slot(h);
                    float *dps = sl.ps, *dq = sl.q;
                    if constexpr (CACHED) {  // and its velocity as the left p's
                        float* dvl = sl.vl;
                        float p[K], q[K], v[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) { p[k] = cp[i]; q[k] = cq[i]; v[k] = vlf[i]; },
                                   [&](int k, int i) { dps[i] = p[k]; dq[i] = q[k]; dvl[i] = v[k]; });
                    } else {
                        float p[K], q[K];
                        lane_trips<K>(n, lane, [&](int k, int i) { p[k] = cp[i]; q[k] = cq[i]; },
                                   [&](int k, int i) { dps[i] = p[k]; dq[i] = q[k]; });
                    }
                    LMC_CLK(kClkLeafStore);
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
                    const Slot sl = slot(s);
                    float *slp = sl.lp, *srp = sl.rp, *sps = sl.ps, *sq = sl.q;
                    LMC_CLK(kClkOther);
                    float d[2] = {0.f, 0.f};
                    if constexpr (CACHED) {
                        // the even leaf's velocity (the slot's left p's) and
                        // this leaf's, which becomes the right p's
                        float *svl = sl.vl, *svr = sl.vr;
                        float t1[K], t2[K], v1[K], v2[K], q[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       t1[k] = sps[i]; t2[k] = cp[i]; v1[k] = svl[i];
                                       v2[k] = vlf[i]; q[k] = cq[i];
                                   },
                                   [&](int k, int i) {
                                       const float ps = t1[k] + t2[k];
                                       d[0] += ps * v1[k];
                                       d[1] += ps * v2[k];
                                       slp[i] = t1[k]; srp[i] = t2[k]; sps[i] = ps;
                                       svr[i] = v2[k];
                                       if (take2) sq[i] = q[k];
                                   });
                    } else {
                        float t1[K], t2[K], v[K], q[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       t1[k] = sps[i]; t2[k] = cp[i]; v[k] = vv[i];
                                       q[k] = cq[i];
                                   },
                                   [&](int k, int i) {
                                       const float ps = t1[k] + t2[k];
                                       d[0] += ps * (v[k] * t1[k]);
                                       d[1] += ps * (v[k] * t2[k]);
                                       slp[i] = t1[k]; srp[i] = t2[k]; sps[i] = ps;
                                       if (take2) sq[i] = q[k];
                                   });
                    }
                    LMC_CLK(kClkMerge);
                    warp_sums(d);
                    LMC_CLK(kClkWarpSums);
                    if (lane == 0) {
                        if (take2) { ssc(s_e, s) = c_e; ssc(s_lpp, s) = c_lp; }
                        ssc(s_ls, s) = ls; ssc(s_lw, s) = lw;
                    }
                    mrg = !(d[0] <= 0.f || d[1] <= 0.f);
                }
            }
            __syncwarp();

            // one in-place merge per trailing one-bit of leaf past bit 0
            int j = 1, hh = h - (is_odd ? 1 : 0);
            LMC_CLK(kClkOther);
            bool go_m = __syncthreads_or(mrg) && is_odd;
            LMC_CLK_VOTE(was_bld);
            while (((leaf >> j) & 1) && go_m) {
                const float u = uniform();
                if (mrg) {
                    const int s1 = hh - 1, s2 = hh;
                    const float ls = logaddexp(ssc(s_ls, s1), ssc(s_ls, s2));
                    const float lw = logaddexp(ssc(s_lw, s1), ssc(s_lw, s2));
                    const bool take2 = logf(u) < ssc(s_ls, s2) - ls;
                    const Slot sa = slot(s1), sb = slot(s2);
                    float *a_lp = sa.lp, *a_rp = sa.rp, *a_ps = sa.ps, *a_q = sa.q;
                    const float *b_lp = sb.lp, *b_rp = sb.rp, *b_ps = sb.ps, *b_q = sb.q;
                    LMC_CLK(kClkOther);
                    float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                    if constexpr (CACHED) {
                        // the four edges' cached velocities; b's right p's
                        // becomes a's
                        const float *a_vl = sa.vl, *b_vl = sb.vl, *b_vr = sb.vr;
                        float* a_vr = sa.vr;
                        float t1rp[K], t1ps[K], t2lp[K], t2rp[K], t2ps[K], q[K];
                        float vt1lp[K], vt1rp[K], vt2lp[K], vt2rp[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       t1rp[k] = a_rp[i]; t1ps[k] = a_ps[i];
                                       t2lp[k] = b_lp[i]; t2rp[k] = b_rp[i]; t2ps[k] = b_ps[i];
                                       vt1lp[k] = a_vl[i]; vt1rp[k] = a_vr[i];
                                       vt2lp[k] = b_vl[i]; vt2rp[k] = b_vr[i];
                                       q[k] = b_q[i];
                                   },
                                   [&](int k, int i) {
                                       const float ps = t1ps[k] + t2ps[k];
                                       d[0] += ps * vt1lp[k];
                                       d[1] += ps * vt2rp[k];
                                       const float ps1 = t1ps[k] + t2lp[k];
                                       d[2] += ps1 * vt1lp[k];
                                       d[3] += ps1 * vt2lp[k];
                                       const float ps2 = t1rp[k] + t2ps[k];
                                       d[4] += ps2 * vt1rp[k];
                                       d[5] += ps2 * vt2rp[k];
                                       a_rp[i] = t2rp[k];
                                       a_vr[i] = vt2rp[k];
                                       a_ps[i] = ps;
                                       if (take2) a_q[i] = q[k];
                                   });
                    } else {
                        float t1lp[K], t1rp[K], t1ps[K], t2lp[K], t2rp[K], t2ps[K], v[K], q[K];
                        lane_trips<K>(n, lane,
                                   [&](int k, int i) {
                                       t1lp[k] = a_lp[i]; t1rp[k] = a_rp[i]; t1ps[k] = a_ps[i];
                                       t2lp[k] = b_lp[i]; t2rp[k] = b_rp[i]; t2ps[k] = b_ps[i];
                                       v[k] = vv[i];
                                       q[k] = b_q[i];
                                   },
                                   [&](int k, int i) {
                                       const float vt1lp = v[k] * t1lp[k], vt1rp = v[k] * t1rp[k];
                                       const float vt2lp = v[k] * t2lp[k], vt2rp = v[k] * t2rp[k];
                                       const float ps = t1ps[k] + t2ps[k];
                                       d[0] += ps * vt1lp;
                                       d[1] += ps * vt2rp;
                                       const float ps1 = t1ps[k] + t2lp[k];
                                       d[2] += ps1 * vt1lp;
                                       d[3] += ps1 * vt2lp;
                                       const float ps2 = t1rp[k] + t2ps[k];
                                       d[4] += ps2 * vt1rp;
                                       d[5] += ps2 * vt2rp;
                                       a_rp[i] = t2rp[k];
                                       a_ps[i] = ps;
                                       if (take2) a_q[i] = q[k];
                                   });
                    }
                    LMC_CLK(kClkMerge);
                    warp_sums(d);
                    bool turn = false;
#pragma unroll
                    for (int k = 0; k < 6; ++k) turn |= d[k] <= 0.f;
                    LMC_CLK(kClkWarpSums);
                    if (lane == 0) {
                        if (take2) { ssc(s_e, s1) = ssc(s_e, s2); ssc(s_lpp, s1) = ssc(s_lpp, s2); }
                        ssc(s_ls, s1) = ls; ssc(s_lw, s1) = lw;
                    }
                    __syncwarp();
                    mrg = mrg && !turn;
                }
                LMC_CLK(kClkOther);
                go_m = __syncthreads_or(mrg);
                LMC_CLK_VOTE(was_bld);
                ++j;
                --hh;
            }

            const bool turned = bld && !div_leaf && !mrg;
            sdv = sdv || div_leaf;
            stn = stn || turned;
            bld = bld && !div_leaf && !turned;
            LMC_CLK(kClkOther);
            go_l = __syncthreads_or(bld);
            LMC_CLK_VOTE(was_bld);
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
            const Slot s0 = slot(0);
            const float *nlp = depth == 0 ? s0.ps : s0.lp, *nrp = depth == 0 ? s0.ps : s0.rp,
                        *nps = s0.ps, *nq = s0.q;
            LMC_CLK(kClkOther);
            float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            constexpr int K2 = K < 2 ? K : 2;  // trips at a time: 11 values a trip are live
            if constexpr (CACHED) {
                // the old edges' velocities (vl, vr), the new subtree's
                // edges' from its slot; its outer edge is the last leaf's
                // p (the slot's right p), whose velocity becomes the
                // tree's new edge's
                const float *nvl = s0.vl, *nvr = depth == 0 ? s0.vl : s0.vr;
                float xps[K2], xlp[K2], xq[K2], ops[K2], olp[K2], orp[K2];
                float q[K2], p[K2], g[K2], vol[K2], vor[K2], vnl[K2], vnr[K2];
                lane_trips<K2>(n, lane,
                           [&](int k, int i) {
                               xps[k] = nps[i]; xlp[k] = nlp[i];
                               if (take_new) xq[k] = nq[i];
                               ops[k] = psum[i]; olp[k] = lp[i]; orp[k] = rp[i];
                               q[k] = cq[i]; p[k] = cp[i]; g[k] = cg[i];
                               vol[k] = vl[i]; vor[k] = vr[i]; vnl[k] = nvl[i]; vnr[k] = nvr[i];
                           },
                           [&](int k, int i) {
                               const float n_ps = xps[k], n_lp = xlp[k];
                               if (take_new) prq[i] = xq[k];
                               const float old_ps = ops[k];
                               const float pst = old_ps + n_ps;
                               psum[i] = pst;
                               const float old_l_p = olp[k], old_r_p = orp[k];
                               if (go_right) {
                                   rq[i] = q[k]; rp[i] = p[k]; rg[i] = g[k]; vr[i] = vnr[k];
                               } else {
                                   lq[i] = q[k]; lp[i] = p[k]; lg[i] = g[k]; vl[i] = vnr[k];
                               }
                               // 3-way U-turn on the merged span (reference nuts.py:332-340)
                               const float ps1 = go_right ? old_ps + n_lp : n_ps + old_l_p;
                               const float ps2 = go_right ? old_r_p + n_ps : n_lp + old_ps;
                               const float v_ol = vol[k], v_or = vor[k], v_c = vnr[k];
                               const float v_nl = vnl[k], v_nr = vnr[k];
                               d[0] += pst * (go_right ? v_ol : v_c);
                               d[1] += pst * (go_right ? v_c : v_or);
                               d[2] += ps1 * (go_right ? v_ol : v_nr);
                               d[3] += ps1 * (go_right ? v_nl : v_ol);
                               d[4] += ps2 * (go_right ? v_or : v_nl);
                               d[5] += ps2 * (go_right ? v_nr : v_or);
                           });
            } else {
                float xps[K2], xlp[K2], xrp[K2], xq[K2], ops[K2], olp[K2], orp[K2];
                float q[K2], p[K2], g[K2], v[K2];
                lane_trips<K2>(n, lane,
                           [&](int k, int i) {
                               xps[k] = nps[i]; xlp[k] = nlp[i]; xrp[k] = nrp[i];
                               if (take_new) xq[k] = nq[i];
                               ops[k] = psum[i]; olp[k] = lp[i]; orp[k] = rp[i];
                               q[k] = cq[i]; p[k] = cp[i]; g[k] = cg[i]; v[k] = vv[i];
                           },
                           [&](int k, int i) {
                               const float n_ps = xps[k], n_lp = xlp[k], n_rp = xrp[k];
                               if (take_new) prq[i] = xq[k];
                               const float old_ps = ops[k];
                               const float pst = old_ps + n_ps;
                               psum[i] = pst;
                               const float old_l_p = olp[k], old_r_p = orp[k];
                               float new_l_p = old_l_p, new_r_p = old_r_p;
                               if (go_right) {
                                   rq[i] = q[k]; rp[i] = p[k]; rg[i] = g[k]; new_r_p = p[k];
                               } else {
                                   lq[i] = q[k]; lp[i] = p[k]; lg[i] = g[k]; new_l_p = p[k];
                               }
                               // 3-way U-turn on the merged span (reference nuts.py:332-340)
                               const float ps1 = go_right ? old_ps + n_lp : n_ps + old_l_p;
                               const float ps2 = go_right ? old_r_p + n_ps : n_lp + old_ps;
                               const float vk = v[k];
                               d[0] += pst * (vk * new_l_p);
                               d[1] += pst * (vk * new_r_p);
                               const float p1a = go_right ? old_l_p : n_rp;
                               const float p1b = go_right ? n_lp : old_l_p;
                               d[2] += ps1 * (vk * p1a);
                               d[3] += ps1 * (vk * p1b);
                               const float p2a = go_right ? old_r_p : n_lp;
                               const float p2b = go_right ? n_rp : old_r_p;
                               d[4] += ps2 * (vk * p2a);
                               d[5] += ps2 * (vk * p2b);
                           });
            }
            LMC_CLK(kClkMerge);
            warp_sums(d);
#pragma unroll
            for (int k = 0; k < 6; ++k) turning_new |= d[k] <= 0.f;
            LMC_CLK(kClkWarpSums);
        }
        const bool sel_turn = ok ? turning_new : stn;
        if (active) {
            trn = trn || sel_turn;
            div = div || sdv;
            ++depth_c;
        }
        const bool nxt = !div && !trn && depth_c < mdc;
        LMC_CLK(kClkOther);
        const bool any_nxt = __syncthreads_or(nxt);
        LMC_CLK_VOTE(active);
        cont = (depth + 1) < max_sched && any_nxt;
        ++depth;
    }
    __syncwarp();
    LMC_CLK(kClkOther);
    LMC_CLK_FLUSH(chain, lane);

    TreeResult r;
    r.pr_e = pr_e; r.pr_lp = pr_lp; r.log_size = acc_ls; r.lwas = acc_lw; r.mec = mec;
    r.depth = depth_c; r.n_leaves = nlv; r.diverging = div; r.turning = trn;
    return r;
}


// The transition an instance runs: the block transition (BLOCK) or the
// warp transition.
template <int BODY, int METRIC, bool BLOCK>
__device__ __forceinline__ TreeResult any_transition(const TreeConsts& T, const BlockState& BS,
                                                     const WarpVecs& V, float* slot_sc,
                                                     int chain, int w, int lane, const float* q0,
                                                     const float* p0, const float* g0,
                                                     float lp0, float E0, float eps, int mdc,
                                                     uint32_t salt) {
    if constexpr (BLOCK) {
        return block_transition<BODY, METRIC>(T, BS, V, slot_sc, chain, w, lane, q0, p0, g0,
                                              lp0, E0, eps, mdc, salt);
    } else {
        (void)BS;
        return transition<BODY, METRIC>(T, V, slot_sc, chain, w, lane, q0, p0, g0, lp0, E0,
                                        eps, mdc, salt);
    }
}

}  // namespace lmc
