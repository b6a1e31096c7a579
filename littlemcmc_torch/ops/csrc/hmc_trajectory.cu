// One classic-HMC transition per chain, diag metric, model inlined.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/hmc_trajectory_pallas.py::
// build_hmc_trajectory_op (pallas_call at :273; body _build_hmc_kernel_body
// :113 and run_hmc_trajectory_values :58-110), pack=1. The plain PyTorch
// version it is held against is ops/hmc_trajectory.py::hmc_trajectory_plain.
// The trajectory itself is hmc_transition.cuh, which the fused HMC kernel
// (fused_hmc.cu) shares.
//
// Mapping. One warp per chain, 8 chains per thread block. Chains share
// nothing during the trajectory, so each warp runs its own n_steps[c]
// leapfrogs and finishes when they are done; the only block-wide barrier
// is after the precision and the chain's vectors are loaded. The accept
// uniform is call 1 of the chain's counter stream, salted with the chain's
// logical chain block and row (the JAX op's chain block, an argument), not
// with this kernel's thread block, so the kernel, the plain version and the
// JAX kernel under interpret=True draw the same number.
//
// What bounds it on this card. Per chain and step: the model body (for the
// correlated Gaussian a 2n^2-FLOP matvec, g = -q P) and about 10n
// elementwise operations for the kick, drift and the energies; fp32 work
// outside the tensor cores, against the inputs read once and the outputs
// written once. The design keeps the chain's q, p, g and inverse mass and
// the precision P in shared memory (P is read from global memory, where L2
// holds it, when it does not fit), so each step reads device memory not at
// all.
//
// Build: as nuts_trajectory.cu (-fmad=false, fmaf explicit in the matvecs).

#include "hmc_transition.cuh"

namespace {

using namespace lmc;

// pointer arguments, in the order of ops/hmc_trajectory.py::_PTRS
enum {
    kQ, kP, kG, kVar, kLogp, kEps, kNSteps, kConsts, kQOut, kGOut,
    kLogpOut, kLogpEnd, kEnergy, kEnergyChange, kAccept, kAccepted, kDiverging, kNumPtrs
};
enum { iC, iN, iCb, iStages, iBody, iSeed0, iSeed1, iRows, kNumInts };
enum { fEmax, fB0, fA0 = fB0 + 4, kNumFloats = fA0 + 3 };

constexpr int kWarps = 8;  // chains per thread block

struct Args {
    void* ptr[kNumPtrs];
    int C, n, cb;
    uint32_t seed0, seed1;
    HmcConsts K;
    int lam_in_smem;
};

template <typename T>
__device__ __forceinline__ T* arg(const Args& A, int k) {
    return static_cast<T*>(A.ptr[k]);
}

template <int BODY>
__global__ void __launch_bounds__(32 * kWarps) hmc_trajectory_kernel(Args A) {
    extern __shared__ float smem[];
    const int n = A.n;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * kWarps + w;

    // shared layout: the chain's q, p, g and inverse mass [4][kWarps][n],
    // then the body's constants where they fit
    float* q = warp_vec(smem, 0, kWarps, w, n);
    float* p = warp_vec(smem, 1, kWarps, w, n);
    float* g = warp_vec(smem, 2, kWarps, w, n);
    float* vv = warp_vec(smem, 3, kWarps, w, n);
    HmcConsts K = A.K;
    K.lam = stage_body<BODY>(K.lam, n, K.rows,
                             A.lam_in_smem ? smem + (size_t)4 * kWarps * n : nullptr);
    const bool live = chain < A.C;
    const size_t row = (size_t)chain * n;
    if (live) {
        for (int i = lane; i < n; i += 32) {
            q[i] = arg<const float>(A, kQ)[row + i];
            p[i] = arg<const float>(A, kP)[row + i];
            g[i] = arg<const float>(A, kG)[row + i];
            vv[i] = arg<const float>(A, kVar)[row + i];
        }
    }
    __syncthreads();  // the body's constants are in shared memory
    if (!live) return;

    const float lp0 = arg<const float>(A, kLogp)[chain];
    const float E0 = half_kinetic<kDiag>(K, p, vv, nullptr, lane) - lp0;
    const HmcResult r = hmc_trajectory<BODY, kDiag>(K, q, p, g, vv, nullptr, lp0, E0,
                                                    arg<const float>(A, kEps)[chain],
                                                    arg<const int>(A, kNSteps)[chain], lane);

    // the Metropolis accept: call 1 of the chain's stream in its logical block
    const uint32_t blk = (uint32_t)(chain / A.cb), rw = (uint32_t)(chain % A.cb);
    const uint32_t salt = fmix32((A.seed0 + blk * 7919u + rw * 101027u) ^ (A.seed1 * kGolden));
    const bool accepted = !r.div && counter_uniform(salt, 1u) < r.acc;

    const float* qin = arg<const float>(A, kQ) + row;
    const float* gin = arg<const float>(A, kG) + row;
    float* qo = arg<float>(A, kQOut) + row;
    float* go = arg<float>(A, kGOut) + row;
    for (int i = lane; i < n; i += 32) {
        qo[i] = accepted ? q[i] : qin[i];
        go[i] = accepted ? g[i] : gin[i];
    }
    if (lane == 0) {
        arg<float>(A, kLogpOut)[chain] = accepted ? r.lp : lp0;
        arg<float>(A, kLogpEnd)[chain] = r.lp;
        arg<float>(A, kEnergy)[chain] = r.en;
        arg<float>(A, kEnergyChange)[chain] = r.dE;
        arg<float>(A, kAccept)[chain] = r.acc;
        arg<bool>(A, kAccepted)[chain] = accepted;
        arg<bool>(A, kDiverging)[chain] = r.div;
    }
}

// 227 KB per block on Hopper
constexpr size_t kSmemLimit = 232448;

template <int BODY>
cudaError_t launch(const Args& A0, cudaStream_t stream) {
    Args A = A0;
    size_t bytes = (size_t)4 * kWarps * A.n * sizeof(float);
    const size_t body_bytes = body_floats(BODY, A.n, A.K.rows) * sizeof(float);
    A.lam_in_smem = (body_bytes > 0 && bytes + body_bytes <= kSmemLimit) ? 1 : 0;
    if (A.lam_in_smem) bytes += body_bytes;
    if (bytes > kSmemLimit) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(hmc_trajectory_kernel<BODY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    hmc_trajectory_kernel<BODY><<<(A.C + kWarps - 1) / kWarps, 32 * kWarps, bytes, stream>>>(A);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). ptrs: the
// kNumPtrs device pointers (kConsts null for a body without constants);
// ints: kNumInts; floats: kNumFloats.
int hmc_trajectory_launch(void* const* ptrs, const int* ints, const float* floats,
                          void* stream) {
    Args A;
    for (int k = 0; k < kNumPtrs; ++k) A.ptr[k] = ptrs[k];
    A.C = ints[iC]; A.n = ints[iN]; A.cb = ints[iCb];
    A.seed0 = (uint32_t)ints[iSeed0]; A.seed1 = (uint32_t)ints[iSeed1];
    A.K.lam = static_cast<const float*>(ptrs[kConsts]);
    A.K.rows = ints[iRows];
    A.K.cov = nullptr;
    A.K.n = A.n; A.K.n_stages = ints[iStages]; A.K.Emax = floats[fEmax];
    for (int k = 0; k < 4; ++k) A.K.b[k] = floats[fB0 + k];
    for (int k = 0; k < 3; ++k) A.K.a[k] = floats[fA0 + k];
    A.lam_in_smem = 0;
    const int body = ints[iBody];
    if (A.C < 1 || A.n < 1 || A.cb < 1 || A.K.n_stages < 1 || A.K.n_stages > 3
        || ((body == 1 || body == 3) && A.n > 32 * kMaxCols) || (body == 2 && A.n != 10)
        || (body == 3 && A.K.rows < 1) || (body == 4 && (A.K.rows < 1 || A.K.rows > kMaxRank))
        || (body == 5 && A.n < 2) || (body == kAutoBody && A.n > 32 * kMaxCols))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (body) {
#ifndef LMC_AUTOSPEC_ONLY  // a generated body's library holds its instances only
        case 0: return (int)launch<0>(A, s);
        case 1: return (int)launch<1>(A, s);
        case 2: return (int)launch<2>(A, s);
        case 3: return (int)launch<3>(A, s);
        case 4: return (int)launch<4>(A, s);
        case 5: return (int)launch<5>(A, s);
#endif
#ifdef LMC_AUTOSPEC_HEADER
        case kAutoBody: return (int)launch<kAutoBody>(A, s);
#endif
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
