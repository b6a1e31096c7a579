// The probe of generated model bodies: each body alone, one warp a chain.
//
// Replaces the TPU kernel littlemcmc_tpu/ops/autospec.py::probe_spec
// (pallas_call at :540), which runs a lowered user model's body alone in a
// minimal kernel and checks it against a plain evaluation before sample()
// trusts it. The plain version it is held against is the traced graph
// (ops/autospec.py::Program.plain); ops/autospec.py::probe_specs compares.
//
// Builds only with a generated header (LMC_AUTOSPEC_PROBE_HEADER,
// written by ops/autospec.py::probe_header): the bodies, each in its own
// namespace lmc::autobody_<k>, and lmc::autoprobe::eval(which, ...)
// choosing one, so one nvcc builds every body a probe run holds.
//
// Mapping: warp w of block b is chain b * 8 + w; its q row is copied into
// shared memory, the body writes its gradient there (the contract of
// model_eval in nuts_transition.cuh), and both go back to global memory.
// The body's constants are read from global memory; its scratch rows
// ([8][scratch_floats]) sit in shared memory after q and the gradient
// where they fit, as the trajectory kernels place them, else in the
// chain's row of the global scratch (C, scratch_floats).
//
// Build: the flags of the other kernels (ops/_build.py::BUILD_FLAGS).

#include "nuts_transition.cuh"

#ifndef LMC_AUTOSPEC_PROBE_HEADER
#error "autospec_probe.cu builds only with a generated header (LMC_AUTOSPEC_PROBE_HEADER)"
#endif
#include LMC_AUTOSPEC_PROBE_HEADER

namespace {

constexpr int kWarps = 8;  // chains per thread block

// 227 KB per block on Hopper
constexpr size_t kSmemLimit = 232448;

__global__ void __launch_bounds__(32 * kWarps)
    autospec_probe_kernel(int which, const float* q, const float* lam, float* scratch,
                          int scratch_floats, int scratch_in_smem, int n, int C, float* logp,
                          float* g) {
    extern __shared__ float smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * kWarps + w;
    if (chain >= C) return;  // the bodies sync the warp only
    float* qs = smem + (size_t)w * 2 * n;
    float* gs = qs + n;
    float* s = scratch_in_smem ? smem + (size_t)kWarps * 2 * n + (size_t)w * scratch_floats
                               : scratch + (size_t)chain * scratch_floats;
    for (int i = lane; i < n; i += 32) qs[i] = q[(size_t)chain * n + i];
    __syncwarp();
    const float lp = lmc::autoprobe::eval(which, qs, gs, lam, n, lane, s);
    for (int i = lane; i < n; i += 32) g[(size_t)chain * n + i] = gs[i];
    if (lane == 0) logp[chain] = lp;
}

}  // namespace

extern "C" {

// ptrs: q (C, n), the body's packed constants (may be null), the scratch
// (C, scratch_floats), logp (C), grad (C, n); ints: which body, n, C,
// scratch_floats. Returns cudaGetLastError() after the launch.
int autospec_probe_launch(void* const* ptrs, const int* ints, const float* floats,
                          void* stream) {
    (void)floats;
    const int which = ints[0], n = ints[1], C = ints[2], scratch_floats = ints[3];
    if (n < 1 || C < 1 || scratch_floats < 0) return (int)cudaErrorInvalidValue;
    size_t bytes = (size_t)kWarps * 2 * n * sizeof(float);
    const size_t need = (size_t)kWarps * scratch_floats * sizeof(float);
    const int in_smem = need > 0 && bytes + need <= kSmemLimit;
    lmc::last_scratch_in_smem = in_smem;
    if (in_smem) bytes += need;
    cudaError_t err = cudaFuncSetAttribute(autospec_probe_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    autospec_probe_kernel<<<(C + kWarps - 1) / kWarps, 32 * kWarps, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        which, static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
        static_cast<float*>(ptrs[2]), scratch_floats, in_smem, n, C,
        static_cast<float*>(ptrs[3]), static_cast<float*>(ptrs[4]));
    return (int)cudaGetLastError();
}

// Where the last launch put the scratch rows: 1 shared memory, 0 global.
int autospec_scratch_in_smem(void) { return lmc::last_scratch_in_smem; }

const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
