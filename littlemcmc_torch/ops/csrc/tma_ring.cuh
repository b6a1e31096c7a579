// The Tensor Memory Accelerator's 1-D bulk copies into a ring of
// shared-memory stages, each stage completing on its own mbarrier: the
// loading half of the batched model kernels (logistic_logp_grad.cu,
// quadform_logp_grad.cu).
//
// One thread issues a stage's copies (cp.async.bulk, global -> shared,
// completing as bytes on the stage's mbarrier, armed first with the
// stage's byte count); every thread of the block waits on the barrier's
// phase parity before reading the stage. A bulk copy needs 16-byte
// aligned global and shared addresses and a size that is a multiple of 16
// bytes: the callers copy the aligned part of each range this way and the
// few floats around it with plain loads (copy_plain). A stage is reused
// only after a __syncthreads that every reader of it has passed, so no
// empty barriers are needed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lmc_tma {

// ops/_tma.py holds the same three numbers for the Python geometry planners
constexpr int kMaxSmemBytes = 232448;  // the dynamic shared memory a block may use on sm_90
constexpr int kBarrierBytes = 128;     // the barriers' room at the front of shared memory
constexpr int kMaxStages = kBarrierBytes / 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: barrier at `bar` expecting one arrival a phase
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one thread, after every barrier_init and before the block's __syncthreads
__device__ __forceinline__ void barrier_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: arrive on `bar`, whose phase then completes when `bytes`
// have landed (at once where bytes is 0)
__device__ __forceinline__ void arrive_expect_bytes(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one thread: copy `bytes` (a multiple of 16, > 0) from `src` (global,
// 16-byte aligned) to `dst` (shared, 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// the issuing thread, before it copies into a stage the block has read
// with ordinary loads: orders those reads before the copy's writes
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// every thread: spin until the phase of parity `parity` of `bar` completes
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// floats [lo, hi) of src to dst by the whole block with ordinary loads
__device__ __forceinline__ void copy_plain(float* dst, const float* __restrict__ src, int lo,
                                           int hi) {
    for (int k = lo + (int)threadIdx.x; k < hi; k += blockDim.x) dst[k] = src[k];
}

// the part of `count` floats a bulk copy takes: a multiple of 4 floats
__host__ __device__ __forceinline__ int bulk_floats(int count) { return count & ~3; }

}  // namespace lmc_tma
