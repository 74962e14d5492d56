// Bulk copies (global -> shared, TMA's cp.async.bulk) and the mbarriers
// they complete on, shared by the kernels that prefetch rows; and bulk
// stores (shared -> global), which complete in bulk groups of the thread
// that issued them.
//
// A bulk copy needs 16-byte-aligned addresses and a size that is a multiple
// of 16 bytes; it adds its bytes to the barrier's transaction count when it
// lands.  A phase of a barrier initialised with count 1 completes once one
// thread has arrived (arrive_expect, which also announces the bytes) and
// every announced byte has landed; a copy may land before the announcement.
//
// Every wait spins at most WAIT_CYCLES clock cycles (about a second) and
// then returns false, so a kernel whose copy never lands sets an error word
// instead of hanging the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr long long FVT_WAIT_CYCLES = 1ll << 31;

__device__ __forceinline__ uint32_t fvt_smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fvt_bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(fvt_smem_addr(bar)), "r"(count)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void fvt_bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(fvt_smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fvt_bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     fvt_smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// True once the barrier's phase of this parity has completed
__device__ __forceinline__ bool fvt_bar_test(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(fvt_smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait for the phase of this parity, at most FVT_WAIT_CYCLES; false on a timeout
__device__ __forceinline__ bool fvt_bar_wait(uint64_t* bar, uint32_t parity) {
    if (fvt_bar_test(bar, parity)) return true;
    const long long t0 = clock64();
    while (!fvt_bar_test(bar, parity)) {
        if (clock64() - t0 > FVT_WAIT_CYCLES) return false;
    }
    return true;
}

// True once the phase of this parity has completed.  Unlike fvt_bar_test
// it may suspend the thread for a while before it answers, so a thread
// that waits in a loop of it takes few of the issue slots its warp's
// neighbours compute with (the ring scan's producer: a spin of
// fvt_bar_test cost its step ~2% on an H100)
__device__ __forceinline__ bool fvt_bar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(fvt_smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Order this thread's earlier shared-memory reads before later bulk copies
// into the same buffer (the copies write through the async proxy)
__device__ __forceinline__ void fvt_fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fvt_bulk_load(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(fvt_smem_addr(dst)), "l"(src), "r"(bytes), "r"(fvt_smem_addr(bar))
        : "memory");
}

// Store bytes of shared memory to global memory as one bulk copy of this
// thread's current bulk group.  Precede it with fvt_fence_proxy_async where
// threads wrote the source; the source may be refilled only after
// fvt_bulk_wait_read.
__device__ __forceinline__ void fvt_bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst), "r"(fvt_smem_addr(src)), "r"(bytes)
                 : "memory");
}

// Close this thread's current bulk group
__device__ __forceinline__ void fvt_bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every bulk group this thread committed has read its source
__device__ __forceinline__ void fvt_bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Wait until every bulk group this thread committed is complete (its
// writes done)
__device__ __forceinline__ void fvt_bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
