// Asynchronous-copy and barrier probes for Hopper (sm_90a)
//
// Replaces scripts/beam_dma_probe.py: p1 (pallas_call at :52), p3 (:98),
// p4 (:126) and p5 (:154).  On the TPU they isolated which DMA pattern
// deadlocked Mosaic; here they check the patterns a prefetching kernel
// rests on, with TMA bulk copies (cp.async.bulk global -> shared,
// completing on an mbarrier) and mbarrier phases:
//
//   p1  one block loops over Tm steps; step t waits for the bulk copy that
//       step t-1 started (the barrier's phase t), writes the block out, and
//       starts step t+1's copy into the same buffer: an identity copy.
//   p3  as p1 with B bulk copies of the step's row, issued from a loop by
//       one thread and completing on one barrier that expects B * bytes;
//       the kernel checks that all B buffers landed equal.
//   p4  per-thread results stored in shared memory, published by every
//       thread's arrive on an mbarrier, and read back as block-uniform
//       scalars: out[t, j] = t + 1.
//   p5  the lexicographic winner (larger value, then lower code) of
//       argmax.cuh's fvt_better, as a warp-shuffle and block tournament,
//       broadcast to every output entry.
//
// Every mbarrier wait spins at most WAIT_CYCLES clock cycles (about a
// second) and then sets a bit of the error flag and returns, so a wrong
// phase fails the call instead of hanging the card.  A bulk copy needs
// 16-byte-aligned addresses and a size that is a multiple of 16 bytes:
// the wrappers check both (a padded K = 3968 row is 15872 bytes).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "argmax.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long WAIT_CYCLES = 1ll << 31;
constexpr int ERR_TIMEOUT = 1;   // an mbarrier wait timed out
constexpr int ERR_MISMATCH = 2;  // p3: a buffer differs from the first

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// True once the barrier's phase of this parity has completed
__device__ __forceinline__ bool bar_test(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait for the phase of this parity, at most WAIT_CYCLES; false on a timeout
__device__ bool bar_wait(uint64_t* bar, uint32_t parity) {
    const long long t0 = clock64();
    while (!bar_test(bar, parity)) {
        if (clock64() - t0 > WAIT_CYCLES) return false;
    }
    return true;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// p1 (B = 1) and p3: dst[t] = src[t] for Tm rows of n floats, each row
// fetched into B buffers by bulk copies that the previous step started
__global__ void __launch_bounds__(THREADS)
copy_rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int Tm, int n, int B,
                 int* __restrict__ err) {
    extern __shared__ __align__(16) float buf[];  // B rows of n floats
    __shared__ uint64_t bar;
    const int tid = threadIdx.x;
    const uint32_t bytes = (uint32_t)n * 4u;
    if (tid == 0) bar_init(&bar, 1);
    __syncthreads();
    if (tid == 0) {
        bar_arrive_expect(&bar, bytes * B);
        for (int b = 0; b < B; ++b) bulk_load(buf + (size_t)b * n, src, bytes, &bar);
    }
    for (int t = 0; t < Tm; ++t) {
        // step t's copies are the barrier's phase t
        if (!__syncthreads_and(bar_wait(&bar, t & 1))) {
            if (tid == 0) atomicOr(err, ERR_TIMEOUT);
            return;
        }
        bool same = true;
        for (int b = 1; b < B; ++b) {
            for (int i = tid; i < n; i += THREADS) {
                same &= __float_as_uint(buf[(size_t)b * n + i]) == __float_as_uint(buf[i]);
            }
        }
        if (!__syncthreads_and(same)) {
            if (tid == 0) atomicOr(err, ERR_MISMATCH);
            return;
        }
        for (int i = tid; i < n; i += THREADS) dst[(size_t)t * n + i] = buf[i];
        __syncthreads();  // every thread is done with the buffers
        if (tid == 0 && t + 1 < Tm) {
            bar_arrive_expect(&bar, bytes * B);
            for (int b = 0; b < B; ++b) {
                bulk_load(buf + (size_t)b * n, src + (size_t)(t + 1) * n, bytes, &bar);
            }
        }
    }
}

// p4: W <= blockDim.x per-thread results a step, double-buffered
constexpr int P4_MAXW = 32;

__global__ void p4_kernel(int* __restrict__ out, int Tm, int W, int* __restrict__ err) {
    __shared__ int s_v[2][P4_MAXW];
    __shared__ uint64_t bar;
    const int tid = threadIdx.x;
    if (tid == 0) bar_init(&bar, blockDim.x);  // every thread arrives once a step
    __syncthreads();
    for (int t = 0; t < Tm; ++t) {
        if (tid < W) s_v[t & 1][tid] = t;  // this thread's result
        bar_arrive(&bar);                   // release: the store is published
        if (!bar_wait(&bar, t & 1)) {       // acquire: every thread's store
            atomicOr(err, ERR_TIMEOUT);
            return;
        }
        int acc = 0;
        for (int b = 0; b < W; ++b) {
            const int s = s_v[t & 1][b];  // the same address for every thread
            if (tid == b) acc = s + 1;
        }
        if (tid < W) out[(size_t)t * W + tid] = acc;
    }
}

// p5: the fvt_better winner of n (value, code) pairs into width entries
__global__ void __launch_bounds__(THREADS)
p5_kernel(const float* __restrict__ v, const int* __restrict__ c, int n,
          float* __restrict__ outv, int* __restrict__ outc, int width) {
    __shared__ float s_v[THREADS / 32];
    __shared__ int s_c[THREADS / 32];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float bv = -INFINITY;
    int bc = INT_MAX;
    for (int i = tid; i < n; i += THREADS) {
        if (fvt_better(v[i], c[i], bv, bc)) {
            bv = v[i];
            bc = c[i];
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (fvt_better(ov, oc, bv, bc)) {
            bv = ov;
            bc = oc;
        }
    }
    if (lane == 0) {
        s_v[warp] = bv;
        s_c[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
        bv = lane < THREADS / 32 ? s_v[lane] : -INFINITY;
        bc = lane < THREADS / 32 ? s_c[lane] : INT_MAX;
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
            if (fvt_better(ov, oc, bv, bc)) {
                bv = ov;
                bc = oc;
            }
        }
        if (lane == 0) {
            s_v[0] = bv;
            s_c[0] = bc;
        }
    }
    __syncthreads();
    for (int j = tid; j < width; j += THREADS) {
        outv[j] = s_v[0];
        outc[j] = s_c[0];
    }
}

int finish(long long* launches) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}

}  // namespace

// p1 (B = 1) and p3: src and dst (Tm, n) float32, n * 4 a multiple of 16,
// both 16-byte aligned, B * n * 4 bytes of shared memory; err one int32,
// zero on entry, ORed with ERR_TIMEOUT / ERR_MISMATCH.  One launch of one
// block.  Returns the launch error.
extern "C" int fvt_probe_copy_rows(const float* src, float* dst, int Tm, int n, int B, int* err,
                                   void* stream, long long* launches) {
    const size_t smem = (size_t)B * n * 4;
    const cudaError_t e = cudaFuncSetAttribute(copy_rows_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    copy_rows_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(src, dst, Tm, n, B,
                                                                               err);
    return finish(launches);
}

// p4: out (Tm, W) int32, 1 <= W <= 32; err as above.  One launch of one warp.
extern "C" int fvt_probe_copy_p4(int* out, int Tm, int W, int* err, void* stream,
                                 long long* launches) {
    if (W < 1 || W > P4_MAXW) return static_cast<int>(cudaErrorInvalidValue);
    p4_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, Tm, W, err);
    return finish(launches);
}

// p5: v (n,) float32 and c (n,) int32; outv (width,) float32 and outc
// (width,) int32.  One launch of one block.
extern "C" int fvt_probe_copy_p5(const float* v, const int* c, int n, float* outv, int* outc,
                                 int width, void* stream, long long* launches) {
    p5_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(v, c, n, outv, outc, width);
    return finish(launches);
}
