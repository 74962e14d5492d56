// Asynchronous-copy and barrier probes for Hopper (sm_90a)
//
// Replaces scripts/beam_dma_probe.py: p1 (pallas_call at :52), p3 (:98),
// p4 (:126) and p5 (:154).  On the TPU they isolated which DMA pattern
// deadlocked Mosaic; here they check the patterns a prefetching kernel
// rests on, with TMA bulk copies (cp.async.bulk global -> shared,
// completing on an mbarrier) and mbarrier phases:
//
//   p1  an identity copy of Tm rows.  G CTAs each own a contiguous run of
//       steps (probes/copy.py:copy_plan) and a ring of D stages, one
//       mbarrier a stage: the copy of step t + D - 1 is issued while step t
//       is consumed, so every wait is on a copy an earlier step started,
//       at the phase parity of the stage's use (D = 1 where two stages do
//       not fit: each step then waits on its own copy).  A step's row goes
//       out by a bulk store from shared memory, and a stage is refilled
//       only after the store has read it.
//   p3  as p1 with B bulk copies of the step's row, issued from a loop by
//       one thread and completing on one barrier that expects B * bytes;
//       the kernel checks that all B buffers landed equal.
//
// What bounds p1 and p3: the bytes, each row read once and written once
// (2.42 us for 255 rows of 15872 bytes at 3.35 TB/s).  One block walking
// every step in series paid a whole copy round trip a step; spreading the
// steps over the SMs and keeping D - 1 copies in flight a CTA leaves the
// round trips to overlap.
//   p4  per-thread results stored in shared memory, published by every
//       thread's arrive on an mbarrier, and read back as block-uniform
//       scalars: out[t, j] = t + 1.
//   p5  the lexicographic winner (larger value, then lower code) of
//       argmax.cuh's fvt_better, as a warp-shuffle and block tournament,
//       broadcast to every output entry.
//
// Every mbarrier wait spins at most FVT_WAIT_CYCLES clock cycles (about a
// second, async_copy.cuh) and then sets a bit of the error flag and
// returns, so a wrong phase fails the call instead of hanging the card.  A bulk copy needs
// 16-byte-aligned addresses and a size that is a multiple of 16 bytes:
// the wrappers check both (a padded K = 3968 row is 15872 bytes).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "argmax.cuh"
#include "async_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ERR_TIMEOUT = 1;   // an mbarrier wait timed out
constexpr int ERR_MISMATCH = 2;  // p3: a buffer differs from the first

constexpr int STAGES_MAX = 16;  // ring stages a CTA (probes/copy.py: STAGES_MAX)

// fields of the int array fvt_probe_copy_rows takes (copy_plan's c_args)
enum CopyField { CF_CTAS, CF_STAGES, CF_COUNT };

// p1 (B = 1) and p3: dst[t] = src[t] for Tm rows of n floats.  CTA g copies
// steps t0 .. t1 of G; a step's row lands in the B buffers of stage
// (t - t0) % D, the k-th use of that stage being its barrier's phase k.
__global__ void __launch_bounds__(THREADS)
copy_ring_kernel(const float* __restrict__ src, float* __restrict__ dst, int Tm, int n, int B,
                 int G, int D, int* __restrict__ err) {
    extern __shared__ __align__(128) float buf[];  // D stages of B rows of n floats
    __shared__ uint64_t bar[STAGES_MAX];
    const int tid = threadIdx.x;
    const int t0 = (int)((long long)blockIdx.x * Tm / G);
    const int steps = (int)((long long)(blockIdx.x + 1) * Tm / G) - t0;
    const uint32_t bytes = (uint32_t)n * 4u;
    const size_t stage = (size_t)B * n;
    // one thread issues step i's B copies into its stage
    auto issue = [&](int i) {
        float* s = buf + (size_t)(i % D) * stage;
        fvt_bar_arrive_expect(&bar[i % D], bytes * B);
        for (int b = 0; b < B; ++b) {
            fvt_bulk_load(s + (size_t)b * n, src + (size_t)(t0 + i) * n, bytes, &bar[i % D]);
        }
    };
    if (tid == 0) {
        for (int d = 0; d < D; ++d) fvt_bar_init(&bar[d], 1);
        for (int i = 0; i < min(D - 1, steps); ++i) issue(i);
    }
    __syncthreads();
    for (int i = 0; i < steps; ++i) {
        const float* s = buf + (size_t)(i % D) * stage;
        if (tid == 0 && i + D - 1 < steps) {
            // the stage of step i - 1: its threads are done with it (the
            // barrier below), and its bulk store must have read it
            fvt_bulk_wait_read();
            fvt_fence_proxy_async();
            issue(i + D - 1);
        }
        if (!__syncthreads_and(fvt_bar_wait(&bar[i % D], (i / D) & 1))) {
            if (tid == 0) {
                atomicOr(err, ERR_TIMEOUT);
                fvt_bulk_wait_all();
            }
            return;
        }
        bool same = true;
        for (int b = 1; b < B; ++b) {
            for (int j = tid; j < n; j += THREADS) {
                same &= __float_as_uint(s[(size_t)b * n + j]) == __float_as_uint(s[j]);
            }
        }
        if (!__syncthreads_and(same)) {
            if (tid == 0) {
                atomicOr(err, ERR_MISMATCH);
                fvt_bulk_wait_all();
            }
            return;
        }
        if (tid == 0) {
            fvt_fence_proxy_async();
            fvt_bulk_store(dst + (size_t)(t0 + i) * n, s, bytes);
            fvt_bulk_commit();
        }
    }
    if (tid == 0) fvt_bulk_wait_all();  // the stores are done before the CTA's memory goes
}

// p4: W <= blockDim.x per-thread results a step, double-buffered
constexpr int P4_MAXW = 32;

__global__ void p4_kernel(int* __restrict__ out, int Tm, int W, int* __restrict__ err) {
    __shared__ int s_v[2][P4_MAXW];
    __shared__ uint64_t bar;
    const int tid = threadIdx.x;
    if (tid == 0) fvt_bar_init(&bar, blockDim.x);  // every thread arrives once a step
    __syncthreads();
    for (int t = 0; t < Tm; ++t) {
        if (tid < W) s_v[t & 1][tid] = t;  // this thread's result
        fvt_bar_arrive(&bar);                   // release: the store is published
        if (!fvt_bar_wait(&bar, t & 1)) {       // acquire: every thread's store
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
// both 16-byte aligned; plan: the CF_COUNT ints of copy_plan (G CTAs, D
// stages of B * n * 4 bytes of shared memory); err one int32, ORed with
// ERR_TIMEOUT / ERR_MISMATCH.  One launch of G blocks.  Returns the launch
// error.
extern "C" int fvt_probe_copy_rows(const float* src, float* dst, const int* plan, int Tm, int n,
                                   int B, int* err, void* stream, long long* launches) {
    const int G = plan[CF_CTAS], D = plan[CF_STAGES];
    if (G < 1 || G > Tm || D < 1 || D > STAGES_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = (size_t)D * B * n * 4;
    const cudaError_t e = cudaFuncSetAttribute(copy_ring_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    copy_ring_kernel<<<G, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(src, dst, Tm, n, B,
                                                                               G, D, err);
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
