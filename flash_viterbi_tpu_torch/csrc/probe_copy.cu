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
// p4 and p5 again as cluster kernels, at the sizes the beam scan's cluster
// (beam_cluster.cuh) meets them every step: C CTAs of one thread-block
// cluster (C <= 16; 16 is a non-portable size) publish results so that
// every CTA reads all of them, and meet in a
// lexicographic winner across CTAs.
//   p4_cluster_kernel<PUB>  each of W results a step is owned by one
//       thread (W / C a CTA).  PUB_MBAR: the owner stores it into every
//       CTA's receive buffer with st.async, which completes its bytes on
//       that CTA's mbarrier (expecting W * 4 bytes a phase); each CTA waits
//       on its own barrier (acquire at cluster scope) and reads the W
//       values from its own shared memory.  Two buffers and two barriers,
//       by step parity: a CTA cannot run two steps ahead of any other, so
//       no phase mixes two steps' bytes.  PUB_SYNC, the beam scan's
//       pattern: the owner writes its own CTA's buffer, one cluster.sync()
//       a step, and every CTA reads the W values from the C CTAs' shared
//       memory.  Either way each CTA reads all W values, thread i result i
//       of every CTA (as the radix select reads its bins, C loads issued
//       before any store).  Result j of step t is t * W + j, and
//       out[t, r, j] = t * W + j + 1 as CTA r read it.
//   p5_cluster_kernel  CTA r reduces a contiguous shard of the n
//       pairs (float4 / int4 loads from the first 16-byte boundary, scalars
//       before it and after the last), the warp-shuffle and block
//       tournament of p5, then the C CTA winners meet as p4's W = C
//       results by the remote-mbarrier publish, and every CTA writes its slice of the width entries.
// What bounds them is no byte count but a chain of dependent steps: Tm
// publish round trips for p4 (through a shared-memory load at C = 1, a
// peer CTA's at C > 1); for p5 a thread's ceil(n / (C * 256)) dependent
// compares, 10 shuffle rounds and (C > 1) one round trip through a peer
// (bench/bounds.py).  chase_kernel<MODE> measures those latencies: a chain
// of dependent shared-memory loads, loads from a peer CTA's shared memory,
// shuffles, or fvt_better compares.  CTA 0 of each kernel records
// clock64() around its chain (cycles a step or a call).  chase_rows_kernel
// chases global memory: backtrack.cu's serial walk (pointer_walk.cuh), one
// thread a lane, each load's address from the last, so over a table larger
// than L2 it times a dependent load through device memory
// (chip_smoke.py:chase_latency_us).  empty_kernel is the
// launch floor that every one-launch probe pays.
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

#include <cooperative_groups.h>

#include "argmax.cuh"
#include "async_copy.cuh"
#include "pointer_walk.cuh"

namespace cg = cooperative_groups;

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

// ---- p4 and p5 as cluster kernels, the latency chases, the empty kernel ----

constexpr int CLUSTER_MAX = 16;  // CTAs of a cluster (probes/copy.py: CLUSTER_MAX)
constexpr int P4C_MAXW = 1024;   // results a step (probes/copy.py: P4C_MAXW)
constexpr int P4C_MAX_OWN = 256; // results a CTA, one a thread (probes/copy.py: P4C_MAX_OWN)
enum Pub { PUB_MBAR = 0, PUB_SYNC = 1 };  // probes/copy.py: PUBS
enum Chase { CH_SMEM = 0, CH_DSMEM = 1, CH_SHFL = 2, CH_BETTER = 3 };  // probes/copy.py: CHASES

// the shared::cluster address of shared address a's counterpart in CTA rank
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
    return out;
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
    return mapa(fvt_smem_addr(p), rank);
}

// store one word into a CTA's shared memory (a shared::cluster address);
// its 4 bytes complete on that CTA's mbarrier bar
__device__ __forceinline__ void st_async_b32(uint32_t addr, int v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                 ::"r"(addr), "r"(v), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void st_async_v2(uint32_t addr, int a, int b, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
        ::"r"(addr), "r"(a), "r"(b), "r"(bar)
        : "memory");
}

__device__ __forceinline__ int ld_cta(uint32_t addr) {
    int v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
    int v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

// as fvt_bar_wait, acquiring at cluster scope what other CTAs stored
// (st.async) before their bytes completed on the barrier
__device__ __forceinline__ bool bar_wait_cluster(uint64_t* bar, uint32_t parity) {
    auto test = [&]() {
        uint32_t done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(fvt_smem_addr(bar)), "r"(parity)
            : "memory");
        return done != 0;
    };
    if (test()) return true;
    const long long t0 = clock64();
    while (!test()) {
        if (clock64() - t0 > FVT_WAIT_CYCLES) return false;
    }
    return true;
}

// p4 as a cluster: W = C * blockDim.x results a step, thread i of CTA r
// owning result j = r * blockDim.x + i, whose value at step t is t * W + j
// (one value per step and slot, so a read of a wrong rank, column or
// parity shows); out (Tm, C, W) int32, out[t, r, j] = t * W + j + 1;
// clocks: CTA 0's clock64() before and after the steps, or null.
template <int PUB>
__global__ void p4_cluster_kernel(int* __restrict__ out, int Tm, long long* __restrict__ clocks,
                                  int* __restrict__ err) {
    __shared__ __align__(16) int s_v[2][P4C_MAXW];
    __shared__ uint64_t s_bar[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int own = blockDim.x;
    const int W = C * own;
    const int tid = threadIdx.x;
    const int j = rank * own + tid;
    if (PUB == PUB_MBAR && tid == 0) {
        fvt_bar_init(&s_bar[0], 1);
        fvt_bar_init(&s_bar[1], 1);
    }
    cluster.sync();  // every CTA's barriers are set before any st.async reaches them
    long long t0 = 0;
    if (rank == 0 && tid == 0) t0 = clock64();
    for (int t = 0; t < Tm; ++t) {
        const int b = t & 1;
        const int v = t * W + j;  // this thread's result
        // thread i reads result i of every CTA (column i), as the radix
        // select reads its bins: all C loads before any store
        int x[CLUSTER_MAX];
        if constexpr (PUB == PUB_MBAR) {
            if (tid == 0) fvt_bar_arrive_expect(&s_bar[b], (uint32_t)W * 4u);
            const uint32_t dst = fvt_smem_addr(&s_v[b][j]);
            const uint32_t bar = fvt_smem_addr(&s_bar[b]);
#pragma unroll
            for (int r = 0; r < CLUSTER_MAX; ++r) {
                if (r < C) st_async_b32(mapa(dst, r), v, mapa(bar, r));
            }
            if (!bar_wait_cluster(&s_bar[b], (t >> 1) & 1)) {
                atomicOr(err, ERR_TIMEOUT);
                break;
            }
#pragma unroll
            for (int r = 0; r < CLUSTER_MAX; ++r) {
                if (r < C) x[r] = s_v[b][r * own + tid];
            }
        } else {
            s_v[b][tid] = v;
            cluster.sync();
#pragma unroll
            for (int r = 0; r < CLUSTER_MAX; ++r) {
                if (r < C) x[r] = *cluster.map_shared_rank(&s_v[b][tid], r);
            }
        }
        int* row = out + ((size_t)t * C + rank) * W + tid;
#pragma unroll
        for (int r = 0; r < CLUSTER_MAX; ++r) {
            if (r < C) row[r * own] = x[r] + 1;
        }
    }
    if (clocks != nullptr && rank == 0 && tid == 0) {
        clocks[0] = t0;
        clocks[1] = clock64();
    }
    cluster.sync();  // no CTA leaves while a peer may still reach its shared memory
}

// one thread's running winner takes (v, k) when fvt_better
__device__ __forceinline__ void consider(float v, int k, float& bv, int& bc) {
    if (fvt_better(v, k, bv, bc)) {
        bv = v;
        bc = k;
    }
}

// the fvt_better winner of a warp's 32 pairs, in every lane
__device__ __forceinline__ void warp_winner(float& bv, int& bc) {
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        consider(ov, oc, bv, bc);
    }
}

// p5 as a cluster of C CTAs: v, c (n,) 16-byte aligned; outv, outc (width,).
// The CTAs' winners meet by the remote-mbarrier publish, the cheaper of p4's
// two at C = 16 on the card.
__global__ void __launch_bounds__(THREADS)
p5_cluster_kernel(const float* __restrict__ v, const int* __restrict__ c, int n,
                  float* __restrict__ outv, int* __restrict__ outc, int width,
                  long long* __restrict__ clocks, int* __restrict__ err) {
    __shared__ float s_v[THREADS / 32];
    __shared__ int s_c[THREADS / 32];
    __shared__ __align__(16) int s_win[CLUSTER_MAX][2];  // the CTAs' winners: value bits, code
    __shared__ uint64_t s_bar;
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) fvt_bar_init(&s_bar, 1);
    if (C > 1) cluster.sync();
    long long t0 = 0;
    if (rank == 0 && tid == 0) t0 = clock64();

    const int lo = (int)((long long)rank * n / C);
    const int hi = (int)((long long)(rank + 1) * n / C);
    const int body = min(hi, (lo + 3) & ~3);  // the first 4-aligned index of the shard
    const int tail = max(body, hi & ~3);      // the first index past the last whole four
    float bv = -INFINITY;
    int bc = INT_MAX;
    for (int i = lo + tid; i < body; i += THREADS) consider(v[i], c[i], bv, bc);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const int4* c4 = reinterpret_cast<const int4*>(c);
    for (int q = body / 4 + tid; q < tail / 4; q += THREADS) {
        const float4 a = v4[q];
        const int4 k = c4[q];
        consider(a.x, k.x, bv, bc);
        consider(a.y, k.y, bv, bc);
        consider(a.z, k.z, bv, bc);
        consider(a.w, k.w, bv, bc);
    }
    for (int i = tail + tid; i < hi; i += THREADS) consider(v[i], c[i], bv, bc);
    warp_winner(bv, bc);
    if (lane == 0) {
        s_v[warp] = bv;
        s_c[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
        bv = lane < THREADS / 32 ? s_v[lane] : -INFINITY;
        bc = lane < THREADS / 32 ? s_c[lane] : INT_MAX;
        warp_winner(bv, bc);
    }
    // every thread takes the CTA's winner from warp 0 ...
    if (tid == 0) {
        s_win[rank][0] = __float_as_int(bv);
        s_win[rank][1] = bc;
    }
    if (C > 1) {
        // ... and the C CTAs' winners meet
        if (tid == 0) fvt_bar_arrive_expect(&s_bar, (uint32_t)C * 8u);
        __syncthreads();  // s_win[rank] is written
        if (tid < C) {
            st_async_v2(cluster_addr(s_win[rank], tid), s_win[rank][0], s_win[rank][1],
                        cluster_addr(&s_bar, tid));
        }
        if (!bar_wait_cluster(&s_bar, 0)) atomicOr(err, ERR_TIMEOUT);
    }
    __syncthreads();
    bv = -INFINITY;
    bc = INT_MAX;
    for (int r = 0; r < C; ++r) consider(__int_as_float(s_win[r][0]), s_win[r][1], bv, bc);
    const int w0 = (int)((long long)rank * width / C);
    const int w1 = (int)((long long)(rank + 1) * width / C);
    for (int k = w0 + tid; k < w1; k += THREADS) {
        outv[k] = bv;
        outc[k] = bc;
    }
    if (clocks != nullptr && rank == 0 && tid == 0) {
        clocks[0] = t0;
        clocks[1] = clock64();
    }
    if (C > 1) cluster.sync();  // no CTA leaves while a peer may still reach its shared memory
}

// hops dependent steps of MODE by thread 0 of CTA 0 (CH_SMEM, CH_DSMEM:
// idx = table[idx] from 0, through CTA 0's or CTA 1's shared copy of the
// n-entry table; CH_SHFL: lane l's x = l, then x = the x of lane (x + 1)
// & 31, lane 0's; CH_BETTER: the fvt_better winner of hops pairs (value
// table[h % n] as float bits, code h; n a power of two), its code); out[0]
// the result,
// clocks[0..1] clock64() around the chain.
template <int MODE>
__global__ void chase_kernel(const int* __restrict__ table, int n, int hops, int* __restrict__ out,
                             long long* __restrict__ clocks) {
    extern __shared__ __align__(16) int s_tab[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_tab[i] = table[i];
    cluster.sync();
    if (rank == 0 && threadIdx.x < 32) {
        long long t0 = 0, t1 = 0;
        int x = 0;
        if constexpr (MODE == CH_SHFL) {
            x = threadIdx.x;
            t0 = clock64();
            for (int h = 0; h < hops; ++h) x = __shfl_sync(0xffffffffu, x, (x + 1) & 31);
            t1 = clock64();
        } else if (threadIdx.x == 0) {
            if constexpr (MODE == CH_SMEM) {
                const uint32_t base = fvt_smem_addr(s_tab);
                t0 = clock64();
                for (int h = 0; h < hops; ++h) x = ld_cta(base + 4u * (uint32_t)x);
                t1 = clock64();
            } else if constexpr (MODE == CH_DSMEM) {
                const uint32_t base = cluster_addr(s_tab, 1);
                t0 = clock64();
                for (int h = 0; h < hops; ++h) x = ld_cluster(base + 4u * (uint32_t)x);
                t1 = clock64();
            } else {
                float bv = -INFINITY;
                int bc = INT_MAX;
                t0 = clock64();
                for (int h = 0; h < hops; ++h) {
                    consider(__int_as_float(s_tab[h & (n - 1)]), h, bv, bc);
                }
                t1 = clock64();
                x = bc;
            }
        }
        if (threadIdx.x == 0) {
            out[0] = x;
            clocks[0] = t0;
            clocks[1] = t1;
        }
    }
    cluster.sync();  // CTA 1 stays until CTA 0's chase through it is done
}

// One thread a lane walks ptrs (Tm, N, K) back from last[n] by the walk's
// own step (pointer_walk.cuh): out[n, Tm] = last[n], then out[n, t] for t
// = Tm-1 down to 0.
__global__ void chase_rows_kernel(const int* __restrict__ ptrs, const int* __restrict__ last,
                                  int* __restrict__ out, int Tm, int N, int K) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    int* path = out + (size_t)n * (Tm + 1);
    path[Tm] = last[n];
    fvt_walk_rows(ptrs, path, last[n], 0, Tm, n, N, K);
}

__global__ void empty_kernel() {}

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

namespace {

// one launch of kernel as clusters of C CTAs of `threads` threads
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int C, int blocks, int threads, size_t smem,
                    void* stream, long long* launches, Args... args) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && smem > 48 * 1024) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}

bool cluster_size_ok(int C) { return C >= 1 && C <= CLUSTER_MAX && (C & (C - 1)) == 0; }

}  // namespace

// p4 as a cluster: out (Tm, C, W) int32, C a power of two up to 16, W a
// multiple of C, W / C <= 256, W <= 1024; pub: PUB_MBAR or PUB_SYNC;
// clocks two int64 or null; err as above.  One launch of one cluster.
extern "C" int fvt_probe_copy_p4_cluster(int* out, int Tm, int W, int C, int pub,
                                         long long* clocks, int* err, void* stream,
                                         long long* launches) {
    if (Tm < 1 || !cluster_size_ok(C) || W < C || W % C || W / C > P4C_MAX_OWN ||
        W > P4C_MAXW || (pub != PUB_MBAR && pub != PUB_SYNC)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = pub == PUB_MBAR ? p4_cluster_kernel<PUB_MBAR> : p4_cluster_kernel<PUB_SYNC>;
    return launch_clusters(kernel, C, C, W / C, 0, stream, launches, out, Tm, clocks, err);
}

// p5 as a cluster: v (n,) float32 and c (n,) int32, both 16-byte aligned;
// outv (width,) float32 and outc (width,) int32; C, clocks and err as for
// p4.  One launch of one cluster of C blocks of 256.
extern "C" int fvt_probe_copy_p5_cluster(const float* v, const int* c, int n, float* outv,
                                         int* outc, int width, int C, long long* clocks,
                                         int* err, void* stream, long long* launches) {
    if (n < 1 || width < 1 || !cluster_size_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_clusters(p5_cluster_kernel, C, C, THREADS, 0, stream, launches, v, c, n, outv,
                           outc, width, clocks, err);
}

// A latency chase: mode CH_SMEM, CH_DSMEM, CH_SHFL or CH_BETTER; table (n,)
// int32, n a power of two (each entry in [0, n) for the loads); out one
// int32; clocks two
// int64.  One launch of one cluster of two CTAs of 32 threads, n * 4 bytes
// of shared memory each.
extern "C" int fvt_probe_chase(const int* table, int n, int hops, int mode, int* out,
                               long long* clocks, void* stream, long long* launches) {
    if (n < 1 || (n & (n - 1)) || (size_t)n * 4 > 232448 || hops < 0 || mode < CH_SMEM ||
        mode > CH_BETTER) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    void (*kernel)(const int*, int, int, int*, long long*) =
        mode == CH_SMEM    ? chase_kernel<CH_SMEM>
        : mode == CH_DSMEM ? chase_kernel<CH_DSMEM>
        : mode == CH_SHFL  ? chase_kernel<CH_SHFL>
                           : chase_kernel<CH_BETTER>;
    return launch_clusters(kernel, 2, 2, 32, (size_t)n * 4, stream, launches, table, n, hops,
                           out, clocks);
}

// The global-memory chase: ptrs (Tm, N, K) int32, last (N,) int32, out
// (N, Tm + 1) int32.  One launch of blocks of 32 threads, a thread a lane.
extern "C" int fvt_probe_chase_rows(const int* ptrs, const int* last, int* out, int Tm, int N,
                                    int K, void* stream, long long* launches) {
    if (Tm < 0 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
    chase_rows_kernel<<<(N + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(ptrs, last,
                                                                                 out, Tm, N, K);
    return finish(launches);
}

// An empty kernel, one block of 32: the launch floor.
extern "C" int fvt_probe_empty(void* stream, long long* launches) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return finish(launches);
}
