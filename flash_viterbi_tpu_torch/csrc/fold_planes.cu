// Fold a chunk of pointer rows into index planes, for Hopper (sm_90a):
//
//     for t in 0 .. c-1, for every plane p:
//         row = rows[t, R == 1 ? 0 : p]
//         plane[p][k] = prop[t, p] ? plane[p][row[k]] : row[k]
//
// Replaces the lax.scan folds of flash_viterbi_tpu/algorithms/flash.py: the
// anchor planes of phase1_anchors_chunked (:185-190, one pointer row shared
// by every plane, R = 1) and the t2 planes of _lean_round_pallas (:396-401,
// a row a plane, R = P).  They are XLA programs, not Pallas kernels; in
// PyTorch each step of such a fold is a gather and a select, two launches
// or more a row, which the host issues more slowly than the scan fills a
// step.  This kernel folds a whole chunk in one launch.
//
// What bounds it: latency.  Row t + 1 reads the plane row t wrote, so the
// rows of one chain are serial; a row gathers K entries against a barrier.
// The rows themselves (4 K bytes each) do not depend on the plane.
//
// Design: a thread-block cluster of G CTAs a plane (G <= 16, launched with
// cudaLaunchKernelEx; ops/cuda/fold.py:fold_plan chooses G, each CTA's
// contiguous range of rows and where the maps live).  The fold is a chain
// of index maps, so it can be regrouped: a step either propagates, V <-
// V[row] (a pointer outside [0, K), or a -1 read through it, gives -1), or
// records, V <- row (a reset).
//   phase A  CTA g folds its rows into a map (V_g, reset_g), the loop
//            started from the identity; its rows arrive through a ring of
//            bulk copies in shared memory (csrc/async_copy.cuh), each row
//            issued as soon as its slot is free, so no row load sits
//            between two barriers.  The waits are bounded and set the
//            error word.
//   phase B  After one cluster barrier the G maps are joined pairwise
//            through distributed shared memory in ceil(log2 G) rounds,
//            (A then B) = B if B.reset else (A.V[B.V], A.reset), a cluster
//            barrier each; CTA 0 ends with the plane's map, and every CTA
//            applies a slice of it, out[k] = reset ? V[k] : plane_in[V[k]]
//            (-1 stays -1), then a last cluster barrier keeps CTA 0's shared
//            memory alive while the others read it.
// So a chain is ceil(c / G) + ceil(log2 G) dependent passes, against the
// old design's c (one block a plane, a row loaded after each barrier).
//
// The two maps of a CTA live in shared memory where they fit beside the
// kernel's static shared memory (ops/cuda/fold.py: FOLD_SMEM), else in a
// global scratch of one region a (plane, CTA), read across CTAs through L2
// (__ldcg) after the cluster barrier.  The ring takes the shared memory
// left; without one (K not a multiple of 4, or no room) rows are read from
// global memory where they are used.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;     // ops/cuda/fold.py: THREADS
constexpr int CLUSTER_MAX = 16;  // ops/cuda/fold.py: CLUSTER_MAX
constexpr int RING_MAX = 8;      // ops/cuda/fold.py: RING_MAX
constexpr int ILP = 8;           // entries a thread has in flight in a pass

// the plan's int array (ops/cuda/fold.py: FoldPlan.c_args): G, ring,
// maps_smem, smem, then the G + 1 row edges
enum PlanField { F_G, F_RING, F_MAPS_SMEM, F_SMEM, F_EDGES };

struct Plan {
    int G;          // CTAs a plane (the cluster)
    int ring;       // pointer rows the ring holds (0: rows read from global memory)
    int maps_smem;  // 1: the maps in shared memory; 0: in the global scratch
    int smem;       // dynamic shared memory bytes
    int edges[CLUSTER_MAX + 1];  // CTA g folds rows [edges[g], edges[g + 1])
};

Plan to_plan(const int* f) {
    Plan pl{f[F_G], f[F_RING], f[F_MAPS_SMEM], f[F_SMEM], {}};
    for (int g = 0; g <= pl.G && g <= CLUSTER_MAX; ++g) pl.edges[g] = f[F_EDGES + g];
    return pl;
}

// a word of another CTA's map: through DSMEM, or from the scratch via L2
template <bool SMEM_MAPS>
__device__ __forceinline__ int load_map(const int* p) {
    if constexpr (SMEM_MAPS) {
        return *p;
    } else {
        return __ldcg(p);
    }
}

// One pass over entries [lo, hi): out[k] = map(in(k)), ILP loads of a
// thread issued before any of their uses (a pass is bound by the latency
// of its dependent shared-memory loads, not by their number)
template <typename In, typename Map, typename Out>
__device__ __forceinline__ void pass(int lo, int hi, In in, Map map, Out out) {
    for (int k0 = lo + static_cast<int>(threadIdx.x); k0 < hi; k0 += ILP * THREADS) {
        int v[ILP];
#pragma unroll
        for (int j = 0; j < ILP; ++j) v[j] = k0 + j * THREADS < hi ? in(k0 + j * THREADS) : 0;
#pragma unroll
        for (int j = 0; j < ILP; ++j) v[j] = map(v[j]);
#pragma unroll
        for (int j = 0; j < ILP; ++j) {
            if (k0 + j * THREADS < hi) out(k0 + j * THREADS, v[j]);
        }
    }
}

template <bool SMEM_MAPS>
__global__ void __launch_bounds__(THREADS, 1)
fold_cluster_kernel(const int* __restrict__ planes, const int* __restrict__ rows,
                    const unsigned char* __restrict__ prop, int* __restrict__ out,
                    int* scratch, int* __restrict__ err, Plan pl, int R, int P, int K) {
    extern __shared__ __align__(128) int sm[];
    __shared__ __align__(8) uint64_t s_bar[RING_MAX];
    __shared__ int s_map[2];  // the buffer that holds this CTA's map, and its reset flag

    cg::cluster_group cluster = cg::this_cluster();
    const int G = pl.G;
    const int g = static_cast<int>(cluster.block_rank());
    const int p = blockIdx.x / G;
    const int tid = threadIdx.x;
    const int t0 = pl.edges[g], n = pl.edges[g + 1] - t0;
    const int D = pl.ring;
    const uint32_t row_bytes = static_cast<uint32_t>(K) * 4u;
    int* maps = SMEM_MAPS ? sm : scratch + ((size_t)p * G + g) * 2 * K;
    int* ring = SMEM_MAPS ? sm + 2 * K : sm;
    // buffer b of CTA r's maps
    auto map_of = [&](int r, int b) -> int* {
        if constexpr (SMEM_MAPS) {
            return cluster.map_shared_rank(sm + (size_t)b * K, r);
        } else {
            return scratch + (((size_t)p * G + r) * 2 + b) * K;
        }
    };
    auto row_of = [&](int t) { return rows + ((size_t)t * R + (R == 1 ? 0 : p)) * K; };
    auto issue = [&](int i) {  // row i of this CTA into ring slot i % D
        uint64_t* bar = &s_bar[i % D];
        fvt_bar_arrive_expect(bar, row_bytes);
        fvt_bulk_load(ring + (size_t)(i % D) * K, row_of(t0 + i), row_bytes, bar);
    };

    if (tid == 0) {
        for (int s = 0; s < D; ++s) fvt_bar_init(&s_bar[s], 1);
        for (int i = 0; i < min(D, n); ++i) issue(i);
    }
    __syncthreads();

    // ---- phase A: this CTA's rows into (V, reset), V in maps[cur]
    int cur = 0, reset = 0;
    bool broken = false;  // a ring wait timed out: stop waiting, report it
    int pf = prop[(size_t)t0 * P + p];
    for (int i = 0; i < n; ++i) {
        const int pn = i + 1 < n ? prop[(size_t)(t0 + i + 1) * P + p] : 0;  // in flight
        const int* src = maps + (size_t)cur * K;
        int* dst = maps + (size_t)(cur ^ 1) * K;
        auto step = [&](const int* row) {
            auto in = [&](int k) { return row[k]; };
            auto put = [&](int k, int v) { dst[k] = v; };
            if (!pf) {  // record
                pass(0, K, in, [](int r) { return r; }, put);
            } else if (i == 0) {  // propagate from the identity
                pass(0, K, in, [&](int r) { return (unsigned)r < (unsigned)K ? r : -1; }, put);
            } else {
                pass(0, K, in, [&](int r) { return (unsigned)r < (unsigned)K ? src[r] : -1; },
                     put);
            }
        };
        if (D) {
            const int s = i % D;
            if (!broken && !fvt_bar_wait(&s_bar[s], static_cast<uint32_t>((i / D) & 1))) {
                broken = true;
                atomicOr(err, 1);
            }
            step(ring + (size_t)s * K);
        } else {
            step(row_of(t0 + i));
        }
        reset |= !pf;
        __syncthreads();  // dst complete, ring slot i % D read by every thread
        if (D && tid == 0 && i + D < n) {
            fvt_fence_proxy_async();
            issue(i + D);
        }
        cur ^= 1;
        pf = pn;
    }

    // ---- phase B: pairwise joins, CTA g taking in CTA g + s
    if (G > 1) {
        if (tid == 0) {
            s_map[0] = cur;
            s_map[1] = reset;
        }
        for (int s = 1; s < G; s <<= 1) {
            cluster.sync();  // every map of the round is complete and visible
            if (g % (2 * s) == 0 && g + s < G) {
                const int* st = cluster.map_shared_rank(s_map, g + s);
                const int bcur = st[0], breset = st[1];
                const int* B = map_of(g + s, bcur);
                const int* A = maps + (size_t)cur * K;
                int* dst = maps + (size_t)(cur ^ 1) * K;
                auto in = [&](int k) { return load_map<SMEM_MAPS>(B + k); };
                auto put = [&](int k, int v) { dst[k] = v; };
                if (breset) {
                    pass(0, K, in, [](int b) { return b; }, put);
                } else {
                    pass(0, K, in, [&](int b) { return (unsigned)b < (unsigned)K ? A[b] : -1; },
                         put);
                }
                cur ^= 1;
                reset |= breset;
                if (tid == 0) {  // read by others only after the next cluster barrier
                    s_map[0] = cur;
                    s_map[1] = reset;
                }
            }
        }
        cluster.sync();
    }

    // ---- apply: CTA 0 holds the plane's map; CTA g writes its slice of it
    const int* V;
    int fin_reset;
    if (G > 1) {
        const int* st = cluster.map_shared_rank(s_map, 0);
        V = map_of(0, st[0]);
        fin_reset = st[1];
    } else {
        V = maps + (size_t)cur * K;
        fin_reset = reset;
    }
    const int* plane = planes + (size_t)p * K;
    int* dst = out + (size_t)p * K;
    pass(static_cast<int>((long long)g * K / G), static_cast<int>((long long)(g + 1) * K / G),
         [&](int k) { return G > 1 ? load_map<SMEM_MAPS>(V + k) : V[k]; },
         [&](int v) { return fin_reset ? v : ((unsigned)v < (unsigned)K ? plane[v] : -1); },
         [&](int k, int v) { dst[k] = v; });
    if (G > 1) cluster.sync();  // CTA 0's shared memory outlives every read of it
}

template <bool SMEM_MAPS>
cudaError_t configure(const Plan& pl) {
    cudaError_t e = cudaFuncSetAttribute(fold_cluster_kernel<SMEM_MAPS>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fold_cluster_kernel<SMEM_MAPS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
}

cudaLaunchConfig_t config(const Plan& pl, int P, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P * pl.G);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <bool SMEM_MAPS>
int clusters(const Plan& pl) {
    cudaError_t e = configure<SMEM_MAPS>(pl);
    if (e != cudaSuccess) return -static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(pl, 1, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, fold_cluster_kernel<SMEM_MAPS>, &cfg);
    return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <bool SMEM_MAPS>
cudaError_t launch(const Plan& pl, const int* planes, const int* rows, const unsigned char* prop,
                   int* out, int* scratch, int* err, int R, int P, int K, cudaStream_t stream) {
    cudaError_t e = configure<SMEM_MAPS>(pl);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(pl, P, stream, attr);
    e = cudaLaunchKernelEx(&cfg, fold_cluster_kernel<SMEM_MAPS>, planes, rows, prop, out, scratch,
                           err, pl, R, P, K);
    return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace

// Clusters of the plan's size and shared memory the card can keep resident
// at once (0: none, so a launch would fail); a negative value is a CUDA error.
extern "C" int fvt_fold_planes_clusters(const int* plan) {
    const Plan pl = to_plan(plan);
    return pl.maps_smem ? clusters<true>(pl) : clusters<false>(pl);
}

// planes (P, K) int32, rows (c, R, K) int32 with R 1 or P (16-byte aligned
// where the plan has a ring), prop (c, P) bytes, out (P, K) int32; scratch
// P x G x 2 x K int32 where the plan keeps the maps in global memory, else
// unused (may be null); err one int32, ORed with 1 when a ring wait timed
// out.  plan: F_EDGES + G + 1 ints (FoldPlan.c_args), its edges rising
// from 0 to c.  One launch of P clusters of G CTAs.  Returns the first CUDA
// error, or cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int fvt_fold_planes(const int* planes, const int* rows, const unsigned char* prop,
                               int* out, int* scratch, int* err, const int* plan, int c, int R,
                               int P, int K, void* stream, long long* launches) {
    const Plan pl = to_plan(plan);
    bool ok = pl.G >= 1 && pl.G <= CLUSTER_MAX && pl.ring >= 0 && pl.ring <= RING_MAX &&
              (pl.ring == 0 || (K % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0)) &&
              pl.edges[0] == 0 && pl.edges[pl.G] == c && (pl.maps_smem || scratch != nullptr);
    for (int g = 0; ok && g < pl.G; ++g) ok = pl.edges[g] < pl.edges[g + 1];
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        pl.maps_smem ? launch<true>(pl, planes, rows, prop, out, scratch, err, R, P, K, s)
                     : launch<false>(pl, planes, rows, prop, out, scratch, err, R, P, K, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
