// Top-B beam scan for Hopper (sm_90a): the N-lane beam recursion
//
//     full[i] = max_b (vals[b] + logA[states[b], i]) + emit_t[i]
//     slot[i] = lowest b attaining that max (0 when every candidate is -inf)
//     beam'   = the top B of full by (value descending, index ascending)
//     hist[t, n, b] = beam'[b],  slots[t, n, b] = slot[beam'[b]]
//
// Replaces flash_viterbi_tpu/ops/pallas/beam.py: beam_scan and
// beam_scan_planes (_call's pallas_call at :205, _beam_scan_kernel), with
// the FLASH-BS anchor planes folded in: after each step plane p takes
// planes[p][slot] where prop[t, p] is set (propagate) and the previous
// beam's states[slot] where not (record).  A lane whose valid[t, n] is
// false keeps its beam and planes and writes hist = states, slots = iota.
//
// What bounds it: a chain of T' dependent top-B selections.  Its bytes are
// the distinct logA rows the beams touch plus the emissions, a few MB at the
// headline shape (0.017 ms at the memory rate), so a step's latency is the
// limit: one round trip to L2 for the B rows the new beam names, the fold,
// and the select's hand-overs.
//
// Design: a thread-block cluster of C CTAs per lane (C <= 16, launched with
// cudaLaunchKernelEx; ops/cuda/beam.py:beam_plan chooses C and the
// placement).  CTA r owns the contiguous columns [lo_r, hi_r), lo_r =
// (r * ceil(Kp/4) / C) * 4, so column order is CTA order, then local order.
//   fold    The moment a beam is known, warp 0 issues bulk copies of the B
//           rows' slices of the CTA's columns into a ring of G groups of RG
//           rows in shared memory, one mbarrier a group; the fold consumes
//           each group as it lands (slots b = 0..B-1 in order, strict '>')
//           and refills a freed group when the ring is shorter than the
//           beam.  Wider slices than a thread's JMAX columns go in chunks.
//           The emission of the next step is loaded into registers while
//           the current step selects.
//   select  A cluster-wide radix select on 32-bit keys orderable(v + 0.0f)
//           (the index is not in the key), 8 bits a pass: each CTA counts
//           its keys' digits in a shared histogram, one cluster barrier,
//           then every CTA sums the C histograms through distributed shared
//           memory and finds the bin of the B-th largest key.  A pass whose
//           bin is taken whole ends the select early.  Keys above that
//           bin's prefix are taken; of the keys equal to it the lowest
//           indices are, counted over CTAs in rank order (the histograms
//           give each CTA the counts of the lower ranks) and then over
//           threads in column order: jax.lax.top_k's tie rule.
//   beam    Each winner's position among the B is its rank in (CTA, column)
//           order, so no atomics: it writes (key, index, slot) to that
//           position in every CTA of the cluster, and after one cluster
//           barrier each CTA ranks the B records by (key descending, index
//           ascending) for its own copy of the new beam.  The leader (rank
//           0) writes hist and slots and folds the P planes.
// So a step costs the row round trip, up to four pass barriers and one
// barrier for the beam, against the old kernel's one SM a lane and a
// bitonic sort of every column with a block barrier a pass.
//
// A CTA keeps its keys, slots and its copy of the beam in shared memory
// when they fit beside one ring group; otherwise (very wide slices, or B in
// the thousands) in a region of a global scratch, one per (lane, CTA), the
// same code through generic pointers.  The valid branch is the same for
// every CTA of a lane, so each reaches every cluster barrier.
//
// Numerics: fp32 adds and compares only, in the plain version's order
// (candidate = vals[b] + row, strict '>' over b, emission after the max,
// + 0.0f so that -0.0 ranks equal to +0.0), so hist, slots and planes are
// bit-identical to it.  Inputs hold no NaN (beam.py:261-264).

#include "beam_cluster.cuh"

namespace {

// the production instantiation: rows through the ring, the fold, the radix select
const auto beam_kernel = beam_cluster_kernel<true, true, SEL_RADIX>;

cudaError_t configure(const Plan& pl) {
    cudaError_t e = cudaFuncSetAttribute(beam_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                pl.smem);
}

}  // namespace

// Clusters of the plan's size and shared memory the card can keep resident
// at once (0: none, so a launch would fail); a negative value is a CUDA error.
extern "C" int fvt_beam_scan_clusters(const int* plan) {
    const Plan pl = to_plan(plan);
    cudaError_t e = configure(pl);
    if (e != cudaSuccess) return -static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.C);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, beam_kernel, &cfg);
    if (e != cudaSuccess) return -static_cast<int>(e);
    return clusters;
}

// The whole beam scan, one launch of N clusters.  Layouts: logA (K, lda)
// rows (lda a multiple of 4, 16-byte aligned), emits (Tm, N, K), vals0 and
// states0 (N, B), valid (Tm, N) bool or null, prop (Tm, P) bool or null
// (P = 0), hist and slots (Tm, N, B) int32, planes (N, P, B) int32.
// scratch: null when the plan keeps the state in shared memory, else N * C
// regions of state_words int32.  err: one int32, ORed with 1 when a ring
// wait timed out.  plan: F_COUNT ints (BeamPlan.c_args).  1 <= B <= K,
// Tm >= 1.  Returns the first CUDA error.
extern "C" int fvt_beam_scan(const float* logA, const float* emits, const float* vals0,
                             const int* states0, const unsigned char* valid,
                             const unsigned char* prop, int* hist, int* slots, int* planes,
                             int* scratch, int* err, const int* plan, int Tm, int N, int K,
                             int B, int P, void* stream, long long* launches) {
    const Plan pl = to_plan(plan);
    if (pl.C > CLUSTER_MAX || pl.rg > RG_MAX || pl.g > GROUPS_MAX || pl.cw > THREADS * JMAX ||
        pl.lda % 4 || pl.cw % 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e = configure(pl);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N * pl.C);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, beam_kernel, logA, emits, vals0, states0, valid, prop,
                           hist, slots, planes, scratch, err, pl, Tm, N, K, B, P);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
