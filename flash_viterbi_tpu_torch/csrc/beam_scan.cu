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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;  // ops/cuda/beam.py: THREADS
constexpr int WARPS = THREADS / 32;
constexpr int JMAX = 4;  // columns a thread folds at once (ops/cuda/beam.py: JMAX)
constexpr int BINS = 256;
constexpr int GROUPS_MAX = 16;  // ring groups (ops/cuda/beam.py: GROUPS_MAX)
constexpr int CLUSTER_MAX = 16;  // CTAs of a cluster (ops/cuda/beam.py: CLUSTER_MAX)
constexpr int RG_MAX = 8;        // rows a ring group (ops/cuda/beam.py: ROWS_A_GROUP)
constexpr unsigned FULL = 0xffffffffu;

// the plan's int array (ops/cuda/beam.py: BeamPlan.c_args)
enum PlanField { F_C, F_WIDTH, F_CW, F_RG, F_G, F_STATE_SMEM, F_STATE_WORDS, F_SMEM, F_LDA,
                 F_COUNT };

struct Plan {
    int C;            // CTAs a lane (the cluster)
    int width;        // the widest CTA's columns, a multiple of 4
    int cw;           // columns a fold chunk, a multiple of 4, <= THREADS * JMAX
    int rg;           // rows a ring group
    int g;            // ring groups
    int state_smem;   // 1: keys, slots and beam in shared memory; 0: in the scratch
    int state_words;  // 4-byte words of that state a CTA
    int smem;         // dynamic shared memory bytes
    int lda;          // floats between logA rows, a multiple of 4
};

Plan to_plan(const int* f) {
    return Plan{f[F_C], f[F_WIDTH], f[F_CW], f[F_RG], f[F_G], f[F_STATE_SMEM],
                f[F_STATE_WORDS], f[F_SMEM], f[F_LDA]};
}

// monotone map of a float's bits to an unsigned integer, and back
__device__ __forceinline__ unsigned int orderable(float v) {
    const unsigned int u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned int o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Exclusive prefix sums of (a, b) over the block in thread order; the
// block's totals in (ta, tb).  Every thread calls it.
__device__ __forceinline__ void block_scan2(int& a, int& b, int& ta, int& tb, int* s_a,
                                            int* s_b) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int ia = a, ib = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int xa = __shfl_up_sync(FULL, ia, o), xb = __shfl_up_sync(FULL, ib, o);
        if (lane >= o) {
            ia += xa;
            ib += xb;
        }
    }
    if (lane == 31) {
        s_a[warp] = ia;
        s_b[warp] = ib;
    }
    __syncthreads();
    int pa = 0, pb = 0;
    ta = tb = 0;
    for (int w = 0; w < WARPS; ++w) {
        const int wa = s_a[w], wb = s_b[w];
        if (w < warp) {
            pa += wa;
            pb += wb;
        }
        ta += wa;
        tb += wb;
    }
    a = pa + ia - a;
    b = pb + ib - b;
    __syncthreads();  // s_a, s_b free for the next call
}

__global__ void __launch_bounds__(THREADS, 1)
beam_cluster_kernel(const float* __restrict__ logA, const float* __restrict__ emits,
                    const float* __restrict__ vals0, const int* __restrict__ states0,
                    const unsigned char* __restrict__ valid,
                    const unsigned char* __restrict__ prop, int* __restrict__ hist,
                    int* __restrict__ slots, int* __restrict__ planes_out, int* scratch,
                    int* __restrict__ err, Plan pl, int Tm, int N, int K, int B, int P) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int s_hist[2][BINS];
    __shared__ __align__(8) uint64_t s_bar[GROUPS_MAX];
    __shared__ int s_wa[WARPS], s_wb[WARPS];
    __shared__ int s_res[5];

    cg::cluster_group cluster = cg::this_cluster();
    const int C = pl.C;
    const int rank = static_cast<int>(cluster.block_rank());
    const int n = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int units = (K + 3) / 4;
    const int lo = min(K, (rank * units / C) * 4);
    const int hi = min(K, ((rank + 1) * units / C) * 4);
    const int W = hi - lo;
    const int PB = P * B;
    const int groups = (B + pl.rg - 1) / pl.rg;
    const int items = groups * ((W + pl.cw - 1) / pl.cw);  // ring items a fold

    // this CTA's state: keys and slots of its columns, its copy of the beam
    // (values; states and the leader's planes double-buffered), the sorted
    // slots and the winners the cluster writes in
    float* ring = reinterpret_cast<float*>(smem);
    int* st = pl.state_smem
                  ? reinterpret_cast<int*>(ring + (size_t)pl.g * pl.rg * pl.cw)
                  : scratch + ((size_t)n * C + rank) * pl.state_words;
    unsigned int* keys = reinterpret_cast<unsigned int*>(st);
    int* cslot = st + pl.width;
    float* vals = reinterpret_cast<float*>(cslot + pl.width);
    int* states = reinterpret_cast<int*>(vals + B);
    int* bslot = states + 2 * B;
    int* planes = bslot + B;
    unsigned int* wkey = reinterpret_cast<unsigned int*>(planes + 2 * PB);
    int* widx = reinterpret_cast<int*>(wkey + B);
    int* wslot = widx + B;
    // the same word of CTA r's state
    auto remote = [&](auto* p, int r) {
        return pl.state_smem ? cluster.map_shared_rank(p, r)
                             : p + (ptrdiff_t)(r - rank) * pl.state_words;
    };

    for (int b = tid; b < B; b += THREADS) {
        vals[b] = vals0[(size_t)n * B + b];
        states[b] = states0[(size_t)n * B + b];
    }
    for (int i = tid; i < PB; i += THREADS) planes[i] = -1;
    for (int i = tid; i < 2 * BINS; i += THREADS) s_hist[i / BINS][i % BINS] = 0;
    if (tid == 0) {
        for (int g = 0; g < pl.g; ++g) fvt_bar_init(&s_bar[g], 1);
    }
    cluster.sync();  // every CTA's shared memory is set before any remote access

    int cur = 0;          // the half of states that holds the beam
    int pc = 0;           // the half of planes that holds the planes
    int pass = 0;         // select passes so far: the histogram buffer
    long long item = 0;   // ring items consumed so far
    bool broken = false;  // a ring wait timed out: stop waiting, report it

    auto next_valid = [&](int t) {
        ++t;
        while (t < Tm && valid != nullptr && !valid[(size_t)t * N + n]) ++t;
        return t;
    };
    // the leader writes rows [t0, t1), where the lane keeps its beam
    auto keep_rows = [&](int t0, int t1) {
        if (rank != 0) return;
        for (int t = t0; t < t1; ++t) {
            const size_t out = ((size_t)t * N + n) * B;
            for (int b = tid; b < B; b += THREADS) {
                hist[out + b] = states[cur * B + b];
                slots[out + b] = b;
            }
        }
    };
    // warp 0: bulk copies of the `count` items of the coming fold from item
    // i0 (the I0-th overall): lane j announces item j's bytes on its group's
    // barrier, then the lanes share the rows of all the items
    auto issue = [&](long long I0, int i0, int count) {
        auto geometry = [&](int j, int& s, int& b0, int& nr, int& c0, uint32_t& bytes) {
            const int i = i0 + j, k = i / groups;
            s = static_cast<int>((I0 + j) % pl.g);
            b0 = (i - k * groups) * pl.rg;
            nr = min(pl.rg, B - b0);
            c0 = lo + k * pl.cw;
            bytes = static_cast<uint32_t>(((min(hi, c0 + pl.cw) - c0 + 3) & ~3) * 4);
        };
        int s, b0, nr, c0;
        uint32_t bytes;
        if (lane < count) {
            geometry(lane, s, b0, nr, c0, bytes);
            fvt_bar_arrive_expect(&s_bar[s], bytes * nr);
        }
        __syncwarp();
        fvt_fence_proxy_async();
        for (int q = lane; q < count * pl.rg; q += 32) {
            const int r = q % pl.rg;
            geometry(q / pl.rg, s, b0, nr, c0, bytes);
            if (r < nr) {
                fvt_bulk_load(ring + ((size_t)s * pl.rg + r) * pl.cw,
                              logA + (size_t)states[cur * B + b0 + r] * pl.lda + c0, bytes,
                              &s_bar[s]);
            }
        }
    };
    auto issue_first = [&]() {
        if (warp == 0) issue(item, 0, min(pl.g, items));
    };

    float e_next[JMAX];  // the coming fold's emissions of this thread's chunk-0 columns
    auto load_emits = [&](int t) {
        const float* e = emits + ((size_t)t * N + n) * K + lo;
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int off = j * THREADS + tid;
            e_next[j] = off < min(W, pl.cw) ? e[off] : 0.0f;
        }
    };

    int t = next_valid(-1);
    keep_rows(0, t);
    if (t < Tm) {
        load_emits(t);
        issue_first();
    }
    while (t < Tm) {
        const int tn = next_valid(t);
        const float* emit = emits + ((size_t)t * N + n) * K;

        // ---- fold: this CTA's columns, chunk by chunk, the ring's groups in slot order
        for (int c0 = lo, i = 0; c0 < hi; c0 += pl.cw) {
            const int cn = min(hi, c0 + pl.cw) - c0;
            float best[JMAX];
            int sl[JMAX];
#pragma unroll
            for (int j = 0; j < JMAX; ++j) {
                best[j] = -INFINITY;
                sl[j] = 0;
            }
            for (int g = 0; g < groups; ++g, ++i) {
                const long long I = item + i;
                const int s = static_cast<int>(I % pl.g);
                if (!broken && !fvt_bar_wait(&s_bar[s], static_cast<uint32_t>((I / pl.g) & 1))) {
                    broken = true;
                    atomicOr(err, 1);
                }
                const float* rows = ring + (size_t)s * pl.rg * pl.cw;
                const int b0 = g * pl.rg, nr = min(pl.rg, B - b0);
#pragma unroll
                for (int r = 0; r < RG_MAX; ++r) {  // slots ascending: strict '>' keeps the lowest
                    if (r < nr) {
                        const float v = vals[b0 + r];
                        const float* row = rows + (size_t)r * pl.cw;
#pragma unroll
                        for (int j = 0; j < JMAX; ++j) {
                            const int off = j * THREADS + tid;
                            if (off < cn) {
                                const float c = v + row[off];
                                if (c > best[j]) {
                                    best[j] = c;
                                    sl[j] = b0 + r;
                                }
                            }
                        }
                    }
                }
                if (i + pl.g < items) {  // a ring shorter than the fold: refill this group
                    __syncthreads();
                    if (warp == 0) issue(I + pl.g, i + pl.g, 1);
                }
            }
#pragma unroll
            for (int j = 0; j < JMAX; ++j) {
                const int off = j * THREADS + tid;
                if (off < cn) {
                    const float e = c0 == lo ? e_next[j] : emit[c0 + off];
                    keys[c0 - lo + off] = orderable((best[j] + e) + 0.0f);
                    cslot[c0 - lo + off] = sl[j];
                }
            }
        }
        item += items;
        if (tn < Tm) load_emits(tn);  // in flight while the cluster selects
        __syncthreads();

        // ---- select: the B-th largest key, 8 bits a pass
        int need = B;             // keys still to take below the prefix's bins
        unsigned int prefix = 0;  // the digits found so far
        int shift = 32;
        int above_before = 0;  // keys taken in lower-rank CTAs above the prefix's bin
        int eq_before = 0;     // lower-rank CTAs' keys in the prefix's bin
        bool whole = false;    // the last bin is taken whole
        for (int p = 0; p < 4 && !whole; ++p, ++pass) {
            shift -= 8;
            int* h = s_hist[pass & 1];
            for (int i = tid; i < W; i += THREADS) {
                const unsigned int k = keys[i];
                if (p == 0 || (k >> (shift + 8)) == prefix) atomicAdd(&h[(k >> shift) & 255], 1);
            }
            cluster.sync();
            int hv = 0, lv = 0;  // bin tid over the cluster, and over the lower ranks
            if (tid < BINS) {
                s_hist[(pass & 1) ^ 1][tid] = 0;  // read by the others before this barrier
                int x[CLUSTER_MAX];  // all C remote loads in flight at once
#pragma unroll
                for (int r = 0; r < CLUSTER_MAX; ++r) {
                    x[r] = r < C ? *cluster.map_shared_rank(h + tid, r) : 0;
                }
#pragma unroll
                for (int r = 0; r < CLUSTER_MAX; ++r) {
                    hv += x[r];
                    lv += r < rank ? x[r] : 0;
                }
            }
            // suffix sums over the bins, highest bin first
            int sh = hv, sl2 = lv;
            if (tid < BINS) {
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int xh = __shfl_down_sync(FULL, sh, o);
                    const int xl = __shfl_down_sync(FULL, sl2, o);
                    if (lane + o < 32) {
                        sh += xh;
                        sl2 += xl;
                    }
                }
                if (lane == 0) {
                    s_wa[warp] = sh;
                    s_wb[warp] = sl2;
                }
            }
            __syncthreads();
            if (tid < BINS) {
                for (int w = warp + 1; w < BINS / 32; ++w) {
                    sh += s_wa[w];
                    sl2 += s_wb[w];
                }
                if (sh >= need && sh - hv < need) {
                    s_res[0] = tid;
                    s_res[1] = sh - hv;
                    s_res[2] = hv;
                    s_res[3] = sl2 - lv;
                    s_res[4] = lv;
                }
            }
            __syncthreads();
            need -= s_res[1];
            prefix = (prefix << 8) | static_cast<unsigned int>(s_res[0]);
            above_before += s_res[3];
            eq_before = s_res[4];
            whole = need == s_res[2];
        }

        // ---- winners: positions in (CTA, column) order, written to every CTA
        const int eq_room = whole ? INT_MAX : max(0, need - eq_before);
        int base_a = above_before + (whole ? eq_before : min(need, eq_before));
        int base_e = 0;
        for (int j0 = 0; j0 < W; j0 += THREADS) {
            const int i = j0 + tid;
            unsigned int k = 0;
            int a = 0, e = 0;
            if (i < W) {
                k = keys[i];
                a = (k >> shift) > prefix;
                e = (k >> shift) == prefix;
            }
            int xa = a, xe = e, ta, te;
            block_scan2(xa, xe, ta, te, s_wa, s_wb);
            if (a || (e && base_e + xe < eq_room)) {
                const int pos = base_a + xa + min(base_e + xe, eq_room);
                const int idx = lo + i, sl = cslot[i];
                for (int r = 0; r < C; ++r) {
                    remote(wkey, r)[pos] = k;
                    remote(widx, r)[pos] = idx;
                    remote(wslot, r)[pos] = sl;
                }
            }
            base_a += ta;
            base_e += te;
        }
        cluster.sync();

        // ---- the new beam: rank the B winners by (key descending, index
        // ascending); positions rise with the index, so a tie is decided by
        // position.  A warp ranks 32 records against the others' keys,
        // loaded 32 at a time and broadcast by shuffles.
        const int nxt = cur ^ 1;
        for (int b0 = warp * 32; b0 < B; b0 += THREADS) {
            const int b = b0 + lane;
            const unsigned int kb = b < B ? wkey[b] : 0u;
            int at = 0;
            for (int o0 = 0; o0 < B; o0 += 32) {
                const unsigned int kl = o0 + lane < B ? wkey[o0 + lane] : 0u;
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    const unsigned int ko = __shfl_sync(FULL, kl, j);
                    const int o = o0 + j;
                    at += o < B && (ko > kb || (ko == kb && o < b));
                }
            }
            if (b < B) {
                vals[at] = from_orderable(kb);
                states[nxt * B + at] = widx[b];
                bslot[at] = wslot[b];
            }
        }
        __syncthreads();
        if (rank == 0) {
            const size_t out = ((size_t)t * N + n) * B;
            const int* old_pl = planes + pc * PB;
            int* new_pl = planes + (pc ^ 1) * PB;
            for (int b = tid; b < B; b += THREADS) {
                const int s = bslot[b];
                hist[out + b] = states[nxt * B + b];
                slots[out + b] = s;
                for (int p = 0; p < P; ++p) {
                    new_pl[p * B + b] = prop[(size_t)t * P + p] ? old_pl[p * B + s]
                                                                : states[cur * B + s];
                }
            }
        }
        cur = nxt;
        pc ^= (P > 0);
        __syncthreads();
        keep_rows(t + 1, tn);
        if (tn < Tm) issue_first();
        t = tn;
    }
    if (rank == 0) {
        for (int i = tid; i < PB; i += THREADS) planes_out[(size_t)n * PB + i] = planes[pc * PB + i];
    }
}

cudaError_t configure(const Plan& pl) {
    cudaError_t e = cudaFuncSetAttribute(beam_cluster_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(beam_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    e = cudaOccupancyMaxActiveClusters(&clusters, beam_cluster_kernel, &cfg);
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
    e = cudaLaunchKernelEx(&cfg, beam_cluster_kernel, logA, emits, vals0, states0, valid, prop,
                           hist, slots, planes, scratch, err, pl, Tm, N, K, B, P);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
