// The beam scan's cluster kernel for Hopper (sm_90a), shared by the
// production scan (csrc/beam_scan.cu, whose head comment gives the design)
// and the beam-step cost probes (csrc/probe_beam.cu).
//
// beam_cluster_kernel<READ, FOLD, SEL> is templated on the probes' switches:
//   READ  the fold's B rows come through the bulk-copy ring; off, it folds
//         values made from (state, column) and issues no copy.
//   FOLD  the max over the B slots with the lowest slot; off with READ on,
//         the rows go into an xor checksum that becomes the slot, so that
//         no read is elided; off with READ off, the first slot alone.
//   SEL   SEL_RADIX, the production select (the cluster-wide 32-bit radix
//         select); SEL_PICK, B rounds of a cluster-wide minimum over packed
//         64-bit keys (value descending, index ascending): a block
//         reduction a round, one cluster barrier, and the C candidates read
//         through distributed shared memory; SEL_NOSMEM, SEL_PICK keeping
//         round b's winner in thread b's registers, written to shared memory
//         once after the rounds; SEL_BLOCKM, SEL_PICK over per-warp best
//         keys, only the warp whose key was taken rescanning its own;
//         SEL_ONEREDUCE, one 32-bit reduction a round (the value alone), the
//         round's number taken as the index: wrong on purpose, for cost
//         attribution; SEL_NONE, the cluster's best key alone, the beam
//         moving on to the next B states ("no-pick").
// Only <true, true, SEL_RADIX> is production; the probes instantiate the
// others at one lane, no anchor planes and no valid mask.  Every if
// constexpr below leaves that instantiation's code as it was.
#pragma once
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
constexpr unsigned long long NONE_KEY = ~0ull;

// the select of beam_cluster_kernel (the head comment)
enum Select { SEL_RADIX, SEL_PICK, SEL_NOSMEM, SEL_BLOCKM, SEL_ONEREDUCE, SEL_NONE };

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

// A fold value without a global read: a float in [1, 2) from (state, column)
__device__ __forceinline__ float made_value(int state, int col) {
    return __uint_as_float(0x3f800000u | ((unsigned int)(state ^ col) & 0x007fffffu));
}

// The pick selects' key of column i of a CTA whose columns start at lo: the
// least key is the largest value, then the lowest index
__device__ __forceinline__ unsigned long long pick_key(unsigned int k, int col) {
    return ((unsigned long long)(~k) << 32) | (unsigned int)col;
}

__device__ __forceinline__ unsigned long long warp_min64(unsigned long long k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = __shfl_xor_sync(FULL, k, o);
        k = x < k ? x : k;
    }
    return k;
}

template <bool READ, bool FOLD, int SEL>
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
    int rnd = 0;          // rounds of the probes' other selects: their candidate buffer
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
        if constexpr (READ) {
            if (warp == 0) issue(item, 0, min(pl.g, items));
        }
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
            if constexpr (READ) {
                unsigned int xs[JMAX] = {};  // no fold: the rows' checksum
                for (int g = 0; g < groups; ++g, ++i) {
                    const long long I = item + i;
                    const int s = static_cast<int>(I % pl.g);
                    if (!broken &&
                        !fvt_bar_wait(&s_bar[s], static_cast<uint32_t>((I / pl.g) & 1))) {
                        broken = true;
                        atomicOr(err, 1);
                    }
                    const float* rows = ring + (size_t)s * pl.rg * pl.cw;
                    const int b0 = g * pl.rg, nr = min(pl.rg, B - b0);
#pragma unroll
                    // slots ascending: strict '>' keeps the lowest
                    for (int r = 0; r < RG_MAX; ++r) {
                        if (r < nr) {
                            const float v = vals[b0 + r];
                            const float* row = rows + (size_t)r * pl.cw;
#pragma unroll
                            for (int j = 0; j < JMAX; ++j) {
                                const int off = j * THREADS + tid;
                                if (off < cn) {
                                    if constexpr (FOLD) {
                                        const float c = v + row[off];
                                        if (c > best[j]) {
                                            best[j] = c;
                                            sl[j] = b0 + r;
                                        }
                                    } else if (b0 + r == 0) {
                                        best[j] = v + row[off];
                                    } else {
                                        xs[j] ^= __float_as_uint(row[off]);
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
                if constexpr (!FOLD) {
#pragma unroll
                    for (int j = 0; j < JMAX; ++j) sl[j] = static_cast<int>(xs[j] & 0xffu);
                }
            } else if constexpr (FOLD) {  // values made from (state, column), no read
                for (int b = 0; b < B; ++b) {
                    const float v = vals[b];
                    const int state = states[cur * B + b];
#pragma unroll
                    for (int j = 0; j < JMAX; ++j) {
                        const int off = j * THREADS + tid;
                        const float c = v + made_value(state, c0 + off);
                        if (off < cn && c > best[j]) {
                            best[j] = c;
                            sl[j] = b;
                        }
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < JMAX; ++j) best[j] = vals[0];
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
        if constexpr (READ) item += items;
        if (tn < Tm) load_emits(tn);  // in flight while the cluster selects
        __syncthreads();

        const int nxt = cur ^ 1;
        if constexpr (SEL == SEL_RADIX) {
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
                    if (p == 0 || (k >> (shift + 8)) == prefix) {
                        atomicAdd(&h[(k >> shift) & 255], 1);
                    }
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
        } else {
            // ---- the probes' other selects: rounds of a cluster-wide minimum.
            // A CTA's candidate of a round goes to the buffer of the round's
            // parity: one cluster barrier a round keeps a buffer from being
            // rewritten before every CTA has read it.
            __shared__ unsigned long long s_cand[2];
            __shared__ int s_cslot[2];
            __shared__ unsigned long long s_red[WARPS];
            auto own_min = [&]() {  // this thread's least pick key
                unsigned long long k = NONE_KEY;
                for (int i = tid; i < W; i += THREADS) {
                    const unsigned long long x = pick_key(keys[i], lo + i);
                    k = x < k ? x : k;
                }
                return k;
            };
            auto publish = [&](unsigned long long k, int slot) {  // thread 0
                s_cand[rnd & 1] = k;
                s_cslot[rnd & 1] = slot;
            };
            auto slot_of = [&](unsigned long long k) {
                return k == NONE_KEY ? 0 : cslot[static_cast<int>(k & 0xffffffffu) - lo];
            };
            // the CTA's least key of s_red, published by warp 0 (after a barrier)
            auto publish_block_min = [&]() {
                if (warp == 0) {
                    const unsigned long long k = warp_min64(lane < WARPS ? s_red[lane] : NONE_KEY);
                    if (lane == 0) publish(k, slot_of(k));
                }
            };
            // after the round's cluster barrier: the least of the C candidates and
            // its slot, in every thread (lane r of each warp reads CTA r's)
            auto cluster_min = [&](unsigned long long& w, int& ws) {
                unsigned long long x = NONE_KEY;
                int xs = 0;
                if (lane < C) {
                    x = *cluster.map_shared_rank(&s_cand[rnd & 1], lane);
                    xs = *cluster.map_shared_rank(&s_cslot[rnd & 1], lane);
                }
                w = warp_min64(x);
                ws = __shfl_sync(FULL, xs, __ffs(__ballot_sync(FULL, x == w)) - 1);
            };
            // taken: a key below every value (orderable 0), in the thread that scans it
            auto take = [&](int idx) {
                if (idx >= lo && idx < hi && tid == (idx - lo) % THREADS) keys[idx - lo] = 0u;
            };
            unsigned long long w;
            int ws;
            if constexpr (SEL == SEL_PICK || SEL == SEL_NOSMEM) {
                unsigned long long mine = NONE_KEY;  // NOSMEM: round tid's winner
                int mslot = 0;
                for (int b = 0; b < B; ++b, ++rnd) {
                    const unsigned long long k = warp_min64(own_min());
                    if (lane == 0) s_red[warp] = k;
                    __syncthreads();
                    publish_block_min();
                    cluster.sync();
                    cluster_min(w, ws);
                    const int idx = static_cast<int>(w & 0xffffffffu);
                    take(idx);
                    if (SEL == SEL_PICK && tid == 0) {
                        vals[b] = from_orderable(~static_cast<unsigned int>(w >> 32));
                        states[nxt * B + b] = idx;
                        bslot[b] = ws;
                    }
                    if (SEL == SEL_NOSMEM && tid == b) {
                        mine = w;
                        mslot = ws;
                    }
                }
                if (SEL == SEL_NOSMEM && tid < B) {
                    vals[tid] = from_orderable(~static_cast<unsigned int>(mine >> 32));
                    states[nxt * B + tid] = static_cast<int>(mine & 0xffffffffu);
                    bslot[tid] = mslot;
                }
            } else if constexpr (SEL == SEL_BLOCKM) {
                // s_red holds each warp's least key; only the warp that owned
                // the round's winner rescans its keys
                unsigned long long k = warp_min64(own_min());
                if (lane == 0) s_red[warp] = k;
                __syncthreads();
                for (int b = 0; b < B; ++b, ++rnd) {
                    publish_block_min();
                    cluster.sync();
                    cluster_min(w, ws);
                    const int idx = static_cast<int>(w & 0xffffffffu);
                    if (tid == 0) {
                        vals[b] = from_orderable(~static_cast<unsigned int>(w >> 32));
                        states[nxt * B + b] = idx;
                        bslot[b] = ws;
                    }
                    if (idx >= lo && idx < hi && warp == ((idx - lo) % THREADS) >> 5) {
                        take(idx);
                        k = warp_min64(own_min());
                        if (lane == 0) s_red[warp] = k;
                    }
                    __syncthreads();
                }
            } else if constexpr (SEL == SEL_ONEREDUCE) {
                for (int b = 0; b < B; ++b, ++rnd) {
                    unsigned int m = ~0u;
                    for (int i = tid; i < W; i += THREADS) m = min(m, ~keys[i]);
                    m = __reduce_min_sync(FULL, m);
                    if (lane == 0) s_red[warp] = m;
                    __syncthreads();
                    if (warp == 0) {
                        m = __reduce_min_sync(
                            FULL, lane < WARPS ? static_cast<unsigned int>(s_red[lane]) : ~0u);
                        if (lane == 0) publish(static_cast<unsigned long long>(m) << 32, 0);
                    }
                    cluster.sync();
                    cluster_min(w, ws);
                    m = static_cast<unsigned int>(w >> 32);
                    take(b);  // the round as the index
                    if (tid == 0) {
                        vals[b] = from_orderable(~m);
                        states[nxt * B + b] = b;
                        bslot[b] = static_cast<int>(m & 0xffu);
                    }
                }
            } else {  // SEL_NONE
                const unsigned long long k = warp_min64(own_min());
                if (lane == 0) s_red[warp] = k;
                __syncthreads();
                publish_block_min();
                cluster.sync();
                cluster_min(w, ws);
                ++rnd;
                const float v = from_orderable(~static_cast<unsigned int>(w >> 32));
                for (int b = tid; b < B; b += THREADS) {
                    vals[b] = v;
                    states[nxt * B + b] = b == 0 ? static_cast<int>(w & 0xffffffffu)
                                                 : (states0[(size_t)n * B + b] + t + 1) % K;
                    bslot[b] = b == 0 ? ws : b;
                }
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
    if constexpr (SEL != SEL_RADIX) {
        cluster.sync();  // every CTA's candidates outlive the last round's reads
    }
}

}  // namespace
