// Max-plus trellis scan for Hopper (sm_90a): the N-lane forward recursion
//
//     d_t[n, i] = max_k (d_{t-1}[n, k] + logA[k, i]) + emit_t[n, i]
//     ptr_t[n, i] = lowest k attaining that max          (WITH_PTR)
//     deltas[t][n, :] = d_{t-1}[n, :], the carry before step t   (!WITH_PTR)
//     emit_t[n, i] = logBT[ys[t, n], i]                  (EMIT_GATHER)
//
// Three kernels live here.
//
// scan_persistent runs the scans: it replaces
// flash_viterbi_tpu/ops/pallas/maxplus.py: maxplus_scan (_scan_kernel, and
// _scan_res_kernel for K <= 1024), maxplus_scan_deltas (_scan_deltas_kernel,
// _scan_res_deltas_kernel) and maxplus_scan_emitgather (_scan_eg_kernel).
// With EMIT_GATHER the emission row of each lane is read from the (M, K)
// table logBT by the lane's symbol, so no (T', N, K) emission buffer exists.
//
// step_block_kernel runs maxplus_step_block (ops/pallas/maxplus.py:720,
// _step_tiles_kernel): one step against a column shard logA[:, lo:lo+Kd]
// with no emission, one launch over every SM.
//
// scan_step is one step a launch; only the scan-ablation probe of
// scripts/vpu_probe.py (ablation, _abl_kernel) runs it, to measure this
// per-step design with the history write on or off and the staged chunk at
// 128, 256 or 512 rows.
//
// ---- scan_persistent ----
//
// What bounds a scan.  Its operations are 2 T' N K^2 adds and maxes: 0.27 ms
// for N=1, T'=255, K=3968 at the card's measured add+max rate.  Its bytes
// depend on where logA lives.  A step needs all of logA (60 MiB at K=3968,
// above the 50 MB L2), so a design that reads it from device memory every
// step is held to the memory rate: 255 x 60 MiB is 5.3 ms.  At N=1 a step is
// therefore a chase of bytes and of the step's fixed cost (the grid-wide
// hand-over of the carry); at N=16 every logA value serves 16 lanes and the
// step is a chase of instructions (~20 us of adds, maxes and shared-memory
// reads at K=3968).
//
// The design keeps logA on chip.  One launch per call: a cooperative launch
// of one block per SM (the launch refuses a grid that cannot be co-resident,
// and the wrapper raises), the lane groups and the T' steps looping inside
// the kernel.  The plan (ops/cuda/maxplus.py:scan_plan) splits logA into R
// source ranges x C column groups, one tile per block, about K^2 / (number
// of SMs) cells each.  A block copies its tile's leading rows into shared
// memory once per launch (cp.async), and streams the other rows every step
// (16-byte loads at K % 4 == 0, up to 8 rows in flight a thread, the next
// rows' loads issued before the current ones fold), from L2 as far as the
// streamed part of every tile together (~33 MB at K=3968) stays there (no
// trace has shown how far it does).  At K=16384 (1 GiB) the streamed part
// comes from device memory as before, but every SM streams.  Where K needs
// more column groups than there are SMs (K > 270336 at one lane, 67584 at
// 16), one range spans all rows and each block walks several groups a step,
// every row streamed.  A persisting L2 access-policy window over logA was
// slower in a trial at K=3968, so none is set.
//
// A thread owns CPT neighbouring destination columns of its block's group
// for every lane of the group (4 columns at up to 4 lanes, 2 at 8, 1 at
// 16): one shared-memory carry value serves CPT columns and one logA value
// every lane.  It walks the tile's source rows in ascending order, so a
// strict '>' keeps the lowest index; lexicographic (value, index) combines
// (argmax.cuh) are needed only where partial results of different source
// ranges meet.  Each block writes its tile's partial (max, argmax) per
// column to a global scratch after a step, and the carry of the next step
// is formed from the R partials of each entry, a team of threads an entry
// (warp shuffles), the emission added after the max.  Two ways, the plan
// choosing by what a block would read (ops/cuda/maxplus.py:TWO_PHASE_BYTES):
//   on read: after the step's one barrier each block forms the carry of its
//     own source range from the partials (their lexicographic winner for
//     the slice it writes out).  One barrier a step, but a block reads
//     K x lanes partials: 16 KB at N=1, K=3968, and 254 KB at N=16.
//   two-phase: after the barrier each block combines its 1/blocks share of
//     all carry entries once, writes them to a global carry, and a second
//     barrier publishes them.  Two barriers a step, K x lanes / blocks
//     partials a block.  On an H100, on read is the faster at 1 and 2
//     lanes of K=3968, two-phase from 4 lanes up and at K=16384 from 2
//     (chip_smoke.py:combine_turns times both).
//
// Barrier: an arrival counter in global memory.  Each block's first thread
// adds one with release semantics (red.release.gpu) and polls with acquire
// loads until every block of this step has arrived, at most WAIT_CYCLES
// (2^31 cycles, about a second), else sets the error word (apart from the
// polled count), which the wrapper reads and raises on, or, where a decode
// passed one word for all its scans, the decode reads once.  The partials and the carry change during the launch, so they are
// read with __ldcg (L2, never the non-coherent path or L1); logA, the
// emissions and delta0 do not change and are read through __ldg.
//
// ---- step_block_kernel ----
//
// What bounds a step.  Its bytes are logA_blk's Ks x Kd floats, read once
// (15.7 MB at Ks=3968, Kd=992; 63 MB at Kd=3968; 268 MB at Ks=16384,
// Kd=4096), from L2 where a sharded decode's back-to-back steps leave the
// shard there (it fits the 50 MB L2 up to Kd=1984 at Ks=3968) and from
// device memory otherwise; at one lane that is all there is.  Its
// operations are an add and a max per (lane, source, column): at 16 lanes
// of Ks=3968, Kd=992 the card's add+max rate holds it to ~4.3 us, more than
// the bytes.
//
// The design puts every SM on it in one launch.  The plan
// (ops/cuda/maxplus.py:step_plan) cuts logA_blk into R source ranges x C
// column groups of 32 x CPT columns, and the lanes into groups of up to
// 16 (the grid's y); a tile is a block of 256 threads.  A thread owns CPT
// neighbouring columns for every lane of its group (as in scan_persistent)
// and each of the block's 8 warps folds one contiguous slice of the tile's
// rows in ascending order with a strict '>': 16-byte loads of logA_blk
// where Kd % 4 == 0 and the base is aligned (scalar ones, clamped, at the
// ragged edge), several rows in flight a thread, the next rows' loads
// issued before the current ones fold.  A warp stages the carry of its
// slice in shared memory 32 rows at a time (lane-minor), each value read
// once, the next chunk's loads in flight while one folds; no block-wide
// barrier falls inside the fold.  The warps' partials then meet in shared
// memory, and where R > 1 the R tiles of a column group are one
// thread-block cluster: after one cluster barrier each CTA combines 1/R of
// the group's entries from every CTA's shared memory and writes them out.
// Every combine is the lexicographic one of argmax.cuh (larger value,
// then lower index), associative and commutative, so neither the split
// nor the order of arrival can change a bit.  No cooperative launch and no
// scratch: the step has no grid-wide barrier to pay.  On an H100 one lane
// streams logA_blk at 1.7-2.9 TB/s; 16 lanes fold 1.7-2.2 T cells/s, held
// by the fold's compare-and-select chain, not by its loads (PERF.md).
//
// ---- scan_step ----
//
// One step a launch over a (K, K) logA: a block owns 32 destination
// columns for up to 16 lanes, its 16 warps split the source rows, the carry
// slice of each source chunk is staged in shared memory and read as a
// warp-wide broadcast.  The source dimension is not split across blocks,
// and every step streams logA from device memory.
//
// Numerics (all three): fp32 add and max only, emission added after the max,
// and the lowest-index tie rule of argmax.cuh; bit-identical to the plain
// versions.  One kernel serves every K: ragged edges are clamped on read and
// masked on write, so K need not be a multiple of anything.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "argmax.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TI = 32;        // destination columns per block: one per thread of a warp
constexpr int WK = 16;        // warps per block, splitting the source dimension
constexpr int KC = 256;       // source rows staged per chunk (the ablation's default)
constexpr int LMAX = 16;      // lanes per launch; more lanes go in groups of 16

// What a step adds after the max: this step's (nl, K) emission rows, or
// rows of the (M, K) logBT gathered by ys, this step's nl symbols (the
// values are fixed: they appear in the kernels' names that ptxas reports)
enum Emit { EMIT_ROWS = 1, EMIT_GATHER = 2 };

// dcur (nl, K), logA (K, K), dnext / ptr / dhist (nl, K).  WRITE_HIST and
// KCH (the source rows staged a chunk) exist for the scan-ablation probe
// (fvt_maxplus_scan_deltas_ablation).
template <int L, bool WITH_PTR, Emit EMIT, bool WRITE_HIST = true, int KCH = KC>
__global__ void __launch_bounds__(TI * WK)
scan_step(const float* __restrict__ logA, const float* __restrict__ dcur,
          const float* __restrict__ emit, const int* __restrict__ ys,
          float* __restrict__ dnext, int* __restrict__ ptr,
          float* __restrict__ dhist, int Ks, int nl) {
    constexpr int RPW = KCH / WK;  // rows of a chunk each warp takes
    static_assert(KCH % WK == 0, "chunk must split evenly across warps");
    const int Kd = Ks;
    __shared__ float s_d[L][KCH];
    __shared__ float s_v[WK][TI];
    __shared__ int s_a[WK][TI];

    const int tx = threadIdx.x;
    const int w = threadIdx.y;
    const int tid = w * TI + tx;
    const int i = blockIdx.x * TI + tx;
    const int ic = i < Kd ? i : Kd - 1;  // ragged edge: clamp the read, mask the write

    float best[L];
    int arg[L];
#pragma unroll
    for (int n = 0; n < L; ++n) {
        best[n] = -INFINITY;
        arg[n] = Ks;
    }

    for (int k0 = 0; k0 < Ks; k0 += KCH) {
        __syncthreads();  // every warp is done with the previous chunk
        for (int j = tid; j < L * KCH; j += TI * WK) {
            const int n = j / KCH;
            const int kk = j - n * KCH;
            const int k = k0 + kk;
            s_d[n][kk] = (n < nl && k < Ks) ? dcur[(size_t)n * Ks + k] : -INFINITY;
        }
        __syncthreads();

        // rows past Ks read as -inf: their candidates never beat a real one
        // (a lower value, or an equal -inf with a higher index)
        const int kb = k0 + w * RPW;
        float a[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int k = kb + r;
            a[r] = k < Ks ? __ldg(logA + (size_t)k * Kd + ic) : -INFINITY;
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
#pragma unroll
            for (int n = 0; n < L; ++n) {
                const float v = s_d[n][w * RPW + r] + a[r];
                if (WITH_PTR) {
                    if (fvt_better(v, kb + r, best[n], arg[n])) {
                        best[n] = v;
                        arg[n] = kb + r;
                    }
                } else {
                    best[n] = fmaxf(best[n], v);
                }
            }
        }
    }

    // combine the WK partial results of each lane, one lane at a time
#pragma unroll
    for (int n = 0; n < L; ++n) {
        __syncthreads();
        s_v[w][tx] = best[n];
        if (WITH_PTR) s_a[w][tx] = arg[n];
        __syncthreads();
        if (w == 0 && n < nl && i < Kd) {
            float bv = s_v[0][tx];
            int ba = WITH_PTR ? s_a[0][tx] : 0;
            for (int ww = 1; ww < WK; ++ww) {
                const float v = s_v[ww][tx];
                if (WITH_PTR) {
                    const int a = s_a[ww][tx];
                    if (fvt_better(v, a, bv, ba)) {
                        bv = v;
                        ba = a;
                    }
                } else {
                    bv = fmaxf(bv, v);
                }
            }
            const size_t o = (size_t)n * Kd + i;
            dnext[o] = bv + (EMIT == EMIT_GATHER ? emit[(size_t)ys[n] * Kd + i] : emit[o]);
            if (WITH_PTR) {
                ptr[o] = ba;
            } else if (WRITE_HIST) {
                dhist[o] = dcur[o];
            }
        }
    }
}

// Tm launches per group of up to 16 lanes, ping-ponging the carry through
// work (2*N*K floats): step(nl, src, dst, st) launches one step of a group
// of lanes, reading the carry src and writing dst; st is the step's offset
// into (Tm, N, K) outputs.
template <class Step>
int for_each_step(const float* delta0, float* dfin, float* work, int Tm, int N,
                  int K, long long* launches, Step step) {
    const size_t NK = (size_t)N * K;
    for (int g0 = 0; g0 < N; g0 += LMAX) {
        const int nl = N - g0 < LMAX ? N - g0 : LMAX;
        const size_t off = (size_t)g0 * K;
        for (int t = 0; t < Tm; ++t) {
            const float* src = t == 0 ? delta0 + off : work + ((t - 1) & 1) * NK + off;
            float* dst = t == Tm - 1 ? dfin + off : work + (t & 1) * NK + off;
            step(nl, src, dst, (size_t)t * NK + off);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
            ++*launches;
        }
    }
    return 0;
}

// The deltas scan one step a launch, as the ablation probe runs it: always
// the 16-lane instantiation, with or without the history write, at KCH
// source rows a chunk.
template <bool WRITE_HIST, int KCH>
int run_ablation(const float* logA, const float* emits, const float* delta0,
                 float* dfin, float* deltas, float* work, int Tm, int N, int K,
                 cudaStream_t s, long long* launches) {
    const dim3 block(TI, WK);
    const dim3 grid((K + TI - 1) / TI);
    return for_each_step(delta0, dfin, work, Tm, N, K, launches,
                         [&](int nl, const float* src, float* dst, size_t st) {
        scan_step<LMAX, false, EMIT_ROWS, WRITE_HIST, KCH><<<grid, block, 0, s>>>(
            logA, src, emits + st, nullptr, dst, nullptr,
            WRITE_HIST ? deltas + st : nullptr, K, nl);
    });
}

// ---- the persistent scan ----

constexpr int PT = 512;                      // threads of a block
constexpr long long WAIT_CYCLES = 1ll << 31; // longest wait at a barrier
constexpr unsigned int ERR_TIMEOUT = 1;      // a grid barrier timed out

// destination columns a thread owns at LG lanes
template <int LG>
__host__ __device__ constexpr int cols_per_thread() {
    return LG <= 4 ? 4 : (LG == 8 ? 2 : 1);
}

// streamed rows whose loads a thread has in flight: 8 where the registers
// allow (a step's streamed rows are latency-bound with fewer), 4 at 4 and 8
// lanes, whose partials fill the registers
template <int LG>
__host__ __device__ constexpr int unroll_rows() {
    return LG == 4 || LG == 8 ? 4 : 8;
}

// The plan's numbers the kernel needs (ops/cuda/maxplus.py:scan_plan)
struct Plan {
    int R;          // source ranges: tile q spans range q / C
    int C;          // column groups: tile q spans group q % C
    int rows_smem;  // leading rows of a tile held in shared memory (one tile a block)
    int stride;     // floats of a tile row in shared memory
    int carry_rows; // source rows whose carry shared memory holds at once
    int team;       // threads that combine one carry entry's R partials
    int two_phase;  // combine once per entry between two barriers, not on read
};

// fields of the int array the C entry points take, in this order
enum PlanField {
    PF_LANES, PF_R, PF_C, PF_BLOCKS, PF_ROWS_SMEM, PF_STRIDE, PF_CARRY_ROWS, PF_TEAM,
    PF_TWO_PHASE, PF_SMEM, PF_COUNT
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Every block of the grid has arrived: count reaches target = blocks x
// barriers passed.  One release-add a block, then its first thread polls
// with an acquire load.  False (and the error word set) when the wait timed
// out, or another block's did.
__device__ bool grid_barrier(unsigned int* count, unsigned int target, unsigned int* err) {
    __shared__ int s_ok;
    __syncthreads();  // the block's writes precede its arrival
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
        const long long t0 = clock64();
        int ok = 1;
        for (unsigned int i = 0; ld_acquire(count) < target; ++i) {
            if ((i & 255) == 255 && (ld_acquire(err) != 0 || clock64() - t0 > WAIT_CYCLES)) {
                atomicOr(err, ERR_TIMEOUT);
                ok = 0;
                break;
            }
        }
        s_ok = ok;
    }
    __syncthreads();
    return s_ok != 0;
}

// CPT floats of one logA row from device memory: one vector load when the
// rows are CPT-aligned, else CPT scalar loads clamped to the row's K
template <int CPT>
__device__ __forceinline__ void load_row(float (&a)[CPT], const float* row, int col, int K,
                                         bool vec) {
    if constexpr (CPT == 4) {
        if (vec) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(row + col));
            a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
            return;
        }
    } else if constexpr (CPT == 2) {
        if (vec) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(row + col));
            a[0] = v.x, a[1] = v.y;
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) a[j] = __ldg(row + min(col + j, K - 1));
}

// CPT floats of one tile row from shared memory (16- or 8-byte aligned)
template <int CPT>
__device__ __forceinline__ void load_tile(float (&a)[CPT], const float* s) {
    if constexpr (CPT == 4) {
        const float4 v = *reinterpret_cast<const float4*>(s);
        a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
    } else if constexpr (CPT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(s);
        a[0] = v.x, a[1] = v.y;
    } else {
        a[0] = s[0];
    }
}

// The carry of every lane of one source row, from shared memory (lane-minor)
template <int LG>
__device__ __forceinline__ void load_carry(float (&d)[LG], const float* s) {
    if constexpr (LG % 4 == 0) {
#pragma unroll
        for (int n = 0; n < LG; n += 4) {
            const float4 v = *reinterpret_cast<const float4*>(s + n);
            d[n] = v.x, d[n + 1] = v.y, d[n + 2] = v.z, d[n + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int n = 0; n < LG; ++n) d[n] = s[n];
    }
}

// Fold source row k (carry d, logA values a) into the running partials
template <int LG, int CPT, bool WITH_PTR>
__device__ __forceinline__ void fold(float (&best)[LG][CPT], int (&arg)[LG][CPT],
                                     const float (&d)[LG], const float (&a)[CPT], int k) {
#pragma unroll
    for (int n = 0; n < LG; ++n) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const float v = d[n] + a[j];
            if (WITH_PTR) {
                // rows come in ascending k: strict '>' keeps the lowest
                if (v > best[n][j]) {
                    best[n][j] = v;
                    arg[n][j] = k;
                }
            } else {
                best[n][j] = fmaxf(best[n][j], v);
            }
        }
    }
}

// The emission of lane row `row` (t * N + lane) at column k
template <Emit EMIT>
__device__ __forceinline__ float emission(const float* __restrict__ emit,
                                          const int* __restrict__ ys, size_t row, int K, int k) {
    return EMIT == EMIT_GATHER ? __ldg(emit + (size_t)__ldg(ys + row) * K + k)
                               : __ldg(emit + row * K + k);
}

// Carry entry (n, k) combined from its R partials (pv, pi: R x LG x K) by a
// team of `team` threads, this thread being member m: it folds ranges m,
// m + team, ..., and the team meets by xor shuffles, so every lane of the
// warp calls it.  With lex, the lexicographic (value, lowest index)
// winner; else the max value alone (ba stays INT_MAX).
template <int LG, bool WITH_PTR>
__device__ __forceinline__ void combine(const float* pv, const int* pi, int R, int K, int team,
                                        int m, int n, int k, bool live, bool lex, float& bv,
                                        int& ba) {
    bv = -INFINITY;
    ba = INT_MAX;
    if (live) {
#pragma unroll 4
        for (int rr = m; rr < R; rr += team) {
            const size_t o = ((size_t)rr * LG + n) * K + k;
            const float v = __ldcg(pv + o);
            if (WITH_PTR && lex) {
                const int a = __ldcg(pi + o);
                if (fvt_better(v, a, bv, ba)) {
                    bv = v;
                    ba = a;
                }
            } else {
                bv = fmaxf(bv, v);
            }
        }
    }
    for (int s = team >> 1; s > 0; s >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
        const int oa = WITH_PTR ? __shfl_xor_sync(0xffffffffu, ba, s) : 0;
        if (WITH_PTR && lex) {
            if (fvt_better(ov, oa, bv, ba)) {
                bv = ov;
                ba = oa;
            }
        } else {
            bv = fmaxf(bv, ov);
        }
    }
}

// Tile q of the plan: source range q / C (rows r0 .. r0 + kr), column units
// u0 .. u1 of group q % C, and the slice w0 .. w1 of the range's rows whose
// pointers, history and final carry it writes (the C tiles of a range split
// the range)
struct Tile {
    int r, r0, kr, u0, u1, w0, w1;
};

__device__ __forceinline__ Tile tile_of(int q, int K, int units, const Plan& p) {
    Tile tl;
    tl.r = q / p.C;
    const int c = q - tl.r * p.C;
    tl.r0 = (int)((long long)tl.r * K / p.R);
    tl.kr = (int)((long long)(tl.r + 1) * K / p.R) - tl.r0;
    tl.u0 = (int)((long long)c * units / p.C);
    tl.u1 = (int)((long long)(c + 1) * units / p.C);
    tl.w0 = (int)((long long)c * tl.kr / p.C);
    tl.w1 = (int)((long long)(c + 1) * tl.kr / p.C);
    return tl;
}

// The whole scan for every group of LG lanes.  emit is emits (Tm, N, K)
// (EMIT_ROWS) or logBT (M, K) with the (Tm, N) symbols ys (EMIT_GATHER).
// part_v / part_i: 2 x R x LG x K partials, two buffers by step parity
// (part_i only WITH_PTR); carry: LG x K, the group's carry (two-phase
// combine only); count: the barrier's arrival count, zero on entry; err: the
// error word, set when a barrier times out (and read at every wait, so a
// scan that shares a word already set stops at its first barrier).  Block b
// walks tiles b, b + gridDim.x, ... of the plan's R x C.
template <int LG, bool WITH_PTR, Emit EMIT>
__global__ void __launch_bounds__(PT, 1)
scan_persistent(const float* __restrict__ logA, const float* __restrict__ emit,
                const int* __restrict__ ys, const float* __restrict__ delta0,
                float* __restrict__ dfin, int* __restrict__ ptrs,
                float* __restrict__ deltas, float* part_v, int* part_i, float* carry,
                unsigned int* count, unsigned int* err, int Tm, int N, int K, Plan p) {
    constexpr int CPT = cols_per_thread<LG>();
    constexpr int UNROLL = unroll_rows<LG>();
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const int nb = gridDim.x;
    const int tiles = p.R * p.C;
    float* s_d = smem;                                        // carry_rows x LG, lane-minor
    float* s_tile = smem + (p.carry_rows * LG + 3) / 4 * 4;  // rows_smem x stride
    const int units = (K + CPT - 1) / CPT;
    const bool vec = K % CPT == 0;

    // the block's first tile (its only one unless tiles > nb), and its
    // leading rows, once per launch (a plan with rows in shared memory
    // gives every block one tile)
    Tile tl = tile_of(blockIdx.x, K, units, p);
    if (p.rows_smem > 0) {
        const int rs = min(p.rows_smem, tl.kr), width = (tl.u1 - tl.u0) * CPT;
        for (int i = tid; i < rs * width; i += PT) {
            const int lr = i / width, jc = i - lr * width;
            cp_async4(s_tile + lr * p.stride + jc,
                      logA + (size_t)(tl.r0 + lr) * K + min(tl.u0 * CPT + jc, K - 1));
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    const size_t part_buf = (size_t)p.R * LG * K;

    unsigned int steps = 0;     // steps done, over every group
    unsigned int arrivals = 0;  // grid barriers passed
    for (int g0 = 0; g0 < N; g0 += LG) {
        const int nl = min(LG, N - g0);
        for (int t = 0; t <= Tm; ++t) {
            for (int q = blockIdx.x; q < tiles; q += nb) {
                if (tiles > nb) tl = tile_of(q, K, units, p);  // a block of several tiles
                const int r0 = tl.r0, kr = tl.kr, w0 = tl.w0, w1 = tl.w1;
                // threads past the group redo its last unit
                const int my_u = min(tl.u0 + tid, tl.u1 - 1);
                const bool active = tl.u0 + tid < tl.u1;
                const int col = my_u * CPT;                     // this thread's first column
                const int rs = min(p.rows_smem, kr);            // tile rows in shared memory
                const float* my_tile = s_tile + (my_u - tl.u0) * CPT;

                float best[LG][CPT];
                int arg[LG][CPT];
#pragma unroll
                for (int n = 0; n < LG; ++n) {
#pragma unroll
                    for (int j = 0; j < CPT; ++j) {
                        best[n][j] = -INFINITY;
                        arg[n][j] = r0;  // an all -inf range resolves to its first row
                    }
                }
                // one pass per p.carry_rows source rows: the carry of the pass's
                // rows is formed in shared memory, then the rows fold (one pass
                // unless the range's carry is too large for shared memory)
                for (int p0 = 0; p0 < kr; p0 += p.carry_rows) {
                    const int p1 = min(kr, p0 + p.carry_rows), np = p1 - p0;
                    const int sm_end = min(p1, rs), st0 = max(p0, rs);
                    // the first streamed rows' loads fly while the carry forms and
                    // the shared rows fold
                    float nxt[UNROLL][CPT];
                    if (t < Tm && st0 < p1) {
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) {
                            load_row<CPT>(nxt[u], logA + (size_t)(r0 + min(st0 + u, p1 - 1)) * K,
                                          col, K, vec);
                        }
                    }
                    // the previous pass (or tile) is done with s_d
                    if (p0 > 0 || q != (int)blockIdx.x) __syncthreads();
                    if (t == 0) {
                        for (int i = tid; i < np * LG; i += PT) {
                            const int n = i / np, lr = p0 + i - n * np, k = r0 + lr;
                            const float v = n < nl ? __ldg(delta0 + (size_t)(g0 + n) * K + k)
                                                   : -INFINITY;
                            s_d[(lr - p0) * LG + n] = v;
                            if (!WITH_PTR && n < nl && lr >= w0 && lr < w1) {
                                deltas[(size_t)(g0 + n) * K + k] = v;
                            }
                        }
                    } else if (p.two_phase) {
                        for (int i = tid; i < np * LG; i += PT) {
                            const int n = i / np, k = r0 + p0 + i - n * np;
                            s_d[(k - r0 - p0) * LG + n] =
                                n < nl ? __ldcg(carry + (size_t)n * K + k) : -INFINITY;
                        }
                    } else {
                        // the carry before step t (t == Tm: the final carry) of rows
                        // p0..p1: the max of the R partials of step t - 1 (their
                        // lexicographic winner for the entries this block writes
                        // out), a team of p.team threads an entry, then the emission
                        const float* pv = part_v + ((steps - 1) & 1) * part_buf;
                        const int* pi = part_i + ((steps - 1) & 1) * part_buf;
                        const int team = p.team;
                        const int tasks = (np * LG * team + 31) / 32 * 32;  // whole warps: shuffles
#pragma unroll 4
                        for (int i = tid; i < tasks; i += PT) {
                            const int e = i / team, m = i - e * team;
                            const bool live = e < np * LG;
                            const int n = live ? e / np : 0;
                            const int lr = p0 + (live ? e - n * np : 0);
                            const int k = r0 + lr;
                            const bool mine = live && n < nl && lr >= w0 && lr < w1;
                            const float em = live && m == 0 && n < nl
                                ? emission<EMIT>(emit, ys, (size_t)(t - 1) * N + g0 + n, K, k)
                                : 0.0f;
                            float bv;
                            int ba;
                            combine<LG, WITH_PTR>(pv, pi, p.R, K, team, m, n, k, live, mine, bv,
                                                  ba);
                            if (live && m == 0) {
                                const float d = n < nl ? bv + em : -INFINITY;
                                if (t < Tm) s_d[(lr - p0) * LG + n] = d;
                                if (mine) {
                                    const size_t o = (size_t)(g0 + n) * K + k;
                                    if (WITH_PTR) ptrs[(size_t)(t - 1) * N * K + o] = ba;
                                    if (t == Tm) {
                                        dfin[o] = d;
                                    } else if (!WITH_PTR) {
                                        deltas[(size_t)t * N * K + o] = d;
                                    }
                                }
                            }
                        }
                    }
                    if (t == Tm) continue;
                    __syncthreads();  // the carry (and, the first time, the tile) is in place

                    for (int lr = p0; lr < sm_end; ++lr) {
                        float d[LG], a[CPT];
                        load_carry<LG>(d, s_d + (lr - p0) * LG);
                        load_tile<CPT>(a, my_tile + lr * p.stride);
                        fold<LG, CPT, WITH_PTR>(best, arg, d, a, r0 + lr);
                    }
                    for (int lr = st0; lr < p1; lr += UNROLL) {
                        float cur[UNROLL][CPT];
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                            for (int j = 0; j < CPT; ++j) cur[u][j] = nxt[u][j];
                        }
                        if (lr + UNROLL < p1) {
#pragma unroll
                            for (int u = 0; u < UNROLL; ++u) {
                                const int k = r0 + min(lr + UNROLL + u, p1 - 1);
                                load_row<CPT>(nxt[u], logA + (size_t)k * K, col, K, vec);
                            }
                        }
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) {
                            if (lr + u < p1) {
                                float d[LG];
                                load_carry<LG>(d, s_d + (lr + u - p0) * LG);
                                fold<LG, CPT, WITH_PTR>(best, arg, d, cur[u], r0 + lr + u);
                            }
                        }
                    }
                }
                if (t < Tm && active) {
                    float* wv = part_v + (steps & 1) * part_buf + (size_t)tl.r * LG * K;
                    int* wi = part_i + (steps & 1) * part_buf + (size_t)tl.r * LG * K;
#pragma unroll
                    for (int n = 0; n < LG; ++n) {
#pragma unroll
                        for (int j = 0; j < CPT; ++j) {
                            if (col + j < K) {
                                wv[(size_t)n * K + col + j] = best[n][j];
                                if (WITH_PTR) wi[(size_t)n * K + col + j] = arg[n][j];
                            }
                        }
                    }
                }
            }
            if (t == Tm) break;
            ++steps;
            if (!grid_barrier(count, ++arrivals * nb, err)) return;
            if (!p.two_phase) continue;

            // two-phase combine: this block's share e0..e1 of the carry
            // entries of step t from their R partials, then the emission;
            // a second barrier publishes them before the next walk reads
            // them (and keeps that walk's partials from overtaking the reads)
            const float* pv = part_v + ((steps - 1) & 1) * part_buf;
            const int* pi = part_i + ((steps - 1) & 1) * part_buf;
            const int e0 = (int)((long long)blockIdx.x * nl * K / nb);
            const int e1 = (int)((long long)(blockIdx.x + 1) * nl * K / nb);
            const int team = p.team;
            const int tasks = ((e1 - e0) * team + 31) / 32 * 32;  // whole warps: shuffles
            for (int i = tid; i < tasks; i += PT) {
                const int m = i % team;
                const int e = e0 + i / team;
                const bool live = e < e1;
                const int n = live ? e / K : 0, k = live ? e - n * K : 0;
                const float em = live && m == 0
                    ? emission<EMIT>(emit, ys, (size_t)t * N + g0 + n, K, k) : 0.0f;
                float bv;
                int ba;
                combine<LG, WITH_PTR>(pv, pi, p.R, K, team, m, n, k, live, true, bv, ba);
                if (live && m == 0) {
                    const float d = bv + em;
                    const size_t o = (size_t)(g0 + n) * K + k;
                    carry[(size_t)n * K + k] = d;
                    if (WITH_PTR) ptrs[(size_t)t * N * K + o] = ba;
                    if (t == Tm - 1) {
                        dfin[o] = d;
                    } else if (!WITH_PTR) {
                        deltas[(size_t)(t + 1) * N * K + o] = d;
                    }
                }
            }
            if (!grid_barrier(count, ++arrivals * nb, err)) return;
            if (t == Tm - 1) break;  // dfin is out: no final carry to form
        }
    }
}

template <int LG, bool WITH_PTR, Emit EMIT>
int launch_persistent(const float* logA, const float* emit, const int* ys,
                      const float* delta0, float* dfin, int* ptrs, float* deltas,
                      float* part_v, int* part_i, float* carry, unsigned int* count,
                      unsigned int* err, int Tm, int N, int K, const int* plan,
                      cudaStream_t stream) {
    const auto kernel = scan_persistent<LG, WITH_PTR, EMIT>;
    const int smem = plan[PF_SMEM];
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    Plan p{plan[PF_R], plan[PF_C], plan[PF_ROWS_SMEM], plan[PF_STRIDE], plan[PF_CARRY_ROWS],
           plan[PF_TEAM], plan[PF_TWO_PHASE]};
    void* args[] = {&logA, &emit, &ys, &delta0, &dfin, &ptrs, &deltas, &part_v, &part_i,
                    &carry, &count, &err, &Tm, &N, &K, &p};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(plan[PF_BLOCKS]),
                                    dim3(PT), args, static_cast<size_t>(smem), stream);
    return static_cast<int>(e);
}

template <bool WITH_PTR, Emit EMIT>
int run_scan(const float* logA, const float* emit, const int* ys, const float* delta0,
             float* dfin, int* ptrs, float* deltas, float* part_v, int* part_i,
             float* carry, unsigned int* count, unsigned int* err, const int* plan, int Tm,
             int N, int K, void* stream, long long* launches) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
#define FVT_SCAN(LG) \
    rc = launch_persistent<LG, WITH_PTR, EMIT>(logA, emit, ys, delta0, dfin, ptrs, deltas, \
                                               part_v, part_i, carry, count, err, Tm, N, K, \
                                               plan, s)
    switch (plan[PF_LANES]) {
        case 1: FVT_SCAN(1); break;
        case 2: FVT_SCAN(2); break;
        case 4: FVT_SCAN(4); break;
        case 8: FVT_SCAN(8); break;
        case 16: FVT_SCAN(16); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FVT_SCAN
    if (rc != 0) return rc;
    ++*launches;
    return 0;
}

// ---- the step block ----

constexpr int SB_THREADS = 256;             // threads of a block (ops/cuda/maxplus.py: STEP_THREADS)
constexpr int SB_WARPS = SB_THREADS / 32;   // warps, each folding a slice of the tile's rows
constexpr int SB_CHUNK = 32;                // source rows whose carry a warp stages at once: one a lane
constexpr int SB_CLUSTER_MAX = 16;          // tiles of a column group (a non-portable size above 8)

// fields of the int array fvt_maxplus_step_block takes (step_plan's c_args)
enum StepField { SF_LANES, SF_R, SF_C, SF_GROUPS, SF_COUNT };

// Dynamic shared memory of a step-block tile at LG lanes: the warps' carry
// chunks while they fold, their partials after
template <int LG>
__host__ __device__ constexpr int step_smem_floats() {
    constexpr int carry = SB_WARPS * SB_CHUNK * LG;
    constexpr int partials = 2 * SB_WARPS * LG * 32 * cols_per_thread<LG>();
    return carry > partials ? carry : partials;
}

// One tile of the step: source range r (rows r0 .. r0 + kr) of column group
// c (column units u0 .. u1, at most 32) for lane group blockIdx.y.  R and C
// as in the plan; cluster rank r is blockIdx.x % R, so a cluster is the R
// ranges of one column group.
template <int LG>
__global__ void __launch_bounds__(SB_THREADS, 2)
step_block_kernel(const float* __restrict__ delta, const float* __restrict__ logA,
                  float* __restrict__ val, int* __restrict__ ptr, int N, int Ks, int Kd, int R,
                  int C) {
    constexpr int CPT = cols_per_thread<LG>();
    constexpr int UNROLL = unroll_rows<LG>();
    constexpr int TW = 32 * CPT;  // columns of a tile at most
    constexpr int E = LG * TW;    // (lane, column) entries of a tile, lane-major
    static_assert(SB_CHUNK == 32, "a warp stages its carry one row a lane");
    static_assert(SB_CHUNK % UNROLL == 0, "a chunk must hold whole groups of rows in flight");
    extern __shared__ __align__(16) float s_buf[];  // step_smem_floats<LG>()
    __shared__ float s_bv[E];  // the tile's partial, which the cluster reads
    __shared__ int s_bi[E];

    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int r = blockIdx.x % R, c = blockIdx.x / R;
    const int g0 = blockIdx.y * LG, nl = min(LG, N - g0);
    const int units = (Kd + CPT - 1) / CPT;
    const int u0 = (int)((long long)c * units / C), u1 = (int)((long long)(c + 1) * units / C);
    const int r0 = (int)((long long)r * Ks / R), kr = (int)((long long)(r + 1) * Ks / R) - r0;
    // this warp's slice of the range
    const int s0 = r0 + (int)((long long)w * kr / SB_WARPS);
    const int s1 = r0 + (int)((long long)(w + 1) * kr / SB_WARPS);
    const int col = min(u0 + lane, u1 - 1) * CPT;  // lanes past the group redo its last unit
    const bool vec = Kd % CPT == 0 && reinterpret_cast<uintptr_t>(logA) % (CPT * 4) == 0;

    float best[LG][CPT];
    int arg[LG][CPT];
#pragma unroll
    for (int n = 0; n < LG; ++n) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            best[n][j] = -INFINITY;
            arg[n][j] = s1 > s0 ? s0 : INT_MAX;  // all -inf: the slice's first row; empty: identity
        }
    }
    float* s_c = s_buf + w * SB_CHUNK * LG;  // this warp's carry chunk, lane-minor
    if (s0 < s1) {
        float nxt[UNROLL][CPT];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            load_row<CPT>(nxt[u], logA + (size_t)min(s0 + u, s1 - 1) * Kd, col, Kd, vec);
        }
        // thread `lane` carries source row k0 + lane of the chunk, every lane of the group
        float cn[LG];
#pragma unroll
        for (int n = 0; n < LG; ++n) {
            cn[n] = n < nl && s0 + lane < s1 ? __ldg(delta + (size_t)(g0 + n) * Ks + s0 + lane)
                                             : -INFINITY;
        }
        for (int k0 = s0; k0 < s1; k0 += SB_CHUNK) {
            const int kend = min(k0 + SB_CHUNK, s1);
            __syncwarp();  // the warp is done with the previous chunk
            if constexpr (LG % 4 == 0) {
#pragma unroll
                for (int n = 0; n < LG; n += 4) {
                    *reinterpret_cast<float4*>(s_c + lane * LG + n) =
                        make_float4(cn[n], cn[n + 1], cn[n + 2], cn[n + 3]);
                }
            } else {
#pragma unroll
                for (int n = 0; n < LG; ++n) s_c[lane * LG + n] = cn[n];
            }
            __syncwarp();
            if (kend < s1) {  // the next chunk's carry flies while this one folds
#pragma unroll
                for (int n = 0; n < LG; ++n) {
                    cn[n] = n < nl && kend + lane < s1
                        ? __ldg(delta + (size_t)(g0 + n) * Ks + kend + lane) : -INFINITY;
                }
            }
            // whole groups of UNROLL rows with no test inside, so the
            // compiler overlaps one row's carry reads with another's folds
            int lr = k0;
            for (; lr + UNROLL <= kend; lr += UNROLL) {
                float cur[UNROLL][CPT];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                    for (int j = 0; j < CPT; ++j) cur[u][j] = nxt[u][j];
                }
                if (lr + UNROLL < s1) {
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        load_row<CPT>(nxt[u], logA + (size_t)min(lr + UNROLL + u, s1 - 1) * Kd,
                                      col, Kd, vec);
                    }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    float d[LG];
                    load_carry<LG>(d, s_c + (lr + u - k0) * LG);
                    fold<LG, CPT, true>(best, arg, d, cur[u], lr + u);
                }
            }
            // the slice's last rows, fewer than UNROLL (kend == s1 here: a
            // chunk before the last holds whole groups), already in nxt
#pragma unroll
            for (int u = 0; u < UNROLL - 1; ++u) {
                if (lr + u < kend) {
                    float d[LG];
                    load_carry<LG>(d, s_c + (lr + u - k0) * LG);
                    fold<LG, CPT, true>(best, arg, d, nxt[u], lr + u);
                }
            }
        }
    }

    // the warps' partials meet: entry e = n * TW + (column within the tile)
    __syncthreads();  // every warp is done with its carry chunks
    float* s_pv = s_buf;
    int* s_pi = reinterpret_cast<int*>(s_buf + SB_WARPS * E);
#pragma unroll
    for (int n = 0; n < LG; ++n) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            s_pv[w * E + n * TW + lane * CPT + j] = best[n][j];
            s_pi[w * E + n * TW + lane * CPT + j] = arg[n][j];
        }
    }
    __syncthreads();
    const int width = min((u1 - u0) * CPT, Kd - u0 * CPT);  // columns of this tile
    for (int e = threadIdx.x; e < E; e += SB_THREADS) {
        float bv = s_pv[e];
        int ba = s_pi[e];
#pragma unroll
        for (int ww = 1; ww < SB_WARPS; ++ww) {
            const float v = s_pv[ww * E + e];
            const int a = s_pi[ww * E + e];
            if (fvt_better(v, a, bv, ba)) {
                bv = v;
                ba = a;
            }
        }
        const int n = e / TW, jc = e - n * TW;
        if (R == 1) {
            if (n < nl && jc < width) {
                const size_t o = (size_t)(g0 + n) * Kd + u0 * CPT + jc;
                val[o] = bv;
                ptr[o] = ba;
            }
        } else {
            s_bv[e] = bv;
            s_bi[e] = ba;
        }
    }
    if (R == 1) return;

    // the R tiles of the column group meet: this CTA takes entries e0 .. e1
    // of every CTA of the cluster
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's partial is in its shared memory
    const int e0 = r * E / R, e1 = (r + 1) * E / R;
    for (int e = e0 + threadIdx.x; e < e1; e += SB_THREADS) {
        const int n = e / TW, jc = e - n * TW;
        if (n >= nl || jc >= width) continue;
        float bv = -INFINITY;
        int ba = INT_MAX;
        for (int q = 0; q < R; ++q) {
            const float v = *cluster.map_shared_rank(s_bv + e, q);
            const int a = *cluster.map_shared_rank(s_bi + e, q);
            if (fvt_better(v, a, bv, ba)) {
                bv = v;
                ba = a;
            }
        }
        const size_t o = (size_t)(g0 + n) * Kd + u0 * CPT + jc;
        val[o] = bv;
        ptr[o] = ba;
    }
    cluster.sync();  // no CTA leaves while another still reads its shared memory
}

template <int LG>
int launch_step_block(const float* delta, const float* logA, float* val, int* ptr, int N,
                      int Ks, int Kd, const int* plan, cudaStream_t stream) {
    const auto kernel = step_block_kernel<LG>;
    const int R = plan[SF_R], C = plan[SF_C];
    if (R < 1 || R > SB_CLUSTER_MAX || C < 1) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int smem = step_smem_floats<LG>() * 4;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R * C, plan[SF_GROUPS]);
    cfg.blockDim = dim3(SB_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    if (R > 1) {
        if (R > 8) {
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = R;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, delta, logA, val, ptr, N, Ks, Kd, R, C);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The whole scan, one cooperative launch.  Layouts are those of the JAX
// functions: logA (K, K), emits (Tm, N, K), delta0 (N, K), dfin (N, K),
// ptrs (Tm, N, K) int32 or deltas (Tm, N, K) float32 -- pass exactly one
// of the two; the other is null.  plan: the PF_COUNT ints of scan_plan;
// scratch: part_v / part_i 2 x R x lanes x K floats / ints (part_i with
// ptrs only), carry lanes x K floats (two-phase plans only, else null);
// count: one zeroed uint32, the barrier's; err: the error word (nonzero
// after the call: a barrier timed out).  Tm >= 1.  Returns the launch error.
extern "C" int fvt_maxplus_scan(const float* logA, const float* emits, const float* delta0,
                                float* dfin, int* ptrs, float* deltas, float* part_v,
                                int* part_i, float* carry, unsigned int* count,
                                unsigned int* err, const int* plan, int Tm, int N, int K,
                                void* stream, long long* launches) {
    if (ptrs != nullptr) {
        return run_scan<true, EMIT_ROWS>(logA, emits, nullptr, delta0, dfin, ptrs, nullptr,
                                         part_v, part_i, carry, count, err, plan, Tm, N, K,
                                         stream, launches);
    }
    return run_scan<false, EMIT_ROWS>(logA, emits, nullptr, delta0, dfin, nullptr, deltas,
                                      part_v, part_i, carry, count, err, plan, Tm, N, K,
                                      stream, launches);
}

// fvt_maxplus_scan with in-kernel emission gather: logBT (M, K) and the
// (Tm, N) int32 symbols ys in place of emits; pointers only (deltas must be
// null).  Every symbol must lie in [0, M): the kernel reads logBT without
// a bound check.
extern "C" int fvt_maxplus_scan_eg(const float* logA, const float* logBT, const int* ys,
                                   const float* delta0, float* dfin, int* ptrs, float* deltas,
                                   float* part_v, int* part_i, float* carry,
                                   unsigned int* count, unsigned int* err, const int* plan,
                                   int Tm, int N, int K, void* stream, long long* launches) {
    if (ptrs == nullptr || deltas != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return run_scan<true, EMIT_GATHER>(logA, logBT, ys, delta0, dfin, ptrs, nullptr, part_v,
                                       part_i, carry, count, err, plan, Tm, N, K, stream,
                                       launches);
}

// One trellis step against a column shard: delta (N, Ks), logA_block
// (Ks, Kd), both row-major; writes the pre-emission val (N, Kd) and ptr
// (N, Kd), the lowest source row in [0, Ks) attaining each max.  plan: the
// SF_COUNT ints of step_plan (lanes a group, R, C, lane groups).  One
// launch.  N, Ks, Kd >= 1.  Returns the launch error (a cluster the card
// cannot schedule is one).
extern "C" int fvt_maxplus_step_block(const float* delta, const float* logA_block,
                                      float* val, int* ptr, const int* plan, int N, int Ks,
                                      int Kd, void* stream, long long* launches) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
    switch (plan[SF_LANES]) {
        case 1: rc = launch_step_block<1>(delta, logA_block, val, ptr, N, Ks, Kd, plan, s); break;
        case 2: rc = launch_step_block<2>(delta, logA_block, val, ptr, N, Ks, Kd, plan, s); break;
        case 4: rc = launch_step_block<4>(delta, logA_block, val, ptr, N, Ks, Kd, plan, s); break;
        case 8: rc = launch_step_block<8>(delta, logA_block, val, ptr, N, Ks, Kd, plan, s); break;
        case 16: rc = launch_step_block<16>(delta, logA_block, val, ptr, N, Ks, Kd, plan, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
    ++*launches;
    return 0;
}

// The scan-ablation probe (replaces scripts/vpu_probe.py: ablation,
// _abl_kernel): the deltas scan one step a launch (scan_step, the design
// the scans ran before the persistent kernel), with (write_hist != 0,
// deltas (Tm, N, K)) or without (deltas null) the carry history, staging
// kc source rows a chunk, kc in {128, 256, 512} (1024 would take 64 KB of
// static shared memory at 16 lanes, above the 48 KB limit).  work holds
// 2*N*K floats for the carry ping-pong.  dfin is the same in every mode.
// Returns the first launch error, or cudaErrorInvalidValue for another kc.
extern "C" int fvt_maxplus_scan_deltas_ablation(const float* logA, const float* emits,
                                                const float* delta0, float* dfin,
                                                float* deltas, float* work, int Tm,
                                                int N, int K, int write_hist, int kc,
                                                void* stream, long long* launches) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FVT_ABLATION(WH, KCH) \
    return run_ablation<WH, KCH>(logA, emits, delta0, dfin, deltas, work, Tm, N, K, s, launches)
    if (write_hist) {
        if (kc == 128) FVT_ABLATION(true, 128);
        if (kc == 256) FVT_ABLATION(true, 256);
        if (kc == 512) FVT_ABLATION(true, 512);
    } else {
        if (kc == 128) FVT_ABLATION(false, 128);
        if (kc == 256) FVT_ABLATION(false, 256);
        if (kc == 512) FVT_ABLATION(false, 512);
    }
#undef FVT_ABLATION
    return static_cast<int>(cudaErrorInvalidValue);
}

// The card's L2: out[0] its bytes, out[1] the most it can set aside for
// persisting accesses (cudaDevAttrMaxPersistingL2CacheSize).  Returns the
// first error.
extern "C" int fvt_device_l2(int device, int* out) {
    cudaError_t e = cudaDeviceGetAttribute(out, cudaDevAttrL2CacheSize, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxPersistingL2CacheSize, device);
    return static_cast<int>(e);
}

extern "C" const char* fvt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
