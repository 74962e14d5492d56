// Max-plus trellis scan for Hopper (sm_90a): the N-lane forward recursion
//
//     d_t[n, i] = max_k (d_{t-1}[n, k] + logA[k, i]) + emit_t[n, i]
//     ptr_t[n, i] = lowest k attaining that max          (WITH_PTR)
//     deltas[t][n, :] = d_{t-1}[n, :], the carry before step t   (!WITH_PTR)
//     emit_t[n, i] = logBT[ys[t, n], i]                  (EMIT_GATHER)
//
// Two kernels live here.
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
// The scan-ablation probe (scripts/vpu_probe.py: ablation, _abl_kernel)
// runs instances of scan_persistent with parts of a step cut (PARTS, a bit
// set of Part; every production instance takes P_ALL), so that the time of
// a step splits into its fixed cost, the combine, the streamed rows, the
// fold and the history write (flash_viterbi_tpu_torch/probes/scan.py).
//
// ---- scan_persistent ----
//
// What bounds a scan.  Its operations are 2 T' N K^2 adds and maxes: 0.24 ms
// for N=1, T'=255, K=3968 at an H100's issue rate (64 add+max cells a clock
// an SM at 1.98 GHz, flash_viterbi_tpu_torch/bench/bounds.py).  Its bytes
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
// The ring route.  Where a range's carry fills shared memory (the plan
// holds no tile row there: 16 lanes at K >= 14341, 8 at 28421, 4 at 55861,
// every block one tile), the scheme above streams every row each step by
// __ldg, 8 rows ahead a thread, and that prefetch drains at each carry
// pass, combine and grid barrier: on an H100 at K=16384, N=16 the reads
// (1.07 GB a step, 0.32 ms at 3.35 TB/s) and the fold (4.3 G cells, 0.26
// ms) took turns, 0.576 ms a step.  Nothing there needs the stream to
// stop: logA does not depend on the carry.  So the fp32 deltas scan has an
// instance of its own there (RING, ring_scan): one producer warp beside the
// 512 folding threads copies each tile row's slice into a ring of stages in
// shared memory by bulk copies (cp.async.bulk, an mbarrier a stage for
// "full" and one for "empty"), waits only for stages the folders released,
// and never joins their barriers (named barrier BAR_FOLD, not
// __syncthreads), so it streams on through the carry passes, the combine
// and the grid barriers, the next step's first rows in flight while this
// one combines.  A folding thread owns 2 columns from 8 lanes (tiles of
// 1024 columns: R=8 x C=16 at K=16384, a 128 KiB carry in one pass, 96 KiB
// of ring in 3 stages of 8 rows), 4 at 4 lanes; the plan is scan_plan(...,
// deltas=True)'s.
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
// Numerics (both): fp32 add and max only, emission added after the max,
// and the lowest-index tie rule of argmax.cuh; bit-identical to the plain
// versions.  One kernel serves every K: ragged edges are clamped on read and
// masked on write, so K need not be a multiple of anything.
//
// ---- the bf16 table (scan_persistent's TA) ----
//
// scan_persistent also reads a bf16 logA (TA = __nv_bfloat16: the pointer
// and deltas scans of precision="bf16", flash_viterbi_tpu/ops/pallas/
// maxplus.py:132 and :196 loading a bf16 tile).  Each table value is
// widened with __bfloat162float before the add, which is exact; the add,
// the max, the strict '>' and the carries stay fp32, so the scan equals the
// fp32 scan of the table rounded to bf16, bit for bit, as JAX's promotion
// of the bf16 tile does.  No bf16 arithmetic: a bf16 add would round the
// sum.  Shared memory holds the tile at 2 bytes a value, twice the rows of
// an fp32 tile (ops/cuda/maxplus.py:scan_plan at elem_bytes=2): at K=3968,
// N=1 a block keeps 58 of its 61 rows, not 29, and streams 3.  The tile
// comes in by 4-byte cp.async pairs where the rows, the tile's first column
// and the stride are even (the plan keeps a bf16 stride even), else by
// 2-byte loads and stores; streamed rows take one 8-byte (4 columns) or
// 4-byte (2 columns) load where K is a multiple of the thread's columns,
// else clamped 2-byte loads.  A streamed row stays in registers as loaded,
// two values a word, and is widened where it folds: widened at the load,
// each thread waited for its loads at once (on an H100 at 700 W the
// K=16384, N=1 scan took 15.5 ms against fp32's 11.0; kept as bits, 6.0),
// and at one lane 16 rows fly a thread, the registers of fp32's 8.  The
// wrapper hands the kernel a 16-byte-aligned table.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "argmax.cuh"
#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

// What a step adds after the max: this step's (nl, K) emission rows, or
// rows of the (M, K) logBT gathered by ys, this step's nl symbols (the
// values are fixed: they appear in the kernels' names that ptxas reports)
enum Emit { EMIT_ROWS = 1, EMIT_GATHER = 2 };

// The parts of a scan step, a bit set (the values are fixed: they appear in
// the kernels' names).  Every production instance takes P_ALL; the
// scan-ablation probe cuts parts to time them.
enum Part {
    P_HIST = 1,     // the carry history written (deltas)
    P_STREAM = 2,   // the streamed rows' loads
    P_FOLD = 4,     // each row folded into the partials (its carry read and the add+max)
    P_COMBINE = 8,  // the partials written and combined into the next carry
    P_ALL = 15,
};

// ---- the persistent scan ----

constexpr int PT = 512;                      // threads of a block
constexpr long long WAIT_CYCLES = 1ll << 31; // longest wait at a barrier
constexpr unsigned int ERR_TIMEOUT = 1;      // a grid barrier (or a ring stage's copy) timed out
constexpr int BAR_FOLD = 1;                  // the named barrier of the PT folding threads

// destination columns a thread owns at LG lanes
template <int LG>
__host__ __device__ constexpr int cols_per_thread() {
    return LG <= 4 ? 4 : (LG == 8 ? 2 : 1);
}

// streamed rows whose loads a thread has in flight: 8 where the registers
// allow (a step's streamed rows are latency-bound with fewer), 4 at 4 and 8
// lanes, whose partials fill the registers.  A bf16 table (ELEM 2) keeps
// its loaded rows as bits, two values a register: 16 rows at one lane (the
// registers of fp32's 8), 8 elsewhere
template <int LG, int ELEM = 4>
__host__ __device__ constexpr int unroll_rows() {
    if constexpr (ELEM == 2) return LG == 1 ? 16 : 8;
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
    int ring;       // table rows the ring route's shared-memory ring holds (0: another route)
};

// fields of the int array the C entry points take, in this order
enum PlanField {
    PF_LANES, PF_R, PF_C, PF_BLOCKS, PF_ROWS_SMEM, PF_STRIDE, PF_CARRY_ROWS, PF_TEAM,
    PF_TWO_PHASE, PF_SMEM, PF_RING, PF_COUNT
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// The PT threads that fold meet; the ring route's producer warp never
// waits with them (a named barrier, not __syncthreads)
__device__ __forceinline__ void fold_sync() {
    asm volatile("bar.sync %0, %1;" ::"n"(BAR_FOLD), "n"(PT) : "memory");
}

// Every block of the grid has arrived: count reaches target = blocks x
// barriers passed.  One release-add a block, then its first thread polls
// with an acquire load.  False (and the error word set) when the wait timed
// out, or another block's did.  FOLDERS: the block's folding threads meet
// by fold_sync alone (the ring route), and a word already set when the
// block arrives stops the scan here.
template <bool FOLDERS = false>
__device__ bool grid_barrier(unsigned int* count, unsigned int target, unsigned int* err) {
    __shared__ int s_ok;
    // the block's writes precede its arrival
    if constexpr (FOLDERS) fold_sync(); else __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
        unsigned int preset = 0;
        if constexpr (FOLDERS) preset = *reinterpret_cast<volatile unsigned int*>(err);
        const long long t0 = clock64();
        int ok = 1;
        for (unsigned int i = 0; ld_acquire(count) < target; ++i) {
            if ((i & 255) == 255 && (ld_acquire(err) != 0 || clock64() - t0 > WAIT_CYCLES)) {
                atomicOr(err, ERR_TIMEOUT);
                ok = 0;
                break;
            }
        }
        if constexpr (FOLDERS) ok = ok && preset == 0;
        s_ok = ok;
    }
    if constexpr (FOLDERS) fold_sync(); else __syncthreads();
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

// The bf16 value in the low or high half of a 32-bit word, widened to fp32
// (exact: the bf16 bits are the float's upper half)
__device__ __forceinline__ float bf16_lo(unsigned int w) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

// CPT table values of one streamed row as loaded, widened only when they
// fold (a widening at the load would wait for it): the floats themselves,
// or the bf16 bits, two values a word (one at CPT = 1)
template <typename TA, int CPT>
struct Loaded {
    float a[CPT];
};
template <int CPT>
struct Loaded<__nv_bfloat16, CPT> {
    unsigned int w[(CPT + 1) / 2];
};

template <int CPT>
__device__ __forceinline__ void load_row(Loaded<float, CPT>& r, const float* row, int col, int K,
                                         bool vec) {
    load_row<CPT>(r.a, row, col, K, vec);
}

// CPT bf16 values of one logA row from device memory: one 8- or 4-byte
// load when the rows are CPT-aligned, else CPT 2-byte loads clamped to the
// row's K (packed in pairs)
template <int CPT>
__device__ __forceinline__ void load_row(Loaded<__nv_bfloat16, CPT>& r,
                                         const __nv_bfloat16* row, int col, int K, bool vec) {
    if constexpr (CPT == 4) {
        if (vec) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + col));
            r.w[0] = v.x, r.w[1] = v.y;
            return;
        }
    } else if constexpr (CPT == 2) {
        if (vec) {
            r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(row + col));
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < CPT; j += 2) {
        const unsigned int lo = __bfloat16_as_ushort(__ldg(row + min(col + j, K - 1)));
        r.w[j / 2] = CPT == 1 ? lo
            : lo | static_cast<unsigned int>(__bfloat16_as_ushort(
                       __ldg(row + min(col + j + 1, K - 1)))) << 16;
    }
}

// A loaded row's values as fp32
template <int CPT>
__device__ __forceinline__ void widen(float (&a)[CPT], const Loaded<float, CPT>& r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) a[j] = r.a[j];
}
template <int CPT>
__device__ __forceinline__ void widen(float (&a)[CPT], const Loaded<__nv_bfloat16, CPT>& r) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) a[j] = j % 2 == 0 ? bf16_lo(r.w[j / 2]) : bf16_hi(r.w[j / 2]);
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

// CPT bf16 values of one tile row from shared memory (8-, 4- or 2-byte
// aligned), widened to fp32
template <int CPT>
__device__ __forceinline__ void load_tile(float (&a)[CPT], const __nv_bfloat16* s) {
    if constexpr (CPT == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(s);
        a[0] = bf16_lo(v.x), a[1] = bf16_hi(v.x), a[2] = bf16_lo(v.y), a[3] = bf16_hi(v.y);
    } else if constexpr (CPT == 2) {
        const unsigned int v = *reinterpret_cast<const unsigned int*>(s);
        a[0] = bf16_lo(v), a[1] = bf16_hi(v);
    } else {
        a[0] = __bfloat162float(s[0]);
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

// Without the fold (the ablation's no-fold): each loaded logA value goes
// into the partials by one max, so that its load is kept
template <int LG, int CPT>
__device__ __forceinline__ void keep(float (&best)[LG][CPT], const float (&a)[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) best[0][j] = fmaxf(best[0][j], a[j]);
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

// ---- the ring route: the fp32 deltas scan with no tile row on chip ----

constexpr int RING_PT = PT + 32;        // the folding threads and the producer warp
constexpr int RING_STAGE_ROWS = 8;      // table rows of a ring stage (ops/cuda/maxplus.py)
constexpr int RING_STAGES_MAX = 32;     // stages the ring's barriers allow

// destination columns a folding thread owns on the ring route: 2 from 8
// lanes (at 16 a tile of 1024 columns halves the ranges' carry; at 8, 4
// columns spilled under the ring's 96 registers), 4 at 4 lanes
template <int LG>
__host__ __device__ constexpr int ring_cols() {
    return LG >= 8 ? 2 : 4;
}

// The bulk copy of one tile row's slice (width floats from row): from the
// 16-byte boundary at or below its first value to the one at or above its
// end, as a bulk copy takes 16-byte-aligned addresses and sizes.  Returns
// the bytes; src is the copy's first byte.
__device__ __forceinline__ uint32_t ring_span(const float* row, int width, const char*& src) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) & ~uintptr_t(15);
    const uintptr_t e = (reinterpret_cast<uintptr_t>(row + width) + 15) & ~uintptr_t(15);
    src = reinterpret_cast<const char*>(a);
    return static_cast<uint32_t>(e - a);
}

// Where a row's first value lies in its ring slot: 0 to 3 floats past the
// slot's start (0 for every row where logA is 16-byte aligned, K % 4 == 0)
__device__ __forceinline__ int ring_offset(const float* row) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

// The producer (one thread): every row the folding threads fold, in their
// order (each lane group's T' steps, each step the tile's rows kr from
// logA row r0), copied into the ring's stages of RING_STAGE_ROWS rows.  It
// waits only for a stage the folders have released (empty), announces the
// stage's bytes on full and never joins the folders' barriers, so it
// streams on through their carry passes, combines and grid barriers.  It
// stops when the folders left (stop) or a wait timed out (the error word
// set), after the copies it issued have landed.  Its work a stage is kept
// short (it shares its SM's issue slots with the folding warps): where
// every row starts 16-byte aligned (aligned) a row is a fixed-size copy
// from the previous row's source plus K floats.
__device__ void ring_produce(const float* logA, int K, int r0, int kr, int c0, int width,
                             bool aligned, long long steps, float* ring, int stride,
                             int stages, uint64_t* full, uint64_t* empty, volatile int* stop,
                             unsigned int* err) {
    constexpr int SR = RING_STAGE_ROWS;
    int s = 0;
    uint32_t phase = 0;
    long long issued = 0;
    const float* tile = logA + (size_t)r0 * K + c0;
    const uint32_t row_bytes = 4u * width;
    for (long long st = 0; st < steps; ++st) {
        const float* row = tile;
        for (int lr = 0; lr < kr; lr += SR) {
            if (!fvt_bar_try(&empty[s], phase ^ 1)) {
                const long long t0 = clock64();
                while (!fvt_bar_try(&empty[s], phase ^ 1)) {
                    if (*stop) goto drain;
                    if (clock64() - t0 > WAIT_CYCLES) {
                        atomicOr(err, ERR_TIMEOUT);
                        goto drain;
                    }
                }
            }
            fvt_fence_proxy_async();  // the folders' reads of the stage precede its refill
            const int rows = min(SR, kr - lr);
            float* dst = ring + s * SR * stride;
            if (aligned) {
                fvt_bar_arrive_expect(&full[s], rows * row_bytes);
                for (int i = 0; i < rows; ++i, row += K, dst += stride) {
                    fvt_bulk_load(dst, row, row_bytes, &full[s]);
                }
            } else {
                const char* src[SR];
                uint32_t bytes[SR], total = 0;
#pragma unroll
                for (int i = 0; i < SR; ++i) {
                    bytes[i] = i < rows ? ring_span(row + (size_t)i * K, width, src[i]) : 0;
                    total += bytes[i];
                }
                fvt_bar_arrive_expect(&full[s], total);
#pragma unroll
                for (int i = 0; i < SR; ++i) {
                    if (i < rows) fvt_bulk_load(dst + i * stride, src[i], bytes[i], &full[s]);
                }
                row += (size_t)rows * K;
            }
            ++issued;
            if (++s == stages) {
                s = 0;
                phase ^= 1;
            }
        }
    }
    return;
drain:
    // the last copy into each stage has landed before the block may leave
    for (int j = 0; j < stages && j < issued; ++j) {
        fvt_bar_wait(&full[j], static_cast<uint32_t>(((issued - 1 - j) / stages) & 1));
    }
}

// CPT table values of one ring row at a folding thread's column (slot: the
// row's slot plus the thread's column in the tile)
template <int CPT, bool ALIGNED>
__device__ __forceinline__ void ring_values(float (&a)[CPT], const float* slot, int off) {
    if constexpr (ALIGNED) {
        load_tile<CPT>(a, slot);
    } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) a[j] = slot[off + j];
    }
}

// Fold ROWS ring rows (logA rows from rowp, K floats apart; their carry at
// sd, lane-minor; their values at st, stride floats apart) into the
// partials, in ascending order, with no test between them, so that one
// row's loads fly while another folds.  ALIGNED: every row's first value
// starts its slot; else each row's offset is read off its address.
template <int LG, int CPT, bool ALIGNED, int ROWS>
__device__ __forceinline__ void ring_fold(float (&best)[LG][CPT], const float* sd,
                                          const float* st, int stride, const float* rowp,
                                          int K) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        float d[LG], a[CPT];
        load_carry<LG>(d, sd + i * LG);
        ring_values<CPT, ALIGNED>(a, st + i * stride,
                                  ALIGNED ? 0 : ring_offset(rowp + (size_t)i * K));
#pragma unroll
        for (int n = 0; n < LG; ++n) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) best[n][j] = fmaxf(best[n][j], d[n] + a[j]);
        }
    }
}

// Fold a ring stage of rows rows: a whole stage unrolled U rows at a time,
// a range's last (shorter) one a row at a time.  A 544-thread block leaves
// ptxas 96 registers: 8 rows at once at 16 lanes (on an H100 the fastest),
// 4 below
template <int LG, int CPT, bool ALIGNED>
__device__ __forceinline__ void ring_fold_stage(float (&best)[LG][CPT], const float* sd,
                                                const float* st, int stride, int rows,
                                                const float* rowp, int K) {
    constexpr int U = LG >= 16 ? RING_STAGE_ROWS : RING_STAGE_ROWS / 2;
    if (rows == RING_STAGE_ROWS) {
#pragma unroll 1
        for (int i = 0; i < RING_STAGE_ROWS; i += U) {
            ring_fold<LG, CPT, ALIGNED, U>(best, sd + i * LG, st + i * stride, stride,
                                           rowp + (size_t)i * K, K);
        }
    } else {
        for (int i = 0; i < rows; ++i) {
            ring_fold<LG, CPT, ALIGNED, 1>(best, sd + i * LG, st + i * stride, stride,
                                           rowp + (size_t)i * K, K);
        }
    }
}

// The deltas scan (fp32 logA, emission rows, every part) where the plan
// holds no tile row in shared memory and every block has one tile: shared
// memory goes to the carry of the tile's range (in passes of carry_rows
// rows where it is too tall) and to a ring of p.ring table rows, stride
// floats each, which one producer warp fills by bulk copies while the PT
// folding threads fold.  The tile's columns are whole quads of 4 (its slice
// of a row is one copy); a folding thread owns ring_cols<LG>() of them for
// every lane.  Each thread still walks its rows in ascending order, and the
// partials, the two-phase combine and the history are those of the
// resident route, so the result is the plain scan's bit for bit.  The
// arguments are scan_persistent's.
template <int LG>
__device__ __forceinline__ void ring_scan(const float* __restrict__ logA,
                                          const float* __restrict__ emit,
                                          const float* __restrict__ delta0,
                                          float* __restrict__ dfin, float* __restrict__ deltas,
                                          float* part_v, float* carry, unsigned int* count,
                                          unsigned int* err, int Tm, int N, int K,
                                          const Plan& p) {
    constexpr int CPT = ring_cols<LG>();
    constexpr int SR = RING_STAGE_ROWS;
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t full[RING_STAGES_MAX], empty[RING_STAGES_MAX];
    __shared__ int s_stop;

    const int tid = threadIdx.x;
    const int nb = gridDim.x;
    const int stages = p.ring / SR;
    float* s_d = smem;                                       // carry_rows x LG, lane-minor
    float* ring = smem + (p.carry_rows * LG + 3) / 4 * 4;    // p.ring rows x p.stride
    // tile blockIdx.x: source range r (rows r0 .. r0 + kr), columns c0 .. c1
    // in whole quads, and the slice w0 .. w1 of the range's rows whose
    // history it writes
    const int r = blockIdx.x / p.C, c = blockIdx.x - r * p.C;
    const int r0 = (int)((long long)r * K / p.R);
    const int kr = (int)((long long)(r + 1) * K / p.R) - r0;
    const int quads = (K + 3) / 4;
    const int c0 = (int)((long long)c * quads / p.C) * 4;
    const int c1 = min(K, (int)((long long)(c + 1) * quads / p.C) * 4);
    const int w0 = (int)((long long)c * kr / p.C), w1 = (int)((long long)(c + 1) * kr / p.C);
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            fvt_bar_init(&full[s], 1);
            fvt_bar_init(&empty[s], PT / 32);  // a folding warp releases a stage at once
        }
        s_stop = 0;
    }
    __syncthreads();
    const bool aligned = K % 4 == 0 && (reinterpret_cast<uintptr_t>(logA) & 15) == 0;
    if (tid >= PT) {
        if (tid == PT) {
            ring_produce(logA, K, r0, kr, c0, c1 - c0, aligned,
                         (long long)((N + LG - 1) / LG) * Tm, ring, p.stride, stages, full,
                         empty, &s_stop, err);
        }
        return;
    }

    const int my_c = c0 + tid * CPT;     // this thread's first column
    const bool active = my_c < c1;
    const int lc = active ? tid * CPT : 0;  // its column in a ring slot
    const size_t part_buf = (size_t)p.R * LG * K;
    int s = 0;              // the stage folded next
    uint32_t phase = 0;     // the parity of its fill
    bool waiting = true;    // false once a stage's copies timed out: no further wait
    unsigned int steps = 0, arrivals = 0;
    for (int g0 = 0; g0 < N; g0 += LG) {
        const int nl = min(LG, N - g0);
        for (int t = 0; t < Tm; ++t) {
            float best[LG][CPT];
#pragma unroll
            for (int n = 0; n < LG; ++n) {
#pragma unroll
                for (int j = 0; j < CPT; ++j) best[n][j] = -INFINITY;
            }
            for (int p0 = 0; p0 < kr; p0 += p.carry_rows) {
                const int p1 = min(kr, p0 + p.carry_rows), np = p1 - p0;
                if (p0 > 0) fold_sync();  // the previous pass is done with s_d
                // the carry of the pass's rows: delta0 (whose slice of the
                // history's first row this tile writes out), else the carry
                // the last combine published
                for (int i = tid; i < np * LG; i += PT) {
                    const int n = i / np, lr = p0 + i - n * np, k = r0 + lr;
                    float v = -INFINITY;
                    if (n < nl && t == 0) {
                        v = __ldg(delta0 + (size_t)(g0 + n) * K + k);
                        if (lr >= w0 && lr < w1) deltas[(size_t)(g0 + n) * K + k] = v;
                    } else if (n < nl) {
                        v = __ldcg(carry + (size_t)n * K + k);
                    }
                    s_d[(lr - p0) * LG + n] = v;
                }
                fold_sync();
                for (int lr = p0; lr < p1; lr += SR) {
                    if (waiting && !fvt_bar_wait(&full[s], phase)) {
                        atomicOr(err, ERR_TIMEOUT);
                        waiting = false;
                    }
                    const int rows = min(SR, p1 - lr);
                    const float* st = ring + s * SR * p.stride + lc;
                    const float* rowp = logA + (size_t)(r0 + lr) * K + c0;
                    if (aligned) {
                        ring_fold_stage<LG, CPT, true>(best, s_d + (lr - p0) * LG, st, p.stride,
                                                       rows, rowp, K);
                    } else {
                        ring_fold_stage<LG, CPT, false>(best, s_d + (lr - p0) * LG, st, p.stride,
                                                        rows, rowp, K);
                    }
                    __syncwarp();
                    if ((tid & 31) == 0) fvt_bar_arrive(&empty[s]);
                    if (++s == stages) {
                        s = 0;
                        phase ^= 1;
                    }
                }
            }
            if (active) {
                float* wv = part_v + (steps & 1) * part_buf + (size_t)r * LG * K;
#pragma unroll
                for (int n = 0; n < LG; ++n) {
#pragma unroll
                    for (int j = 0; j < CPT; ++j) {
                        if (my_c + j < c1) wv[(size_t)n * K + my_c + j] = best[n][j];
                    }
                }
            }
            ++steps;
            if (!grid_barrier<true>(count, ++arrivals * nb, err)) {
                // the producer stops too
                if (tid == 0) *reinterpret_cast<volatile int*>(&s_stop) = 1;
                return;
            }
            // two-phase combine, as the resident route's: this block's share
            // of the carry entries of step t from their R partials, then the
            // emission; the second barrier publishes them
            const float* pv = part_v + ((steps - 1) & 1) * part_buf;
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
                    ? emission<EMIT_ROWS>(emit, nullptr, (size_t)t * N + g0 + n, K, k) : 0.0f;
                float bv;
                int ba;
                combine<LG, false>(pv, nullptr, p.R, K, team, m, n, k, live, true, bv, ba);
                if (live && m == 0) {
                    const float d = bv + em;
                    const size_t o = (size_t)(g0 + n) * K + k;
                    carry[(size_t)n * K + k] = d;
                    if (t == Tm - 1) {
                        dfin[o] = d;
                    } else {
                        deltas[(size_t)(t + 1) * N * K + o] = d;
                    }
                }
            }
            if (!grid_barrier<true>(count, ++arrivals * nb, err)) {
                if (tid == 0) *reinterpret_cast<volatile int*>(&s_stop) = 1;
                return;
            }
        }
    }
}

// The whole scan for every group of LG lanes.  emit is emits (Tm, N, K)
// (EMIT_ROWS) or logBT (M, K) with the (Tm, N) symbols ys (EMIT_GATHER).
// part_v / part_i: 2 x R x LG x K partials, two buffers by step parity
// (part_i only WITH_PTR); carry: LG x K, the group's carry (two-phase
// combine only); count: the barrier's arrival count, zero on entry; err: the
// error word, set when a barrier times out (and read at every wait, so a
// scan that shares a word already set stops at its first barrier).  Block b
// walks tiles b, b + gridDim.x, ... of the plan's R x C.  PARTS: the parts
// of a step that run (P_ALL in production).  Without P_STREAM the first
// streamed rows, prefetched once a pass, fold again in place of the rest;
// without P_FOLD every loaded value goes into the partials by one max;
// without P_COMBINE no partial is written or combined, the carry stays the
// first one and a sink of the partials keeps the fold alive; with no part
// a step is its grid barriers alone.  Only P_ALL, and P_ALL less P_HIST
// for dfin, compute the scan.  TA: logA's element type, float or
// __nv_bfloat16 (the tile in shared memory is of the same type).  RING:
// the ring route (ring_scan, RING_PT threads), an fp32 deltas scan of every
// part under a plan whose p.ring is set.
template <int LG, bool WITH_PTR, Emit EMIT, int PARTS, typename TA = float, bool RING = false>
__global__ void __launch_bounds__(RING ? RING_PT : PT, 1)
scan_persistent(const TA* __restrict__ logA, const float* __restrict__ emit,
                const int* __restrict__ ys, const float* __restrict__ delta0,
                float* __restrict__ dfin, int* __restrict__ ptrs,
                float* __restrict__ deltas, float* part_v, int* part_i, float* carry,
                unsigned int* count, unsigned int* err, int Tm, int N, int K, Plan p) {
    if constexpr (RING) {
        static_assert(!WITH_PTR && EMIT == EMIT_ROWS && PARTS == P_ALL && sizeof(TA) == 4,
                      "the ring route is the fp32 deltas scan");
        ring_scan<LG>(logA, emit, delta0, dfin, deltas, part_v, carry, count, err, Tm, N, K, p);
        return;
    }
    constexpr int CPT = cols_per_thread<LG>();
    constexpr int UNROLL = unroll_rows<LG, sizeof(TA)>();
    constexpr bool HIST = PARTS & P_HIST, STREAM = PARTS & P_STREAM, FOLD = PARTS & P_FOLD,
                   COMBINE = PARTS & P_COMBINE, WORK = PARTS != 0;
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const int nb = gridDim.x;
    const int tiles = p.R * p.C;
    float* s_d = smem;                                        // carry_rows x LG, lane-minor
    // rows_smem x stride table values
    TA* s_tile = reinterpret_cast<TA*>(smem + (p.carry_rows * LG + 3) / 4 * 4);
    const int units = (K + CPT - 1) / CPT;
    const bool vec = K % CPT == 0;

    // the block's first tile (its only one unless tiles > nb), and its
    // leading rows, once per launch (a plan with rows in shared memory
    // gives every block one tile)
    Tile tl = tile_of(blockIdx.x, K, units, p);
    if constexpr (WORK) {
        if (p.rows_smem > 0) {
            const int rs = min(p.rows_smem, tl.kr), width = (tl.u1 - tl.u0) * CPT;
            const int c0 = tl.u0 * CPT;
            if constexpr (sizeof(TA) == 4) {
                for (int i = tid; i < rs * width; i += PT) {
                    const int lr = i / width, jc = i - lr * width;
                    cp_async4(s_tile + lr * p.stride + jc,
                              logA + (size_t)(tl.r0 + lr) * K + min(c0 + jc, K - 1));
                }
            } else if (((K | c0 | p.stride) & 1) == 0) {
                // bf16 pairs: an even column of an even row is 4-byte
                // aligned in both memories; a pair past the row's end
                // (columns no thread writes out) copies the row's last pair
                const int pairs = (width + 1) / 2;
                for (int i = tid; i < rs * pairs; i += PT) {
                    const int lr = i / pairs, jc = 2 * (i - lr * pairs);
                    cp_async4(s_tile + lr * p.stride + jc,
                              logA + (size_t)(tl.r0 + lr) * K + min(c0 + jc, K - 2));
                }
            } else {
                for (int i = tid; i < rs * width; i += PT) {
                    const int lr = i / width, jc = i - lr * width;
                    s_tile[lr * p.stride + jc] =
                        logA[(size_t)(tl.r0 + lr) * K + min(c0 + jc, K - 1)];
                }
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    }
    const size_t part_buf = (size_t)p.R * LG * K;
    float sink = -INFINITY;  // without P_COMBINE: the max of every partial

    unsigned int steps = 0;     // steps done, over every group
    unsigned int arrivals = 0;  // grid barriers passed
    for (int g0 = 0; g0 < N; g0 += LG) {
        const int nl = min(LG, N - g0);
        for (int t = 0; t <= Tm; ++t) {
            if constexpr (WORK) for (int q = blockIdx.x; q < tiles; q += nb) {
                if (tiles > nb) tl = tile_of(q, K, units, p);  // a block of several tiles
                const int r0 = tl.r0, kr = tl.kr, w0 = tl.w0, w1 = tl.w1;
                // threads past the group redo its last unit
                const int my_u = min(tl.u0 + tid, tl.u1 - 1);
                const bool active = tl.u0 + tid < tl.u1;
                const int col = my_u * CPT;                     // this thread's first column
                const int rs = min(p.rows_smem, kr);            // tile rows in shared memory
                const TA* my_tile = s_tile + (my_u - tl.u0) * CPT;

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
                    Loaded<TA, CPT> nxt[UNROLL];
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
                            if (!WITH_PTR && HIST && n < nl && lr >= w0 && lr < w1) {
                                deltas[(size_t)(g0 + n) * K + k] = v;
                            }
                        }
                    } else if (p.two_phase) {
                        if constexpr (COMBINE) for (int i = tid; i < np * LG; i += PT) {
                            const int n = i / np, k = r0 + p0 + i - n * np;
                            s_d[(k - r0 - p0) * LG + n] =
                                n < nl ? __ldcg(carry + (size_t)n * K + k) : -INFINITY;
                        }
                    } else if constexpr (COMBINE) {
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
                                    } else if (!WITH_PTR && HIST) {
                                        deltas[(size_t)t * N * K + o] = d;
                                    }
                                }
                            }
                        }
                    }
                    if (t == Tm) continue;
                    __syncthreads();  // the carry (and, the first time, the tile) is in place

                    for (int lr = p0; lr < sm_end; ++lr) {
                        if constexpr (FOLD) {
                            float d[LG], a[CPT];
                            load_carry<LG>(d, s_d + (lr - p0) * LG);
                            load_tile<CPT>(a, my_tile + lr * p.stride);
                            fold<LG, CPT, WITH_PTR>(best, arg, d, a, r0 + lr);
                        } else {
                            float a[CPT];
                            load_tile<CPT>(a, my_tile + lr * p.stride);
                            keep<LG, CPT>(best, a);
                        }
                    }
                    for (int lr = st0; lr < p1; lr += UNROLL) {
                        Loaded<TA, CPT> cur[UNROLL];
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
                        if (STREAM && lr + UNROLL < p1) {
#pragma unroll
                            for (int u = 0; u < UNROLL; ++u) {
                                const int k = r0 + min(lr + UNROLL + u, p1 - 1);
                                load_row<CPT>(nxt[u], logA + (size_t)k * K, col, K, vec);
                            }
                        }
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) {
                            if (lr + u < p1) {
                                float a[CPT];
                                widen<CPT>(a, cur[u]);
                                if constexpr (FOLD) {
                                    float d[LG];
                                    load_carry<LG>(d, s_d + (lr + u - p0) * LG);
                                    fold<LG, CPT, WITH_PTR>(best, arg, d, a, r0 + lr + u);
                                } else {
                                    keep<LG, CPT>(best, a);
                                }
                            }
                        }
                    }
                }
                if (!COMBINE && t < Tm) {
#pragma unroll
                    for (int n = 0; n < LG; ++n) {
#pragma unroll
                        for (int j = 0; j < CPT; ++j) sink = fmaxf(sink, best[n][j]);
                    }
                }
                if (COMBINE && t < Tm && active) {
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
            if constexpr (COMBINE) {
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
                        } else if (!WITH_PTR && HIST) {
                            deltas[(size_t)(t + 1) * N * K + o] = d;
                        }
                    }
                }
            }
            if (!grid_barrier(count, ++arrivals * nb, err)) return;
            if (t == Tm - 1) break;  // dfin is out: no final carry to form
        }
    }
    // no value of the sink is expected: the store keeps the fold it reads
    if (!COMBINE && WORK && sink == INFINITY) part_v[blockIdx.x] = sink;
}

template <int LG, bool WITH_PTR, Emit EMIT, int PARTS, typename TA = float, bool RING = false>
int launch_persistent(const TA* logA, const float* emit, const int* ys,
                      const float* delta0, float* dfin, int* ptrs, float* deltas,
                      float* part_v, int* part_i, float* carry, unsigned int* count,
                      unsigned int* err, int Tm, int N, int K, const int* plan,
                      cudaStream_t stream) {
    const auto kernel = scan_persistent<LG, WITH_PTR, EMIT, PARTS, TA, RING>;
    const int smem = plan[PF_SMEM];
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    Plan p{plan[PF_R], plan[PF_C], plan[PF_ROWS_SMEM], plan[PF_STRIDE], plan[PF_CARRY_ROWS],
           plan[PF_TEAM], plan[PF_TWO_PHASE], plan[PF_RING]};
    void* args[] = {&logA, &emit, &ys, &delta0, &dfin, &ptrs, &deltas, &part_v, &part_i,
                    &carry, &count, &err, &Tm, &N, &K, &p};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(plan[PF_BLOCKS]),
                                    dim3(RING ? RING_PT : PT), args, static_cast<size_t>(smem),
                                    stream);
    return static_cast<int>(e);
}

template <bool WITH_PTR, Emit EMIT, typename TA = float>
int run_scan(const TA* logA, const float* emit, const int* ys, const float* delta0,
             float* dfin, int* ptrs, float* deltas, float* part_v, int* part_i,
             float* carry, unsigned int* count, unsigned int* err, const int* plan, int Tm,
             int N, int K, void* stream, long long* launches) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
#define FVT_SCAN(LG, RING) \
    rc = launch_persistent<LG, WITH_PTR, EMIT, P_ALL, TA, RING>(logA, emit, ys, delta0, dfin, \
                                                                ptrs, deltas, part_v, part_i, \
                                                                carry, count, err, Tm, N, K, \
                                                                plan, s)
    if (plan[PF_RING] != 0) {
        // the ring route: the fp32 deltas scan at 4, 8 and 16 lanes only
        if constexpr (!WITH_PTR && EMIT == EMIT_ROWS && sizeof(TA) == 4) {
            switch (plan[PF_LANES]) {
                case 4: FVT_SCAN(4, true); break;
                case 8: FVT_SCAN(8, true); break;
                case 16: FVT_SCAN(16, true); break;
                default: return static_cast<int>(cudaErrorInvalidValue);
            }
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    } else {
        switch (plan[PF_LANES]) {
            case 1: FVT_SCAN(1, false); break;
            case 2: FVT_SCAN(2, false); break;
            case 4: FVT_SCAN(4, false); break;
            case 8: FVT_SCAN(8, false); break;
            case 16: FVT_SCAN(16, false); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
#undef FVT_SCAN
    if (rc != 0) return rc;
    ++*launches;
    return 0;
}

// The scan-ablation probe's variants, in the order of
// flash_viterbi_tpu_torch/probes/scan.py:VARIANTS: the deltas scan (EMIT_ROWS) with the parts of a step it keeps.  "full" is the
// production instance; "all-streamed" runs it under a plan that holds no
// row in shared memory (the wrapper's choice); the rest cut one part each
// but "barrier-only", which keeps none.
struct Ablation {
    const char* name;
    int parts;
};
constexpr Ablation ABLATION[] = {
    {"full", P_ALL},
    {"no-hist", P_ALL & ~P_HIST},
    {"all-streamed", P_ALL},
    {"no-stream", P_ALL & ~P_STREAM},
    {"no-fold", P_ALL & ~P_FOLD},
    {"no-combine", P_ALL & ~P_COMBINE},
    {"barrier-only", 0},
};
constexpr int N_ABLATION = sizeof(ABLATION) / sizeof(ABLATION[0]);

// One ablation variant at LG lanes a group
template <int LG>
int run_ablation(int variant, const float* logA, const float* emits, const float* delta0,
                 float* dfin, float* deltas, float* part_v, float* carry, unsigned int* count,
                 unsigned int* err, const int* plan, int Tm, int N, int K, cudaStream_t s) {
    static_assert(N_ABLATION == 7, "one case a variant");
#define FVT_ABLATION(V) \
    case V: \
        return launch_persistent<LG, false, EMIT_ROWS, ABLATION[V].parts>( \
            logA, emits, nullptr, delta0, dfin, nullptr, deltas, part_v, nullptr, carry, count, \
            err, Tm, N, K, plan, s)
    switch (variant) {
        FVT_ABLATION(0);
        FVT_ABLATION(1);
        FVT_ABLATION(2);
        FVT_ABLATION(3);
        FVT_ABLATION(4);
        FVT_ABLATION(5);
        FVT_ABLATION(6);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FVT_ABLATION
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
// of the two; the other is null.  plan: the PF_COUNT ints of scan_plan (a
// plan with PF_RING set, the ring route's, takes deltas at 4, 8 or 16 lanes);
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

// fvt_maxplus_scan on a bf16 logA (K, K), 16-byte aligned, under a plan
// made for 2-byte table values (scan_plan(..., elem_bytes=2)); every other
// argument as there.  Pointer or deltas scan as ptrs is given or null.
extern "C" int fvt_maxplus_scan_bf16(const __nv_bfloat16* logA, const float* emits,
                                     const float* delta0, float* dfin, int* ptrs,
                                     float* deltas, float* part_v, int* part_i, float* carry,
                                     unsigned int* count, unsigned int* err, const int* plan,
                                     int Tm, int N, int K, void* stream, long long* launches) {
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
// _abl_kernel): the deltas scan of fvt_maxplus_scan (its arguments, in its
// order; ptrs and part_i null, deltas (Tm, N, K) wherever the variant
// writes the history) as variant `variant` of ABLATION, one cooperative
// launch.  The plan's lanes are 1 or 16: the ablation instantiates those
// two (a group of 16 also runs fewer live lanes); it takes no ring plan.  Only "full",
// "all-streamed" and, for dfin, "no-hist" compute the scan; the others'
// outputs are undefined.  Returns the launch error, or
// cudaErrorInvalidValue for another variant, lane count or a null deltas
// the variant writes.
extern "C" int fvt_maxplus_scan_deltas_ablation(const float* logA, const float* emits,
                                                const float* delta0, float* dfin, int* ptrs,
                                                float* deltas, float* part_v, int* part_i,
                                                float* carry, unsigned int* count,
                                                unsigned int* err, const int* plan, int Tm,
                                                int N, int K, int variant, void* stream,
                                                long long* launches) {
    if (variant < 0 || variant >= N_ABLATION || ptrs != nullptr || part_i != nullptr ||
        plan[PF_RING] != 0 || (deltas == nullptr && (ABLATION[variant].parts & P_HIST) != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
    switch (plan[PF_LANES]) {
        case 1:
            rc = run_ablation<1>(variant, logA, emits, delta0, dfin, deltas, part_v, carry, count,
                                 err, plan, Tm, N, K, s);
            break;
        case 16:
            rc = run_ablation<16>(variant, logA, emits, delta0, dfin, deltas, part_v, carry,
                                  count, err, plan, Tm, N, K, s);
            break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
    ++*launches;
    return 0;
}

// The card's limits: out[0] its L2 bytes, out[1] the most of it that can be
// set aside for persisting accesses, out[2] the SM clock's maximum in kHz,
// out[3] its SMs, out[4] the shared memory and out[5] the 32-bit registers
// of one SM.  Returns the first error.
extern "C" int fvt_device_limits(int device, int* out) {
    const cudaDeviceAttr attrs[] = {
        cudaDevAttrL2CacheSize, cudaDevAttrMaxPersistingL2CacheSize, cudaDevAttrClockRate,
        cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrMaxRegistersPerMultiprocessor};
    for (int i = 0; i < 6; ++i) {
        const cudaError_t e = cudaDeviceGetAttribute(out + i, attrs[i], device);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

extern "C" const char* fvt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
