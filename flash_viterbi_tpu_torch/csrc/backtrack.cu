// Reverse pointer walk over N lanes for Hopper (sm_90a).
//
// Replaces flash_viterbi_tpu/ops/pallas/backtrack.py:
// backtrack_pallas_batched (_bt_kernel).  ptrs (Tm, N, K) int32: row t holds
// lane n's predecessors for the step into t+1; last (N,) int32; out
// (N, Tm+1) int32 with out[n, Tm] = last[n] and, walking back,
//
//     out[n, t] = step(ptrs[t, n], out[n, t+1]),
//     step(row, s) = s in [0, K) ? max(row[s], -1) : -1
//
// the TPU kernel's rule (it selects the lane that equals s, else -1, and
// takes the max): an entry below -1 reads as -1, one of K or more is
// written as it is and -1 follows.
//
// What bounds it.  Walked one step after another, a lane costs Tm
// dependent loads (0.19-0.20 us a step back to back on an H100) and reads
// 4 bytes a step.  The walk composes Tm index maps, so it can be regrouped
// (as fold_planes.cu regroups its fold): the bound is then the table's
// bytes, read once, plus a short dependent chain.
//
// Design: one launch, the plan of ops/cuda/backtrack.py:backtrack_plan.
//   serial (G = 1) one thread a lane walks its Tm rows from last[n]
//            (pointer_walk.cuh): the short walks and the wide batches,
//            where the phases below cannot win.
//   chunked (G > 1) `blocks` CTAs of THREADS.  The Tm rows split into G
//            chunks of L rows, the last one ragged.
//   phase A  Fold every chunk c of every lane n into its map V_{n,c}, from
//            the identity, the chunk's rows from the latest back:
//            V[k] <- step(row_t, V[k]).  A work item is (c, n, slice): the
//            plan cuts K into S slices so that N = 1 at short Tm still
//            fills the SMs; a CTA takes items blockIdx.x, + blocks, ...
//            A thread keeps its E entries of V in registers (E a template
//            argument: a loop of 16 predicated entries cost ~0.5 us a row
//            in instructions alone) and reads each row's entries where
//            they are used, its E loads of a row independent: a row is one
//            dependent round trip.  (Rows bulk-copied through a ring in
//            shared memory, as the fold's phase A reads them, were faster
//            only at K = 16384, by ~10%, and need bounded waits and an error
//            word: PERF.md, scripts/torch_backtrack_turns.py.)  The maps go
//            to a global scratch of N x G x K int32.
//   then     Each CTA takes a ticket; the last one (no CTA waits for
//            another: no grid barrier, no co-residency needed, no wait that
//            could hang) resets the ticket for the next call and finishes:
//   phase B  a thread a lane walks the chunk boundaries, b[G] = last[n],
//            b[c] = b[c+1] in [0, K) ? V_{n,c}[b[c+1]] : -1: G dependent
//            loads through L2 (__ldcg: written during this launch);
//   phase C  a thread a (lane, chunk) walks its rows from b[c+1] and writes
//            the path: L dependent loads.
// So the dependent chain is ~L row round trips, G + L global loads and
// one ticket, against Tm loads walked serially.

#include <cuda_runtime.h>

#include "pointer_walk.cuh"

namespace {

constexpr int THREADS = 512;        // threads of a chunked CTA (ops/cuda/backtrack.py)
constexpr int SERIAL_THREADS = 32;  // threads of a serial block

// the plan's int array (ops/cuda/backtrack.py: BacktrackPlan.c_args)
enum PlanField { F_G, F_L, F_S, F_BLOCKS, F_E, F_COUNT };

struct Plan {
    int G;       // chunks (1: the serial walk)
    int L;       // rows a chunk; the last chunk holds Tm - (G - 1) L
    int S;       // slices of K a chunk's map is folded in, a CTA each
    int blocks;  // CTAs of a chunked launch
};

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
backtrack_kernel(const int* __restrict__ ptrs, const int* __restrict__ last,
                 int* __restrict__ out, int* scratch, unsigned int* ticket, Plan p, int Tm,
                 int N, int K) {
    if (p.G == 1) {  // serial: a thread a lane
        const int n = blockIdx.x * blockDim.x + threadIdx.x;
        if (n >= N) return;
        int* path = out + (size_t)n * (Tm + 1);
        path[Tm] = last[n];
        fvt_walk_rows(ptrs, path, last[n], 0, Tm, n, N, K);
        return;
    }

    __shared__ int s_last;
    const int tid = threadIdx.x;
    const int G = p.G, L = p.L, S = p.S;
    int* maps = scratch;                       // (N, G, K)
    int* bounds = scratch + (size_t)N * G * K;  // (N, G + 1)

    // ---- phase A: the maps; item it = (c * N + n) * S + s: chunk c's rows
    // [c L, end), K slice s
    for (int it = blockIdx.x; it < G * N * S; it += p.blocks) {
        const int s = it % S, n = (it / S) % N, c = it / (S * N);
        const int end = min((c + 1) * L, Tm);
        const int lo = static_cast<int>((long long)s * K / S);
        const int hi = static_cast<int>((long long)(s + 1) * K / S);
        int v[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int k = lo + tid + j * THREADS;
            v[j] = k < hi ? k : -1;
        }
        for (int t = end - 1; t >= c * L; --t) {  // entries as loaded, as in fvt_walk_rows
            const int* row = ptrs + ((size_t)t * N + n) * K;
#pragma unroll
            for (int j = 0; j < E; ++j) {
                v[j] = (unsigned)v[j] < (unsigned)K ? __ldg(row + v[j]) : -1;
            }
        }
        int* map = maps + ((size_t)n * G + c) * K;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int k = lo + tid + j * THREADS;
            if (k < hi) map[k] = max(v[j], -1);
        }
    }

    // ---- the last CTA to finish phase A walks on
    __threadfence();  // this thread's maps are visible before its CTA's ticket
    __syncthreads();
    if (tid == 0) {
        s_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(p.blocks) - 1u;
        if (s_last) {
            *ticket = 0;  // every CTA has taken its ticket: ready for the next call
            __threadfence();
        }
    }
    __syncthreads();
    if (!s_last) return;

    // ---- phase B: the chunk boundaries
    for (int n = tid; n < N; n += THREADS) {
        int s = last[n];
        int* b = bounds + (size_t)n * (G + 1);
        b[G] = s;
        for (int c = G - 1; c >= 0; --c) {
            s = (unsigned)s < (unsigned)K ? __ldcg(maps + ((size_t)n * G + c) * K + s) : -1;
            b[c] = s;
        }
    }
    __syncthreads();

    // ---- phase C: the path, a thread a (lane, chunk)
    for (int w = tid; w < N * G; w += THREADS) {
        const int n = w / G, c = w % G;
        int* path = out + (size_t)n * (Tm + 1);
        if (c == G - 1) path[Tm] = last[n];
        fvt_walk_rows(ptrs, path, __ldcg(bounds + (size_t)n * (G + 1) + c + 1), c * L,
                      min((c + 1) * L, Tm), n, N, K);
    }
}

template <int E>
void launch(const Plan& p, cudaStream_t s, const int* ptrs, const int* last, int* out,
            int* scratch, unsigned int* ticket, int Tm, int N, int K) {
    if (p.G == 1) {
        backtrack_kernel<E><<<(N + SERIAL_THREADS - 1) / SERIAL_THREADS, SERIAL_THREADS, 0, s>>>(
            ptrs, last, out, scratch, ticket, p, Tm, N, K);
    } else {
        backtrack_kernel<E><<<p.blocks, THREADS, 0, s>>>(ptrs, last, out, scratch, ticket, p, Tm,
                                                         N, K);
    }
}

}  // namespace

// ptrs (Tm, N, K) int32, last (N,) int32, out (N, Tm + 1) int32; for a
// chunked plan also scratch (N x G x K + N x (G + 1) int32) and ticket (one
// word, zero before the launch; the launch leaves it zero).  plan: F_COUNT
// ints (BacktrackPlan.c_args), E in {1, 2, 4, 8, 16} (1 for the serial
// walk).  One launch.  Returns the first CUDA error, or
// cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int fvt_backtrack(const int* ptrs, const int* last, int* out, int* scratch,
                             unsigned int* ticket, const int* plan, int Tm, int N, int K,
                             void* stream, long long* launches) {
    const Plan p{plan[F_G], plan[F_L], plan[F_S], plan[F_BLOCKS]};
    const int E = plan[F_E];
    const bool ok =
        p.G == 1 ? p.L == Tm
                 : (p.G > 1 && p.L >= 1 && (long long)(p.G - 1) * p.L < Tm &&
                    (long long)p.G * p.L >= Tm && p.S >= 1 &&
                    (long long)E * THREADS * p.S >= K && p.blocks >= 1 &&
                    p.blocks <= p.G * N * p.S && scratch != nullptr && ticket != nullptr);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (E) {
        case 1: launch<1>(p, s, ptrs, last, out, scratch, ticket, Tm, N, K); break;
        case 2: launch<2>(p, s, ptrs, last, out, scratch, ticket, Tm, N, K); break;
        case 4: launch<4>(p, s, ptrs, last, out, scratch, ticket, Tm, N, K); break;
        case 8: launch<8>(p, s, ptrs, last, out, scratch, ticket, Tm, N, K); break;
        case 16: launch<16>(p, s, ptrs, last, out, scratch, ticket, Tm, N, K); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
