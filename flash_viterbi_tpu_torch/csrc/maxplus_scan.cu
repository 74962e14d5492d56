// Max-plus trellis scan for Hopper (sm_90a): the N-lane forward recursion
//
//     d_t[n, i] = max_k (d_{t-1}[n, k] + logA[k, i]) + emit_t[n, i]
//     ptr_t[n, i] = lowest k attaining that max          (WITH_PTR)
//     deltas[t][n, :] = d_{t-1}[n, :], the carry before step t   (!WITH_PTR)
//     emit_t[n, i] = logBT[ys[t, n], i]                  (EMIT_GATHER)
//
// Replaces flash_viterbi_tpu/ops/pallas/maxplus.py: maxplus_scan
// (_scan_kernel, and _scan_res_kernel for K <= 1024), maxplus_scan_deltas
// (_scan_deltas_kernel, _scan_res_deltas_kernel),
// maxplus_scan_emitgather (_scan_eg_kernel) and maxplus_step_block
// (_step_tiles_kernel), and the scan-ablation probe of
// scripts/vpu_probe.py (ablation, _abl_kernel), which runs the deltas
// scan's own step with the history write on or off and the staged chunk at
// 128, 256 or 512 source rows.  With EMIT_GATHER the emission row of each lane is
// read from the (M, K) table logBT by the lane's symbol, so no (T', N, K)
// emission buffer exists; the table (794 KB at M=50, K=3968) stays in L2,
// and a step reads one of its rows per lane where the plain scan reads one
// row of emits.
// One kernel serves every K; the ragged column edge is masked, so K need
// not be a multiple of anything.
//
// The step is rectangular: the carry has Ks source entries, logA is
// (Ks, Kd) and a step writes Kd destination columns.  The scans run it at
// Ks = Kd = K.  maxplus_step_block runs one step with EMIT_NONE against a
// column shard logA[:, lo:lo+Kd] of the state-sharded decode: it writes
// the pre-emission max and its lowest source index, a global row index
// because every source row is present.
//
// What bounds it: every step reads all of logA (Ks*Kd*4 bytes; 64 MiB at
// K=4096, more than the 50 MB L2), so a step streams logA from HBM.  The
// design reads that stream once per step for all lanes of a launch: a
// block owns 32 destination columns for up to 16 lanes, each thread keeps
// its lanes' running (max, argmax) in registers, and the block's 16 warps
// split the source rows so 128 blocks x 512 threads keep enough loads in
// flight.  A warp reads 32 neighbouring columns of one logA row
// (coalesced); the carry slice of each source chunk is staged in shared
// memory and read as a warp-wide broadcast.  The host launches one kernel
// per step, ping-ponging the carry between two buffers.  A narrow column
// shard gets few blocks (31 at Kd=992): the source dimension is not split
// across blocks, so such a step uses a quarter of the SMs.
//
// Numerics: fp32 add and max only, emission added after the max, and the
// lowest-index tie rule of argmax.cuh; bit-identical to the plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "argmax.cuh"

namespace {

constexpr int TI = 32;        // destination columns per block: one per thread of a warp
constexpr int WK = 16;        // warps per block, splitting the source dimension
constexpr int KC = 256;       // source rows staged per chunk (the scans' choice)
constexpr int LMAX = 16;      // lanes per launch; more lanes go in groups of 16

// What a step adds after the max: nothing (maxplus_step_block), this
// step's (nl, Kd) emission rows, or rows of the (M, Kd) logBT gathered by
// ys, this step's nl symbols
enum Emit { EMIT_NONE, EMIT_ROWS, EMIT_GATHER };

// dcur (nl, Ks), logA (Ks, Kd), dnext / ptr / dhist (nl, Kd).  Only the
// step block (EMIT_NONE) is rectangular: the scans take Kd = Ks, and the
// compiler sees it, so their code is that of a square step.  WRITE_HIST
// and KCH (the source rows staged a chunk) exist for the scan-ablation
// probe (fvt_maxplus_scan_deltas_ablation); their defaults are the kernels
// every decode runs.
template <int L, bool WITH_PTR, Emit EMIT, bool WRITE_HIST = true, int KCH = KC>
__global__ void __launch_bounds__(TI * WK)
scan_step(const float* __restrict__ logA, const float* __restrict__ dcur,
          const float* __restrict__ emit, const int* __restrict__ ys,
          float* __restrict__ dnext, int* __restrict__ ptr,
          float* __restrict__ dhist, int Ks, int Kd_block, int nl) {
    constexpr int RPW = KCH / WK;  // rows of a chunk each warp takes
    static_assert(KCH % WK == 0, "chunk must split evenly across warps");
    const int Kd = EMIT == EMIT_NONE ? Kd_block : Ks;
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
            if (EMIT == EMIT_NONE) {
                dnext[o] = bv;
            } else {
                dnext[o] = bv + (EMIT == EMIT_GATHER ? emit[(size_t)ys[n] * Kd + i] : emit[o]);
            }
            if (WITH_PTR) {
                ptr[o] = ba;
            } else if (WRITE_HIST) {
                dhist[o] = dcur[o];
            }
        }
    }
}

template <bool WITH_PTR, Emit EMIT>
void launch_step(int nl, dim3 grid, dim3 block, cudaStream_t stream,
                 const float* logA, const float* dcur, const float* emit,
                 const int* ys, float* dnext, int* ptr, float* dhist, int Ks,
                 int Kd = 0) {
    if (nl <= 1) {
        scan_step<1, WITH_PTR, EMIT><<<grid, block, 0, stream>>>(logA, dcur, emit, ys, dnext, ptr, dhist, Ks, Kd, nl);
    } else if (nl <= 2) {
        scan_step<2, WITH_PTR, EMIT><<<grid, block, 0, stream>>>(logA, dcur, emit, ys, dnext, ptr, dhist, Ks, Kd, nl);
    } else if (nl <= 4) {
        scan_step<4, WITH_PTR, EMIT><<<grid, block, 0, stream>>>(logA, dcur, emit, ys, dnext, ptr, dhist, Ks, Kd, nl);
    } else if (nl <= 8) {
        scan_step<8, WITH_PTR, EMIT><<<grid, block, 0, stream>>>(logA, dcur, emit, ys, dnext, ptr, dhist, Ks, Kd, nl);
    } else {
        scan_step<16, WITH_PTR, EMIT><<<grid, block, 0, stream>>>(logA, dcur, emit, ys, dnext, ptr, dhist, Ks, Kd, nl);
    }
}

// Tm launches per group of up to 16 lanes, ping-ponging the carry through
// work (2*N*K floats): step(nl, src, dst, st, t, g0) launches step t of
// the group of lanes g0.., reading the carry src and writing dst; st is
// the step's offset into (Tm, N, K) outputs.
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
            step(nl, src, dst, (size_t)t * NK + off, t, g0);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return static_cast<int>(err);
            ++*launches;
        }
    }
    return 0;
}

// The scan.  With EMIT_ROWS, emit is emits (Tm, N, K) and ys is null; with
// EMIT_GATHER, emit is logBT (M, K) and ys the (Tm, N) symbols.
template <Emit EMIT>
int run_scan(const float* logA, const float* emit, const int* ys,
             const float* delta0, float* dfin, int* ptrs, float* deltas,
             float* work, int Tm, int N, int K, cudaStream_t s,
             long long* launches) {
    const dim3 block(TI, WK);
    const dim3 grid((K + TI - 1) / TI);
    return for_each_step(delta0, dfin, work, Tm, N, K, launches,
                         [&](int nl, const float* src, float* dst, size_t st, int t, int g0) {
        const float* e = EMIT == EMIT_GATHER ? emit : emit + st;
        const int* y = EMIT == EMIT_GATHER ? ys + (size_t)t * N + g0 : nullptr;
        if (ptrs != nullptr) {
            launch_step<true, EMIT>(nl, grid, block, s, logA, src, e, y, dst,
                                    ptrs + st, nullptr, K);
        } else {
            launch_step<false, EMIT>(nl, grid, block, s, logA, src, e, y, dst,
                                     nullptr, deltas + st, K);
        }
    });
}

// The deltas scan as the ablation probe runs it: always the 16-lane
// instantiation (every group of the probe's shapes has 16 lanes, so it is
// the kernel production launches there), with or without the history
// write, at KCH source rows a chunk.
template <bool WRITE_HIST, int KCH>
int run_ablation(const float* logA, const float* emits, const float* delta0,
                 float* dfin, float* deltas, float* work, int Tm, int N, int K,
                 cudaStream_t s, long long* launches) {
    const dim3 block(TI, WK);
    const dim3 grid((K + TI - 1) / TI);
    return for_each_step(delta0, dfin, work, Tm, N, K, launches,
                         [&](int nl, const float* src, float* dst, size_t st, int, int) {
        scan_step<LMAX, false, EMIT_ROWS, WRITE_HIST, KCH><<<grid, block, 0, s>>>(
            logA, src, emits + st, nullptr, dst, nullptr,
            WRITE_HIST ? deltas + st : nullptr, K, 0, nl);
    });
}

}  // namespace

// The whole scan.  Layouts are those of the JAX functions: logA (K, K),
// emits (Tm, N, K), delta0 (N, K), dfin (N, K), ptrs (Tm, N, K) int32 or
// deltas (Tm, N, K) float32 -- pass exactly one of the two; the other is
// null.  work holds 2*N*K floats for the carry ping-pong.  Tm >= 1.
// Returns the first launch error.
extern "C" int fvt_maxplus_scan(const float* logA, const float* emits,
                                const float* delta0, float* dfin, int* ptrs,
                                float* deltas, float* work, int Tm, int N,
                                int K, void* stream, long long* launches) {
    return run_scan<EMIT_ROWS>(logA, emits, nullptr, delta0, dfin, ptrs, deltas,
                           work, Tm, N, K, static_cast<cudaStream_t>(stream),
                           launches);
}

// fvt_maxplus_scan with in-kernel emission gather: logBT (M, K) and the
// (Tm, N) int32 symbols ys in place of emits.  Every symbol must lie in
// [0, M): the kernel reads logBT without a bound check.
extern "C" int fvt_maxplus_scan_eg(const float* logA, const float* logBT,
                                   const int* ys, const float* delta0,
                                   float* dfin, int* ptrs, float* deltas,
                                   float* work, int Tm, int N, int K,
                                   void* stream, long long* launches) {
    return run_scan<EMIT_GATHER>(logA, logBT, ys, delta0, dfin, ptrs, deltas, work,
                          Tm, N, K, static_cast<cudaStream_t>(stream), launches);
}

// One trellis step against a column shard: delta (N, Ks), logA_block
// (Ks, Kd), both row-major; writes the pre-emission val (N, Kd) and ptr
// (N, Kd), the lowest source row in [0, Ks) attaining each max.  One
// launch per group of up to 16 lanes.  N, Ks, Kd >= 1.  Returns the first
// launch error.
extern "C" int fvt_maxplus_step_block(const float* delta, const float* logA_block,
                                      float* val, int* ptr, int N, int Ks, int Kd,
                                      void* stream, long long* launches) {
    const dim3 block(TI, WK);
    const dim3 grid((Kd + TI - 1) / TI);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int g0 = 0; g0 < N; g0 += LMAX) {
        const int nl = N - g0 < LMAX ? N - g0 : LMAX;
        launch_step<true, EMIT_NONE>(nl, grid, block, s, logA_block,
                                     delta + (size_t)g0 * Ks, nullptr, nullptr,
                                     val + (size_t)g0 * Kd, ptr + (size_t)g0 * Kd,
                                     nullptr, Ks, Kd);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        ++*launches;
    }
    return 0;
}

// The scan-ablation probe (replaces scripts/vpu_probe.py: ablation,
// _abl_kernel): fvt_maxplus_scan without pointers, with (write_hist != 0,
// deltas (Tm, N, K)) or without (deltas null) the carry history, staging
// kc source rows a chunk, kc in {128, 256, 512} (1024 would take 64 KB of
// static shared memory at 16 lanes, above the 48 KB limit).  dfin is the
// same in every mode.  Returns the first launch error, or
// cudaErrorInvalidValue for another kc.
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

extern "C" const char* fvt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
