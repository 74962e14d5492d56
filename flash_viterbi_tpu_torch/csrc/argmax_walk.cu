// Recompute-argmax backtrack over a carry history for Hopper (sm_90a):
//
//     s_Tm = last[n]
//     s_t  = lowest argmax_k (deltas[t][n, k] + logAT[s_{t+1}, k])
//            where valid[t, n], else s_{t+1}
//
// Replaces flash_viterbi_tpu/ops/pallas/backtrack.py: argmax_walk_pallas,
// all of its routes (_walk_kernel with the _xla_walk_rows tail for the rows
// that do not fill a chunk of 8, _walk_kernel_resident and
// _walk_kernel_resident_small).  Those routes exist because of the TPU's
// memory limits; this one kernel walks every row of every shape.
//
// What bounds it: latency.  Row t's state decides which logAT row row t-1
// reads, so rows are serial; each row reads 2*K*4 bytes (the carry row and
// one contiguous logAT row).  One warp walks one lane: its 32 threads read
// neighbouring elements of both rows (coalesced), keep a running
// (max, argmax), and combine with a shuffle butterfly under the tie rule of
// argmax.cuh, so every thread ends with the same state.  Lanes run in
// parallel, one warp each.
//
// The caller passes logAT = logA transposed and contiguous (one K*K copy
// per decode; caching it across decodes is left for a later change).
// valid is (Tm, N) bytes (torch.bool) or null for all rows valid.  A last
// state outside [0, K) has no logAT row: that lane's path is written as -1.

#include <cuda_runtime.h>
#include <math.h>

#include "argmax.cuh"

namespace {

constexpr int WARPS = 4;  // lanes per block

__global__ void __launch_bounds__(32 * WARPS)
walk_kernel(const float* __restrict__ deltas, const float* __restrict__ logAT,
            const int* __restrict__ last, const unsigned char* __restrict__ valid,
            int* __restrict__ out, int Tm, int N, int K) {
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (n >= N) return;  // the whole warp leaves together
    int* path = out + (size_t)n * (Tm + 1);
    int s = last[n];
    if (s < 0 || s >= K) {
        for (int t = lane; t <= Tm; t += 32) path[t] = -1;
        return;
    }
    if (lane == 0) path[Tm] = s;
    for (int t = Tm - 1; t >= 0; --t) {
        if (valid == nullptr || valid[(size_t)t * N + n]) {
            const float* d = deltas + ((size_t)t * N + n) * K;
            const float* a = logAT + (size_t)s * K;
            float best = -INFINITY;
            int arg = K;
#pragma unroll 4
            for (int k = lane; k < K; k += 32) {
                const float v = d[k] + a[k];
                if (fvt_better(v, k, best, arg)) {
                    best = v;
                    arg = k;
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, best, off);
                const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
                if (fvt_better(ov, oa, best, arg)) {
                    best = ov;
                    arg = oa;
                }
            }
            s = arg;
        }
        if (lane == 0) path[t] = s;
    }
}

}  // namespace

extern "C" int fvt_argmax_walk(const float* deltas, const float* logAT,
                               const int* last, const unsigned char* valid,
                               int* out, int Tm, int N, int K, void* stream,
                               long long* launches) {
    walk_kernel<<<(N + WARPS - 1) / WARPS, 32 * WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(deltas, logAT, last, valid,
                                                       out, Tm, N, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
