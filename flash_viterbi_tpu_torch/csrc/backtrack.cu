// Reverse pointer walk over N lanes for Hopper (sm_90a).
//
// Replaces flash_viterbi_tpu/ops/pallas/backtrack.py:
// backtrack_pallas_batched (_bt_kernel).  ptrs (Tm, N, K) int32: row t holds
// lane n's predecessors for the step into t+1; last (N,) int32; out
// (N, Tm+1) int32 with out[n, Tm] = last[n].
//
// What bounds it: latency.  Each step is one dependent 4-byte load whose
// address comes from the previous load, so a lane costs Tm load latencies
// and the bytes are negligible.  One thread walks one lane; lanes run in
// parallel.  Prefetching the rows of the next time chunk is left for a
// later change.
//
// A state outside [0, K) has no row to follow: the walk writes -1 from there
// on and reads nothing, as the TPU kernel does.

#include <cuda_runtime.h>

namespace {

__global__ void backtrack_kernel(const int* __restrict__ ptrs,
                                 const int* __restrict__ last,
                                 int* __restrict__ out, int Tm, int N, int K) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    int* path = out + (size_t)n * (Tm + 1);
    int s = last[n];
    path[Tm] = s;
    for (int t = Tm - 1; t >= 0; --t) {
        s = (s >= 0 && s < K) ? ptrs[((size_t)t * N + n) * K + s] : -1;
        path[t] = s;
    }
}

}  // namespace

extern "C" int fvt_backtrack(const int* ptrs, const int* last, int* out,
                             int Tm, int N, int K, void* stream,
                             long long* launches) {
    const int block = 32;
    backtrack_kernel<<<(N + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(ptrs, last, out, Tm, N, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
