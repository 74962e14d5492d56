// The pointer walk's dependent step, shared by backtrack.cu (its serial
// plan and its phase C) and probe_copy.cu (the global-memory latency chase).
//
// ptrs (Tm, N, K) int32: row t holds lane n's predecessors for the step into
// t+1.  Walking back from the state s at t1, for t = t1-1 down to t0:
//
//     s = s in [0, K) ? ptrs[t, n, s] : -1,   path[t] = max(s, -1)
//
// the TPU kernel's rule (flash_viterbi_tpu/ops/pallas/backtrack.py:
// _bt_kernel selects the lane equal to s, else -1, and takes the max).  The
// chain carries each entry as loaded: any negative one fails the next
// step's test as -1 does, so only the stored state takes the max (on the
// chain it cost the walk 4-11% at 16-64 lanes on an H100).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void fvt_walk_rows(const int* __restrict__ ptrs,
                                              int* __restrict__ path, int s, int t0, int t1,
                                              int n, int N, int K) {
    for (int t = t1 - 1; t >= t0; --t) {
        s = (unsigned)s < (unsigned)K ? __ldg(ptrs + ((size_t)t * N + n) * K + s) : -1;
        path[t] = max(s, -1);
    }
}
