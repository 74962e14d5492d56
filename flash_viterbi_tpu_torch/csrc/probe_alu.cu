// Add+max throughput probe for Hopper (sm_90a)
//
// Replaces scripts/vpu_probe.py: vpu_peak (_vpu_kernel, pallas_call at
// :67).  It computes _vpu_kernel's function exactly, element by element:
//
//     y_c = x * s_c                      for s = 0.5, 0.25, 0.125, 0.0625
//     R times, for each c:  y_c = max(y_c + x, y_c)
//     out = ((y_0 + y_1) + y_2) + y_3
//
// One cell is one add and one max, the work of a max-plus trellis cell,
// which are two instructions on this card (FADD and FMNMX: no fused
// add-max exists, so the published fp32 peak, which counts an FMA as two
// operations, is not this mix's rate).
//
// Design: one thread per element keeps its four chains in registers, so
// the loop reads and writes no memory and the time is the ALU's.  Four
// independent chains a thread and a full card of warps hide the add's and
// the max's latency (a single dependent chain would measure latency, not
// throughput).  The multiplies by powers of two are exact, so whether the
// compiler contracts the first round's multiply and add into an FMA does
// not change a bit.
//
// SASS (cuobjdump -sass of the library built for sm_90a by CUDA 12.8,
// read by probes/alu.py:sass_counts): 135 FADD, 132 FMNMX, 4 FMUL, no
// FFMA.  The loop body unrolled 32 times holds 128 FADD and 128 FMNMX; the
// remainder loop holds 4 of each, and the sum 3 FADD.  Nothing is folded
// away, and no multiply and add were contracted.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
alu_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int R) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float xv = x[i];
    float y0 = xv * 0.5f;
    float y1 = xv * 0.25f;
    float y2 = xv * 0.125f;
    float y3 = xv * 0.0625f;
#pragma unroll 32
    for (int r = 0; r < R; ++r) {
        y0 = fmaxf(y0 + xv, y0);
        y1 = fmaxf(y1 + xv, y1);
        y2 = fmaxf(y2 + xv, y2);
        y3 = fmaxf(y3 + xv, y3);
    }
    out[i] = ((y0 + y1) + y2) + y3;
}

}  // namespace

// x and out hold n floats; R >= 0 rounds.  One launch.  Returns the
// launch error.
extern "C" int fvt_probe_alu(const float* x, float* out, int n, int R, void* stream,
                             long long* launches) {
    alu_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, n, R);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
