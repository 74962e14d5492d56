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
// which are two instructions on this card (FADD and FMNMX; no fused
// add-max exists).  What bounds it: the issue rate.  An SM issues one warp
// instruction a clock on each of its four sub-partitions, so it does at
// most 64 cells a clock: 4.0 us for R=64 over 512 x 512 at 132 SMs and
// 1.98 GHz (flash_viterbi_tpu_torch/bench/bounds.py).
//
// Design: one launch of exactly the blocks the card keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, the wrapper's
// plan), so no block waits for another to leave.  A thread takes pairs of
// elements, p and p + half (half = ceil(n / 2)), and runs both elements'
// four chains interleaved: eight independent chains in registers, enough
// to hide the add's and the max's latency with few warps a sub-partition.
// The pairs go to warps in an order that spreads them over every block
// (global warp w * gridDim.x + block, 32 consecutive pairs a warp, so loads
// stay coalesced), and the grid strides over them; an odd n leaves its last
// pair one element.  probes/alu.py:thread_elements mirrors the walk.  The
// multiplies by powers of two are exact, so whether the compiler contracts
// the first round's multiply and add into an FMA does not change a bit.
//
// With a clock buffer each block's first thread records clock64() at its
// start and, after the block's last warp is done, at its end, and the SM
// it ran on (%smid): the cycles of a call, on each SM's own counter.
//
// SASS (cuobjdump -sass of the library built for sm_90a by CUDA 12.8, read
// by probes/alu.py:sass_counts): 525 FADD, 516 FMNMX, 14 FMUL and 6 FFMA,
// first rounds' multiply and add contracted (exact, as above).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // probes/alu.py: THREADS
constexpr int WARPS = THREADS / 32;

// E elements' chains, interleaved: each element's operations in
// _vpu_kernel's order
template <int E>
__device__ __forceinline__ void chains(const float (&xv)[E], float (&res)[E], int R) {
    float y[E][4];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        y[e][0] = xv[e] * 0.5f;
        y[e][1] = xv[e] * 0.25f;
        y[e][2] = xv[e] * 0.125f;
        y[e][3] = xv[e] * 0.0625f;
    }
#pragma unroll 32
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
            for (int c = 0; c < 4; ++c) y[e][c] = fmaxf(y[e][c] + xv[e], y[e][c]);
        }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) res[e] = ((y[e][0] + y[e][1]) + y[e][2]) + y[e][3];
}

__global__ void __launch_bounds__(THREADS)
alu_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int half, int R,
           long long* __restrict__ clk) {
    long long t0 = 0;
    if (clk != nullptr && threadIdx.x == 0) t0 = clock64();
    const int lane = threadIdx.x & 31;
    const int all_warps = gridDim.x * WARPS;
    for (int gw = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; gw < (half + 31) / 32;
         gw += all_warps) {
        const int p = gw * 32 + lane;
        if (p >= half) continue;
        const int q = p + half;
        if (q < n) {
            const float xv[2] = {x[p], x[q]};
            float res[2];
            chains<2>(xv, res, R);
            out[p] = res[0];
            out[q] = res[1];
        } else {
            const float xv[1] = {x[p]};
            float res[1];
            chains<1>(xv, res, R);
            out[p] = res[0];
        }
    }
    if (clk != nullptr) {
        __syncthreads();  // the block's last warp is done
        if (threadIdx.x == 0) {
            unsigned int sm;
            asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
            long long* c = clk + 3 * blockIdx.x;
            c[0] = t0;
            c[1] = clock64();
            c[2] = sm;
        }
    }
}

}  // namespace

// Blocks of alu_kernel one SM keeps resident, or a negative CUDA error.
extern "C" int fvt_probe_alu_blocks_per_sm(void) {
    int blocks = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, alu_kernel, THREADS, 0);
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// x and out hold n floats; half = (n + 1) / 2; R >= 0 rounds; blocks of
// THREADS threads (the resident grid); clk null or 3 x blocks int64 (start,
// end, SM of each block).  One launch.  Returns the launch error.
extern "C" int fvt_probe_alu(const float* x, float* out, int n, int half, int R, int blocks,
                             long long* clk, void* stream, long long* launches) {
    if (n < 1 || half != (n + 1) / 2 || blocks < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    alu_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, half, R,
                                                                          clk);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
