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
// one contiguous logAT row), 31.7 KB at K=3968: T' dependent round trips
// to L2 or device memory, not the bytes.
//
// Design: one block of THREADS threads per lane, N blocks, no state across
// blocks.  A step reads the logAT row of s with 16-byte loads spread over
// the whole block (scalar loads for the few columns before the row's first
// 16-byte boundary and after its last), so the row costs one round trip,
// and reduces (value, index) by warp shuffles and one shared-memory round
// under argmax.cuh's tie rule, after which every thread holds the same s.
// The carry rows do not depend on s: thread 0 bulk-copies them, one walked
// row ahead, into a ring of shared-memory buffers (two; three for rows
// wider than CHMAX columns, which come in chunks), so only the logAT row
// waits on the previous step.  A carry row that starts or ends off a
// 16-byte boundary is copied from the boundary below its start to the one
// below its end; the last few columns past that are read from global.
//
// The caller passes logAT = logA transposed and contiguous (one K*K copy
// per decode; caching it across decodes is left for a later change); both
// it and deltas 16-byte aligned.  valid is (Tm, N) bytes (torch.bool) or
// null for all rows valid.  A last state outside [0, K) has no logAT row:
// that lane's path is written as -1.  A ring wait gives up after about a
// second and sets the error word (async_copy.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "argmax.cuh"
#include "async_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHMAX = 16384;  // carry columns a ring buffer holds
constexpr int NB_MAX = 3;

struct Ring {
    int ch;   // columns a chunk, a multiple of 4
    int nch;  // chunks a row
    int nb;   // buffers, each ch + 4 floats
};

Ring ring_for(int K) {
    const int ch = K <= CHMAX ? (K + 3) / 4 * 4 : CHMAX;
    const int nch = (K + ch - 1) / ch;
    return Ring{ch, nch, nch == 1 ? 2 : NB_MAX};
}

__device__ __forceinline__ void take(float v, int k, float& best, int& arg) {
    if (fvt_better(v, k, best, arg)) {
        best = v;
        arg = k;
    }
}

__global__ void __launch_bounds__(THREADS)
walk_kernel(const float* __restrict__ deltas, const float* __restrict__ logAT,
            const int* __restrict__ last, const unsigned char* __restrict__ valid,
            int* __restrict__ out, int* __restrict__ err, int Tm, int N, int K, Ring rg) {
    extern __shared__ __align__(128) float buf[];  // nb buffers of ch + 4 floats
    __shared__ __align__(8) uint64_t s_bar[NB_MAX];
    __shared__ float s_v[2][WARPS];
    __shared__ int s_i[2][WARPS];
    const int n = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* path = out + (size_t)n * (Tm + 1);
    int s = last[n];
    if (s < 0 || s >= K) {  // the whole block leaves together
        for (int t = tid; t <= Tm; t += THREADS) path[t] = -1;
        return;
    }
    auto walked = [&](int t) { return valid == nullptr || valid[(size_t)t * N + n] != 0; };
    if (tid == 0) {
        path[Tm] = s;
        for (int b = 0; b < rg.nb; ++b) fvt_bar_init(&s_bar[b], 1);
    }
    __syncthreads();

    // thread 0's copy cursor: walked row ti, chunk ci; the items issued
    int ti = Tm - 1, ci = 0;
    long long issued = 0;
    while (ti >= 0 && !walked(ti)) --ti;
    auto issue = [&]() {
        if (ti < 0) return;
        const int b = static_cast<int>(issued % rg.nb);
        const size_t off = ((size_t)ti * N + n) * K + (size_t)ci * rg.ch;
        const size_t len = min(rg.ch, K - ci * rg.ch);
        const size_t a0 = off & ~(size_t)3, e0 = (off + len) & ~(size_t)3;
        if (e0 > a0) {
            fvt_fence_proxy_async();
            fvt_bar_arrive_expect(&s_bar[b], static_cast<uint32_t>((e0 - a0) * 4));
            fvt_bulk_load(buf + (size_t)b * (rg.ch + 4), deltas + a0,
                          static_cast<uint32_t>((e0 - a0) * 4), &s_bar[b]);
        } else {
            fvt_bar_arrive(&s_bar[b]);
        }
        ++issued;
        if (++ci == rg.nch) {
            ci = 0;
            do --ti;
            while (ti >= 0 && !walked(ti));
        }
    };
    if (tid == 0) {
        for (int b = 0; b < rg.nb; ++b) issue();
    }

    long long used = 0;
    bool broken = false;
    int row = 0;  // walked rows so far: the reduction's buffer
    for (int t = Tm - 1; t >= 0; --t) {
        if (!walked(t)) {
            if (tid == 0) path[t] = s;
            continue;
        }
        const float* a = logAT + (size_t)s * K;
        const float* drow = deltas + ((size_t)t * N + n) * K;
        float best = -INFINITY;
        int arg = K;
        for (int c = 0; c < rg.nch; ++c, ++used) {
            const int b = static_cast<int>(used % rg.nb);
            if (!broken && !fvt_bar_wait(&s_bar[b], static_cast<uint32_t>((used / rg.nb) & 1))) {
                broken = true;
                atomicOr(err, 1);
            }
            const int k0 = c * rg.ch, len = min(rg.ch, K - k0);
            const size_t off = ((size_t)t * N + n) * K + k0;
            const int copied = static_cast<int>(((off + len) & ~(size_t)3) > off
                                                    ? ((off + len) & ~(size_t)3) - off
                                                    : 0);
            const float* d = buf + (size_t)b * (rg.ch + 4) + (off & 3);
            auto carry = [&](int k) { return k - k0 < copied ? d[k - k0] : drow[k]; };
            const int head = min(len, static_cast<int>((4 - (((size_t)s * K + k0) & 3)) & 3));
            const int quads = (len - head) / 4;
            const int kq = k0 + head;  // the first 16-byte-aligned column of the logAT row
            if (tid < head) take(carry(k0 + tid) + a[k0 + tid], k0 + tid, best, arg);
            for (int q = tid; q < quads; q += THREADS) {
                const int k = kq + 4 * q;
                const float4 av = *reinterpret_cast<const float4*>(a + k);
                take(carry(k) + av.x, k, best, arg);
                take(carry(k + 1) + av.y, k + 1, best, arg);
                take(carry(k + 2) + av.z, k + 2, best, arg);
                take(carry(k + 3) + av.w, k + 3, best, arg);
            }
            const int kt = kq + 4 * quads + tid;  // the row's last few columns
            if (kt < k0 + len) take(carry(kt) + a[kt], kt, best, arg);
            if (c + 1 < rg.nch) {  // a chunk's buffer is free: refill it
                __syncthreads();
                if (tid == 0) issue();
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, o);
            const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
            take(ov, oa, best, arg);
        }
        const int h = row & 1;
        if (lane == 0) {
            s_v[h][warp] = best;
            s_i[h][warp] = arg;
        }
        __syncthreads();
        if (tid == 0) issue();  // the row's last buffer is free
        best = s_v[h][0];
        arg = s_i[h][0];
        for (int w = 1; w < WARPS; ++w) take(s_v[h][w], s_i[h][w], best, arg);
        s = arg;
        if (tid == 0) path[t] = s;
        ++row;
    }
}

}  // namespace

// deltas (Tm, N, K) f32 and logAT (K, K) f32, both 16-byte aligned; last
// (N,) int32; valid (Tm, N) bool or null; out (N, Tm + 1) int32; err one
// int32, ORed with 1 when a ring wait timed out.  One launch of N blocks.
extern "C" int fvt_argmax_walk(const float* deltas, const float* logAT, const int* last,
                               const unsigned char* valid, int* out, int* err, int Tm, int N,
                               int K, void* stream, long long* launches) {
    const Ring rg = ring_for(K);
    const size_t smem = (size_t)rg.nb * (rg.ch + 4) * 4;
    cudaError_t e = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    walk_kernel<<<N, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(deltas, logAT, last,
                                                                         valid, out, err, Tm, N,
                                                                         K, rg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
