// Top-B beam scan for Hopper (sm_90a): the N-lane beam recursion
//
//     full[i] = max_b (vals[b] + logA[states[b], i]) + emit_t[i]
//     slot[i] = lowest b attaining that max (0 when every candidate is -inf)
//     beam'   = the top B of full by (value descending, index ascending)
//     hist[t, n, b] = beam'[b],  slots[t, n, b] = slot[beam'[b]]
//
// Replaces flash_viterbi_tpu/ops/pallas/beam.py: beam_scan and
// beam_scan_planes (_call, _beam_scan_kernel), with the FLASH-BS anchor
// planes folded in: after each step plane p takes planes[p][slot] where
// prop[t, p] is set (propagate) and the previous beam's states[slot] where
// not (record).  A lane whose valid[t, n] is false keeps its beam and
// planes and writes hist = states, slots = iota (ragged segments).
//
// Shape: the beam recursions of different lanes are independent, so one
// block owns one lane and loops over the T' steps itself: one launch per
// call and no synchronisation across blocks.  The lane's beam values, its
// beam states (double-buffered), the P planes (double-buffered) and the
// step's sort keys live in shared memory when they fit a block's 227 KB
// (Kp <= 16384 at B=64); above that the same arrays live in a global
// scratch the wrapper allocates, one region a lane (~330 KB at Kp=17024,
// which stays in L2), and the same network runs over it.  The block's own
// barriers order those global accesses as they do shared ones.
//
// What bounds it: a chain of T' dependent top-B selections.  Its bytes are
// the distinct logA rows the beam touches plus the emissions, a few MB at
// the headline shape, so the limit is the latency of each step: the fold
// (B row reads per column, coalesced, mostly from L2) and a block-wide
// bitonic sort with one barrier per pass.  One SM per lane leaves the card
// mostly idle at N=1; spreading the fold over a thread-block cluster, and a
// select that sorts less than all Kp keys, are for a later change.
//
// Select: each score becomes the 64-bit key (~orderable(v + 0.0f)) << 32 |
// index, sorted ascending, so the first B keys are the top B by value
// descending, then index ascending: the tie order of jax.lax.top_k and of
// the Pallas kernel.  v + 0.0f turns -0.0 into +0.0 so that the two rank
// equal.  Padding keys up to the next power of two are all ones and sort
// last; padded states of the tables (index >= the real K, value -inf) sort
// after every real -inf state by their higher index.
//
// Numerics: fp32 adds and compares only, in the plain version's order
// (candidate = vals[b] + row, strict '>' over b, emission after the max),
// so hist, slots and planes are bit-identical to it.  Inputs hold no NaN
// (the contract of beam.py:261-264); nothing checks it on the card.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;

// monotone map of a float's bits to an unsigned integer
__device__ __forceinline__ unsigned int orderable(float v) {
    const unsigned int u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned int o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

int pow2_at_least(int k) {
    int p = 1;
    while (p < k) p <<= 1;
    return p;
}

// a lane's working set: keys (K2 x u64), slot per column (K), beam values
// (B), beam states (2B), planes (2PB); in dynamic shared memory or, when it
// does not fit, in a region of the global scratch
size_t smem_bytes(int K, int B, int P) {
    return (size_t)pow2_at_least(K) * 8 + (size_t)K * 4 + (size_t)B * 4
           + (size_t)2 * B * 4 + (size_t)2 * P * B * 4;
}

__global__ void __launch_bounds__(MAX_THREADS)
beam_scan_kernel(const float* __restrict__ logA, const float* __restrict__ emits,
                 const float* __restrict__ vals0, const int* __restrict__ states0,
                 const unsigned char* __restrict__ valid,
                 const unsigned char* __restrict__ prop, int* __restrict__ hist,
                 int* __restrict__ slots, int* __restrict__ planes_out,
                 unsigned long long* scratch, size_t lane_words, int Tm, int N, int K,
                 int B, int P, int K2) {
    extern __shared__ unsigned long long smem[];
    const int n = blockIdx.x;
    unsigned long long* s_key = scratch != nullptr ? scratch + n * lane_words : smem;
    int* s_slot = reinterpret_cast<int*>(s_key + K2);
    float* s_vals = reinterpret_cast<float*>(s_slot + K);
    int* s_states = reinterpret_cast<int*>(s_vals + B);  // two halves of B
    int* s_planes = s_states + 2 * B;                    // two halves of P*B

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int PB = P * B;
    for (int b = tid; b < B; b += nt) {
        s_vals[b] = vals0[(size_t)n * B + b];
        s_states[b] = states0[(size_t)n * B + b];
    }
    for (int i = tid; i < PB; i += nt) s_planes[i] = -1;
    int cur = 0;  // the half of s_states that holds the beam
    int pc = 0;   // the half of s_planes that holds the planes
    __syncthreads();

    for (int t = 0; t < Tm; ++t) {
        const size_t out = ((size_t)t * N + n) * B;
        const int* st = s_states + cur * B;
        // the same branch for the whole block, so no barrier is skipped by
        // some threads only; nothing in shared memory changes
        if (valid != nullptr && !valid[(size_t)t * N + n]) {
            for (int b = tid; b < B; b += nt) {
                hist[out + b] = st[b];
                slots[out + b] = b;
            }
            continue;
        }

        // fold: one thread per column, slots in order, coalesced row reads
        const float* emit = emits + ((size_t)t * N + n) * K;
        for (int col = tid; col < K; col += nt) {
            float best = s_vals[0] + __ldg(logA + (size_t)st[0] * K + col);
            int slot = 0;
#pragma unroll 8
            for (int b = 1; b < B; ++b) {
                const float c = s_vals[b] + __ldg(logA + (size_t)st[b] * K + col);
                if (c > best) {
                    best = c;
                    slot = b;
                }
            }
            const float v = (best + emit[col]) + 0.0f;
            s_key[col] = ((unsigned long long)(~orderable(v)) << 32) | (unsigned int)col;
            s_slot[col] = slot;
        }
        for (int i = K + tid; i < K2; i += nt) s_key[i] = ~0ull;
        __syncthreads();

        // select: bitonic sort of the K2 keys, ascending
        for (int k = 2; k <= K2; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = tid; i < (K2 >> 1); i += nt) {
                    const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
                    const int hi = lo + j;
                    const unsigned long long a = s_key[lo];
                    const unsigned long long c = s_key[hi];
                    if ((a > c) == ((lo & k) == 0)) {
                        s_key[lo] = c;
                        s_key[hi] = a;
                    }
                }
                __syncthreads();
            }
        }

        // the new beam; the old beam and planes stay readable in their
        // halves until the barrier below
        const int nxt = cur ^ 1;
        const int* old_pl = s_planes + pc * PB;
        int* new_pl = s_planes + (pc ^ 1) * PB;
        for (int b = tid; b < B; b += nt) {
            const unsigned long long key = s_key[b];
            const int idx = (int)(key & 0xffffffffu);
            const int sl = s_slot[idx];
            hist[out + b] = idx;
            slots[out + b] = sl;
            s_vals[b] = from_orderable(~(unsigned int)(key >> 32));
            s_states[nxt * B + b] = idx;
            for (int p = 0; p < P; ++p) {
                new_pl[p * B + b] = prop[(size_t)t * P + p] ? old_pl[p * B + sl] : st[sl];
            }
        }
        cur = nxt;
        pc ^= (P > 0);
        __syncthreads();
    }

    for (int i = tid; i < PB; i += nt) planes_out[(size_t)n * PB + i] = s_planes[pc * PB + i];
}

}  // namespace

// Bytes of a lane's working set at (K, B, P): the dynamic shared memory a
// block needs, or the scratch region a lane takes when that is too large.
extern "C" int fvt_beam_scan_smem(int K, int B, int P) {
    return static_cast<int>(smem_bytes(K, B, P));
}

// The whole beam scan.  Layouts: logA (K, K), emits (Tm, N, K), vals0 and
// states0 (N, B), valid (Tm, N) bool or null, prop (Tm, P) bool or null
// (P = 0), hist and slots (Tm, N, B) int32, planes (N, P, B) int32.
// scratch: null to keep each lane's working set in shared memory, or N
// regions of fvt_beam_scan_smem(K, B, P) bytes rounded up to 8, 8-byte
// aligned, for a working set larger than a block's shared memory.
// 1 <= B <= K, Tm >= 1.  Returns the first CUDA error.
extern "C" int fvt_beam_scan(const float* logA, const float* emits,
                             const float* vals0, const int* states0,
                             const unsigned char* valid, const unsigned char* prop,
                             int* hist, int* slots, int* planes, void* scratch, int Tm,
                             int N, int K, int B, int P, void* stream,
                             long long* launches) {
    const int K2 = pow2_at_least(K);
    const size_t lane_words = (smem_bytes(K, B, P) + 7) / 8;
    const size_t smem = scratch != nullptr ? 0 : smem_bytes(K, B, P);
    cudaError_t e = cudaFuncSetAttribute(beam_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int half = K2 >> 1;
    const int threads = half < 32 ? 32 : (half > MAX_THREADS ? MAX_THREADS : half);
    beam_scan_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        logA, emits, vals0, states0, valid, prop, hist, slots, planes,
        static_cast<unsigned long long*>(scratch), lane_words, Tm, N, K, B, P, K2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
