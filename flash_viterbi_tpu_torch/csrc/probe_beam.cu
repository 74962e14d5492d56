// Beam-step cost probes for Hopper (sm_90a)
//
// Replaces scripts/beam_profile.py (run_variant, pallas_call at :120;
// make_kernel :25) and scripts/beam_profile2.py (run_variant, :161;
// make_kernel :34): variants of one beam step that switch its parts off,
// and other top-B selects, so that the beam scan's time per step can be
// split between the B row reads, the fold and the select.
//
// Each variant is a copy of csrc/beam_scan.cu's beam_scan_kernel at one
// lane (N=1), no anchor planes (P=0) and no valid mask, templated on
//
//     READ: the fold's B logA rows come from global memory.  Off, it folds
//           values made from (state, column) without a read ("no-dma"; on
//           the TPU the rows were copied into VMEM, here at K=4096 they are
//           1 MiB and are read where they are used).
//     FOLD: the max over the B slots with the lowest slot.  Off with READ
//           on, the rows are read into an xor checksum that becomes the
//           slot, so that no read is elided ("no-fold", "dma-only").
//     SEL:  the select of the top B keys.  SORT is production's block-wide
//           bitonic sort of all K keys; PICK runs B rounds of a block-wide
//           minimum over the packed 64-bit keys not yet taken (the TPU
//           probe's "prod" and "packed" at once: a packed key needs one
//           reduction); NOSMEM is PICK keeping each round's winner in a
//           register, written to shared memory once after the rounds;
//           BLOCKM is PICK over per-warp best keys, where only the warp
//           whose key was taken rescans its keys; ONEREDUCE does one 32-bit
//           reduction a round (the value key only) and takes the round's
//           number as the index: wrong on purpose, for cost attribution, as
//           on the TPU; NONE takes the block's best key alone and keeps
//           moving the beam to the next B states ("no-pick").
//
// A step writes codes[t, b] = state * 256 + slot (B <= 256), the TPU
// probes' output.  SORT, PICK, NOSMEM and BLOCKM with READ and FOLD
// compute the production function: the key order (value descending,
// index ascending, -0.0 equal to +0.0) and the fold are beam_scan.cu's,
// so their codes equal hist * 256 + slots of beam_scan bit for bit.  The
// other variants are timed, not compared; each writes something derived
// from the work it keeps, so that nothing it keeps is elided.
//
// What bounds it: as beam_scan.cu, a chain of Tm dependent top-B
// selections on one SM; the probes say how much of a step each part takes.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int WARPS = MAX_THREADS / 32;
constexpr unsigned long long NONE_KEY = ~0ull;

enum Select { SEL_SORT, SEL_PICK, SEL_NOSMEM, SEL_BLOCKM, SEL_ONEREDUCE, SEL_NONE };

// monotone map of a float's bits to an unsigned integer (beam_scan.cu's)
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

// dynamic shared memory: keys (K2 x u64), slot per column (K), beam values
// (B), beam states (2B)
size_t smem_bytes(int K, int B) {
    return (size_t)pow2_at_least(K) * 8 + (size_t)K * 4 + (size_t)B * 4 + (size_t)2 * B * 4;
}

__device__ __forceinline__ unsigned long long min_key(unsigned long long a, unsigned long long b) {
    return b < a ? b : a;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) k = min_key(k, __shfl_xor_sync(0xffffffffu, k, o));
    return k;
}

// The block's least key; every thread gets it.  Two barriers.
__device__ __forceinline__ unsigned long long block_min(unsigned long long k,
                                                        unsigned long long* s_red,
                                                        unsigned long long* s_win) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    k = warp_min(k);
    if (lane == 0) s_red[warp] = k;
    __syncthreads();
    if (warp == 0) {
        k = warp_min(lane < (int)(blockDim.x >> 5) ? s_red[lane] : NONE_KEY);
        if (lane == 0) *s_win = k;
    }
    __syncthreads();
    return *s_win;
}

// The least key among this thread's columns tid, tid + nt, ...
__device__ __forceinline__ unsigned long long own_min(const unsigned long long* s_key, int K) {
    unsigned long long k = NONE_KEY;
    for (int col = threadIdx.x; col < K; col += blockDim.x) k = min_key(k, s_key[col]);
    return k;
}

// A fold value without a global read: a float in [1, 2) from (state, col)
__device__ __forceinline__ float made_value(int state, int col) {
    return __uint_as_float(0x3f800000u | ((unsigned int)(state ^ col) & 0x007fffffu));
}

template <bool READ>
__device__ __forceinline__ float row_value(const float* __restrict__ logA, int state, int K,
                                           int col) {
    return READ ? __ldg(logA + (size_t)state * K + col) : made_value(state, col);
}

template <bool READ, bool FOLD, int SEL>
__global__ void __launch_bounds__(MAX_THREADS)
beam_probe_kernel(const float* __restrict__ logA, const float* __restrict__ emits,
                  const float* __restrict__ vals0, const int* __restrict__ states0,
                  int* __restrict__ codes, int Tm, int K, int B, int K2) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* s_key = smem;
    int* s_slot = reinterpret_cast<int*>(s_key + K2);
    float* s_vals = reinterpret_cast<float*>(s_slot + K);
    int* s_states = reinterpret_cast<int*>(s_vals + B);  // two halves of B
    __shared__ unsigned long long s_red[WARPS];
    __shared__ unsigned long long s_win;
    __shared__ unsigned int s_red32[WARPS];
    __shared__ unsigned int s_win32;

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int b = tid; b < B; b += nt) {
        s_vals[b] = vals0[b];
        s_states[b] = states0[b];
    }
    int cur = 0;  // the half of s_states that holds the beam
    __syncthreads();

    for (int t = 0; t < Tm; ++t) {
        const int* st = s_states + cur * B;
        int* ns = s_states + (cur ^ 1) * B;
        int* out = codes + (size_t)t * B;

        // fold: one thread per column, slots in order
        const float* emit = emits + (size_t)t * K;
        for (int col = tid; col < K; col += nt) {
            float best;
            int slot = 0;
            if (FOLD) {
                best = s_vals[0] + row_value<READ>(logA, st[0], K, col);
#pragma unroll 8
                for (int b = 1; b < B; ++b) {
                    const float c = s_vals[b] + row_value<READ>(logA, st[b], K, col);
                    if (c > best) {
                        best = c;
                        slot = b;
                    }
                }
            } else if (READ) {
                best = s_vals[0] + __ldg(logA + (size_t)st[0] * K + col);
                unsigned int sum = 0;
#pragma unroll 8
                for (int b = 1; b < B; ++b) sum ^= __float_as_uint(__ldg(logA + (size_t)st[b] * K + col));
                slot = (int)(sum & 0xffu);
            } else {
                best = s_vals[0];
            }
            const float v = (best + emit[col]) + 0.0f;
            s_key[col] = ((unsigned long long)(~orderable(v)) << 32) | (unsigned int)col;
            s_slot[col] = slot;
        }
        if (SEL == SEL_SORT) {
            for (int i = K + tid; i < K2; i += nt) s_key[i] = NONE_KEY;
        }
        __syncthreads();

        if (SEL == SEL_SORT) {
            // beam_scan.cu's select: bitonic sort of the K2 keys, ascending
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
            for (int b = tid; b < B; b += nt) {
                const unsigned long long key = s_key[b];
                const int idx = (int)(key & 0xffffffffu);
                out[b] = idx * 256 + s_slot[idx];
                s_vals[b] = from_orderable(~(unsigned int)(key >> 32));
                ns[b] = idx;
            }
        } else if (SEL == SEL_PICK || SEL == SEL_NOSMEM) {
            unsigned long long mine = NONE_KEY;  // NOSMEM: thread b's round's winner
            for (int b = 0; b < B; ++b) {
                const unsigned long long key = block_min(own_min(s_key, K), s_red, &s_win);
                const int idx = (int)(key & 0xffffffffu);
                if (tid == idx % nt) s_key[idx] = NONE_KEY;  // taken
                if (SEL == SEL_PICK && tid == 0) {
                    out[b] = idx * 256 + s_slot[idx];
                    s_vals[b] = from_orderable(~(unsigned int)(key >> 32));
                    ns[b] = idx;
                }
                if (SEL == SEL_NOSMEM && tid == b) mine = key;
            }
            if (SEL == SEL_NOSMEM && tid < B) {
                const int idx = (int)(mine & 0xffffffffu);
                out[tid] = idx * 256 + s_slot[idx];
                s_vals[tid] = from_orderable(~(unsigned int)(mine >> 32));
                ns[tid] = idx;
            }
        } else if (SEL == SEL_BLOCKM) {
            // s_red holds each warp's best key; warp 0 reduces them, and the
            // warp that owned the winner takes it and rescans its keys
            unsigned long long k = warp_min(own_min(s_key, K));
            if (lane == 0) s_red[warp] = k;
            __syncthreads();
            for (int b = 0; b < B; ++b) {
                if (warp == 0) {
                    k = warp_min(lane < (nt >> 5) ? s_red[lane] : NONE_KEY);
                    if (lane == 0) s_win = k;
                }
                __syncthreads();
                const unsigned long long key = s_win;
                const int idx = (int)(key & 0xffffffffu);
                const int owner = idx % nt;
                if (tid == 0) {
                    out[b] = idx * 256 + s_slot[idx];
                    s_vals[b] = from_orderable(~(unsigned int)(key >> 32));
                    ns[b] = idx;
                }
                if (warp == owner >> 5) {
                    if (tid == owner) s_key[idx] = NONE_KEY;
                    k = warp_min(own_min(s_key, K));
                    if (lane == 0) s_red[warp] = k;
                }
                __syncthreads();
            }
        } else if (SEL == SEL_ONEREDUCE) {
            for (int b = 0; b < B; ++b) {
                unsigned int m = ~0u;
                for (int col = tid; col < K; col += nt) {
                    const unsigned int hi = (unsigned int)(s_key[col] >> 32);
                    m = hi < m ? hi : m;
                }
                m = __reduce_min_sync(0xffffffffu, m);
                if (lane == 0) s_red32[warp] = m;
                __syncthreads();
                if (warp == 0) {
                    m = __reduce_min_sync(0xffffffffu, lane < (nt >> 5) ? s_red32[lane] : ~0u);
                    if (lane == 0) s_win32 = m;
                }
                __syncthreads();
                m = s_win32;
                if (tid == b % nt) s_key[b] = NONE_KEY;  // the round as the index
                if (tid == 0) {
                    out[b] = b * 256 + (int)(m & 0xffu);
                    s_vals[b] = from_orderable(~m);
                    ns[b] = b;
                }
            }
        } else {  // SEL_NONE
            const unsigned long long key = block_min(own_min(s_key, K), s_red, &s_win);
            const int idx = (int)(key & 0xffffffffu);
            for (int b = tid; b < B; b += nt) {
                out[b] = b == 0 ? idx * 256 + s_slot[idx] : b;
                s_vals[b] = from_orderable(~(unsigned int)(key >> 32));
                ns[b] = (states0[b] + t + 1) % K;
            }
        }
        cur ^= 1;
        __syncthreads();
    }
}

using Kernel = void (*)(const float*, const float*, const float*, const int*, int*, int, int,
                        int, int);

// in the order of flash_viterbi_tpu_torch/probes/beam.py:VARIANTS
const Kernel VARIANTS[] = {
    beam_probe_kernel<true, true, SEL_SORT>,        // full / sort
    beam_probe_kernel<true, true, SEL_NONE>,        // no-pick
    beam_probe_kernel<true, false, SEL_SORT>,       // no-fold
    beam_probe_kernel<false, true, SEL_SORT>,       // no-dma
    beam_probe_kernel<true, false, SEL_NONE>,       // dma-only
    beam_probe_kernel<false, false, SEL_NONE>,      // empty
    beam_probe_kernel<true, true, SEL_PICK>,        // pick
    beam_probe_kernel<true, true, SEL_NOSMEM>,      // nosmem
    beam_probe_kernel<true, true, SEL_BLOCKM>,      // blockm
    beam_probe_kernel<true, true, SEL_ONEREDUCE>,   // onereduce
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

}  // namespace

// Bytes of dynamic shared memory the probe needs at (K, B).
extern "C" int fvt_probe_beam_smem(int K, int B) { return static_cast<int>(smem_bytes(K, B)); }

// One beam probe: logA (K, K), emits (Tm, K), vals0 and states0 (B,),
// codes (Tm, B) int32.  1 <= B <= min(K, 256), Tm >= 1; the caller checks
// that fvt_probe_beam_smem fits a block.  One launch of one block.
// Returns the first CUDA error, or cudaErrorInvalidValue for an unknown
// variant.
extern "C" int fvt_probe_beam(const float* logA, const float* emits, const float* vals0,
                              const int* states0, int* codes, int Tm, int K, int B,
                              int variant, void* stream, long long* launches) {
    if (variant < 0 || variant >= N_VARIANTS) return static_cast<int>(cudaErrorInvalidValue);
    const Kernel kernel = VARIANTS[variant];
    const int K2 = pow2_at_least(K);
    const size_t smem = smem_bytes(K, B);
    cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int half = K2 >> 1;
    int threads = half < 32 ? 32 : (half > MAX_THREADS ? MAX_THREADS : half);
    while (threads < B) threads <<= 1;  // NOSMEM keeps round b's winner in thread b
    kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(logA, emits, vals0, states0,
                                                                    codes, Tm, K, B, K2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
