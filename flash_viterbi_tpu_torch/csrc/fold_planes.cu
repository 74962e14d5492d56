// Fold a chunk of pointer rows into index planes, for Hopper (sm_90a):
//
//     for t in 0 .. c-1, for every plane p:
//         row = rows[t, R == 1 ? 0 : p]
//         plane[p][k] = prop[t, p] ? plane[p][row[k]] : row[k]
//
// Replaces the lax.scan folds of flash_viterbi_tpu/algorithms/flash.py: the
// anchor planes of phase1_anchors_chunked (:185-190, one pointer row shared
// by every plane, R = 1) and the t2 planes of _lean_round_pallas (:396-401,
// a row a plane, R = P).  They are XLA programs, not Pallas kernels; in
// PyTorch each step of such a fold is a gather and a select, two launches
// or more a row, which the host issues more slowly than the scan fills a
// step.  This kernel folds a whole chunk in one launch.
//
// What bounds it: latency.  Row t + 1 reads the plane row t wrote, so the
// rows of a chunk are serial; a row moves 4 K bytes of pointers in and
// gathers K entries of the plane, 31.7 KB at K=3968, against a barrier.
//
// Design: one block a plane, no state across blocks.  The plane lives in
// two buffers, read from one and written to the other a row, one barrier a
// row; they are in shared memory where 2 K ints fit a block (K <= 29056),
// else in the caller's global scratch (2 x P x K ints), which the block
// alone touches, so the barrier orders it the same way.  A pointer outside
// [0, K) has no plane entry: the kernel writes -1 there.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
fold_kernel(const int* __restrict__ planes, const int* __restrict__ rows,
            const unsigned char* __restrict__ prop, int* __restrict__ out,
            int* scratch, int c, int R, int P, int K, int in_smem) {
    extern __shared__ int sm[];
    const int p = blockIdx.x;
    int* cur = in_smem ? sm : scratch + (size_t)p * 2 * K;
    int* nxt = cur + K;
    const int* plane = planes + (size_t)p * K;
    for (int k = threadIdx.x; k < K; k += THREADS) cur[k] = plane[k];
    __syncthreads();
    for (int t = 0; t < c; ++t) {
        const int* row = rows + ((size_t)t * R + (R == 1 ? 0 : p)) * K;
        if (prop[(size_t)t * P + p]) {
            for (int k = threadIdx.x; k < K; k += THREADS) {
                const int r = row[k];
                nxt[k] = (unsigned)r < (unsigned)K ? cur[r] : -1;
            }
        } else {
            for (int k = threadIdx.x; k < K; k += THREADS) nxt[k] = row[k];
        }
        __syncthreads();
        int* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    int* dst = out + (size_t)p * K;
    for (int k = threadIdx.x; k < K; k += THREADS) dst[k] = cur[k];
}

}  // namespace

// Shared memory the kernel takes for a plane of K entries, 0 where the
// plane goes to global scratch instead.
extern "C" int fvt_fold_planes_smem(int K) {
    const long long bytes = 2LL * K * (long long)sizeof(int);
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
        return -1;
    return bytes <= limit ? static_cast<int>(bytes) : 0;
}

// planes (P, K) int32, rows (c, R, K) int32 with R 1 or P, prop (c, P)
// bytes, out (P, K) int32; scratch 2 x P x K int32 where
// fvt_fold_planes_smem(K) is 0, else unused (may be null).
extern "C" int fvt_fold_planes(const int* planes, const int* rows, const unsigned char* prop,
                               int* out, int* scratch, int c, int R, int P, int K,
                               void* stream, long long* launches) {
    const int smem = fvt_fold_planes_smem(K);
    if (smem < 0) return static_cast<int>(cudaGetLastError());
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fold_kernel<<<P, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        planes, rows, prop, out, scratch, c, R, P, K, smem > 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
