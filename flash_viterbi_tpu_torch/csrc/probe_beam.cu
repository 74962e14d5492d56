// Beam-step cost probes for Hopper (sm_90a)
//
// Replaces scripts/beam_profile.py (run_variant, pallas_call at :120;
// make_kernel :25) and scripts/beam_profile2.py (run_variant, :161;
// make_kernel :34): variants of one beam step that switch its parts off,
// and other top-B selects, so that the beam scan's time per step can be
// split between the B row reads, the fold and the select.
//
// Each variant is an instantiation of the production beam scan's cluster
// kernel (csrc/beam_cluster.cuh: beam_cluster_kernel<READ, FOLD, SEL>, whose
// head comment gives the switches) at one lane (N=1), no anchor planes
// (P=0) and no valid mask, under the production plan
// (ops/cuda/beam.py:beam_plan) and launch: a cluster of C CTAs.  "full" is
// the production instantiation itself.  READ, FOLD and SEL_RADIX / SEL_PICK
// / SEL_NOSMEM / SEL_BLOCKM compute the production function, so their
// hist * 256 + slots equal beam_scan's bit for bit; the others are timed,
// not compared, and each writes something derived from the work it keeps,
// so that nothing it keeps is elided.
//
// What bounds it: as beam_scan.cu, a chain of Tm dependent top-B
// selections; the probes say how much of a step each part takes.

#include "beam_cluster.cuh"

namespace {

using Kernel = void (*)(const float*, const float*, const float*, const int*,
                        const unsigned char*, const unsigned char*, int*, int*, int*, int*, int*,
                        Plan, int, int, int, int, int);

struct Variant {
    const char* name;  // flash_viterbi_tpu_torch/probes/beam.py: VARIANTS
    Kernel kernel;
};

// in the order of flash_viterbi_tpu_torch/probes/beam.py:VARIANTS
const Variant VARIANTS[] = {
    {"full", beam_cluster_kernel<true, true, SEL_RADIX>},
    {"no-pick", beam_cluster_kernel<true, true, SEL_NONE>},
    {"no-fold", beam_cluster_kernel<true, false, SEL_RADIX>},
    {"no-dma", beam_cluster_kernel<false, true, SEL_RADIX>},
    {"dma-only", beam_cluster_kernel<true, false, SEL_NONE>},
    {"empty", beam_cluster_kernel<false, false, SEL_NONE>},
    {"pick", beam_cluster_kernel<true, true, SEL_PICK>},
    {"nosmem", beam_cluster_kernel<true, true, SEL_NOSMEM>},
    {"blockm", beam_cluster_kernel<true, true, SEL_BLOCKM>},
    {"onereduce", beam_cluster_kernel<true, true, SEL_ONEREDUCE>},
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

}  // namespace

// One beam probe: logA (K, lda) rows (lda a multiple of 4, 16-byte
// aligned), emits (Tm, K), vals0 and states0 (B,), hist and slots (Tm, B)
// int32; err one int32, ORed with 1 when a ring wait timed out.  plan:
// F_COUNT ints (BeamPlan.c_args) of a one-lane plan whose state fits
// shared memory.  1 <= B <= K, Tm >= 1.  One launch of one cluster.
// Returns the first CUDA error, or cudaErrorInvalidValue for an unknown
// variant or a plan the probe cannot run.
extern "C" int fvt_probe_beam(const float* logA, const float* emits, const float* vals0,
                              const int* states0, int* hist, int* slots, int* err,
                              const int* plan, int Tm, int K, int B, int variant, void* stream,
                              long long* launches) {
    const Plan pl = to_plan(plan);
    if (variant < 0 || variant >= N_VARIANTS || !pl.state_smem || pl.C > CLUSTER_MAX ||
        pl.rg > RG_MAX || pl.g > GROUPS_MAX || pl.cw > THREADS * JMAX || pl.lda % 4 || pl.cw % 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Kernel kernel = VARIANTS[variant].kernel;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.C);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, logA, emits, vals0, states0,
                           static_cast<const unsigned char*>(nullptr),
                           static_cast<const unsigned char*>(nullptr), hist, slots,
                           static_cast<int*>(nullptr), static_cast<int*>(nullptr), err, pl, Tm, 1,
                           K, B, 0);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    return 0;
}
