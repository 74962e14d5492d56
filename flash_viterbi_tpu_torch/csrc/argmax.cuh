// The tie rule shared by every kernel of the port.
//
// A partial result is a (value, index) pair.  Pairs combine
// lexicographically: the larger value wins, and on equal values the lower
// index wins.  That makes the combine associative and commutative, so any
// split of the source dimension, any reduction tree and any warp-shuffle
// order yield the lowest-index argmax that jnp.argmax / the framework
// numerics contract define.  The identity is (-inf, K): every real
// candidate, even a -inf one, beats it on the index, so a column whose
// candidates are all -inf (a dead padded state) resolves to index 0.
//
// Only fp32 add, max and compare feed these pairs; each is correctly
// rounded, so results are bit-identical to the plain PyTorch versions.
// Never build with --use_fast_math.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ bool fvt_better(float v, int k, float best, int best_k) {
    return v > best || (v == best && k < best_k);
}
