"""Fused full-state decoder: one forward scan over all T, one backward walk.

Counterpart of ``flash_viterbi_tpu/algorithms/fused.py`` on its kernel
path, with JAX's routing (a speed choice; every route gives the same path,
bit for bit, as ``vanilla``):

* K <= ``RESIDENT_MAX_K``: a pointer-free scan (``maxplus_scan_deltas``)
  stores the carry history, and ``argmax_walk`` re-derives each walked
  step's argmax from one logA column.
* Otherwise: a pointer scan (``maxplus_scan``), then ``backtrack_batched``.

``fused_decode_batch`` stacks a (Bs, T) batch as lanes of the same
kernels, so one read of ``logA`` per step serves up to 16 sequences.
``RESIDENT_MAX_K`` and the batch's ``pointers="auto"`` threshold are TPU
figures, kept until H100 rows re-derive them (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from ..ops import maxplus as mp
from ..ops.cuda import (argmax_walk, backtrack_batched, maxplus_scan,
                        maxplus_scan_deltas)
from ..ops.cuda.maxplus import error_word, raise_on_error
from .base import Decoder, register

RESIDENT_MAX_K = 1024
POINTERS = ("auto", "store", "recompute")


def _walk(logA, emits, delta0, pointers: str):
    """Scan ``emits`` (T', N, K) from ``delta0`` (N, K) and walk back from
    the lowest-index argmax of the final scores; (N, T'+1) int32 paths.
    The scan and the walk share one error word, read once at the end."""
    err = error_word(logA.device)
    if pointers == "recompute":
        dfin, deltas = maxplus_scan_deltas(logA, emits, delta0, err=err)
        last = mp.first_argmax(dfin, 1)[1]
        paths = argmax_walk(deltas, logA.t().contiguous(), last, err=err)
    else:
        dfin, ptrs = maxplus_scan(logA, emits, delta0, err=err)
        last = mp.first_argmax(dfin, 1)[1]
        paths = backtrack_batched(ptrs, last)
    raise_on_error(err, "fused")
    return paths


def fused_decode(logA, logB, logPi, y):
    """Decode the (T,) observations ``y``; returns the (T,) int32 path."""
    emits = logB.t()[y]  # (T, K)
    delta0 = logPi + emits[0]
    pointers = "recompute" if logA.shape[0] <= RESIDENT_MAX_K else "store"
    return _walk(logA, emits[1:].unsqueeze(1), delta0[None, :], pointers)[0]


def fused_decode_batch(logA, logB, logPi, ys, pointers: str = "auto"):
    """Decode a (Bs, T) batch through the N-lane kernels; returns (Bs, T)
    int32 paths identical to per-sequence :func:`fused_decode`.

    ``pointers``: "store" records argmax witnesses in the forward scan;
    "recompute" stores the fp32 carry history instead and re-derives each
    walked step's argmax from one logA column (bit-identical paths: the
    same fp32 sums drive both argmaxes); "auto" picks recompute at Bs >= 4.
    """
    if pointers not in POINTERS:
        raise ValueError(f"unknown pointers {pointers!r}; have {POINTERS}")
    Bs, T = ys.shape
    # indexing by the transposed symbols keeps their strides: copy so the
    # kernels get a contiguous (T, Bs, K)
    emits = logB.t()[ys.t()].contiguous()
    delta0 = logPi[None, :] + emits[0]
    if pointers == "auto":
        pointers = "recompute" if Bs >= 4 else "store"
    return _walk(logA, emits[1:], delta0, pointers)


def _memory(K: int, T: int, **_) -> int:
    # full pointer table + delta carry/accumulators (ops/pallas/maxplus.py)
    return T * K * 4 + 4 * K * 4


@register("fused")
def _build(precision: str = "fp32", pointers: str = "auto", **static) -> Decoder:
    """``pointers`` applies to batches (``decode_batch``); a single
    sequence takes the route its K gives.  Other keywords are recorded in
    ``static`` and change nothing, as in the JAX package."""
    if precision == "bf16":
        raise NotImplementedError(
            "fused precision='bf16' is not ported yet (ROADMAP.md, queue 1)")
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return Decoder("fused", fused_decode,
                   {"precision": precision, "pointers": pointers, **static}, _memory)
