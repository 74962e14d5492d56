"""Fused full-state decoder: one forward scan over all T, one backward walk.

Counterpart of ``flash_viterbi_tpu/algorithms/fused.py`` on its kernel
path.  Two routes, a speed choice (every route gives the same path, bit
for bit, as ``vanilla``):

* "store": a pointer scan (``maxplus_scan``), then ``backtrack_batched``.
* "recompute": a pointer-free scan (``maxplus_scan_deltas``) stores the
  carry history, and ``argmax_walk`` re-derives each walked step's argmax
  from one logA column.

``fused_decode_batch`` stacks a (Bs, T) batch as lanes of the same
kernels, so one read of ``logA`` per step serves up to 16 sequences.
:func:`pointer_route` picks the route of a single sequence and of the
batch's ``pointers="auto"`` from the H100's rows, not from the JAX
package's TPU figures (its ``RESIDENT_MAX_K`` and Bs >= 4).

``precision="bf16"`` rounds ``logA`` to bfloat16 at the start of each
call (``ops.maxplus.table_at``), so the kernels read half the bytes; sums,
maxes and carries stay fp32, and the path is the fp32 path of the rounded
table, bit for bit -- an approximate decode of the model.  As in JAX, a
single sequence then takes the pointer route at every K, and the batch's
``pointers="auto"`` takes "store".
"""

from __future__ import annotations

import torch

from ..ops import maxplus as mp
from ..ops.cuda import (argmax_walk, backtrack_batched, maxplus_scan,
                        maxplus_scan_deltas)
from ..ops.cuda import backtrack as kb
from ..ops.cuda.common import H100_SMS
from ..ops.cuda.common import allocated as a
from ..ops.cuda.maxplus import error_word, plan_scratch_bytes, raise_on_error
from ..utils.profiling import span, traced
from .base import Decoder, register

POINTERS = ("auto", "store", "recompute")

# The routes' rule, from scripts/torch_route_sweep.py's rows on NVIDIA H100
# 80GB HBM3, 700.00 W (results/torch_route_sweep.jsonl, PERF.md "Routing
# figures"): the two routes timed in turns, recompute only where store lay
# outside the faster's spread (the larger of a route's least-to-most range
# over its six decodes and 2% of its median) somewhere in its region, else
# store, whose working set lacks recompute's transposed (K, K) logA.
#: a single sequence recomputes at RECOMPUTE_K[0] < K <= RECOMPUTE_K[1]:
#: the N=1 scan's plan is there one column group of 96-128 source ranges,
#: whose pointer combine costs more than the walk (T=16384: K=2048 115.599
#: ms against store's 148.559, K=1536 101.949 against 112.742); store led
#: or lay within the spread at K <= 1280 (K=1280: 95.840 against 98.986;
#: K=1024: store 83.186 against 86.457) and from K=2176 (120.151 against
#: 130.936; K=3968 211.944 against 220.689)
RECOMPUTE_K = (1280, 2048)
#: a batch recomputes from 2 sequences (K=3968, T=256, Bs=4: 5.940 ms
#: against 8.167; Bs=16: 11.903 against 17.831), but stores where the two
#: lay within the spread or store led: two sequences at K <=
#: PAIR_STORE_MAX_K (K=64, T=2048: store 8.723 against 9.120; K=256: 9.853
#: against 9.967; K=512: recompute 10.608 against 11.221), and up to
#: STREAMED_STORE_MAX_BS sequences (one 4-lane group) from STREAMED_MIN_K,
#: where both scans stream the table (K=16384, T=2048, Bs=4: store 718.581
#: against 724.774; Bs=5: recompute 856.963 against 1165.830; K=8192, Bs=4:
#: store 198.320 against 194.554)
PAIR_STORE_MAX_K = 256
STREAMED_MIN_K = 8192
STREAMED_STORE_MAX_BS = 4


def pointer_route(K: int, Bs: int = 1, precision: str = "fp32") -> str:
    """"store" or "recompute": the route of Bs sequences at the padded K
    (a single sequence is Bs=1; the batch's ``pointers="auto"``)."""
    if precision != "fp32":
        return "store"
    if Bs == 1:
        return "recompute" if RECOMPUTE_K[0] < K <= RECOMPUTE_K[1] else "store"
    if Bs == 2 and K <= PAIR_STORE_MAX_K:
        return "store"
    if K >= STREAMED_MIN_K and Bs <= STREAMED_STORE_MAX_BS:
        return "store"
    return "recompute"


def _walk(logA, emits, delta0, pointers: str):
    """Scan ``emits`` (T', N, K) from ``delta0`` (N, K) and walk back from
    the lowest-index argmax of the final scores; (N, T'+1) int32 paths.
    The scan and the walk share one error word, read once at the end."""
    err = error_word(logA.device)
    if pointers == "recompute":
        dfin, deltas = maxplus_scan_deltas(logA, emits, delta0, err=err)
        last = mp.first_argmax(dfin, 1)[1]
        paths = argmax_walk(deltas, mp.transposed(logA), last, err=err)
    else:
        dfin, ptrs = maxplus_scan(logA, emits, delta0, err=err)
        last = mp.first_argmax(dfin, 1)[1]
        paths = backtrack_batched(ptrs, last)
    raise_on_error(err, "fused")
    return paths


@traced("fvt.decode.fused")
def fused_decode(logA, logB, logPi, y, precision: str = "fp32"):
    """Decode the (T,) observations ``y``; returns the (T,) int32 path."""
    logA = mp.table_at(logA, precision)
    with span("fvt.emissions"):
        emits = logB.t()[y]  # (T, K)
        delta0 = logPi + emits[0]
    pointers = pointer_route(logA.shape[0], 1, precision)
    return _walk(logA, emits[1:].unsqueeze(1), delta0[None, :], pointers)[0]


@traced("fvt.decode.fused")
def fused_decode_batch(logA, logB, logPi, ys, pointers: str = "auto",
                       precision: str = "fp32"):
    """Decode a (Bs, T) batch through the N-lane kernels; returns (Bs, T)
    int32 paths identical to per-sequence :func:`fused_decode`.

    ``pointers``: "store" records argmax witnesses in the forward scan;
    "recompute" stores the fp32 carry history instead and re-derives each
    walked step's argmax from one logA column (bit-identical paths: the
    same fp32 sums drive both argmaxes); "auto" takes
    :func:`pointer_route`'s.
    """
    if pointers not in POINTERS:
        raise ValueError(f"unknown pointers {pointers!r}; have {POINTERS}")
    logA = mp.table_at(logA, precision)
    Bs, T = ys.shape
    # indexing by the transposed symbols keeps their strides: copy so the
    # kernels get a contiguous (T, Bs, K)
    with span("fvt.emissions"):
        emits = logB.t()[ys.t()].contiguous()
        delta0 = logPi[None, :] + emits[0]
    if pointers == "auto":
        pointers = pointer_route(logA.shape[0], Bs, precision)
    return _walk(logA, emits[1:], delta0, pointers)


def argmax_bytes(N: int, K: int) -> int:
    """Bytes ``ops.maxplus.first_argmax`` allocates over (N, K) scores:
    the max, the index row, the compare, the candidates and the result."""
    return a(N * 4) + a(K * 4) + a(N * K) + a(N * K * 4) + a(N * 4)


def peak_bytes(K: int, T: int, precision: str = "fp32", sms: int = H100_SMS) -> int:
    """Device bytes :func:`fused_decode` of one sequence allocates at its
    peak beside the tables, on a card of ``sms`` SMs, the (T,) int64
    observations counted: the bf16 table (made each call), the (T, K)
    emissions, the scan's (T-1, K) pointers or carries and its final
    scores, beside the larger of the scan's scratch and the walk's (the
    argmax, the path and the backtrack's maps, or recompute's transposed
    (K, K) logA, made each call)."""
    Tm = max(T - 1, 0)
    store = pointer_route(K, 1, precision) == "store"
    elem = 2 if precision == "bf16" else 4
    held = (a(T * 8) + a(T * K * 4) + a(K * 4) + a(4) + a(Tm * K * 4) + a(K * 4)
            + (a(K * K * 2) if precision == "bf16" else 0))
    if not Tm:
        return held + argmax_bytes(1, K) + a(T * 4)
    scan = plan_scratch_bytes(K, 1, sms, store, elem)
    walk = argmax_bytes(1, K) + a(T * 4)
    if store:
        walk += a(4 * kb.backtrack_plan(Tm, 1, K, sms).scratch_words(1, K))
    else:
        walk += a(K * K * elem)
    return held + max(scan, walk)


def _memory(K: int, T: int, **_) -> int:
    # full pointer table + delta carry/accumulators (ops/pallas/maxplus.py)
    return T * K * 4 + 4 * K * 4


@register("fused")
def _build(precision: str = "fp32", pointers: str = "auto", **static) -> Decoder:
    """``pointers`` applies to batches (``decode_batch``); a single
    sequence takes the route :func:`pointer_route` gives.  Other keywords are
    recorded in ``static`` and change nothing, as in the JAX package."""
    if precision not in mp.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")

    def fn(logA, logB, logPi, y):
        return fused_decode(logA, logB, logPi, y, precision)

    return Decoder("fused", fn, {"precision": precision, "pointers": pointers, **static},
                   _memory)
