"""Checkpoint (sqrt-T) Viterbi: O(K*sqrt(T)) memory via recompute-backtrack.

Counterpart of ``flash_viterbi_tpu/algorithms/checkpoint.py``'s kernel path
(``checkpoint_decode_pallas``), the capability of the reference's
``checkpoint Viterbi.c``:

* **Forward**: one emission-gather scan (``maxplus_scan_emitgather``) per
  chunk of ``step`` positions, keeping only the chunk-start carries.
* **Backward**: from the last chunk to the first, re-run the chunk's scan
  from its snapshot, keeping its pointer table only, and backtrack inside
  it (``backtrack_batched``).

Nothing (T, K)-shaped is built: each chunk's symbols are a slice of the
observation vector on the device, and the scan gathers the emission rows
from the (M, K) ``logB.T`` itself.  Live memory is the C+1 snapshots plus
one chunk's (step, K) pointers.  Every scan of a decode shares one error
word, read once at its end, so the 2 x sqrt(T) scans cost one host
synchronisation, not one each.  On CUDA tensors both calls launch the
hand-written kernels; on CPU tensors they run their plain versions.

JAX's ``lax.scan`` form of the decode (time padded to a whole number of
chunks with masked steps) is TPU shape discipline and is not ported.
"""

from __future__ import annotations

import math

import torch

from ..ops import maxplus as mp
from ..ops.cuda import backtrack as kb
from ..ops.cuda import backtrack_batched, maxplus_scan_emitgather
from ..ops.cuda.common import H100_SMS
from ..ops.cuda.common import allocated as a
from ..ops.cuda.maxplus import error_word, plan_scratch_bytes, raise_on_error
from ..utils.profiling import span
from .base import Decoder, register
from .fused import argmax_bytes


#: the least snapshot step, from scripts/torch_route_sweep.py's rows on
#: NVIDIA H100 80GB HBM3, 700.00 W (results/torch_route_sweep.jsonl,
#: PERF.md "Routing figures"): a chunk costs two scan launches and a walk
#: whatever its length, so below this step the chunks cost more than the
#: spread (K=3968, T=1024: step 64 29.285 ms against step 512's 27.998;
#: T=4096: 115.554 against step 1024's 109.809); from it on every swept
#: step lay within the fastest's spread, and √T has the least working set
SNAPSHOT_MIN_STEP = 128


def snapshot_step(T: int) -> int:
    """Snapshot spacing the decode runs by default: √T, the step of the
    smallest working set, but at least ``SNAPSHOT_MIN_STEP`` (one chunk
    below it).  Exposed so working-set models (``algorithms.auto``) see the
    same figure the decode uses."""
    return min(max(math.isqrt(max(T, 1)), SNAPSHOT_MIN_STEP), max(T - 1, 1))


def checkpoint_decode(logA, logB, logPi, y, step: int = 0):
    """√T-checkpoint decode of the (T,) observations ``y``; returns the
    (T,) int32 path.  ``step <= 0`` takes :func:`snapshot_step`."""
    T = y.shape[0]
    if step <= 0:
        step = snapshot_step(T)
    logBT = logB.t().contiguous()  # (M, K): one row per symbol
    ys = y.to(torch.int32)
    bounds = list(range(0, T - 1, step)) + [T - 1]  # chunk edges (times)
    chunks = list(zip(bounds[:-1], bounds[1:]))
    err = error_word(y.device)

    def run_chunk(d0, lo, hi):
        """Scan steps lo+1..hi from the carry d0 at lo; returns (delta_hi,
        ptrs (hi-lo, 1, K))."""
        dfin, ptrs = maxplus_scan_emitgather(logA, logBT, ys[lo + 1:hi + 1, None],
                                             d0[None, :], err=err)
        return dfin[0], ptrs

    # no variable holds a chunk's pointers past its use, so one chunk's
    # table is alive at a time
    with span("fvt.checkpoint.forward"):
        snaps = [logPi + logBT.index_select(0, y[:1])[0]]
        for lo, hi in chunks:
            snaps.append(run_chunk(snaps[-1], lo, hi)[0])

    with span("fvt.checkpoint.backward"):
        state = mp.argmax_final(snaps[-1])
        pieces = []
        for (lo, hi), snap in zip(reversed(chunks), reversed(snaps[:-1])):
            # states at times lo..hi
            seg = backtrack_batched(run_chunk(snap, lo, hi)[1], state[None])[0]
            pieces.append(seg[1:])
            state = seg[0]
        pieces.append(state[None])
        path = torch.cat(pieces[::-1])
    raise_on_error(err, "checkpoint")
    return path


def peak_bytes(K: int, T: int, M: int, step: int = 0, sms: int = H100_SMS) -> int:
    """Device bytes :func:`checkpoint_decode` allocates at its peak beside
    the tables, on a card of ``sms`` SMs, the (T,) int64 observations
    counted: the (M, K) ``logB.T`` copy, the int32 symbols, the C+1
    snapshots and the paths walked so far, beside one chunk's pointers with
    the larger of the scan's scratch and the walk's; or, at the end, the
    joined path."""
    if step <= 0:
        step = snapshot_step(T)
    edges = list(range(0, T - 1, step)) + [T - 1]
    lens = [hi - lo for lo, hi in zip(edges[:-1], edges[1:])]
    held = (a(T * 8) + a(M * K * 4) + a(T * 4) + a(4) + (len(lens) + 1) * a(K * 4)
            + argmax_bytes(1, K) + sum(a((n + 1) * 4) for n in lens))
    chunk = 0
    for n in set(lens):
        scan = a(K * 4) + plan_scratch_bytes(K, 1, sms, True)
        walk = a((n + 1) * 4) + a(4 * kb.backtrack_plan(n, 1, K, sms).scratch_words(1, K))
        chunk = max(chunk, a(n * K * 4) + max(scan, walk))
    return held + max(chunk, a(T * 4))


def _memory(K: int, T: int, step: int = 0, **_) -> int:
    """Reference-exact (checkpoint Viterbi.c:250): sizeof(T1_previous) +
    sizeof(T1) + sizeof(T1_current) + sizeof(checkpoints) + the max
    backward-subroutine tables sizeof(T1_sub)+sizeof(T2_sub), where
    T_sub = this_step + (count != T-1)."""
    if step <= 0:
        step = int(math.floor(math.sqrt(T)))
    checkpoints = list(range(0, T, step))
    C = len(checkpoints)
    subs = []
    count_first = True
    for i in range(C - 1, -1, -1):
        this_step = step if i != C - 1 else T - checkpoints[C - 1]
        t_sub = this_step + (0 if count_first else 1)
        count_first = False
        subs.append(8 * K * t_sub)
    # T1_previous[K] + snapshot matrix T1[K][C] + T1_current[K]
    # + checkpoints[T/step+1] + max subroutine tables (:188-250)
    return 2 * 4 * K + 4 * K * C + 4 * (T // step + 1) + max(subs)


@register("checkpoint")
def _build(step: int = 0, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return checkpoint_decode(logA, logB, logPi, y, step=step)

    return Decoder("checkpoint", fn, {"step": step, **static}, _memory)
