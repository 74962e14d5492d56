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
from ..ops.cuda import backtrack_batched, maxplus_scan_emitgather
from ..ops.cuda.maxplus import error_word, raise_on_error
from .base import Decoder, register


def snapshot_step(T: int) -> int:
    """Snapshot spacing the kernel path actually runs: √T chunks, but
    per-kernel-call overhead dominates past ~100 chunks on the remote
    runtime — the call count is capped at long T.  Exposed so working-set
    models (``algorithms.auto``) see the same figure the decode uses."""
    return max(int(math.floor(math.sqrt(max(T, 1)))), min(1024, T // 64))


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
    snaps = [logPi + logBT.index_select(0, y[:1])[0]]
    for lo, hi in chunks:
        snaps.append(run_chunk(snaps[-1], lo, hi)[0])

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
