"""FLASH Viterbi, pointer mode: anchored two-phase segmented decode.

Counterpart of ``flash_viterbi_tpu/algorithms/flash.py``'s pointer mode on
its kernel path (``phase1_anchors_pallas``, ``decode_segments_pointer_pallas``
in recompute form):

* **Phase 1**: one N=1 pointer scan over all T steps (``maxplus_scan``),
  then one backtrack (``backtrack_batched``) reads the final state and the
  N-1 anchor states at the balanced midpoints.
* **Phase 2**: the N anchored segments are stacked as lanes.  A
  pointer-free scan (``maxplus_scan_deltas``) stores each lane's carry
  history, and a masked walk (``argmax_walk``) re-derives every step's
  argmax from one logA column; rows past a segment's end keep the state.
* The segment paths are gathered into the output.

The two scans share one error word, read once at the end of the decode
(one host synchronisation for a timed-out grid barrier, not one a scan).
On CUDA tensors every one of those four calls launches a hand-written
kernel; on CPU tensors each runs its plain version.  Both give the path
the JAX decoder gives, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import maxplus as mp
from ..ops.cuda import (argmax_walk, backtrack_batched, maxplus_scan,
                        maxplus_scan_deltas)
from ..ops.cuda.maxplus import error_word, raise_on_error
from .base import Decoder, register


def flash_midpoints(L: int, R: int, N: int) -> list[int]:
    """Balanced interior midpoints (reference :129-136)."""
    gap, extra = divmod(R - L, N)
    mids: list[int] = []
    m = L + gap
    if extra:
        extra -= 1
        m += 1
    mids.append(m)
    for _ in range(1, N - 1):
        m = mids[-1] + gap
        if extra:
            extra -= 1
            m += 1
        mids.append(m)
    return mids


def segment_layout(mids: list[int], T: int) -> tuple[list[int], list[int], int]:
    """(starts, lens, Lmax) of the N anchored segments bounded by ``mids``
    (segment s covers [starts[s], starts[s] + lens[s] - 1]; the last ends
    at T-1)."""
    starts = [0] + [m + 1 for m in mids]
    ends = list(mids) + [T - 1]
    lens = [e - s + 1 for s, e in zip(starts, ends)]
    return starts, lens, max(lens)


def prop_schedule(mids: list[int], T: int, j0: int = 1,
                  j1: int | None = None) -> np.ndarray:
    """(j1-j0, P) bool: True where anchor plane p PROPAGATES (j > mid+1)
    rather than records, for trellis steps j in [j0, j1) (reference
    :163,176-179,242)."""
    j1 = T if j1 is None else j1
    mids_a = np.asarray(mids, dtype=np.int64).reshape(1, -1)
    return np.arange(j0, j1, dtype=np.int64)[:, None] > mids_a + 1


def phase1_anchors(logA, logPi, emits, mids: torch.Tensor, err=None):
    """Final state and the states at ``mids`` (P,) int64: one pointer scan
    over all steps (``err``: the scan's error word, as ``maxplus_scan``
    takes it), then one backtrack.  Returns (last () int32, anchors (P,)
    int32)."""
    delta0 = logPi + emits[0]
    dfin, ptrs = maxplus_scan(logA, emits[1:].unsqueeze(1), delta0[None, :], err=err)
    last = mp.argmax_final(dfin[0])
    if not mids.numel():
        return last, torch.zeros((0,), dtype=torch.int32, device=emits.device)
    path = backtrack_batched(ptrs, last[None])[0]
    return last, path[mids]


def decode_segments_pointer(logA, logPi, emits, starts, lens, init_states,
                            end_states, Lmax: int, T: int, err=None):
    """Decode N forced-boundary segments as lanes; returns (N, Lmax) paths.
    ``err`` is the scan's and the walk's error word, as ``maxplus_scan_deltas``
    takes it.

    ``init_states[s]`` is the resolved state at ``starts[s]-1`` (ignored for
    segment 0, which starts from ``logPi``); ``end_states[s]`` the resolved
    state at ``starts[s]+lens[s]-1``.
    """
    N = starts.shape[0]
    dev = emits.device
    idx = torch.clamp(starts[:, None] + torch.arange(Lmax, device=dev)[None, :],
                      max=T - 1)
    seg_emits = emits[idx]  # (N, Lmax, K)
    first = torch.arange(N, device=dev) == 0
    d0 = torch.where(first[:, None], logPi[None, :], logA[init_states]) + seg_emits[:, 0]
    emitsN = seg_emits[:, 1:, :].transpose(0, 1).contiguous()  # (Lmax-1, N, K)
    valid = torch.arange(1, Lmax, device=dev)[:, None] <= (lens - 1)[None, :]
    _, deltas = maxplus_scan_deltas(logA, emitsN, d0, err=err)
    # the walk reads logA columns as contiguous rows of its transpose: one
    # K*K copy per decode
    return argmax_walk(deltas, logA.t().contiguous(), end_states, valid=valid, err=err)


def flash_decode(logA, logB, logPi, y, num_segments: int = 8):
    T = y.shape[0]
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    dev = logA.device
    mids_l = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts_l, lens_l, Lmax = segment_layout(mids_l, T)
    # the segments tile [0, T) in order, so the output is a gather of the
    # (N, Lmax) segment paths.  Every index tensor is built here, before
    # the first launch: a host-to-device copy in mid-decode would wait for
    # the kernels queued before it.
    order = [s * Lmax + j for s, ln in enumerate(lens_l) for j in range(ln)]
    mids, starts, lens, order = (torch.tensor(v, dtype=torch.int64, device=dev)
                                 for v in (mids_l, starts_l, lens_l, order))
    emits = logB.t()[y].contiguous()  # (T, K)
    err = error_word(dev)

    last, anchors = phase1_anchors(logA, logPi, emits, mids, err)
    init_states = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev), anchors])
    end_states = torch.cat([anchors, last[None]])
    paths = decode_segments_pointer(logA, logPi, emits, starts, lens,
                                    init_states, end_states, Lmax, T, err)
    out = paths.reshape(-1)[order]
    raise_on_error(err, "flash")
    return out


def _threadpool_sizeof(N: int) -> int:
    # glibc x86-64: pthread_mutex_t 40 + pthread_cond_t 48 + pthread_t[N]
    # + 3 ints, padded to 8 (FLASH_Viterbi_multithread.c:36-46)
    return (40 + 48 + 8 * N + 12 + 7) // 8 * 8


def _memory(K: int, T: int, num_segments: int = 8, **_) -> int:
    """Reference-exact (FLASH_Viterbi_multithread.c:341-367), with
    num_segments in MAX_THREADS' role: max(phase-1 tables, per-thread
    double buffers) + sizeof(ThreadPool) + 8 — the final +8 reproduces the
    sizeof(obserRouteLEN*sizeof(INTERVAL)) sizeof-of-expression bug (:367),
    which evaluates to sizeof(unsigned long)."""
    N = max(1, num_segments)
    phase1 = 0
    if N > 2 and T >= 2 * N:
        phase1 = (N - 1) * 4 + 2 * K * 4 + 2 * (N - 1) * K * 4
    tmp = N * (2 * K * 4 + 2 * K * 4)
    return max(phase1, tmp) + _threadpool_sizeof(N) + 8


@register("flash")
def _build(num_segments: int = 8, mode: str = "pointer",
           precision: str = "fp32") -> Decoder:
    if mode == "lean":
        raise NotImplementedError(
            "flash mode='lean' is not ported yet (ROADMAP.md, queue 1)")
    if mode != "pointer":
        raise ValueError(f"unknown flash mode {mode!r}")
    if precision == "bf16":
        raise NotImplementedError(
            "flash precision='bf16' is not ported yet (ROADMAP.md, queue 1)")
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")

    def fn(logA, logB, logPi, y):
        return flash_decode(logA, logB, logPi, y, num_segments=num_segments)

    return Decoder("flash", fn, {"num_segments": num_segments, "mode": mode,
                                 "precision": precision}, _memory)
