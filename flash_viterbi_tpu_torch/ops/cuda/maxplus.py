"""The fused max-plus scans: CUDA kernels and their plain versions.

Counterparts of ``flash_viterbi_tpu/ops/pallas/maxplus.py``'s
``maxplus_scan`` and ``maxplus_scan_deltas``, with the same signatures and
layouts.  The kernel is ``csrc/maxplus_scan.cu``.
"""

from __future__ import annotations

import torch

from .. import maxplus as mp
from .common import expect, expect_contiguous, launch, on_cuda


def _check(logA, emits, delta0) -> tuple[int, int, int]:
    if emits.dim() != 3:
        raise ValueError(f"emits must be (T', N, K), got {tuple(emits.shape)}")
    Tm, N, K = emits.shape
    if K < 1 or N < 1:
        raise ValueError(f"empty state or lane dimension: {tuple(emits.shape)}")
    expect("logA", logA, torch.float32, (K, K))
    expect("emits", emits, torch.float32, (Tm, N, K))
    expect("delta0", delta0, torch.float32, (N, K))
    return Tm, N, K


def maxplus_scan_plain(logA, emits, delta0):
    """Plain version of :func:`maxplus_scan`, one lane at a time (scratch
    stays at one (K, K) tensor)."""
    Tm, N, K = _check(logA, emits, delta0)
    dfin = torch.empty_like(delta0)
    ptrs = torch.empty((Tm, N, K), dtype=torch.int32, device=emits.device)
    for n in range(N):
        dfin[n], ptrs[:, n] = mp.forward_scan(delta0[n], logA, emits[:, n])
    return dfin, ptrs


def maxplus_scan_deltas_plain(logA, emits, delta0):
    """Plain version of :func:`maxplus_scan_deltas`, one lane at a time."""
    Tm, N, K = _check(logA, emits, delta0)
    dfin = torch.empty_like(delta0)
    deltas = torch.empty((Tm, N, K), dtype=torch.float32, device=emits.device)
    for n in range(N):
        d = delta0[n]
        for t in range(Tm):
            deltas[t, n] = d
            d = mp.maxplus_step_noptr(d, logA, emits[t, n])
        dfin[n] = d
    return dfin, deltas


def _scan_cuda(logA, emits, delta0, with_ptr: bool, counter):
    Tm, N, K = emits.shape
    expect_contiguous(logA=logA, emits=emits, delta0=delta0)
    dev = emits.device
    hist = torch.empty((Tm, N, K), device=dev,
                       dtype=torch.int32 if with_ptr else torch.float32)
    if Tm == 0:
        return delta0, hist
    dfin = torch.empty((N, K), dtype=torch.float32, device=dev)
    work = torch.empty((2, N, K), dtype=torch.float32, device=dev)
    launch("fvt_maxplus_scan", counter, dev,
           logA.data_ptr(), emits.data_ptr(), delta0.data_ptr(), dfin.data_ptr(),
           hist.data_ptr() if with_ptr else None,
           None if with_ptr else hist.data_ptr(),
           work.data_ptr(), Tm, N, K)
    return dfin, hist


def maxplus_scan(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor):
    """Run the N-lane forward scan.

    Args:
      logA:   (K, K) fp32, source k rows -> dest i columns.
      emits:  (T', N, K) fp32 log emission rows for steps 1..T'.
      delta0: (N, K) fp32 scores at step 0.

    Returns:
      (delta_final (N, K) fp32, ptrs (T', N, K) int32).
    """
    _check(logA, emits, delta0)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_plain(logA, emits, delta0)
    return _scan_cuda(logA, emits, delta0, True, maxplus_scan)


def maxplus_scan_deltas(logA: torch.Tensor, emits: torch.Tensor,
                        delta0: torch.Tensor):
    """Forward scan emitting the carry history instead of pointers.

    Returns (delta_final (N, K), deltas (T', N, K) fp32) with
    ``deltas[t]`` = the carry before step t (``deltas[0] == delta0``).
    Scores are bit-identical to :func:`maxplus_scan`'s.
    """
    _check(logA, emits, delta0)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_deltas_plain(logA, emits, delta0)
    return _scan_cuda(logA, emits, delta0, False, maxplus_scan_deltas)


maxplus_scan.launches = 0
maxplus_scan_deltas.launches = 0
