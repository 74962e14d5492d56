"""The fused max-plus scans and the state-sharded step: CUDA kernels and
their plain versions.

Counterparts of ``flash_viterbi_tpu/ops/pallas/maxplus.py``'s
``maxplus_scan``, ``maxplus_scan_deltas``, ``maxplus_scan_emitgather`` and
``maxplus_step_block``, with the same signatures and layouts.  The kernel
is ``csrc/maxplus_scan.cu``.
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


def _check_eg(logA, logBT, ys, delta0) -> tuple[int, int, int]:
    if ys.dim() != 2 or logBT.dim() != 2:
        raise ValueError(f"ys must be (T', N) and logBT (M, K), got "
                         f"{tuple(ys.shape)} and {tuple(logBT.shape)}")
    Tm, N = ys.shape
    M, K = logBT.shape
    if K < 1 or N < 1 or M < 1:
        raise ValueError(f"empty state, lane or symbol dimension: M={M}, N={N}, K={K}")
    expect("logA", logA, torch.float32, (K, K))
    expect("logBT", logBT, torch.float32, (M, K))
    expect("ys", ys, torch.int32, (Tm, N))
    expect("delta0", delta0, torch.float32, (N, K))
    if ys.device.type == "cpu" and bool(((ys < 0) | (ys >= M)).any()):
        raise ValueError(f"symbols outside [0, {M}) in ys")
    return Tm, N, K


def maxplus_scan_emitgather_plain(logA, logBT, ys, delta0):
    """Plain version of :func:`maxplus_scan_emitgather`: gathers each
    lane's emission rows, then runs the forward scan one lane at a time."""
    Tm, N, K = _check_eg(logA, logBT, ys, delta0)
    dfin = torch.empty_like(delta0)
    ptrs = torch.empty((Tm, N, K), dtype=torch.int32, device=ys.device)
    for n in range(N):
        dfin[n], ptrs[:, n] = mp.forward_scan(delta0[n], logA,
                                              logBT[ys[:, n].to(torch.int64)])
    return dfin, ptrs


def _scan_cuda(fn_name: str, counter, inputs: dict, delta0, Tm: int,
               with_ptr: bool):
    """Launch C entry point ``fn_name`` on ``inputs`` (logA and the
    emission operands, in its argument order); returns (dfin, ptrs) or
    (dfin, deltas)."""
    N, K = delta0.shape
    expect_contiguous(delta0=delta0, **inputs)
    dev = delta0.device
    hist = torch.empty((Tm, N, K), device=dev,
                       dtype=torch.int32 if with_ptr else torch.float32)
    if Tm == 0:
        return delta0, hist
    dfin = torch.empty((N, K), dtype=torch.float32, device=dev)
    work = torch.empty((2, N, K), dtype=torch.float32, device=dev)
    launch(fn_name, counter, dev, *(t.data_ptr() for t in inputs.values()),
           delta0.data_ptr(), dfin.data_ptr(),
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
    return _scan_cuda("fvt_maxplus_scan", maxplus_scan,
                      {"logA": logA, "emits": emits}, delta0, emits.shape[0], True)


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
    return _scan_cuda("fvt_maxplus_scan", maxplus_scan_deltas,
                      {"logA": logA, "emits": emits}, delta0, emits.shape[0], False)


def maxplus_scan_emitgather(logA: torch.Tensor, logBT: torch.Tensor,
                            ys: torch.Tensor, delta0: torch.Tensor):
    """The pointer scan with each step's emission row gathered in the
    kernel, so no (T', N, K) emission buffer is built.

    Args:
      logA:   (K, K) fp32.
      logBT:  (M, K) fp32, the transposed emission table ``logB.T``.
      ys:     (T', N) int32 symbols for steps 1..T', each in [0, M).  CPU
        tensors are checked; on CUDA the check would cost a device sync,
        so the caller validates the symbols before upload.
      delta0: (N, K) fp32.

    Returns (delta_final (N, K) fp32, ptrs (T', N, K) int32), bit-identical
    to :func:`maxplus_scan` on the gathered emissions.
    """
    Tm, _, _ = _check_eg(logA, logBT, ys, delta0)
    if not on_cuda(logA, logBT, ys, delta0):
        return maxplus_scan_emitgather_plain(logA, logBT, ys, delta0)
    return _scan_cuda("fvt_maxplus_scan_eg", maxplus_scan_emitgather,
                      {"logA": logA, "logBT": logBT, "ys": ys}, delta0, Tm, True)


def _check_step(delta, logA_block) -> tuple[int, int, int]:
    if delta.dim() != 2 or logA_block.dim() != 2:
        raise ValueError(f"delta must be (N, Ks) and logA_block (Ks, Kd), got "
                         f"{tuple(delta.shape)} and {tuple(logA_block.shape)}")
    N, Ks = delta.shape
    Kd = logA_block.shape[1]
    if N < 1 or Ks < 1 or Kd < 1:
        raise ValueError(f"empty lane, source or destination dimension: "
                         f"N={N}, Ks={Ks}, Kd={Kd}")
    expect("delta", delta, torch.float32, (N, Ks))
    expect("logA_block", logA_block, torch.float32, (Ks, Kd))
    return N, Ks, Kd


def step_block_supported(Ks: int, Kd: int) -> bool:
    """The kernel takes every positive shape (kept for parity with the JAX
    package, whose Pallas tiling refuses some)."""
    return Ks >= 1 and Kd >= 1


def maxplus_step_block_plain(delta, logA_block):
    """Plain version of :func:`maxplus_step_block`, one lane at a time
    (scratch stays at one (Ks, Kd) tensor)."""
    N, _, Kd = _check_step(delta, logA_block)
    val = torch.empty((N, Kd), dtype=torch.float32, device=delta.device)
    ptr = torch.empty((N, Kd), dtype=torch.int32, device=delta.device)
    for n in range(N):
        val[n], ptr[n] = mp.first_argmax(delta[n][:, None] + logA_block, 0)
    return val, ptr


def maxplus_step_block(delta: torch.Tensor, logA_block: torch.Tensor):
    """One trellis step against a column shard of logA.

    Args:
      delta:      (N, Ks) fp32 full-source carry.
      logA_block: (Ks, Kd) fp32, a column slice ``logA[:, lo:lo+Kd]``.

    Returns:
      (val (N, Kd) fp32 pre-emission scores,
       ptr (N, Kd) int32 global source indices, the lowest attaining each max).
    """
    N, Ks, Kd = _check_step(delta, logA_block)
    if not on_cuda(delta, logA_block):
        return maxplus_step_block_plain(delta, logA_block)
    expect_contiguous(delta=delta, logA_block=logA_block)
    dev = delta.device
    val = torch.empty((N, Kd), dtype=torch.float32, device=dev)
    ptr = torch.empty((N, Kd), dtype=torch.int32, device=dev)
    launch("fvt_maxplus_step_block", maxplus_step_block, dev, delta.data_ptr(),
           logA_block.data_ptr(), val.data_ptr(), ptr.data_ptr(), N, Ks, Kd)
    return val, ptr


maxplus_scan.launches = 0
maxplus_scan_deltas.launches = 0
maxplus_scan_emitgather.launches = 0
maxplus_step_block.launches = 0
