"""Backward walks: CUDA kernels and their plain versions.

``backtrack_batched`` follows a stored pointer table (counterpart of
``flash_viterbi_tpu/ops/pallas/backtrack.py:backtrack_pallas_batched``,
kernel ``csrc/backtrack.cu``).  ``argmax_walk`` re-derives each walked
step's argmax from the carry history (counterpart of
``argmax_walk_pallas``, kernel ``csrc/argmax_walk.cu``).

Every ``last_states[n]`` must be a state in [0, K).  On CPU tensors the
wrappers check it; on CUDA tensors the check would cost a device sync, so
the kernels instead write -1 where a walk has no valid state.
"""

from __future__ import annotations

import torch

from ..maxplus import first_argmax
from .common import expect, expect_contiguous, launch, on_cuda
from .maxplus import error_word, raise_on_error


def _check_last(last, N: int, K: int) -> torch.Tensor:
    if last.dtype not in (torch.int32, torch.int64) or last.numel() != N:
        raise ValueError(f"last_states must be {N} integer states, got "
                         f"{last.dtype} {tuple(last.shape)}")
    last = last.reshape(N).to(torch.int32).contiguous()
    if last.device.type == "cpu" and bool(((last < 0) | (last >= K)).any()):
        raise ValueError(f"last_states outside [0, {K}): {last.tolist()}")
    return last


def backtrack_batched_plain(ptrs: torch.Tensor, last_states: torch.Tensor):
    """Plain version of :func:`backtrack_batched`."""
    Tm, N, K = ptrs.shape
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=ptrs.device)
    s = last_states.reshape(N).to(torch.int64)
    out[:, Tm] = s
    lanes = torch.arange(N, device=ptrs.device)
    for t in range(Tm - 1, -1, -1):
        ok = (s >= 0) & (s < K)
        s = torch.where(ok, ptrs[t, lanes, s.clamp(0, K - 1)].to(torch.int64), -1)
        out[:, t] = s
    return out


def backtrack_batched(ptrs: torch.Tensor, last_states: torch.Tensor) -> torch.Tensor:
    """Reverse pointer walk over N independent lanes.

    Args:
      ptrs: (T', N, K) int32 — row t holds lane n's predecessors for the
        step into t+1 (the layout :func:`maxplus_scan` emits).
      last_states: (N,) integer states at the final time.

    Returns:
      (N, T'+1) int32 paths ending in ``last_states``.
    """
    if ptrs.dim() != 3:
        raise ValueError(f"ptrs must be (T', N, K), got {tuple(ptrs.shape)}")
    Tm, N, K = ptrs.shape
    expect("ptrs", ptrs, torch.int32, (Tm, N, K))
    last = _check_last(last_states, N, K)
    if Tm == 0:
        return last[:, None]
    if not on_cuda(ptrs, last):
        return backtrack_batched_plain(ptrs, last)
    expect_contiguous(ptrs=ptrs)
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=ptrs.device)
    launch("fvt_backtrack", backtrack_batched, ptrs.device,
           ptrs.data_ptr(), last.data_ptr(), out.data_ptr(), Tm, N, K)
    return out


def argmax_walk_plain(deltas: torch.Tensor, logAT: torch.Tensor,
                      last_states: torch.Tensor, valid: torch.Tensor | None = None):
    """Plain version of :func:`argmax_walk`, all lanes of a row at once."""
    Tm, N, K = deltas.shape
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=deltas.device)
    s = last_states.reshape(N).to(torch.int64)
    out[:, Tm] = s
    for t in range(Tm - 1, -1, -1):
        _, idx = first_argmax(deltas[t] + logAT[s], 1)
        if valid is not None:
            idx = torch.where(valid[t], idx, s.to(torch.int32))
        out[:, t] = idx
        s = idx.to(torch.int64)
    return out


def argmax_walk(deltas: torch.Tensor, logAT: torch.Tensor,
                last_states: torch.Tensor, valid: torch.Tensor | None = None, *,
                err: torch.Tensor | None = None) -> torch.Tensor:
    """Backtrack over the carry history ``deltas``.

    Args:
      deltas: (T', N, K) f32 — ``deltas[t]`` is the carry before forward
        step t (:func:`maxplus_scan_deltas`'s second output).
      logAT:  (K, K) f32 — the transposed transition table (row s holds
        the logA column of destination s).
      last_states: (N,) integer states at the final time.
      valid: optional (T', N) bool — False keeps the lane's state at that
        row (ragged segments).  None: every row is real.
      err: an error word (``maxplus.error_word``) shared by several calls
        and read by the caller; by default the call reads its own and
        raises if a wait for a prefetched carry row timed out.  The CPU's
        plain version ignores it.

    Returns (N, T'+1) int32 paths ending in ``last_states``:
    ``path[t] = lowest argmax_k(deltas[t][n, k] + logAT[path[t+1], k])``.
    """
    if deltas.dim() != 3:
        raise ValueError(f"deltas must be (T', N, K), got {tuple(deltas.shape)}")
    Tm, N, K = deltas.shape
    expect("deltas", deltas, torch.float32, (Tm, N, K))
    expect("logAT", logAT, torch.float32, (K, K))
    if valid is not None:
        expect("valid", valid, torch.bool, (Tm, N))
    last = _check_last(last_states, N, K)
    if Tm == 0:
        return last[:, None]
    tensors = (deltas, logAT, last) + (() if valid is None else (valid,))
    if not on_cuda(*tensors):
        return argmax_walk_plain(deltas, logAT, last, valid)
    expect_contiguous(deltas=deltas, logAT=logAT)
    # bulk copies and 16-byte loads need 16-byte-aligned rows' bases
    deltas, logAT = (x.clone() if x.data_ptr() % 16 else x for x in (deltas, logAT))
    if valid is not None:
        valid = valid.contiguous()
    own = err is None
    if own:
        err = error_word(deltas.device)
    else:
        expect("err", err, torch.int32, (1,))
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=deltas.device)
    launch("fvt_argmax_walk", argmax_walk, deltas.device,
           deltas.data_ptr(), logAT.data_ptr(), last.data_ptr(),
           None if valid is None else valid.data_ptr(), out.data_ptr(), err.data_ptr(),
           Tm, N, K)
    if own:
        raise_on_error(err, "argmax_walk")
    return out


backtrack_batched.launches = 0
argmax_walk.launches = 0
