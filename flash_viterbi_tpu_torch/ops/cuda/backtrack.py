"""Backward walks: CUDA kernels and their plain versions.

``backtrack_batched`` follows a stored pointer table (counterpart of
``flash_viterbi_tpu/ops/pallas/backtrack.py:backtrack_pallas_batched``,
kernel ``csrc/backtrack.cu``): one launch over the plan of
:func:`backtrack_plan` (pure Python), a walk of one thread a lane for
short tables, else three phases that fold chunks of rows into index maps,
walk the chunk boundaries and write the path.  ``argmax_walk`` re-derives
each walked step's argmax from the carry history (counterpart of
``argmax_walk_pallas``, kernel ``csrc/argmax_walk.cu``).  A bfloat16
``logAT`` (``precision="bf16"``) goes to the kernel's bf16 instance, whose
wrapper :func:`argmax_walk_bf16` counts its own launches.

Every ``last_states[n]`` must be a state in [0, K).  On CPU tensors the
wrappers check it; on CUDA tensors the check would cost a device sync, so
the kernels instead write -1 where a walk has no valid state.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..maxplus import first_argmax
from .common import expect, expect_contiguous, launch, on_cuda
from .maxplus import TABLE_DTYPES, error_word, raise_on_error, sm_count

THREADS = 512         # threads of a chunked CTA (csrc: THREADS)
SERIAL_THREADS = 32   # threads of a serial block (csrc: SERIAL_THREADS)
E_MAX = 16            # map entries a thread keeps (csrc: the largest E instance)
S_MAX = 16            # slices of K a chunk's map is folded in, at most
# Where backtrack_plan keeps the serial walk (NVIDIA H100 80GB HBM3, 700 W;
# results/torch_backtrack_sweep.jsonl): fewer rows than SERIAL_ROWS (a
# chunked plan's fixed cost is ~30 serial steps), or more than
# SERIAL_ENTRIES entries a row over all lanes (the chunked walk reads the
# whole table: at K=3968 it wins at 8 lanes, not at 16)
SERIAL_ROWS = 32
SERIAL_ENTRIES = 1 << 15


class BacktrackPlan(NamedTuple):
    """How ``backtrack_batched``'s kernel walks a (T', N, K) table.

    ``G`` = 1: the serial walk, a thread a lane over its ``L`` = T' rows.
    Else T' splits into ``G`` chunks of ``L`` rows (the last holds T' -
    (G-1)·L); each chunk's map is folded in ``S`` slices of K, one CTA of
    THREADS an (chunk, lane, slice) item, a thread keeping ``E`` entries (a
    power of two: the kernel's instance), over ``blocks`` CTAs (one an SM
    at most: one wave)."""

    G: int
    L: int
    S: int = 1
    blocks: int = 1
    E: int = 1

    @property
    def serial(self) -> bool:
        return self.G == 1

    def scratch_words(self, N: int, K: int) -> int:
        """int32 words of global scratch a call allocates: the G maps of
        every lane (N·G·K) and the chunk boundaries (N·(G+1)); 0 serial."""
        return 0 if self.serial else N * self.G * K + N * (self.G + 1)

    def c_args(self):
        """The int array the C entry point takes (csrc: PlanField)."""
        fields = (self.G, self.L, self.S, self.blocks, self.E)
        return (ctypes.c_int * len(fields))(*fields)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def serial_plan(Tm: int, N: int) -> BacktrackPlan:
    return BacktrackPlan(G=1, L=Tm, blocks=_cdiv(N, SERIAL_THREADS))


def chunked_plan(Tm: int, N: int, K: int, sms: int, L: int,
                 S: int = 1) -> BacktrackPlan | None:
    """The chunked plan of chunks of ``L`` rows and ``S`` slices, or None
    where the kernel cannot run it: fewer than 2 chunks, or more than E_MAX
    entries a thread."""
    G = _cdiv(Tm, L)
    E = 1 << (_cdiv(_cdiv(K, S), THREADS) - 1).bit_length()
    if G < 2 or not 1 <= S <= K or E > E_MAX:
        return None
    return BacktrackPlan(G=G, L=L, S=S, blocks=min(sms, G * N * S), E=E)


def backtrack_plan(Tm: int, N: int, K: int, sms: int, *, L: int | None = None,
                   S: int | None = None) -> BacktrackPlan:
    """The plan of a walk over a (T', N, K) table on a card of ``sms`` SMs.

    By default the serial walk below SERIAL_ROWS rows, above SERIAL_ENTRIES
    entries a row, or where fewer than 2 chunks of every lane fit one wave;
    else one wave of G·N·S <= ``sms`` CTAs: G near sqrt(2·T') (a chunk's L
    rows cost phases A and C about two dependent steps each, phase B one a
    chunk), capped by the wave, and S the most slices (a power of two up to
    S_MAX, a slice keeping THREADS entries or more) the wave holds, at least
    the least that keeps E within E_MAX.  ``L`` (with ``S``, default 1)
    forces a chunked plan; ``L`` >= T' forces the serial one; a forced plan
    the kernel cannot run raises."""
    if min(Tm, N, K, sms) < 1:
        raise ValueError(f"need T', N, K, sms >= 1, got {Tm}, {N}, {K}, {sms}")
    if L is not None:
        if L >= Tm:
            return serial_plan(Tm, N)
        got = chunked_plan(Tm, N, K, sms, L, S or 1)
        if got is None:
            raise ValueError(f"no chunked plan of L={L}, S={S or 1} for T'={Tm}, K={K}")
        return got
    s_min = 1 << (_cdiv(K, E_MAX * THREADS) - 1).bit_length()
    g_max = sms // (N * s_min)
    if Tm < SERIAL_ROWS or N * K > SERIAL_ENTRIES or g_max < 2:
        return serial_plan(Tm, N)
    L = _cdiv(Tm, min(g_max, round(math.sqrt(2 * Tm))))
    G = _cdiv(Tm, L)
    S = s_min
    while 2 * S <= min(S_MAX, K // THREADS) and G * N * 2 * S <= sms:
        S *= 2
    return chunked_plan(Tm, N, K, sms, L, S)


def _check_plan(plan: BacktrackPlan, Tm: int, N: int, K: int) -> None:
    if plan.serial:
        ok = plan.L == Tm
    else:
        ok = (plan.G == _cdiv(Tm, plan.L) and plan.G >= 2 and plan.E * THREADS * plan.S >= K
              and 1 <= plan.blocks <= plan.G * N * plan.S)
    if not ok:
        raise ValueError(f"the plan {plan} does not fit T'={Tm}, N={N}, K={K}")


# the plan of each shape a process walks, made once (the rule costs ~6 us of
# host time a call; a call's host time is part of its latency)
_cached_plan = functools.lru_cache(maxsize=256)(backtrack_plan)

_tickets: dict = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The chunked kernel's ticket word of ``device``'s current stream: zeroed
    once, and left zero by every launch (its last CTA resets it), so a call
    pays no memset.  Calls on one stream run one after another."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def _check_last(last, N: int, K: int) -> torch.Tensor:
    if last.dtype not in (torch.int32, torch.int64) or last.numel() != N:
        raise ValueError(f"last_states must be {N} integer states, got "
                         f"{last.dtype} {tuple(last.shape)}")
    last = last.reshape(N).to(torch.int32).contiguous()
    if last.device.type == "cpu" and bool(((last < 0) | (last >= K)).any()):
        raise ValueError(f"last_states outside [0, {K}): {last.tolist()}")
    return last


def backtrack_batched_plain(ptrs: torch.Tensor, last_states: torch.Tensor):
    """Plain version of :func:`backtrack_batched`: the walk one row at a
    time, ``s <- max(ptrs[t, n, s], -1)`` where s is in [0, K), else -1."""
    Tm, N, K = ptrs.shape
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=ptrs.device)
    s = last_states.reshape(N).to(torch.int64)
    out[:, Tm] = s
    lanes = torch.arange(N, device=ptrs.device)
    for t in range(Tm - 1, -1, -1):
        ok = (s >= 0) & (s < K)
        row = ptrs[t, lanes, s.clamp(0, K - 1)].to(torch.int64).clamp_min(-1)
        s = torch.where(ok, row, -1)
        out[:, t] = s
    return out


def backtrack_batched(ptrs: torch.Tensor, last_states: torch.Tensor, *,
                      plan: BacktrackPlan | None = None) -> torch.Tensor:
    """Reverse pointer walk over N independent lanes.

    Args:
      ptrs: (T', N, K) int32 — row t holds lane n's predecessors for the
        step into t+1 (the layout :func:`maxplus_scan` emits).
      last_states: (N,) integer states at the final time.
      plan: the kernel's split (default: :func:`backtrack_plan` for the
        card).  The CPU's plain version ignores it.

    Returns:
      (N, T'+1) int32 paths ending in ``last_states``: ``path[t] =
      max(ptrs[t, n, path[t+1]], -1)`` where ``path[t+1]`` is in [0, K),
      else -1 (the TPU kernel's rule).  The kernel waits on nothing, so it
      has no error word.
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
    dev = ptrs.device
    if plan is None:
        plan = _cached_plan(Tm, N, K, sm_count(dev))
    else:
        _check_plan(plan, Tm, N, K)
    out = torch.empty((N, Tm + 1), dtype=torch.int32, device=dev)
    scratch = (None if plan.serial else
               torch.empty(plan.scratch_words(N, K), dtype=torch.int32, device=dev))
    launch("fvt_backtrack", backtrack_batched, dev, ptrs.data_ptr(), last.data_ptr(),
           out.data_ptr(), None if scratch is None else scratch.data_ptr(),
           None if plan.serial else _ticket(dev).data_ptr(), plan.c_args(), Tm, N, K)
    return out


def argmax_walk_plain(deltas: torch.Tensor, logAT: torch.Tensor,
                      last_states: torch.Tensor, valid: torch.Tensor | None = None):
    """Plain version of :func:`argmax_walk` (and :func:`argmax_walk_bf16`),
    all lanes of a row at once; a bf16 ``logAT`` is promoted in the fp32
    sum ``deltas[t] + logAT[s]``."""
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
      logAT:  (K, K) f32 or bf16 — the transposed transition table (row s
        holds the logA column of destination s); a bf16 one goes to
        :func:`argmax_walk_bf16` on CUDA tensors.
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
    return _walk(deltas, logAT, last_states, valid, err, TABLE_DTYPES)


def argmax_walk_bf16(deltas: torch.Tensor, logAT: torch.Tensor,
                     last_states: torch.Tensor, valid: torch.Tensor | None = None, *,
                     err: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`argmax_walk` on a (K, K) bfloat16 ``logAT``, its own kernel
    instance and launch count.  The CPU's plain version is
    :func:`argmax_walk_plain`."""
    return _walk(deltas, logAT, last_states, valid, err, (torch.bfloat16,))


def _walk(deltas, logAT, last_states, valid, err, tables):
    """Check the walk's arguments (``logAT`` of a dtype in ``tables``) and
    run the plain version on CPU tensors, else the kernel instance of
    ``logAT``'s dtype."""
    if deltas.dim() != 3:
        raise ValueError(f"deltas must be (T', N, K), got {tuple(deltas.shape)}")
    Tm, N, K = deltas.shape
    expect("deltas", deltas, torch.float32, (Tm, N, K))
    expect("logAT", logAT, tables, (K, K))
    if valid is not None:
        expect("valid", valid, torch.bool, (Tm, N))
    last = _check_last(last_states, N, K)
    if Tm == 0:
        return last[:, None]
    tensors = (deltas, logAT, last) + (() if valid is None else (valid,))
    if not on_cuda(*tensors):
        return argmax_walk_plain(deltas, logAT, last, valid)
    fn_name, counter = (("fvt_argmax_walk_bf16", argmax_walk_bf16)
                        if logAT.dtype == torch.bfloat16 else ("fvt_argmax_walk", argmax_walk))
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
    launch(fn_name, counter, deltas.device,
           deltas.data_ptr(), logAT.data_ptr(), last.data_ptr(),
           None if valid is None else valid.data_ptr(), out.data_ptr(), err.data_ptr(),
           Tm, N, K)
    if own:
        raise_on_error(err, "argmax_walk")
    return out


backtrack_batched.launches = 0
argmax_walk.launches = 0
argmax_walk_bf16.launches = 0
