"""Tropical (max-plus) trellis primitives in plain PyTorch.

Counterpart of ``flash_viterbi_tpu/ops/maxplus.py``.  One trellis step::

    delta'[i] = max_k ( delta[k] + logA[k, i] ) + logB[i, y_t]
    ptr[i]    = lowest k attaining the max

Numerics contract (shared with the JAX package and the CUDA kernels): the
inner sum ``delta + logA`` in fp32, the max over the source index, the
emission added after the max, and the lowest index on ties.  The tie rule
is written out as ``min(where(x == max, iota, K))`` rather than left to
``torch.argmax``, so it holds on every device and backend.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

#: the transition table's precisions a decoder takes: "bf16" rounds logA to
#: bfloat16 (JAX's ``logA.astype(jnp.bfloat16)``) and leaves every sum, max
#: and carry in fp32 -- an approximate mode, exact for the rounded table
PRECISIONS = ("fp32", "bf16")


def table_at(logA: torch.Tensor, precision: str) -> torch.Tensor:
    """``logA`` as a decode at ``precision`` reads it: itself under "fp32",
    rounded to bfloat16 (to nearest, ties to even, as XLA converts) under
    "bf16"; a bf16 value promotes to fp32 exactly wherever it meets an fp32
    operand.  ValueError for another precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    return logA.to(torch.bfloat16) if precision == "bf16" else logA


def transposed(logA: torch.Tensor) -> torch.Tensor:
    """A copy of ``logA`` transposed and contiguous, the layout
    ``argmax_walk`` reads (row s holds the column of destination s)."""
    with span("fvt.transpose"):
        return logA.t().contiguous()


def first_argmax(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, lowest index attaining it) along ``dim``; int32 indices.

    All -inf slices (dead padded states) resolve to index 0."""
    val = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=x.device).reshape(shape)
    idx = torch.where(x == val, iota, n).amin(dim=dim)
    return val.squeeze(dim), idx


def maxplus_step(delta: torch.Tensor, logA: torch.Tensor, emit: torch.Tensor):
    """One trellis step: (K,) scores, (K, K) logA (source rows, dest
    columns), (K,) emission column -> ((K,) new scores, (K,) int32 ptr)."""
    scores = delta[:, None] + logA
    val, ptr = first_argmax(scores, 0)
    return val + emit, ptr


def maxplus_step_noptr(delta: torch.Tensor, logA: torch.Tensor, emit: torch.Tensor):
    """Pointer-free step."""
    return (delta[:, None] + logA).amax(dim=0) + emit


def init_delta(logPi: torch.Tensor, logB: torch.Tensor, y0) -> torch.Tensor:
    """delta_0 = logPi + logB[:, y_0]  (reference :142)."""
    return logPi + logB[:, y0]


def forced_delta(logA: torch.Tensor, logB: torch.Tensor, state, y_t) -> torch.Tensor:
    """delta at a segment's entry, forced from the known previous state
    (reference :147-151): logA[state, :] + logB[:, y_t]."""
    return logA[state, :] + logB[:, y_t]


def forward_scan(delta0: torch.Tensor, logA: torch.Tensor, emits: torch.Tensor):
    """Forward pass over ``emits`` (T', K) from ``delta0`` (K,).

    Returns (delta_final (K,), ptrs (T', K) int32)."""
    delta = delta0
    ptrs = torch.empty(emits.shape, dtype=torch.int32, device=emits.device)
    for t in range(emits.shape[0]):
        delta, ptrs[t] = maxplus_step(delta, logA, emits[t])
    return delta, ptrs


def forward_scan_noptr(delta0: torch.Tensor, logA: torch.Tensor,
                       emits: torch.Tensor) -> torch.Tensor:
    """Score-only forward pass over ``emits`` (T', K) from ``delta0`` (K,):
    the final (K,) scores, a loop of :func:`maxplus_step_noptr` (no kernel)."""
    delta = delta0
    for t in range(emits.shape[0]):
        delta = maxplus_step_noptr(delta, logA, emits[t])
    return delta


def backtrack(ptrs: torch.Tensor, last_state: torch.Tensor) -> torch.Tensor:
    """Reverse pointer walk: ptrs (T', K) int32, scalar last state ->
    (T'+1,) int32 path ending in ``last_state``."""
    Tm = ptrs.shape[0]
    path = torch.empty(Tm + 1, dtype=torch.int32, device=ptrs.device)
    state = last_state.to(torch.int64).reshape(())
    path[Tm] = state
    for t in range(Tm - 1, -1, -1):
        state = ptrs[t, state].to(torch.int64)
        path[t] = state
    return path


def argmax_final(delta: torch.Tensor) -> torch.Tensor:
    """Lowest-index argmax of the final scores, int32 scalar."""
    return first_argmax(delta, 0)[1]


def path_score(logA, logB, logPi, y, path) -> torch.Tensor:
    """Log-likelihood of a state path (fp32, for cross-checks)."""
    p = path.to(torch.int64)
    yv = y.to(torch.int64)
    e = logPi[p[0]] + logB[p[0], yv[0]]
    trans = logA[p[:-1], p[1:]]
    emits = logB[p[1:], yv[1:]]
    return e + torch.sum(trans + emits)
