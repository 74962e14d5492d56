"""The plain reference: Viterbi in PyTorch, and each path's score in float64.

It works from the probability tables the benchmark drew (``gen.tables``),
never from the program's padded log tables, and imports nothing of the
program.  :func:`viterbi` is the textbook recursion

    delta_t(j) = max_i [delta_{t-1}(i) + log A(i, j)] + log B(j, y_t)

in float32 over log tables it takes itself (float64 logs rounded once),
with each step's scores shifted by their maximum so that they stay near 0
and keep float32's resolution over thousands of steps, and back-pointers
walked from the best final state.  Its work is blocked so that it fits
beside the tables: ``lanes`` sequences at a time, and the target states in
chunks of the transposed table.

:func:`path_scores` scores any path in float64 from the probabilities, so a
path the program returned and the reference's own path are held to one
exact yardstick.
"""

from __future__ import annotations

import torch

#: bytes of one chunk's sums, (lanes, states, K) float32: on an H100 a
#: step at K=16384 took 1.33 ms with 1 GiB chunks, 1.45 ms with 128 MiB and
#: 2.00 ms with 32 MiB, where launches outnumber the work
CHUNK_BYTES = 2**30
#: bytes of back-pointers one block of lanes may hold, (T-1, lanes, K) int64
POINTER_BYTES = 2 * 2**30


def log_tables(A, B, Pi, table_dtype=torch.float32, block: int = 2048):
    """(log A transposed (K, K), log B (K, M), log Pi (K,)) in float32:
    float64 logs rounded to ``table_dtype`` (a bfloat16 table holds the
    bfloat16-rounded values in float32)."""
    K = A.shape[0]
    logAT = torch.empty((K, K), dtype=torch.float32, device=A.device)
    for j0 in range(0, K, block):
        logAT[j0:j0 + block] = A[:, j0:j0 + block].t().double().log().to(table_dtype).float()
    return logAT, B.double().log().float(), Pi.double().log().float()


def viterbi(A, B, Pi, ys, table_dtype=torch.float32, lanes: int | None = None):
    """(n, T) int64 best paths of the observation rows ``ys`` (n, T)."""
    logAT, logB, logPi = log_tables(A, B, Pi, table_dtype)
    K = A.shape[0]
    n, T = ys.shape
    if lanes is None:
        lanes = max(1, min(n, POINTER_BYTES // (max(T - 1, 1) * K * 8)))
    return torch.cat([_block(logAT, logB, logPi, ys[b:b + lanes]) for b in range(0, n, lanes)])


def _block(logAT, logB, logPi, ys):
    L, T = ys.shape
    K = logAT.shape[0]
    dev = logAT.device
    rows = max(1, min(K, CHUNK_BYTES // (L * K * 4)))
    sums = torch.empty((L, rows, K), dtype=torch.float32, device=dev)
    bp = torch.empty((max(T - 1, 1), L, K), dtype=torch.int64, device=dev)
    nxt = torch.empty((L, K), dtype=torch.float32, device=dev)
    delta = logPi[None, :] + logB[:, ys[:, 0]].t()
    for t in range(1, T):
        for j0 in range(0, K, rows):
            j1 = min(K, j0 + rows)
            s = sums[:, : j1 - j0]
            torch.add(logAT[None, j0:j1], delta[:, None, :], out=s)
            torch.max(s, dim=2, out=(nxt[:, j0:j1], bp[t - 1, :, j0:j1]))
        delta = nxt + logB[:, ys[:, t]].t()
        top = delta.amax(dim=1, keepdim=True)
        delta -= torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    path = torch.empty((L, T), dtype=torch.int64, device=dev)
    state = delta.argmax(dim=1)
    path[:, T - 1] = state
    for t in range(T - 1, 0, -1):
        state = bp[t - 1].gather(1, state[:, None])[:, 0]
        path[:, t - 1] = state
    return path


def path_scores(A, B, Pi, ys, paths) -> torch.Tensor:
    """(n,) float64 log-probabilities of ``paths`` (n, T) for ``ys``; -inf
    for a path with a state outside [0, K) or an edge of probability 0."""
    K = A.shape[0]
    p = paths.to(torch.int64)
    inside = ((p >= 0) & (p < K)).all(dim=1)
    p = p.clamp(0, K - 1)
    y = ys.to(torch.int64)
    score = (Pi[p[:, 0]].double().log() + B[p, y].double().log().sum(dim=1)
             + A[p[:, :-1], p[:, 1:]].double().log().sum(dim=1))
    return torch.where(inside, score, torch.full_like(score, float("-inf")))
