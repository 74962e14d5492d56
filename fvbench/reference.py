"""The plain references: exact Viterbi and FLASH-BS in PyTorch, and each
path's score in float64.

They work from the probability tables the benchmark drew (``gen.tables``),
never from the program's padded log tables, and import nothing of the
program.  :func:`viterbi` is the textbook recursion

    delta_t(j) = max_i [delta_{t-1}(i) + log A(i, j)] + log B(j, y_t)

in float32 over log tables it takes itself (float64 logs rounded once),
with each step's scores shifted by their maximum so that they stay near 0
and keep float32's resolution over thousands of steps, and back-pointers
walked from the best final state.  Its work is blocked so that it fits
beside the tables: ``lanes`` sequences at a time, and the target states in
chunks of the transposed table.

:func:`flash_bs` is the FLASH-BS decode the framework defines (a top-B
beam over all T that records N-1 anchors at the midpoints of
:func:`segments`, then N segments decoded by beams of their own between
forced ends; a segment whose end state left its beam is -1 throughout).
It makes the roundings and tie choices of that definition, so that a
sound program returns its paths exactly: ``delta + log A[beam rows]`` in
float32, the max over the beam, the emission added after the max, no
shift; the top B a stable descending sort (ties to the lower state), the
argmax the first maximum.

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
#: bytes of one beam step's sums, (lanes, B, K) float32
BEAM_BYTES = 2**30


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


def path_scores(A, B, Pi, ys, paths, gaps: bool = False) -> torch.Tensor:
    """(n,) float64 log-probabilities of ``paths`` (n, T) for ``ys``; -inf
    for a path with a state outside [0, K) or an edge of probability 0.
    With ``gaps``, a -1 is a position left out: it contributes nothing, nor
    do the edges into and out of it, and only a state outside [-1, K) makes
    the path -inf."""
    K = A.shape[0]
    p = paths.to(torch.int64)
    there = p >= 0 if gaps else torch.ones_like(p, dtype=torch.bool)
    inside = ((p >= -1 if gaps else p >= 0) & (p < K)).all(dim=1)
    p = p.clamp(0, K - 1)
    y = ys.to(torch.int64)
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    first = torch.where(there[:, 0], Pi[p[:, 0]].double().log(), zero)
    emit = torch.where(there, B[p, y].double().log(), zero)
    edge = torch.where(there[:, :-1] & there[:, 1:], A[p[:, :-1], p[:, 1:]].double().log(), zero)
    score = first + emit.sum(dim=1) + edge.sum(dim=1)
    return torch.where(inside, score, torch.full_like(score, float("-inf")))


def flash_midpoints(L: int, R: int, N: int) -> list[int]:
    """The N-1 balanced interior midpoints of [L, R]: the gaps of
    (R - L) // N, the first (R - L) % N of them one longer."""
    gap, extra = divmod(R - L, N)
    mids, m = [], L
    for _ in range(N - 1):
        m += gap + (1 if extra else 0)
        extra = max(extra - 1, 0)
        mids.append(m)
    return mids


def segment_count(T: int, num_segments: int) -> int:
    """The segments a FLASH-BS decode of T positions runs: ``num_segments``,
    cut to T // 2 (at least 1) where T < 2 * num_segments."""
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2))
    return N


def segments(T: int, num_segments: int) -> tuple[list[int], list[int]]:
    """(starts, lengths) of the anchored segments of a FLASH-BS decode of T
    positions: segment s covers [starts[s], starts[s] + lengths[s] - 1],
    bounded by the midpoints of [0, T - 1]."""
    N = segment_count(T, num_segments)
    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts = [0] + [m + 1 for m in mids]
    ends = mids + [T - 1]
    return starts, [e - s + 1 for s, e in zip(starts, ends)]


def flash_bs(A, B, Pi, ys, beam_width: int, num_segments: int,
             lanes: int | None = None) -> torch.Tensor:
    """(n, T) int64 FLASH-BS paths of the observation rows ``ys`` (n, T),
    -1 throughout a segment whose forced end state left its beam."""
    K = A.shape[0]
    # log_tables transposes what it is given: given A's transpose, log A itself
    logA, logB, logPi = log_tables(A.t(), B, Pi)
    Bw = min(int(beam_width), K)
    n = ys.shape[0]
    if lanes is None:
        lanes = max(1, min(n, BEAM_BYTES // (Bw * K * 4)))
    return torch.cat([_flash_bs_block(logA, logB, logPi, ys[b:b + lanes], Bw, num_segments)
                      for b in range(0, n, lanes)])


def _top(full, Bw):
    """The top ``Bw`` of each row: value descending, the lower state first
    on ties (+0.0 normalises -0.0, which a sort may rank apart)."""
    vals, idx = torch.sort(full + 0.0, dim=1, descending=True, stable=True)
    return vals[:, :Bw], idx[:, :Bw]


def _first(hit):
    """The lowest index along dim 1 where ``hit`` holds (the last index
    where none does)."""
    n = hit.shape[1]
    iota = torch.arange(n, device=hit.device).view([1, n] + [1] * (hit.dim() - 2))
    return torch.where(hit, iota, n).amin(dim=1).clamp(max=n - 1)


def _beam_step(logA, vals, states, emit):
    """full[l, i] = max_b (vals[l, b] + log A[states[l, b], i]) + emit[l, i],
    and the first b attaining each max."""
    sums = vals[:, :, None] + logA[states]  # (L, Bw, K) float32
    best = sums.amax(dim=1)
    return best + emit, _first(sums == best[:, None, :])


def _flash_bs_block(logA, logB, logPi, ys, Bw, num_segments):
    L, T = ys.shape
    dev = logA.device

    def emit(t):
        return logB[:, ys[:, t]].t()  # (L, K)

    starts, lens = segments(T, num_segments)
    mids = [s - 1 for s in starts[1:]]
    # phase 1: the beam over all T; plane p follows, for each beam entry,
    # the state its path holds at mids[p]
    vals, states = _top(logPi[None, :] + emit(0), Bw)
    planes = torch.full((L, len(mids), Bw), -1, dtype=torch.int64, device=dev)
    for t in range(1, T):
        full, slot = _beam_step(logA, vals, states, emit(t))
        vals, nxt = _top(full, Bw)
        won = slot.gather(1, nxt)
        for p, m in enumerate(mids):
            src = planes[:, p] if t > m + 1 else states
            planes[:, p] = src.gather(1, won)
        states = nxt
    anchors = planes[:, :, 0]
    begin = torch.cat([torch.zeros((L, 1), dtype=torch.int64, device=dev), anchors], dim=1)
    end = torch.cat([anchors, states[:, :1]], dim=1)
    out = torch.empty((L, T), dtype=torch.int64, device=dev)
    for s, (a, ln) in enumerate(zip(starts, lens)):
        first = logPi[None, :] if s == 0 else logA[begin[:, s].clamp(min=0)]
        vals, states = _top(first + emit(a), Bw)
        hist, ptrs = [states], []
        for t in range(a + 1, a + ln):
            full, slot = _beam_step(logA, vals, states, emit(t))
            vals, states = _top(full, Bw)
            ptrs.append(slot.gather(1, states))
            hist.append(states)
        match = states == end[:, s:s + 1]
        sl = _first(match)[:, None]
        for t in range(ln - 1, -1, -1):
            out[:, a + t] = hist[t].gather(1, sl)[:, 0]
            if t:
                sl = ptrs[t - 1].gather(1, sl)
        out[:, a:a + ln] = torch.where(match.any(dim=1)[:, None], out[:, a:a + ln], -1)
    return out
