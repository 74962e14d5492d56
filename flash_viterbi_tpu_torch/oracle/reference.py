"""NumPy mirror of the reference C FLASH recursion, bit-exact to it.

The tie-flip arbiter's yardstick (``oracle.validate``): the C program's
phase-1 N-divide pass and its binary interval splitting, step by step, in
either numerics:

* ``"c"``   — the C float dance bit for bit: probabilities stored fp32,
  ``log()`` in float64, sums in the C program's order and precision with
  truncation to fp32 where it assigns to ``ElementType``.
* ``"f32"`` — the framework's numerics contract: float64 logs truncated to
  fp32 once, the inner sum ``delta + logA`` in fp32, the emission added
  after the max.  FLASH's lean mode performs the same IEEE operations in
  the same order, so its paths equal this mode's exactly.

Ties: strict-greater scans, so the lowest index wins (``np.argmax``'s
first occurrence).  NaN scores never win in C; they map to -inf before the
argmax.  Copied from ``flash_viterbi_tpu/oracle/reference.py`` (its
``_log64`` .. ``_trellis_step`` and ``flash``), kept here because the port
never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64


def _log64(p: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(np.asarray(p, dtype=F64))


def _sanitize(scores: np.ndarray) -> np.ndarray:
    """NaN candidates never win a strict-> scan; treat them as -inf."""
    return np.where(np.isnan(scores), -np.inf, scores)


class Tables:
    """Precomputed log tables for one problem, in both precisions.

    ``quantize_probs`` mirrors the C loaders storing probabilities as fp32
    before the (float64) log is taken.
    """

    def __init__(self, A, B, Pi, y, quantize_probs: bool = True):
        A = np.asarray(A, dtype=F64)
        B = np.asarray(B, dtype=F64)
        Pi = np.asarray(Pi, dtype=F64)
        if quantize_probs:
            A, B, Pi = (x.astype(F32).astype(F64) for x in (A, B, Pi))
        self.logA64 = _log64(A)
        self.logB64 = _log64(B)
        self.logPi64 = _log64(Pi)
        self.logA32 = self.logA64.astype(F32)
        self.logB32 = self.logB64.astype(F32)
        self.logPi32 = self.logPi64.astype(F32)
        self.Pi = Pi  # probability-domain Pi (post-quantize) for callers
        # that re-log per access like the C (e.g. SIEVE-Mp's root Pi)
        self.y = np.asarray(y, dtype=np.int64)
        self.K = A.shape[0]
        self.M = B.shape[1]
        self.T = len(self.y)


# ---------------------------------------------------------------------------
# Trellis step kernels (vectorized over (k_src, i_dst)) for both numerics
# and both C summation orders.
# ---------------------------------------------------------------------------

def _step32(tb: Tables, delta: np.ndarray, t: int):
    """Framework-contract f32 step: (delta_new, argmax).  Inner sum
    ``delta + logA`` in fp32; emission added after the max (see module doc)."""
    s = _sanitize((delta[:, None] + tb.logA32).astype(F32))
    arg = np.argmax(s, axis=0)
    d = (np.max(s, axis=0).astype(F32) + tb.logB32[:, tb.y[t]]).astype(F32)
    return d, arg


def _step_scores_vanilla(tb: Tables, delta: np.ndarray, t: int, numerics: str):
    """C vanilla order: fl32( (delta_k + logA64) + logB64 )  [vanilla Viterbi.c:140]."""
    assert numerics == "c"
    s = (delta.astype(F64)[:, None] + tb.logA64) + tb.logB64[None, :, tb.y[t]]
    return s.astype(F32)


def _step_scores_flash(tb: Tables, delta: np.ndarray, t: int, numerics: str):
    """FLASH order: fl32( f64(fl32(logB32 + delta_k)) + logA64 )
    [FLASH_Viterbi_multithread.c:167-170]."""
    assert numerics == "c"
    emit32 = tb.logB64[:, tb.y[t]].astype(F32)
    inner = (emit32[None, :] + delta[:, None]).astype(F32)
    return (inner.astype(F64) + tb.logA64).astype(F32)


def _init_delta_pi(tb: Tables, numerics: str) -> np.ndarray:
    if numerics == "c":
        return (tb.logPi64 + tb.logB64[:, tb.y[0]]).astype(F32)
    return (tb.logPi32 + tb.logB32[:, tb.y[0]]).astype(F32)


def _init_delta_forced(tb: Tables, state: int, t: int, numerics: str) -> np.ndarray:
    """delta at time t forced from known state at t-1
    [FLASH_Viterbi_multithread.c:147-151]."""
    if numerics == "c":
        return (tb.logA64[state, :] + tb.logB64[:, tb.y[t]]).astype(F32)
    return (tb.logA32[state, :] + tb.logB32[:, tb.y[t]]).astype(F32)


def _argmax_low(v: np.ndarray) -> int:
    return int(np.argmax(_sanitize(v)))


def _trellis_step(tb: Tables, delta: np.ndarray, t: int, numerics: str, order: str):
    """One full trellis step: (delta_new, argmax) under either numerics mode.

    ``order`` selects the C summation order ("vanilla" or "flash"); it is
    ignored for the framework's "f32" contract, which has a single order.
    """
    if numerics == "c":
        fn = _step_scores_vanilla if order == "vanilla" else _step_scores_flash
        s = _sanitize(fn(tb, delta, t, numerics))
        return np.max(s, axis=0).astype(F32), np.argmax(s, axis=0)
    return _step32(tb, delta, t)


# ---------------------------------------------------------------------------
# FLASH Viterbi  [src/FLASH_Viterbi_multithread.c]
# ---------------------------------------------------------------------------

def _flash_midpoints(L: int, R: int, N: int) -> list[int]:
    """Balanced midpoints [FLASH_Viterbi_multithread.c:129-136]."""
    gap, extra = divmod(R - L, N)
    mids = []
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


def _nvviter(tb: Tables, ans: np.ndarray, L: int, R: int, mid: int, numerics: str):
    """Single-midpoint segment decode [FLASH_Viterbi_multithread.c:204-262]."""
    T = tb.T
    if L == 0:
        delta = _init_delta_pi(tb, numerics)
        t2 = np.zeros(tb.K, dtype=np.int64)
    else:
        state = int(ans[L - 1])
        delta = _init_delta_forced(tb, state, L, numerics)
        t2 = np.full(tb.K, state, dtype=np.int64)
    for j in range(L + 1, R + 1):
        delta, arg = _trellis_step(tb, delta, j, numerics, "flash")
        t2 = t2[arg] if j > mid + 1 else arg
    a = int(ans[R])
    if L == 0 and R == T - 1:
        a = _argmax_low(delta)
        ans[R] = a
    ans[mid] = t2[a]


def _nvviter_ndivide(tb: Tables, ans: np.ndarray, L: int, R: int, N: int,
                     numerics: str) -> list[int]:
    """Multi-midpoint phase-1 pass [FLASH_Viterbi_multithread.c:126-201]."""
    T = tb.T
    mids = _flash_midpoints(L, R, N)
    if L == 0:
        delta = _init_delta_pi(tb, numerics)
        planes = np.zeros((N - 1, tb.K), dtype=np.int64)
    else:
        state = int(ans[L - 1])
        delta = _init_delta_forced(tb, state, L, numerics)
        planes = np.full((N - 1, tb.K), state, dtype=np.int64)
    p = -1
    for j in range(L + 1, R + 1):
        while p + 2 < N and j > mids[p + 1] + 1:
            p += 1
        delta, arg = _trellis_step(tb, delta, j, numerics, "flash")
        new_planes = np.empty_like(planes)
        for n in range(N - 1):
            new_planes[n] = planes[n][arg] if n <= p else arg
        planes = new_planes
    a = int(ans[R])
    if L == 0 and R == T - 1:
        a = _argmax_low(delta)
        ans[R] = a
    for n in range(N - 1):
        ans[mids[n]] = planes[n][a]
    return mids


def flash(A, B, Pi, y, threads: int = 4, numerics: str = "c") -> np.ndarray:
    """Full FLASH decode: phase-1 N-divide + binary interval splitting
    [FLASH_Viterbi_multithread.c:338-368].  ``threads`` plays the role of
    MAX_THREADS (= the N-way split factor); scheduling order does not affect
    the result, so the work queue is processed FIFO here."""
    tb = Tables(A, B, Pi, y, quantize_probs=(numerics == "c"))
    T = tb.T
    ans = np.zeros(T, dtype=np.int64)
    N = threads
    queue: list[tuple[int, int]] = []
    if N > 2 and T >= 2 * N:
        mids = _nvviter_ndivide(tb, ans, 0, T - 1, N, numerics)
        queue.append((0, mids[0]))
        for i in range(N - 2):
            queue.append((mids[i] + 1, mids[i + 1]))
        queue.append((mids[N - 2] + 1, T - 1))
    else:
        queue.append((0, T - 1))
    head = 0
    while head < len(queue):
        L, R = queue[head]
        head += 1
        mid = (L + R) >> 1
        _nvviter(tb, ans, L, R, mid, numerics)
        if R <= L + 1:
            continue
        queue.append((L, mid))
        if R > mid + 1:
            queue.append((mid + 1, R))
    return ans
