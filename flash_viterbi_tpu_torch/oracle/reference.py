"""NumPy mirrors of the reference C programs, bit-exact to them.

The golden layer the port's decoders and the tie-flip arbiter
(``oracle.validate``) are held to: the C programs' recursions, step by
step, each a port of

* vanilla Viterbi        -- ``Base_line/C implementations/vanilla Viterbi.c:125-173``
* checkpoint Viterbi     -- ``checkpoint Viterbi.c:122-251``
* FLASH Viterbi          -- ``src/FLASH_Viterbi_multithread.c:126-368``
* FLASH-BS Viterbi       -- ``src/FLASH_BS_Viterbi_multithread.c:50-577``,
  its size-B min-heap of beam states and the quirks (a)-(c) of SURVEY.md
  section 3.6 (the leaf-scan final argmax, the phase-1 scores read from
  plane 1, ``Find_T3_State``'s -1 for a state the beam lost)

in either numerics:

* ``"c"``   -- the C float dance bit for bit: probabilities stored fp32,
  ``log()`` in float64, sums in each C program's order and precision with
  truncation to fp32 where it assigns to ``ElementType``.
* ``"f32"`` -- the framework's numerics contract: float64 logs truncated to
  fp32 once, the inner sum ``delta + logA`` in fp32, the emission added
  after the max.  The port's exact decoders (and FLASH's lean mode) perform
  the same IEEE operations in the same order, so their paths equal this
  mode's exactly.

Ties: strict-greater scans, so the lowest index wins (``np.argmax``'s
first occurrence).  NaN scores never win in C; they map to -inf before the
argmax (an all-NaN row then yields 0 where C yields -1).  A copy of
``flash_viterbi_tpu/oracle/reference.py``, kept here because the port
never imports the JAX package; the compiled C programs themselves are not
in this repository.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64
NEG32 = np.float32(-3.4028235e38)  # -FLT_MAX


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
# Vanilla Viterbi
# ---------------------------------------------------------------------------

def vanilla(A, B, Pi, y, numerics: str = "c") -> np.ndarray:
    tb = Tables(A, B, Pi, y, quantize_probs=(numerics == "c"))
    T, K = tb.T, tb.K
    delta = _init_delta_pi(tb, numerics)
    ptrs = np.zeros((T, K), dtype=np.int64)
    for j in range(1, T):
        delta, ptrs[j] = _trellis_step(tb, delta, j, numerics, "vanilla")
    ans = np.zeros(T, dtype=np.int64)
    ans[T - 1] = _argmax_low(delta)
    for j in range(T - 1, 0, -1):
        ans[j - 1] = ptrs[j][ans[j]]
    return ans


# ---------------------------------------------------------------------------
# Checkpoint Viterbi  [checkpoint Viterbi.c:122-251]
# ---------------------------------------------------------------------------

def checkpoint(A, B, Pi, y, step: int = 0, numerics: str = "c") -> np.ndarray:
    tb = Tables(A, B, Pi, y, quantize_probs=(numerics == "c"))
    T = tb.T
    if step <= 0:
        step = int(np.floor(np.sqrt(1.0 * T)))
    checkpoints = list(range(0, T, step))
    C = len(checkpoints)

    delta = _init_delta_pi(tb, numerics)
    snaps = np.zeros((C, tb.K), dtype=F32)
    snaps[0] = delta
    cnt = 0
    for j in range(1, T):
        delta, _ = _trellis_step(tb, delta, j, numerics, "vanilla")
        if j % step == 0 and cnt + 1 < C and j == checkpoints[cnt + 1]:
            cnt += 1
            snaps[cnt] = delta

    ans = np.zeros(T, dtype=np.int64)
    count = T - 1
    for i in range(C - 1, -1, -1):
        this_step = step if i != C - 1 else T - checkpoints[C - 1]
        t_sub = this_step + (0 if count == T - 1 else 1)
        base = checkpoints[i]
        d = snaps[i].copy()
        ptrs = np.zeros((t_sub, tb.K), dtype=np.int64)
        for j in range(1, t_sub):
            d, ptrs[j] = _trellis_step(tb, d, base + j, numerics, "vanilla")
        if count == T - 1:
            ans[count] = _argmax_low(d)
            count -= 1
        for j in range(t_sub - 1, 0, -1):
            ans[count] = ptrs[j][ans[count + 1]]
            count -= 1
    return ans


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


# ---------------------------------------------------------------------------
# FLASH-BS Viterbi (beam via min-heap)  [src/FLASH_BS_Viterbi_multithread.c]
# ---------------------------------------------------------------------------

class _Heap:
    """Exact port of the reference's size-B min-heap of beam states.

    Array layout: slot 0 holds the element count (in its float Value field,
    quirk (c) of SURVEY.md §3.6); elements live in slots 1..B.  States are
    offered in increasing index order; replacement requires strictly greater
    Value, so ties keep the earlier (lower-index) state.
    [FLASH_BS_Viterbi_multithread.c:51-211]
    """

    __slots__ = ("B", "val", "state", "t3", "count")

    def __init__(self, B: int):
        self.B = B
        self.val = np.zeros(B + 1, dtype=F32)
        self.state = np.full(B + 1, -1, dtype=np.int64)
        self.t3 = np.full(B + 1, -1, dtype=np.int64)
        self.count = 0

    def _set(self, pos, v, s, t3):
        self.val[pos] = v
        self.state[pos] = s
        self.t3[pos] = t3

    def _heapify(self):
        total = self.count
        for node in range(total // 2, 0, -1):
            parent = node
            child = 2 * node
            tv, ts, tt = self.val[parent], self.state[parent], self.t3[parent]
            while child <= total:
                if child + 1 <= total and self.val[child] > self.val[child + 1]:
                    child += 1
                if tv <= self.val[child]:
                    break
                self.val[parent] = self.val[child]
                self.state[parent] = self.state[child]
                self.t3[parent] = self.t3[child]
                parent = child
                child *= 2
            self._set(parent, tv, ts, tt)

    def _replace_min(self, v, s, t3):
        self._set(1, v, s, t3)
        total = self.count
        parent, child = 1, 2
        while child <= total:
            if child + 1 <= total and self.val[child] > self.val[child + 1]:
                child += 1
            if self.val[parent] <= self.val[child]:
                break
            for arr in (self.val, self.state, self.t3):
                arr[parent], arr[child] = arr[child], arr[parent]
            parent = child
            child *= 2

    def offer(self, v: np.float32, i: int, t3: int):
        """generate_state_heap [FLASH_BS_Viterbi_multithread.c:167-211]."""
        B = self.B
        if i < B - 1:
            self._set(i + 1, v, i, t3)
            self.count += 1
        elif i == B - 1:
            self._set(i + 1, v, i, t3)
            self.count += 1
            self._heapify()
        elif v > self.val[1]:
            self._replace_min(v, i, t3)

    def find_t3(self, state: int) -> int:
        for i in range(1, self.count + 1):
            if self.state[i] == state:
                return int(self.t3[i])
        return -1

    def leaf_argmax(self) -> int:
        """Final-argmax quirk (a): scan slot 1 plus slots [B/2+2, B]
        [FLASH_BS_Viterbi_multithread.c:376-381]."""
        score, arg = self.val[1], 0
        for i in range(self.B // 2 + 1, self.B):
            if self.val[i + 1] > score:
                arg, score = i, self.val[i + 1]
        return arg


def _bs_step(tb: Tables, heap_val, heap_state, t: int, numerics: str):
    """(score (K,), argmax-slot (K,)) from beam predecessors at time t.

    C order: fl32( f64(fl32(fl32(logB) + value_b)) + logA64[pre,i] )
    [FLASH_BS_Viterbi_multithread.c:349-353].  f32 mode uses the framework
    contract (inner sum, emission after the max)."""
    pre = heap_state  # (B,)
    if numerics == "c":
        emit32 = tb.logB64[:, tb.y[t]].astype(F32)  # (K,)
        inner = (emit32[None, :] + heap_val[:, None]).astype(F32)
        s = _sanitize((inner.astype(F64) + tb.logA64[pre, :]).astype(F32))
        return np.max(s, axis=0).astype(F32), np.argmax(s, axis=0)
    s = _sanitize((heap_val[:, None] + tb.logA32[pre, :]).astype(F32))
    score = (np.max(s, axis=0).astype(F32) + tb.logB32[:, tb.y[t]]).astype(F32)
    return score, np.argmax(s, axis=0)


def _bs_fill_initial(tb: Tables, heaps: list[_Heap], L: int, ans, numerics: str):
    if L == 0:
        if numerics == "c":
            tmp = (tb.logPi64 + tb.logB64[:, tb.y[0]]).astype(F32)
        else:
            tmp = (tb.logPi32 + tb.logB32[:, tb.y[0]]).astype(F32)
    else:
        state = int(ans[L - 1])
        if numerics == "c":
            tmp = (tb.logA64[state, :] + tb.logB64[:, tb.y[L]]).astype(F32)
        else:
            tmp = (tb.logA32[state, :] + tb.logB32[:, tb.y[L]]).astype(F32)
    for i in range(tb.K):
        for h in heaps:
            h.offer(tmp[i], i, -1)


def _nvviter_bs(tb: Tables, ans, L, R, mid, B: int, numerics: str):
    """[FLASH_BS_Viterbi_multithread.c:401-473]"""
    T = tb.T
    h = _Heap(B)
    _bs_fill_initial(tb, [h], L, ans, numerics)
    for j in range(L + 1, R + 1):
        score, arg = _bs_step(tb, h.val[1 : B + 1], h.state[1 : B + 1], j, numerics)
        nh = _Heap(B)
        src = h.t3 if j > mid + 1 else h.state
        for i in range(tb.K):
            nh.offer(score[i], i, int(src[arg[i] + 1]))
        h = nh
    if L == 0 and R == T - 1:
        a = h.leaf_argmax()
        ans[R] = h.state[a + 1]
        ans[mid] = h.t3[a + 1]
    else:
        ans[mid] = h.find_t3(int(ans[R]))


def _nvviter_ndivide_bs(tb: Tables, ans, L, R, N, B, numerics: str) -> list[int]:
    """[FLASH_BS_Viterbi_multithread.c:295-399]"""
    T = tb.T
    mids = _flash_midpoints(L, R, N)
    heaps = [_Heap(B) for _ in range(N - 1)]
    _bs_fill_initial(tb, heaps, L, ans, numerics)
    p = -1
    for j in range(L + 1, R + 1):
        while p + 2 < N and j > mids[p + 1] + 1:
            p += 1
        # quirk (b): scores always read from plane index 1 (valid since
        # calc() gates phase 1 on N > 2)
        hq = heaps[1]
        score, arg = _bs_step(tb, hq.val[1 : B + 1], hq.state[1 : B + 1], j, numerics)
        new_heaps = [_Heap(B) for _ in range(N - 1)]
        for i in range(tb.K):
            a = int(arg[i]) + 1
            for k in range(N - 1):
                t3 = heaps[k].t3[a] if k <= p else heaps[k].state[a]
                new_heaps[k].offer(score[i], i, int(t3))
        heaps = new_heaps
    if L == 0 and R == T - 1:
        a = heaps[1].leaf_argmax()
        ans[R] = heaps[1].state[a + 1]
        for n in range(N - 1):
            ans[mids[n]] = heaps[n].t3[a + 1]
    else:
        for n in range(N - 1):
            ans[mids[n]] = heaps[n].find_t3(int(ans[R]))
    return mids


def flash_bs(A, B_mat, Pi, y, beam_width: int, threads: int = 4,
             numerics: str = "c") -> np.ndarray:
    """Full FLASH-BS decode [FLASH_BS_Viterbi_multithread.c:548-577]."""
    tb = Tables(A, B_mat, Pi, y, quantize_probs=(numerics == "c"))
    T = tb.T
    assert tb.K >= beam_width, "beam width must not exceed state count"
    ans = np.zeros(T, dtype=np.int64)
    N = threads
    queue: list[tuple[int, int]] = []
    if N > 2 and T >= 2 * N:
        mids = _nvviter_ndivide_bs(tb, ans, 0, T - 1, N, beam_width, numerics)
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
        _nvviter_bs(tb, ans, L, R, mid, beam_width, numerics)
        if R <= L + 1:
            continue
        queue.append((L, mid))
        if R > mid + 1:
            queue.append((mid + 1, R))
    return ans
