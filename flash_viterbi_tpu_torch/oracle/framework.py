"""NumPy mirror of the framework's decode semantics.

Identical fp32 operations in identical order and the lowest-index tie
rule, so a decoder's path must equal this one exactly.  Copies of
``flash_viterbi_tpu/oracle/framework.py``'s ``vanilla``, ``topk``,
``flash_bs`` and ``beam``, kept here because the port never imports the
JAX package.
"""

from __future__ import annotations

import numpy as np

from ..models.hmm import _log32

F32 = np.float32


def _tables(A, B, Pi):
    return _log32(A), _log32(B), _log32(Pi)


def _step(delta, logA, emit):
    # fp32 ops, framework order: inner sum delta+logA, emission after the max
    scores = (delta[:, None] + logA).astype(F32)
    return (np.max(scores, axis=0) + emit).astype(F32), np.argmax(scores, axis=0)


def vanilla(A, B, Pi, y) -> np.ndarray:
    logA, logB, logPi = _tables(A, B, Pi)
    y = np.asarray(y, dtype=np.int64)
    T = len(y)
    delta = (logPi + logB[:, y[0]]).astype(F32)
    ptrs = np.zeros((T, logA.shape[0]), dtype=np.int64)
    for t in range(1, T):
        delta, ptrs[t] = _step(delta, logA, logB[:, y[t]])
    ans = np.zeros(T, dtype=np.int64)
    ans[T - 1] = int(np.argmax(delta))
    for t in range(T - 1, 0, -1):
        ans[t - 1] = ptrs[t][ans[t]]
    return ans


def topk(vals: np.ndarray, B: int):
    """jax.lax.top_k semantics: descending, ties keep lower index."""
    order = np.argsort(-vals, kind="stable")[:B]
    return vals[order], order


def flash_bs(A, B_mat, Pi, y, beam_width: int, num_segments: int = 8) -> np.ndarray:
    """Mirror of ``algorithms.flash_bs.flash_bs_decode`` (top-k beam,
    anchored two-phase segmented decode)."""
    from ..algorithms.flash import flash_midpoints

    logA, logB, logPi = _tables(A, B_mat, Pi)
    y = np.asarray(y, dtype=np.int64)
    T = len(y)
    Bw = beam_width
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    emits = logB[:, y].T  # (T, K)

    def beam_step(vals, states, emit):
        rows = logA[states]
        scores = (vals[:, None] + rows).astype(F32)
        return (np.max(scores, axis=0) + emit).astype(F32), np.argmax(scores, axis=0)

    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    P = len(mids)

    # phase 1
    vals, states = topk((logPi + emits[0]).astype(F32), Bw)
    planes = np.full((P, Bw), -1, dtype=np.int64)
    for t in range(1, T):
        full, slot = beam_step(vals, states, emits[t])
        nv, ns = topk(full, Bw)
        best_slot = slot[ns]
        for n in range(P):
            planes[n] = planes[n][best_slot] if t > mids[n] + 1 else states[best_slot]
        vals, states = nv, ns
    last = int(states[0])
    anchors = planes[:, 0].copy()

    starts = [0] + [m + 1 for m in mids]
    ends = mids + [T - 1]
    init_states = np.concatenate([[0], anchors]).astype(np.int64)
    end_states = np.concatenate([anchors, [last]]).astype(np.int64)

    out = np.zeros(T, dtype=np.int64)
    for s in range(len(starts)):
        L, R = starts[s], ends[s]
        full0 = (logPi if s == 0 else logA[max(int(init_states[s]), 0)]) + emits[L]
        vals, states = topk(full0.astype(F32), Bw)
        hist = [states]
        ptrs = []
        for t in range(L + 1, R + 1):
            full, slot = beam_step(vals, states, emits[t])
            nv, ns = topk(full, Bw)
            ptrs.append(slot[ns])
            hist.append(ns)
            vals, states = nv, ns
        match = states == end_states[s]
        if not match.any():
            out[L : R + 1] = -1
            continue
        sl = int(np.argmax(match))
        path = np.zeros(R - L + 1, dtype=np.int64)
        path[-1] = hist[-1][sl]
        for t in range(R - L - 1, -1, -1):
            sl = int(ptrs[t][sl])
            path[t] = hist[t][sl]
        out[L : R + 1] = path
    return out


def beam(A, B_mat, Pi, y, beam_width: int) -> np.ndarray:
    """Mirror of ``algorithms.beam.beam_decode`` (plain beam Viterbi with
    full beam-history tables; emission added after the max, fp32)."""
    logA, logB, logPi = _tables(A, B_mat, Pi)
    K = logA.shape[0]
    y = np.asarray(y, dtype=np.int64)
    T = len(y)
    Bw = min(int(beam_width), K)

    full0 = (logPi + logB[:, y[0]]).astype(np.float32)
    vals, states = topk(full0, Bw)
    states_hist = [states]
    slot_ptrs = []
    for t in range(1, T):
        scores = (vals[:, None] + logA[states]).astype(np.float32)
        full = (scores.max(axis=0) + logB[:, y[t]]).astype(np.float32)
        slot = scores.argmax(axis=0)
        nv, ns = topk(full, Bw)
        slot_ptrs.append(slot[ns])
        states_hist.append(ns)
        vals, states = nv, ns

    s = 0  # beam is score-sorted: slot 0 is the best end state
    slots = [0]
    for ptr in reversed(slot_ptrs):
        s = int(ptr[s])
        slots.append(s)
    slots = slots[::-1]
    return np.asarray([states_hist[t][slots[t]] for t in range(T)],
                      dtype=np.int64)
