"""NumPy mirror of the framework's decode semantics.

Identical fp32 operations in identical order and the lowest-index tie
rule, so a decoder's path must equal this one exactly.  Copies of
``flash_viterbi_tpu/oracle/framework.py``'s ``vanilla``, ``topk``,
``flash_bs``, ``beam``, ``sieve_bs_mp`` and ``sieve_bs``, kept here
because the port never imports the JAX package.
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


def sieve_bs_mp(A, B_mat, Pi, y, beam_width: int) -> np.ndarray:
    """Mirror of ``algorithms.sieve.sieve_bs_mp_decode`` (beam-pruned
    fixed-median D&C) in the framework's own fp32 numerics.

    The reference-faithful float64 oracle is ``oracle.sieve_bs.sieve_bs_mp``;
    it and the decoder legitimately diverge on *permuted-path ties* —
    cyclic paths traversing the same edge multiset in a different order
    under repeated observation symbols score mathematically equal, the
    f64 oracle sees an exact tie (first-inserted wins) while the fp32
    sums round apart — so this mirror is the bit-exact yardstick for the
    device decoder on arbitrary fixtures.  Returns the flattened in-order
    pair path, -1 where a segment's pair was never set.
    """
    from ..algorithms.sieve import build_tree

    logA, logB, logPi = _tables(A, B_mat, Pi)
    K = logA.shape[0]
    y = np.asarray(y, dtype=np.int64)
    T = len(y)
    Bw = min(int(beam_width), K)
    NEG = F32(-np.inf)
    if T == 1:
        return np.asarray([int(np.argmax(logPi + logB[:, y[0]]))])

    A_pos = logA > NEG
    emitQ = np.where(logB > NEG, logB, F32(0.0)).astype(F32)
    iota = np.arange(K)

    def select_beam(touched, newT1):
        eff = min(Bw, int(touched.sum()))
        vals = np.where(touched,
                        np.where(np.isneginf(newT1), F32(-2.0e38), newT1),
                        F32(-3.0e38))
        top_idx = np.argsort(-vals, kind="stable")[:Bw]
        tokm = np.zeros(K, F32)
        tokm[top_idx[:eff]] = 1.0
        return top_idx, eff, tokm

    def run_node(start, length, mask, cur, last_f):
        th = length // 2
        T1 = np.where(mask > 0, (logPi + emitQ[:, y[start]]).astype(F32), NEG)
        src = np.where(cur > 0, T1, NEG)
        scores = (src[:, None] + logA).astype(F32)
        val1 = scores.max(axis=0)
        win1 = scores.argmax(axis=0)
        touched = ((cur > 0) @ A_pos) & (mask > 0)
        T1 = np.where(touched, (val1 + emitQ[:, y[start + 1]]).astype(F32), NEG)
        won1 = touched & (val1 > NEG)
        if th == 1:
            px = np.where(won1, win1, -1)
            py = np.where(won1, iota, -1)
        else:
            px = np.full(K, -1)
            py = np.full(K, -1)
        tok_idx, eff, tokm = select_beam(touched, T1)
        mid_beam = tokm if th == 1 else cur

        for j in range(2, length):
            rows = logA[tok_idx]
            t1tok = T1[tok_idx].copy()
            t1tok[eff:] = NEG
            sc = (t1tok[:, None] + rows).astype(F32)
            val = sc.max(axis=0)
            slot = sc.argmax(axis=0)
            win = tok_idx[slot]
            touched = ((tokm > 0) @ A_pos) & (mask > 0)
            newT1 = np.where(touched, (val + emitQ[:, y[start + j]]).astype(F32), NEG)
            rec = j == th
            px_rec = win if rec else px[win]
            py_rec = iota if rec else py[win]
            won = touched & (val > NEG)
            px = np.where(won, px_rec, -1)
            py = np.where(won, py_rec, -1)
            tok_idx, eff, tokm = select_beam(touched, newT1)
            if rec:
                mid_beam = tokm
            T1 = newT1

        argm = int(np.argmax(np.where(mask > 0, T1, NEG)))
        last = int(last_f) if last_f > -2 else argm
        safe = min(max(last, 0), K - 1)
        x_a = int(px[safe]) if last >= 0 else -1
        x_b = int(py[safe]) if last >= 0 else -1
        return x_a, x_b, mid_beam, last

    def bfs_mask(adj, src, hops):
        visited = np.zeros(K, bool)
        frontier = np.zeros(K, bool)
        frontier[src] = True
        for _ in range(max(hops, 0)):
            new = (frontier @ adj) & ~visited
            visited |= new
            frontier = new
        out = visited.astype(F32)
        out[src] = 1.0
        return out

    nodes = build_tree(T)
    masks = {0: np.ones(K, F32)}
    tokens = {0: np.ones(K, F32)}
    lasts = {0: -2}
    pairs_x: dict = {}
    pairs_y: dict = {}
    for n in sorted(nodes, key=lambda n: n.depth):
        x_a, x_b, mid_beam, last = run_node(
            n.start, n.length, masks[n.idx], tokens[n.idx], lasts[n.idx])
        pairs_x[n.idx], pairs_y[n.idx] = x_a, x_b
        n_left = n.length // 2
        n_right = n.length - n_left
        if n.left >= 0:
            masks[n.left] = bfs_mask(A_pos.T, max(x_a, 0), n_left - 1)
            tokens[n.left] = tokens[n.idx]
            lasts[n.left] = x_a
        if n.right >= 0:
            masks[n.right] = bfs_mask(A_pos, max(x_b, 0), n_right - 1)
            tokens[n.right] = mid_beam
            lasts[n.right] = last

    by_inorder = sorted(nodes, key=lambda n: n.inorder)
    xs = [pairs_x[n.idx] for n in by_inorder]
    ys_ = [pairs_y[n.idx] for n in by_inorder]
    flat = ([xs[0], ys_[0]] + ys_[1:])[:T]
    out = np.full(T, -1, dtype=np.int64)
    out[: len(flat)] = flat
    return out


def sieve_bs(A, B_mat, Pi, y, beam_width: int, b_hops=None) -> list:
    """Mirror of ``algorithms.sieve_bs.sieve_bs_decode`` (dynamic-median
    beam D&C) in the framework's own fp32 numerics; returns the in-order
    median-pair list.  Copied from ``flash_viterbi_tpu/oracle/framework.py``.

    Bit-exact with the device decoder on arbitrary fixtures — including
    NaN-row models and the permuted-path ties where the float64 oracle
    (``oracle.sieve_bs.sieve_bs``) legitimately differs or refuses
    (``ReferenceUndefined``); the decoder's totality extension (sentinel
    pair, skipped impossible recursion) is mirrored too.
    """
    from ..algorithms.sieve_bs import _host_reach

    logA, logB, logPi = _tables(A, B_mat, Pi)
    K = logA.shape[0]
    y = np.asarray(y, dtype=np.int64)
    T = len(y)
    Bw = min(int(beam_width), K)
    NEG = F32(-np.inf)
    A_pos = logA > NEG
    emitQ = np.where(logB > NEG, logB, F32(0.0)).astype(F32)
    # same liveness rule as the decoder (padded states are dead everywhere)
    real = (np.isfinite(logA).any(axis=1) | np.isfinite(logB).any(axis=1)
            | np.isfinite(logPi))
    iota = np.arange(K)
    b = T if b_hops is None else int(b_hops)
    hops = min(max(b - 1, 0), K)

    def bfs_counts(adj):
        visited = np.zeros((K, K), bool)
        frontier = np.eye(K, dtype=bool)
        for _ in range(hops):
            new = (frontier @ adj) & ~visited
            if not new.any():  # graph saturated — identical output
                break
            visited |= new
            frontier = new
        return visited.sum(axis=1).astype(F32)

    desc_cnt = bfs_counts(A_pos)
    anc_cnt = bfs_counts(A_pos.T)

    def beam_vals(T1, touched):
        return np.where(touched,
                        np.where(np.isneginf(T1), F32(-2.0e38), T1),
                        F32(-3.0e38))

    def select(T1, touched):
        bidx = np.argsort(-beam_vals(T1, touched), kind="stable")[:Bw]
        eff = min(Bw, int(touched.sum()))
        tokm = np.zeros(K, bool)
        tokm[bidx[:eff]] = True
        return bidx, eff, tokm

    def node_forward(mask, y_seg, tokens0, last_forced):
        L = len(y_seg)
        Thalf = F32(L) / F32(2.0)
        # model Pi at every node (SIEVE-BS.c:367), like the device decoder
        T1_0 = np.where(mask, (logPi + emitQ[:, y_seg[0]]).astype(F32), NEG)
        src = np.where(tokens0, T1_0, NEG)
        cand = np.where(A_pos, (src[:, None] + logA).astype(F32), NEG)
        cand = (cand + emitQ[:, y_seg[1]][None, :]).astype(F32)
        cand = np.where(mask[None, :], cand, NEG)
        t1 = cand.max(axis=0)
        winner = cand.argmax(axis=0)
        touched = (tokens0 @ A_pos) & mask
        won = touched & (t1 > NEG)
        pair1 = np.maximum(anc_cnt[winner], desc_cnt)
        mx = np.where(won, winner, -1)
        my = np.where(won, iota, -1)
        mn = np.where(won, 1, 0)
        mval = np.where(won, pair1, np.inf).astype(F32)
        T1 = np.where(touched, t1, NEG)

        bidx, eff, tokm = select(T1, touched)
        beams = np.zeros((L, K), bool)
        beams[1] = tokm

        for j in range(2, L):
            emit_row = emitQ[:, y_seg[j]]
            nT1 = np.full(K, NEG)
            nmx = np.full(K, -1)
            nmy = np.full(K, -1)
            nmn = np.zeros(K, dtype=np.int64)
            nmval = np.full(K, np.inf, F32)
            for c in range(Bw):
                node = int(bidx[c])
                validc = c < eff
                cand = ((T1[node] + logA[node]).astype(F32) + emit_row).astype(F32)
                edge = A_pos[node] & mask & validc
                win = edge & (cand > nT1)
                pair = np.maximum(anc_cnt[node], desc_cnt)
                pv = mval[node]
                closer = abs(F32(j) - Thalf) < abs(F32(mn[node]) - Thalf)
                take_new = (pair < pv) | ((pair == pv) & closer)
                take_inh = (~take_new) & (mx[node] != -1)
                wn = win & take_new
                wi = win & take_inh
                nmx = np.where(wn, node, np.where(wi, mx[node], nmx))
                nmy = np.where(wn, iota, np.where(wi, my[node], nmy))
                nmn = np.where(wn, j, np.where(wi, mn[node], nmn))
                nmval = np.where(wn, pair, np.where(wi, pv, nmval)).astype(F32)
                nT1 = np.where(win, cand, nT1)
            ntouched = (tokm @ A_pos) & mask
            nbidx, neff, ntok = select(nT1, ntouched)
            beams[j] = ntok
            nT1 = np.where(ntouched, nT1, NEG)
            T1, mx, my, mn, mval = nT1, nmx, nmy, nmn, nmval
            bidx, eff, tokm, touched = nbidx, neff, ntok, ntouched

        if last_forced >= 0:
            last = int(last_forced)
        else:
            last = int(np.argmax(beam_vals(T1, touched)))
        x_a = int(mx[last])
        x_b = int(my[last])
        n_left = int(mn[last])
        tokens_right = beams[n_left] if x_a != -1 else np.zeros(K, bool)
        return x_a, x_b, n_left, tokens_right, last

    path: list = []

    def rec(mask, y_seg, last, tokens):
        L = len(y_seg)
        if mask.sum() <= 1:
            return
        if L == 1:
            path.append((-1, -1))
            return
        tokens0 = mask if tokens is None else tokens
        x_a, x_b, n_left, tokens_right, last_r = node_forward(
            mask, y_seg, tokens0, -1 if last is None else int(last))
        if n_left > 1 and x_a >= 0:
            lm = _host_reach(A_pos, x_a, n_left, out=False).copy()
            lm[x_a] = True
            rec(lm, y_seg[:n_left], x_a, tokens)
        path.append((x_a, x_b))
        n_right = L - n_left
        if n_right > 1 and x_b >= 0:
            rm = _host_reach(A_pos, x_b, n_right, out=True).copy()
            rm[x_b] = True
            rec(rm, y_seg[-n_right:], last_r, tokens_right)
    rec(np.asarray(real, bool), y, None, None)
    return path
