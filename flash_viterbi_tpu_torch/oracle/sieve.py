"""NumPy oracles for the SIEVE family: SIEVE-Mp, bit-exact to the reference,
and SIEVE (dynamic median) and SIEVE-DAG in the float64 semantics of their
Python originals.

SIEVE-Mp is a behavioural port of ``Base_line/C implementations/SIEVE-Mp.c:286-509``
(``Viterbi.py:686-820``, sieve_middlepath): divide and conquer over the
time midpoint; a single forward pass per node tracks, per end state, the
"median pair" (x_a, x_b) of states straddling t = floor(T/2); BFS
reachability (<= N-1 hops) prunes each half's state set; the pairs are
flattened into the path at the end.

Reference quirks reproduced deliberately (they are the semantics):

* ``initial_state`` is global, mutated before every right recursion and never
  reset (C :447): left children of right subtrees force their Pi to the
  *enclosing* subtree's entry state, the state at their first time index.
* Right recursions pass ``last = -1`` (C :452): a right child's final state
  is re-chosen by argmax of its own T1, not forced.
* Length-2 leaf segments append a ``-1`` sentinel instead of their pair when
  the path buffer is mid-assembly (C :420-428); ``change_mp_path`` (C
  :466-489) consumes sentinels by pulling the *next* pair's both states.
* BFS marks nodes within <= b hops, excluding the source unless revisited
  (C :200-280); the pruned index set keeps the parent's (sorted) order.

SIEVE (dynamic median, ``Viterbi.py:529-681``) and SIEVE-DAG
(``Viterbi.py:994-1152``) have no C port: ``sieve_dynamic`` and ``sieve_dag``
follow the float64 Python originals and return the in-order median pairs.

Copied from ``flash_viterbi_tpu/oracle/sieve.py`` (``sieve_mp``,
``_mp_forward``, ``_bfs_mask``, ``_b_hop_counts``, ``sieve_dag``,
``sieve_dynamic``), kept here because the port never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

from .reference import F32, F64, Tables, _sanitize

__all__ = ["sieve_mp", "sieve_dynamic", "sieve_dag"]


class _MpState:
    """Recursion-wide mutable state (the C file's globals)."""

    __slots__ = ("mp_path", "initial_state", "T_total")

    def __init__(self, T_total: int):
        self.mp_path: list[tuple[int, int]] = []
        self.initial_state = -1
        self.T_total = T_total


def _mp_forward(tb: Tables, indices: np.ndarray, y_seg: np.ndarray,
                Pi_seg: np.ndarray, last: int, numerics: str):
    """One node's forward pass: returns (x_a, x_b) for the (possibly forced)
    end state.  [SIEVE-Mp.c:304-370]"""
    K = len(indices)
    T = len(y_seg)
    logA = tb.logA64 if numerics == "c" else tb.logA32
    logB = tb.logB64 if numerics == "c" else tb.logB32
    sub_A = logA[np.ix_(indices, indices)]

    with np.errstate(divide="ignore"):
        if numerics == "c":
            T1 = (np.log(Pi_seg.astype(F64)) + logB[indices, y_seg[0]]).astype(F32)
        else:
            T1 = (np.log(Pi_seg.astype(F64)).astype(F32)
                  + logB[indices, y_seg[0]]).astype(F32)

    mid = T // 2
    med_x = np.full(K, -1, dtype=np.int64)
    med_y = np.full(K, -1, dtype=np.int64)
    for j in range(1, T):
        if numerics == "c":
            s = (T1.astype(F64)[:, None] + sub_A) + logB[indices, y_seg[j]][None, :]
            s = _sanitize(s.astype(F32))
            arg = np.argmax(s, axis=0)
            T1 = np.max(s, axis=0).astype(F32)
        else:
            s = _sanitize((T1[:, None] + sub_A).astype(F32))
            arg = np.argmax(s, axis=0)
            T1 = (np.max(s, axis=0).astype(F32)
                  + logB[indices, y_seg[j]]).astype(F32)
        if j == mid:
            med_x = indices[arg].astype(np.int64)
            med_y = indices.astype(np.int64).copy()
        elif j > mid:
            med_x = med_x[arg]
            med_y = med_y[arg]

    if last < 0:
        last = int(np.argmax(_sanitize(T1)))
    return int(med_x[last]), int(med_y[last])


def sieve_mp(A, B, Pi, y, numerics: str = "c") -> np.ndarray:
    """Full SIEVE-Mp decode [SIEVE-Mp.c:491-509 + change_mp_path :466-489]."""
    tb = Tables(A, B, Pi, y, quantize_probs=(numerics == "c"))
    T = tb.T
    y_arr = np.asarray(y, dtype=np.int64)
    A_pos = np.asarray(A, dtype=F64) > 0  # edge existence (fp32-quantization
    # cannot turn a positive prob into 0 or vice versa)
    st = _MpState(T)

    def recurse(indices: np.ndarray, y_seg: np.ndarray, last: int,
                is_root: bool = False):
        K = len(indices)
        if st.initial_state > -1:
            Pi_seg = (indices == st.initial_state).astype(F32)
        elif is_root:
            # top-level call receives the model Pi with isPiNone=0
            # (SIEVE-Mp.c:499 passes vit->Pi); only unforced *descendants*
            # fall through to the uniform prior (isPiNone=1, :300-307)
            Pi_seg = np.asarray(tb.Pi, dtype=F32)[indices]
        else:
            Pi_seg = np.full(K, np.float32(1.0) / K, dtype=F32)

        x_a, x_b = _mp_forward(tb, indices, y_seg, Pi_seg, last, numerics)

        Ts = len(y_seg)
        N_left = Ts // 2

        if N_left > 1:
            # ancestors: edge indices[i] -> s exists iff A[indices[i], s] > 0
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj.T, indices, x_a, N_left - 1)
            keep = vis | (indices == x_a)
            left_idx = indices[keep]
            left_last = int(np.nonzero(left_idx == x_a)[0][0])
            recurse(left_idx, y_seg[:N_left], left_last)

        N_right = Ts - N_left
        if (N_right <= 1 and N_left <= 1 and len(st.mp_path) < st.T_total - 2
                and len(st.mp_path) != 0):
            st.mp_path.append((-1, -1))
        else:
            st.mp_path.append((x_a, x_b))

        if N_right > 1:
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj, indices, x_b, N_right - 1)
            keep = vis | (indices == x_b)
            right_idx = indices[keep]
            st.initial_state = x_b
            recurse(right_idx, y_seg[-N_right:], -1)

    recurse(np.arange(tb.K, dtype=np.int64), y_arr, -1, is_root=True)

    # change_mp_path [SIEVE-Mp.c:466-489]
    mp = st.mp_path
    ans = np.zeros(T, dtype=np.int64)
    ln = 0
    ans[ln] = mp[0][0]; ln += 1
    ans[ln] = mp[0][1]; ln += 1
    i = 1
    while ln <= len(mp):
        if mp[i][0] == -1:
            if i + 1 >= len(mp):
                break
            ans[ln] = mp[i + 1][0]; ln += 1
            ans[ln] = mp[i + 1][1]; ln += 1
            i += 1
        else:
            ans[ln] = mp[i][1]; ln += 1
        i += 1
    return ans


def _bfs_mask(sub_adj: np.ndarray, indices: np.ndarray, source: int,
              hops: int) -> np.ndarray:
    """Boolean mask over ``indices`` of nodes within <= hops of ``source``.

    ``sub_adj[i, j]`` True iff edge indices[i] -> indices[j] in traversal
    direction.  The source starts unvisited (SIEVE-Mp.c:201-236)."""
    K = len(indices)
    visited = np.zeros(K, dtype=bool)
    src_pos = int(np.nonzero(indices == source)[0][0])
    frontier = np.zeros(K, dtype=bool)
    frontier[src_pos] = True
    for _ in range(hops):
        reach = sub_adj[frontier].any(axis=0)
        new = reach & ~visited
        if not new.any():
            break
        visited |= new
        frontier = new
    return visited


# ---------------------------------------------------------------------------
# SIEVE (dynamic median) — float64 Python-semantics port [Viterbi.py:529-681]
# ---------------------------------------------------------------------------

def _b_hop_counts(A_pos: np.ndarray, b: int):
    """#states within <= b hops of each state, both directions
    [Viterbi.py:476-526].  Source excluded unless reachable via a cycle."""
    K = A_pos.shape[0]
    anc = np.zeros(K, dtype=np.int64)
    dec = np.zeros(K, dtype=np.int64)
    idx = np.arange(K, dtype=np.int64)
    for s in range(K):
        anc[s] = int(_bfs_mask(A_pos.T, idx, s, b).sum())
        dec[s] = int(_bfs_mask(A_pos, idx, s, b).sum())
    return anc, dec


def sieve_dag(A, B, Pi, y) -> list:
    """SIEVE for DAG-structured HMMs [Viterbi.py:994-1152].

    No C port exists; semantics are the float64 Python original, which
    *recomputes* ancestor/descendant counts at every recursion level via a
    topological accumulation over the DAG
    (``viterbi_preprocessing_{ancestors,descendants}_pruning_dag``,
    :850-988).  The counts equal "#states within <= T_seg-1 hops in the
    index-restricted digraph", which is what we compute (BFS; identical on
    DAGs, and also terminates on cyclic inputs where the reference's
    topological sweep would spin forever).  Returns the in-order median
    pair list.
    """
    A = np.asarray(A, dtype=F64)
    B = np.asarray(B, dtype=F64)
    y = np.asarray(y, dtype=np.int64)
    K_full = A.shape[0]
    A_pos = A > 0

    out_pairs: list = []
    state = {"initial_state": None}

    def hop_counts(indices: np.ndarray, T_seg: int):
        sub_adj = A_pos[np.ix_(indices, indices)]
        anc = {}
        dec = {}
        for pos, s in enumerate(indices):
            anc[int(s)] = int(_bfs_mask(sub_adj.T, indices, int(s), T_seg - 1).sum())
            dec[int(s)] = int(_bfs_mask(sub_adj, indices, int(s), T_seg - 1).sum())
        return anc, dec

    def recurse(indices: np.ndarray, y_seg: np.ndarray, last):
        K = len(indices)
        T = len(y_seg)
        if K == 1:
            return
        anc_cnt, dec_cnt = hop_counts(indices, T)
        if state["initial_state"] is not None:
            Pi_seg = np.array([0.0 if it != state["initial_state"] else 1.0
                               for it in indices])
        else:
            Pi_seg = np.full(K, 1.0 / K)

        subA = A[np.ix_(indices, indices)]
        subB = B[indices]
        with np.errstate(divide="ignore", invalid="ignore"):
            T1 = np.log(Pi_seg) + np.log(subB[:, y_seg[0]])
            prev_n = np.full(K, -1, dtype=np.int64)
            prev_med = [-1] * K
            prev_val = np.full(K, np.inf)
            for j in range(1, T):
                scores = T1[:, None] + np.log(subA) + np.log(subB[:, y_seg[j]])[None, :]
                scores = _sanitize(scores)
                arg = np.argmax(scores, axis=0)
                T1 = np.max(scores, axis=0)
                new_n = np.full(K, -1, dtype=np.int64)
                new_med = [-1] * K
                new_val = np.full(K, np.inf)
                for i in range(K):
                    m = arg[i]
                    cand = max(anc_cnt[int(indices[m])], dec_cnt[int(indices[i])])
                    if cand < prev_val[m]:
                        new_val[i] = cand
                        new_med[i] = (int(indices[m]), int(indices[i]))
                        new_n[i] = j
                    elif prev_med[m] != -1:
                        new_med[i] = prev_med[m]
                        new_n[i] = prev_n[m]
                        new_val[i] = prev_val[m]
                prev_n, prev_med, prev_val = new_n, new_med, new_val

        if last is None:
            last = int(np.argmax(_sanitize(np.asarray(T1))))
        if prev_med[last] == -1:
            return
        x_a, x_b = prev_med[last]
        N_left = int(prev_n[last])
        y_left = y_seg[:N_left]

        if len(y_left) > 1:
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj.T, indices, x_a, N_left - 1)
            keep = vis | (indices == x_a)
            left_idx = indices[keep]
            left_last = int(np.nonzero(left_idx == x_a)[0][0])
            recurse(left_idx, y_left, left_last)

        out_pairs.append((x_a, x_b))

        N_right = T - N_left
        y_right = y_seg[-N_right:]
        if len(y_right) > 1:
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj, indices, x_b, N_right - 1)
            keep = vis | (indices == x_b)
            right_idx = indices[keep]
            state["initial_state"] = x_b
            recurse(right_idx, y_right, None)

    recurse(np.arange(K_full, dtype=np.int64), y, None)
    return out_pairs


def sieve_dynamic(A, B, Pi, y, b_hops: int | None = None) -> list:
    """SIEVE with dynamic median selection [Viterbi.py:529-681].

    No C port exists in the reference; semantics are the float64 Python
    original: the forward pass tracks, per end state, the best split
    ``(x_a, x_b, t)`` seen so far — the transition minimizing
    ``max(#ancestors(x_a), #descendants(x_b))`` (first strictly smaller
    wins).  Returns the in-order list of median pairs (the reference
    appends pairs to ``self.path``; its flattening is the pair list).
    """
    A = np.asarray(A, dtype=F64)
    B = np.asarray(B, dtype=F64)
    Pi0 = np.asarray(Pi, dtype=F64)
    y = np.asarray(y, dtype=np.int64)
    K_full = A.shape[0]
    A_pos = A > 0
    if b_hops is None:
        b_hops = max(1, int(np.floor(np.log2(max(2, K_full)))))
    anc_cnt, dec_cnt = _b_hop_counts(A_pos, b_hops)

    out_pairs: list = []
    state = {"initial_state": None}

    def recurse(indices: np.ndarray, y_seg: np.ndarray, last):
        K = len(indices)
        T = len(y_seg)
        if K == 1:
            return
        if state["initial_state"] is not None:
            Pi_seg = np.array([0.0 if it != state["initial_state"] else 1.0
                               for it in indices])
        else:
            Pi_seg = np.full(K, 1.0 / K)

        subA = A[np.ix_(indices, indices)]
        subB = B[indices]
        with np.errstate(divide="ignore"):
            T1 = np.log(Pi_seg) + np.log(subB[:, y_seg[0]])
            prev_n = np.full(K, -1, dtype=np.int64)
            prev_med = [-1] * K
            prev_val = np.full(K, np.inf)
            for j in range(1, T):
                scores = T1[:, None] + np.log(subA) + np.log(subB[:, y_seg[j]])[None, :]
                scores = _sanitize(scores)
                arg = np.argmax(scores, axis=0)
                T1 = np.max(scores, axis=0)
                new_n = np.full(K, -1, dtype=np.int64)
                new_med = [-1] * K
                new_val = np.full(K, np.inf)
                for i in range(K):
                    m = arg[i]
                    cand = max(anc_cnt[indices[m]], dec_cnt[indices[i]])
                    if cand < prev_val[m]:
                        new_val[i] = cand
                        new_med[i] = (int(indices[m]), int(indices[i]))
                        new_n[i] = j
                    elif prev_med[m] != -1:
                        new_med[i] = prev_med[m]
                        new_n[i] = prev_n[m]
                        new_val[i] = prev_val[m]
                prev_n, prev_med, prev_val = new_n, new_med, new_val

        if last is None:
            last = int(np.argmax(_sanitize(T1)))
        if prev_med[last] == -1:
            return
        x_a, x_b = prev_med[last]
        N_left = int(prev_n[last])
        y_left = y_seg[:N_left]

        if len(y_left) > 1:
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj.T, indices, x_a, N_left - 1)
            keep = vis | (indices == x_a)
            left_idx = indices[keep]
            left_last = int(np.nonzero(left_idx == x_a)[0][0])
            recurse(left_idx, y_left, left_last)

        out_pairs.append((x_a, x_b))

        N_right = T - N_left
        y_right = y_seg[-N_right:]
        if len(y_right) > 1:
            sub_adj = A_pos[np.ix_(indices, indices)]
            vis = _bfs_mask(sub_adj, indices, x_b, N_right - 1)
            keep = vis | (indices == x_b)
            right_idx = indices[keep]
            state["initial_state"] = x_b
            recurse(right_idx, y_right, None)

    recurse(np.arange(K_full, dtype=np.int64), y, None)
    return out_pairs
