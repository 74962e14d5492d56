"""NumPy oracle for SIEVE-Mp, bit-exact to the reference.

A behavioural port of ``Base_line/C implementations/SIEVE-Mp.c:286-509``
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

Copied from ``flash_viterbi_tpu/oracle/sieve.py`` (``sieve_mp``,
``_mp_forward``, ``_bfs_mask``), kept here because the port never imports
the JAX package.
"""

from __future__ import annotations

import numpy as np

from .reference import F32, F64, Tables, _sanitize

__all__ = ["sieve_mp"]


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
