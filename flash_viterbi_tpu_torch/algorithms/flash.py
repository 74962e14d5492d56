"""FLASH Viterbi: anchored two-phase segmented decode, pointer and lean modes.

Counterpart of ``flash_viterbi_tpu/algorithms/flash.py`` on its kernel
path.  Both modes share phase 1's anchors and give the same path as the
JAX decoder, bit for bit.

**Pointer mode** (``phase1_anchors_pallas``, ``decode_segments_pointer_pallas``
in recompute form):

* **Phase 1**: one N=1 pointer scan over all T steps (``maxplus_scan``),
  then one backtrack (``backtrack_batched``) reads the final state and the
  N-1 anchor states at the balanced midpoints.
* **Phase 2**: the N anchored segments are stacked as lanes.  A
  pointer-free scan (``maxplus_scan_deltas``) stores each lane's carry
  history, and a masked walk (``argmax_walk``) re-derives every step's
  argmax from one logA column; rows past a segment's end keep the state.
* The segment paths are gathered into the output.

**Lean mode** (``phase1_anchors_chunked``, ``_lean_round_pallas``,
``_decode_leaves``): the reference's binary splitting with O(N*K) live
memory, the formula of :func:`lean_working_set`.

* **Phase 1**: pointer scans of ``LEAN_CHUNK`` steps; after each,
  ``fold_planes`` folds its pointer rows into the N-1 anchor planes, so no
  pointer table outlives its chunk.
* **Rounds**: the static splitting tree's intervals longer than
  ``lean_leaf``, round by round.  The intervals of one exact length are
  lanes of chunked pointer scans whose rows ``fold_planes`` folds into
  each lane's t2 plane; the plane's entry at the interval's end state
  resolves its midpoint.
* **Leaves**: intervals of at most ``lean_leaf`` positions (both ends
  resolved by then) decode as forced-boundary lanes of a carry-history
  scan and an ``argmax_walk``, at most ``LEAF_LANES`` a call.

Emission rows are gathered from ``logB.T`` by symbol for each call, so
lean mode never builds the (T, K) emission table.  A call takes as many
lanes as keep its tables, its carries and the scan's scratch within what
:func:`lean_working_set` leaves once the decode's index tensors are
counted; splitting lanes between calls changes no value.

Every index tensor of a decode is built before its first launch (a
host-to-device copy in mid-decode would wait for the kernels queued before
it), and the scans and walks share one error word, read once at the end.
On CUDA tensors every call above launches a hand-written kernel; on CPU
tensors each runs its plain version.

``precision="bf16"`` rounds ``logA`` to bfloat16 before anything reads it,
so every scan, walk and forced entry row reads the bf16 table (the scans'
and the walk's bf16 instances on the card); the carries, sums and maxes
stay fp32, and the path is the fp32 path of the rounded table.  The
decoder keeps the cast, as it keeps the transposed table (``_Transposed``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import maxplus as mp
from ..ops.cuda import (argmax_walk, backtrack_batched, fold_planes, maxplus_scan,
                        maxplus_scan_deltas)
from ..ops.cuda import backtrack as kb
from ..ops.cuda import fold as kf
from ..ops.cuda.common import H100_SMS
from ..ops.cuda.common import allocated as a
from ..ops.cuda.maxplus import (error_word, plan_scratch_bytes, raise_on_error,
                                scan_scratch_bytes)
from .base import Decoder, register
from .fused import argmax_bytes

# lean-mode shape knobs, shared with the working-set formula
# (lean_working_set, which algorithms.auto uses): changing one changes both.
# Kept from scripts/torch_route_sweep.py's rows on NVIDIA H100 80GB HBM3,
# 700.00 W (results/torch_route_sweep.jsonl, PERF.md "Routing figures"),
# each varied alone at K in {3968, 8192, 16384} x T in {256, 2048, 16384}:
# lean is the memory-lean mode, so memory comes first, and no value with a
# working set as small was faster beyond the spread.  Larger chunks are
# faster at long T for 2-4x the working set (K=3968, T=16384: chunk 128
# 737.043 ms, peak 519,124,992 bytes, against 816.681 ms, 141,990,400;
# chunk 32 988.587 ms, 74,129,408); 16 leaf lanes halve the leaves' tables
# for +5-11% (T=2048: 88.027 against 78.971 ms); another leaf splits the
# sequence elsewhere and may flip a path's fp32 tie (leaf 32 moved 4
# positions at K=3968, T=16384), so the leaf stays.
LEAN_CHUNK = 64   # steps of a lean scan call
LEAN_LEAF = 64    # split intervals down to this length, then decode the leaves
LEAF_LANES = 32   # leaf lanes a call at most
# bytes a lean call leaves free of the formula's figure, for the decode's
# small allocations (error word, barrier words, final scores)
LEAN_SLACK = 256 * 1024


def flash_midpoints(L: int, R: int, N: int) -> list[int]:
    """Balanced interior midpoints (reference :129-136)."""
    gap, extra = divmod(R - L, N)
    mids: list[int] = []
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


def segment_layout(mids: list[int], T: int) -> tuple[list[int], list[int], int]:
    """(starts, lens, Lmax) of the N anchored segments bounded by ``mids``
    (segment s covers [starts[s], starts[s] + lens[s] - 1]; the last ends
    at T-1)."""
    starts = [0] + [m + 1 for m in mids]
    ends = list(mids) + [T - 1]
    lens = [e - s + 1 for s, e in zip(starts, ends)]
    return starts, lens, max(lens)


def prop_schedule(mids: list[int], T: int, j0: int = 1,
                  j1: int | None = None) -> np.ndarray:
    """(j1-j0, P) bool: True where anchor plane p PROPAGATES (j > mid+1)
    rather than records, for trellis steps j in [j0, j1) (reference
    :163,176-179,242)."""
    j1 = T if j1 is None else j1
    mids_a = np.asarray(mids, dtype=np.int64).reshape(1, -1)
    return np.arange(j0, j1, dtype=np.int64)[:, None] > mids_a + 1


def split_tree(segments: list[tuple[int, int]]) -> list[list[tuple[int, int, int]]]:
    """Static binary splitting tree: rounds of (L, R, mid) intervals.

    Mirrors the work the reference's queue generates (``worker``
    :298-303): every interval with R > L+1 spawns (L, mid) and, when
    R > mid+1, (mid+1, R).  The intervals of one round are independent.
    """
    rounds, _ = split_tree_leaves(segments, min_leaf=0)
    return rounds


def split_tree_leaves(segments: list[tuple[int, int]], min_leaf: int = 0):
    """Binary splitting rounds, stopping at ``min_leaf``-length leaves.

    Returns (rounds, leaves): intervals of length <= min_leaf are not
    split further; their interiors decode in one forced-boundary pass each
    (both endpoints' states are resolved by then).  min_leaf=0 reproduces
    the reference's full splitting (every position resolved as some
    interval's midpoint).
    """
    rounds: list[list[tuple[int, int, int]]] = []
    leaves: list[tuple[int, int]] = []
    work = []
    for L, R in segments:
        if R <= L:
            continue
        if R - L + 1 <= min_leaf:
            leaves.append((L, R))
        else:
            work.append((L, R))
    while work:
        rounds.append([(L, R, (L + R) >> 1) for (L, R) in work])
        nxt = []
        for L, R in work:
            mid = (L + R) >> 1
            for (l2, r2) in ((L, mid), (mid + 1, R)):
                if r2 <= l2:
                    continue
                if r2 - l2 + 1 <= min_leaf:
                    leaves.append((l2, r2))
                else:
                    nxt.append((l2, r2))
        work = nxt
    return rounds, leaves


def lean_working_set(K: int, T: int, num_segments: int = 8,
                     lean_leaf: int = LEAN_LEAF) -> int:
    """Bytes of device scratch a lean decode keeps live at most, beside the
    model tables (``flash_viterbi_tpu/algorithms/auto.py:134-155``): the
    larger of a round's streamed chunk over its live intervals with their
    (delta, t2) carries, S bounded by the last round before the leaves, and
    the leaf pass's (lean_leaf-1, LEAF_LANES, K) tables, plus O(N*K)."""
    N = num_segments
    leaf = int(lean_leaf)
    if leaf <= 0:  # pure lean: no leaf pass, rounds split to length 2
        s_max = max(N, (T + 3) // 4)
        return (2 * LEAN_CHUNK + 2) * s_max * K * 4 + (2 * N + 4) * K * 4
    seg_len = -(-T // max(N, 1))
    if seg_len <= leaf:  # segments go straight to leaves, no rounds
        round_b = 0
        llen, n_leaves = seg_len, N
    else:
        s_max = max(N, T // max(2 * leaf, 1))
        # x2: the gathered emissions chunk is live alongside the pointers
        round_b = (2 * LEAN_CHUNK + 2) * s_max * K * 4
        llen, n_leaves = leaf, max(1, -(-T // max(leaf, 2)))
    leaf_b = 2 * max(llen - 1, 1) * min(LEAF_LANES, n_leaves) * K * 4
    return max(round_b, leaf_b) + (2 * N + 4) * K * 4


class _Kept:
    """``make(src, *key)``, kept for the ``src`` tensor (and its version)
    and the ``key`` it was made from."""

    def __init__(self, make):
        self._make = make
        self._src, self._version, self._key, self._out = None, -1, None, None

    def __call__(self, src: torch.Tensor, *key) -> torch.Tensor:
        if self._src is not src or self._version != src._version or self._key != key:
            self._src, self._out = None, None  # free the old first
            self._out = self._make(src, *key)
            self._src, self._version, self._key = src, src._version, key
        return self._out


class _Transposed:
    """The forms of ``logA`` a decode makes, each kept for the tensor (and
    its version) it was made from, so that a decoder called again on the
    same tables reuses them, as it does the tables: calling it gives a table
    transposed and contiguous, the layout ``argmax_walk`` reads, and
    :meth:`cast` the table at a precision (``ops.maxplus.table_at``; under
    "bf16" a copy of K*K*2 bytes)."""

    def __init__(self):
        self.cast = _Kept(mp.table_at)
        self._logAT = _Kept(mp.transposed)

    def __call__(self, logA: torch.Tensor) -> torch.Tensor:
        return self._logAT(logA)


class _Indices:
    """The index arrays of a decode, put together on the host and copied to
    the device in one transfer of each dtype before the first launch."""

    def __init__(self):
        self._parts: dict = {np.int32: [], np.bool_: []}
        self._size = {np.int32: 0, np.bool_: 0}
        self._flat: dict = {}

    def add(self, arr, dtype=np.int32):
        a = np.ascontiguousarray(arr, dtype=dtype)
        handle = (dtype, self._size[dtype], a.shape)
        self._parts[dtype].append(a.ravel())
        self._size[dtype] += a.size
        return handle

    def upload(self, dev) -> None:
        """Copy every array to ``dev``."""
        for dtype, parts in self._parts.items():
            flat = np.concatenate(parts) if parts else np.zeros(0, dtype)
            self._flat[dtype] = torch.from_numpy(flat).to(dev)

    def __getitem__(self, handle) -> torch.Tensor:
        dtype, off, shape = handle
        return self._flat[dtype][off:off + int(np.prod(shape, dtype=np.int64))].view(shape)


def phase1_anchors(logA, logPi, emits, mids: torch.Tensor, err=None):
    """Final state and the states at ``mids`` (P,) int64: one pointer scan
    over all steps (``err``: the scan's error word, as ``maxplus_scan``
    takes it), then one backtrack.  Returns (last () int32, anchors (P,)
    int32)."""
    delta0 = logPi + emits[0]
    dfin, ptrs = maxplus_scan(logA, emits[1:].unsqueeze(1), delta0[None, :], err=err)
    last = mp.argmax_final(dfin[0])
    if not mids.numel():
        return last, torch.zeros((0,), dtype=torch.int32, device=emits.device)
    path = backtrack_batched(ptrs, last[None])[0]
    return last, path[mids]


def decode_segments_pointer(logA, logAT, logPi, emits, starts, lens, init_states,
                            end_states, Lmax: int, T: int, err=None):
    """Decode N forced-boundary segments as lanes; returns (N, Lmax) paths.
    ``logAT`` is ``logA`` transposed and contiguous, the walk's layout;
    ``err`` is the scan's and the walk's error word, as
    ``maxplus_scan_deltas`` takes it.

    ``init_states[s]`` is the resolved state at ``starts[s]-1`` (ignored for
    segment 0, which starts from ``logPi``); ``end_states[s]`` the resolved
    state at ``starts[s]+lens[s]-1``.
    """
    N = starts.shape[0]
    dev = emits.device
    idx = torch.clamp(starts[:, None] + torch.arange(Lmax, device=dev)[None, :],
                      max=T - 1)
    seg_emits = emits[idx]  # (N, Lmax, K)
    first = torch.arange(N, device=dev) == 0
    d0 = torch.where(first[:, None], logPi[None, :], logA[init_states]) + seg_emits[:, 0]
    emitsN = seg_emits[:, 1:, :].transpose(0, 1).contiguous()  # (Lmax-1, N, K)
    valid = torch.arange(1, Lmax, device=dev)[:, None] <= (lens - 1)[None, :]
    _, deltas = maxplus_scan_deltas(logA, emitsN, d0, err=err)
    return argmax_walk(deltas, logAT, end_states, valid=valid, err=err)


def _pointer_decode(logA, logB, logPi, y, N: int, transposed) -> torch.Tensor:
    T = y.shape[0]
    dev = logA.device
    mids_l = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts_l, lens_l, Lmax = segment_layout(mids_l, T)
    # the segments tile [0, T) in order, so the output is a gather of the
    # (N, Lmax) segment paths
    order = [s * Lmax + j for s, ln in enumerate(lens_l) for j in range(ln)]
    mids, starts, lens, order = (torch.tensor(v, dtype=torch.int64, device=dev)
                                 for v in (mids_l, starts_l, lens_l, order))
    emits = logB.t()[y].contiguous()  # (T, K)
    err = error_word(dev)

    last, anchors = phase1_anchors(logA, logPi, emits, mids, err)
    init_states = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev), anchors])
    end_states = torch.cat([anchors, last[None]])
    paths = decode_segments_pointer(logA, transposed(logA), logPi, emits, starts, lens,
                                    init_states, end_states, Lmax, T, err)
    out = paths.reshape(-1)[order]
    raise_on_error(err, "flash")
    return out


def phase1_anchors_chunked(logA, logPi, logB, y, mids: torch.Tensor, prop: torch.Tensor,
                           err=None, chunk: int = LEAN_CHUNK):
    """Final state and the states at ``mids`` (P,) with O(P*K + chunk*K)
    live memory: pointer scans of ``chunk`` steps, each chunk's pointer
    rows folded into the P anchor planes at once (``prop``: the (T-1, P)
    :func:`prop_schedule`).  Returns (last () int32, anchors (P,) int32)."""
    T = y.shape[0]
    P = mids.shape[0]
    logBT = logB.t()
    d = mp.init_delta(logPi, logB, y[0])
    planes = torch.zeros((P, logA.shape[0]), dtype=torch.int32, device=logA.device)
    for c0 in range(0, T - 1, chunk):
        c1 = min(c0 + chunk, T - 1)
        dC, ptrs = maxplus_scan(logA, logBT.index_select(0, y[c0 + 1:c1 + 1]).unsqueeze(1),
                                d[None, :], err=err)
        d = dC[0]
        if P:
            planes = fold_planes(planes, ptrs, prop[c0:c1], err=err)
        del ptrs  # before the next chunk's tables are made
    last = mp.argmax_final(d)
    return last, planes[:, last]


def _lanes_a_call(S: int, steps: int, K: int, budget: int, scratch, with_ptr: bool) -> int:
    """The most of S lanes (at least 1) whose call keeps two (steps, lanes,
    K) tables (emissions and pointers or carries), four (lanes, K) rows
    (carries, planes, their temporaries) and the scan's scratch
    (``scratch(K, lanes, with_ptr)`` bytes) within ``budget`` bytes."""
    for g in range(S, 1, -1):
        if (2 * steps + 4) * g * K * 4 + scratch(K, g, with_ptr) <= budget:
            return g
    return 1


def _index_bytes(T: int, P: int, rounds, leaves) -> int:
    """Bytes a lean decode holds throughout beside its calls: ``ans``, the
    anchors' index and schedule, and every call's index arrays (int32
    positions, bool schedules; the same whatever the calls' lanes)."""
    b = 4 * T + 4 * P + max(T - 1, 0) * P
    for rnd in rounds:
        b += sum(5 * (R - L) + 17 for L, R, _ in rnd)   # pos, prop; L, prev, R, mid, head
    b += sum(4 * (R - L) + 4 * (R - L + 1) + 13 for L, R in leaves)  # pos, out; L, prev, R, head
    return b


def _lean_program(T: int, mids_l, starts_l, lens_l, num_segments: int, lean_leaf: int,
                  K: int, scratch, ix: _Indices):
    """The lean decode's calls, their index arrays added to ``ix``: (round
    calls, leaf calls), each a dict of the call's lanes and handles;
    ``scratch`` as :func:`_lanes_a_call` takes it."""
    segments = [(s, s + ln - 1) for s, ln in zip(starts_l, lens_l)]
    rounds, leaves = split_tree_leaves(segments, min_leaf=max(0, lean_leaf))
    # what a call may use: the formula's figure less what the decode holds
    # throughout and a margin for its small tensors
    budget = (lean_working_set(K, T, num_segments, lean_leaf)
              - _index_bytes(T, len(mids_l), rounds, leaves) - LEAN_SLACK)

    def lanes(group, steps, cap, with_ptr):
        """Calls of at most ``cap`` lanes, sized to the budget, for one
        exact-length group."""
        g = _lanes_a_call(min(len(group), cap), steps, K, budget, scratch, with_ptr)
        for g0 in range(0, len(group), g):
            sub = group[g0:g0 + g]
            Ls = np.asarray([iv[0] for iv in sub])
            Rs = np.asarray([iv[1] for iv in sub])
            pos = Ls[None, :] + np.arange(1, steps + 1)[:, None]  # (steps, g): steps 1..steps
            yield sub, Ls, pos, {
                "steps": steps, "g": len(sub), "L": ix.add(Ls),
                "prev": ix.add(np.maximum(Ls - 1, 0)), "head": ix.add(Ls == 0, np.bool_),
                "R": ix.add(Rs), "pos": ix.add(pos)}

    round_calls = []
    for rnd in rounds:
        calls = []
        for length in sorted({iv[1] - iv[0] + 1 for iv in rnd}):
            group = [iv for iv in rnd if iv[1] - iv[0] + 1 == length]
            for sub, _, pos, call in lanes(group, length - 1, len(group), True):
                mids = np.asarray([iv[2] for iv in sub])
                # t2 records the step's pointer while j <= mid + 1, then
                # follows it (reference :242)
                call["mid"] = ix.add(mids)
                call["prop"] = ix.add(pos > mids[None, :] + 1, np.bool_)
                calls.append(call)
        round_calls.append(calls)
    leaf_calls = []
    for length in sorted({r - l + 1 for l, r in leaves}):
        group = [iv for iv in leaves if iv[1] - iv[0] + 1 == length]
        for _, Ls, _, call in lanes(group, length - 1, LEAF_LANES, False):
            call["out"] = ix.add(Ls[:, None] + np.arange(length)[None, :])
            leaf_calls.append(call)
    return round_calls, leaf_calls


def _forced_start(logA, logPi, logBT, y, ans, ix: _Indices, call):
    """The lanes' carries at their first positions (logPi, or the logA row
    of the resolved state before, plus the emission row) and those states
    (0 for a lane that starts the sequence)."""
    head = ix[call["head"]]
    prev = ans[ix[call["prev"]]]
    e0 = logBT.index_select(0, y.index_select(0, ix[call["L"]]))
    d = torch.where(head[:, None], logPi[None, :], logA[prev]) + e0
    return d, torch.where(head, torch.zeros_like(prev), prev)


def _emissions(logBT, y, pos: torch.Tensor) -> torch.Tensor:
    """The (c, g, K) emission rows at the (c, g) positions ``pos``."""
    c, g = pos.shape
    return logBT.index_select(0, y.index_select(0, pos.reshape(-1))).view(c, g, -1)


def _lean_round(logA, logPi, logBT, y, ans, ix: _Indices, calls, err, chunk=LEAN_CHUNK):
    """One splitting round: ``ans[mid]`` of every interval, from chunked
    pointer scans whose rows fold into each lane's t2 plane (the
    reference's in-scan t2 recurrence, :227-246)."""
    K = logA.shape[0]
    for call in calls:
        d, prev = _forced_start(logA, logPi, logBT, y, ans, ix, call)
        t2 = prev[:, None].expand(call["g"], K).contiguous()
        pos, prop = ix[call["pos"]], ix[call["prop"]]
        for c0 in range(0, call["steps"], chunk):
            c1 = min(c0 + chunk, call["steps"])
            d, ptrs = maxplus_scan(logA, _emissions(logBT, y, pos[c0:c1]), d, err=err)
            t2 = fold_planes(t2, ptrs, prop[c0:c1], err=err)
            del ptrs  # before the next chunk's tables are made
        ends = ans[ix[call["R"]]].to(torch.int64)
        ans[ix[call["mid"]]] = t2.gather(1, ends[:, None])[:, 0]
    return ans


def _decode_leaves(logA, logAT, logPi, logBT, y, ans, ix: _Indices, calls, err):
    """Forced-boundary decode of the splitting tree's leaves: each call's
    lanes scan their carry history (``maxplus_scan_deltas``) and walk back
    from their resolved end states (``argmax_walk``)."""
    for call in calls:
        d0, _ = _forced_start(logA, logPi, logBT, y, ans, ix, call)
        emitsN = _emissions(logBT, y, ix[call["pos"]])
        _, deltas = maxplus_scan_deltas(logA, emitsN, d0, err=err)
        del emitsN
        paths = argmax_walk(deltas, logAT, ans[ix[call["R"]]], err=err)
        del deltas
        ans[ix[call["out"]].reshape(-1)] = paths.reshape(-1)
    return ans


def _lean_decode(logA, logB, logPi, y, N: int, num_segments: int, lean_leaf: int,
                 transposed) -> torch.Tensor:
    T = y.shape[0]
    dev = logA.device
    mids_l = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts_l, lens_l, _ = segment_layout(mids_l, T)
    ix = _Indices()
    h_mids = ix.add(mids_l)
    h_prop = ix.add(prop_schedule(mids_l, T), np.bool_)
    round_calls, leaf_calls = _lean_program(
        T, mids_l, starts_l, lens_l, num_segments, lean_leaf, logA.shape[0],
        lambda k, g, with_ptr: scan_scratch_bytes(k, g, dev, with_ptr), ix)
    ix.upload(dev)
    logBT = logB.t()
    err = error_word(dev)

    last, anchors = phase1_anchors_chunked(logA, logPi, logB, y, ix[h_mids], ix[h_prop], err,
                                           chunk=LEAN_CHUNK)
    ans = torch.zeros((T,), dtype=torch.int32, device=dev)
    ans[T - 1] = last
    if mids_l:
        ans[ix[h_mids]] = anchors
    del anchors
    for calls in round_calls:
        ans = _lean_round(logA, logPi, logBT, y, ans, ix, calls, err, chunk=LEAN_CHUNK)
    if leaf_calls:
        ans = _decode_leaves(logA, transposed(logA), logPi, logBT, y, ans, ix, leaf_calls, err)
    raise_on_error(err, "flash")
    return ans


def flash_decode(logA, logB, logPi, y, num_segments: int = 8, mode: str = "pointer",
                 lean_leaf: int = LEAN_LEAF, transposed: _Transposed | None = None,
                 precision: str = "fp32"):
    """The (T,) int32 path of ``y`` under the (padded) tables, ``logA``
    read at ``precision``.  ``transposed`` makes the table at that
    precision and the walk's transposed table (by default fresh copies each
    call)."""
    transposed = transposed or _Transposed()
    logA = transposed.cast(logA, precision)
    T = y.shape[0]
    N = _segments(num_segments, T)
    if mode == "pointer":
        return _pointer_decode(logA, logB, logPi, y, N, transposed)
    if mode == "lean":
        return _lean_decode(logA, logB, logPi, y, N, num_segments, lean_leaf, transposed)
    raise ValueError(f"unknown flash mode {mode!r}")


def _segments(num_segments: int, T: int) -> int:
    """The segments a decode of T positions runs: at most T // 2, at least 1."""
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    return N


def _kept_bytes(K: int, precision: str, walks: bool) -> int:
    """What the decoder keeps across calls (``_Transposed``): the bf16
    table, and the walk's transposed table where a walk reads it."""
    elem = 2 if precision == "bf16" else 4
    return (a(K * K * 2) if precision == "bf16" else 0) + (a(K * K * elem) if walks else 0)


def pointer_peak_bytes(K: int, T: int, num_segments: int = 8, precision: str = "fp32",
                       sms: int = H100_SMS) -> int:
    """Device bytes a pointer-mode decode allocates at its peak beside the
    tables, on a card of ``sms`` SMs, the (T,) int64 observations and what
    the decoder keeps counted: the kept tables, the (T, K) emissions and
    the index arrays, beside the larger of phase 1 (the (T-1, K) pointers,
    the scan's scratch or the walk's) and phase 2 (the segments' emissions
    twice, their carry history, the scan's scratch or the walk's path),
    and the gathered path."""
    N = _segments(num_segments, T)
    elem = 2 if precision == "bf16" else 4
    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    _, _, Lmax = segment_layout(mids, T)
    P, Tm, Ls = len(mids), T - 1, Lmax - 1
    held = (_kept_bytes(K, precision, True) + 2 * a(T * 8) + a(P * 8) + 2 * a(N * 8)
            + a(T * K * 4) + a(4) + 4 * a(N * 4))
    walk1 = argmax_bytes(1, K) + (a(T * 4) + a(4 * kb.backtrack_plan(Tm, 1, K, sms)
                                                .scratch_words(1, K)) if P and Tm else 0)
    phase1 = (2 * a(K * 4) + a(Tm * K * 4)
              + max(plan_scratch_bytes(K, 1, sms, True, elem) if Tm else 0, walk1))
    rows = a(N * K * 4)
    seg = 3 * a(N * Lmax * 8) + a(N * Lmax * K * 4)
    scan2 = (plan_scratch_bytes(K, N, sms, False, elem) if Ls else 0)
    phase2 = seg + max(3 * rows, rows + 2 * a(Ls * N * K * 4) + a(Ls * N) + rows
                       + max(scan2, a(N * Lmax * 4)))
    return held + max(phase1, phase2 + a(T * 4))


def lean_peak_bytes(K: int, T: int, num_segments: int = 8, lean_leaf: int = LEAN_LEAF,
                    precision: str = "fp32", sms: int = H100_SMS) -> int:
    """Device bytes a lean decode allocates at its peak beside the tables,
    on a card of ``sms`` SMs, the (T,) int64 observations and what the
    decoder keeps counted: the kept tables, the index arrays and the
    answer, beside the largest of phase 1's chunk (its emissions,
    pointers, the scan's scratch and the anchor planes), a round's call
    and a leaf call, each with the lanes the decode gives it there."""
    N = _segments(num_segments, T)
    elem = 2 if precision == "bf16" else 4
    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts, lens, _ = segment_layout(mids, T)
    ix = _Indices()
    ix.add(mids)
    ix.add(prop_schedule(mids, T), np.bool_)
    round_calls, leaf_calls = _lean_program(
        T, mids, starts, lens, num_segments, lean_leaf, K,
        lambda k, g, with_ptr: plan_scratch_bytes(k, g, sms, with_ptr), ix)
    held = (_kept_bytes(K, precision, bool(leaf_calls)) + a(T * 8) + a(4)
            + a(4 * ix._size[np.int32]) + a(ix._size[np.bool_]) + a(T * 4))
    P = len(mids)

    def fold(P, c, R):
        plan = kf.fold_plan(P, c, R, K, sms)
        return a(P * K * 4) + (0 if plan.maps_smem else a(P * plan.G * 2 * K * 4))

    c = min(LEAN_CHUNK, T - 1)
    peak = 2 * a(K * 4) + a(P * K * 4) + argmax_bytes(1, K)
    if c > 0:
        peak += a(c * K * 4) + max(a(c * K * 4) + a(K * 4)
                                   + plan_scratch_bytes(K, 1, sms, True, elem),
                                   fold(P, c, 1) if P else 0)
    for call in (cl for calls in round_calls for cl in calls):
        g, c = call["g"], min(LEAN_CHUNK, call["steps"])
        rows = a(g * K * 4)
        body = (2 * rows + a(c * g * K * 4)
                + max(a(c * g * K * 4) + a(c * g * 8) + rows
                      + plan_scratch_bytes(K, g, sms, True, elem), fold(g, c, g)))
        peak = max(peak, 3 * rows, body)
    for call in leaf_calls:
        g, n = call["g"], call["steps"]
        rows, hist = a(g * K * 4), a(n * g * K * 4)
        peak = max(peak, 3 * rows, rows + hist + a(n * g * 8),
                   2 * rows + 2 * hist + plan_scratch_bytes(K, g, sms, False, elem),
                   2 * rows + hist + a(g * (n + 1) * 4) + a(g * (n + 1) * 8))
    return held + peak


def _threadpool_sizeof(N: int) -> int:
    # glibc x86-64: pthread_mutex_t 40 + pthread_cond_t 48 + pthread_t[N]
    # + 3 ints, padded to 8 (FLASH_Viterbi_multithread.c:36-46)
    return (40 + 48 + 8 * N + 12 + 7) // 8 * 8


def _memory(K: int, T: int, num_segments: int = 8, **_) -> int:
    """Reference-exact (FLASH_Viterbi_multithread.c:341-367), the same for
    both modes, with num_segments in MAX_THREADS' role: max(phase-1 tables,
    per-thread double buffers) + sizeof(ThreadPool) + 8 — the final +8
    reproduces the sizeof(obserRouteLEN*sizeof(INTERVAL))
    sizeof-of-expression bug (:367), which evaluates to sizeof(unsigned
    long)."""
    N = max(1, num_segments)
    phase1 = 0
    if N > 2 and T >= 2 * N:
        phase1 = (N - 1) * 4 + 2 * K * 4 + 2 * (N - 1) * K * 4
    tmp = N * (2 * K * 4 + 2 * K * 4)
    return max(phase1, tmp) + _threadpool_sizeof(N) + 8


@register("flash")
def _build(num_segments: int = 8, mode: str = "pointer", precision: str = "fp32",
           lean_leaf: int = LEAN_LEAF, **static) -> Decoder:
    """Other keywords (the JAX package's ``use_pallas``, for one) are
    recorded in ``static`` and change nothing."""
    if mode not in ("pointer", "lean"):
        raise ValueError(f"unknown flash mode {mode!r}")
    if precision not in mp.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    transposed = _Transposed()

    def fn(logA, logB, logPi, y):
        return flash_decode(logA, logB, logPi, y, num_segments=num_segments, mode=mode,
                            lean_leaf=lean_leaf, transposed=transposed, precision=precision)

    return Decoder("flash", fn, {"num_segments": num_segments, "mode": mode,
                                 "precision": precision, "lean_leaf": lean_leaf, **static},
                   _memory)
