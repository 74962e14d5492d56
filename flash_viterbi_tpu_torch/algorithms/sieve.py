"""SIEVE-Mp and SIEVE-BS-Mp: fixed-median divide and conquer, level-batched.

Counterpart of ``flash_viterbi_tpu/algorithms/sieve.py``, bit for bit.  The
reference (``Base_line/C implementations/SIEVE-Mp.c:286-509``) recurses
over the time midpoint, BFS-prunes the state set of each half and runs a
pruned forward pass per node.  The recursion *tree over time* is static
(floor(T/2) splits), so

* nodes run **level by level**: the segments of one level with equal
  length are lanes of one ``maxplus_scan`` call (at most two calls a
  level: lengths within a level differ by at most one);
* pruning is a **mask**: banned states get -inf emissions, which kills
  them as destinations and (by their -inf scores) as sources, so the
  masked full-K argmax equals the reference's subset argmax, lowest index
  on ties included;
* the BFS is a fixed number of hops of a 0/1 frontier times the 0/1
  adjacency, batched over the segments (a matmul a hop);
* the median planes come from the scan's pointer rows: ``fold_planes``
  folds the rows after the midpoint into identity planes, and the row at
  the midpoint read through them gives the other plane;
* the in-order pair flattening (``change_mp_path`` :466-489) has a static
  structure, so it reduces to one gather from the pairs.

Reference quirks kept: right children re-pick their end state by argmax
(last=-1, :452), left children force it to x_a; unforced segments use a
subset-uniform prior log(1/K_sub) (:303-307), from a float64 table made on
the host (an fp32 log can differ by one ulp and flip an exact tie).

``sieve_bs_mp`` (``SIEVE-BS-Mp.c``) runs the same tree with top-B beams:
each segment's first step (whose token set may exceed the beam) is a
one-step ``maxplus_scan`` with zero emissions, every later step gathers
the B beam rows of ``logA`` and runs in O(S*B*K) as plain tensor
operations (as in the JAX package, where they are XLA operations).

The index arrays of a decode are copied to the device in one transfer
before its first launch, and the scans share one error word read once at
the end.  On CUDA tensors ``maxplus_scan`` and ``fold_planes`` launch the
hand-written kernels; on CPU tensors they run their plain versions.  JAX's
``use_pallas`` switch routes nothing here (it is recorded, as any extra
keyword is).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.beam import beam_topk
from ..ops.cuda import fold_planes, maxplus_scan
from ..ops.cuda.maxplus import error_word, raise_on_error
from ..ops.maxplus import first_argmax
from .base import Decoder, register
from .flash import _Indices

NEG = float("-inf")
# bytes each (S, B, K) fp32 temporary of a beam step (the gathered logA rows,
# the scores) may take: a step's lanes go in chunks under it.  At the
# headline (B=64, Kp=3968) one lane takes 1 MiB, so chunks of 64 lanes
BEAM_STEP_BYTES = 64 * 2**20
# the reference's beam sentinels: a touched state whose score is -inf ranks
# above every untouched state (sieve_bs_mp_decode's _select_beam)
TOUCHED_NEG = -2.0e38
UNTOUCHED_NEG = -3.0e38


@dataclasses.dataclass
class _Node:
    idx: int
    start: int
    length: int
    parent: int  # -1 for root
    side: str  # "root" | "left" | "right"
    depth: int
    inorder: int = -1
    left: int = -1
    right: int = -1
    sentinel: bool = False


def build_tree(T: int) -> list[_Node]:
    """Static recursion tree, in-order numbering and sentinel flags
    (mirrors sieve_middlepath's call structure + mp_path appends)."""
    nodes: list[_Node] = []

    def rec(start: int, length: int, parent: int, side: str, depth: int) -> int:
        me = len(nodes)
        nodes.append(_Node(me, start, length, parent, side, depth))
        n_left = length // 2
        n_right = length - n_left
        if n_left > 1:
            nodes[me].left = rec(start, n_left, me, "left", depth + 1)
        if n_right > 1:
            nodes[me].right = rec(start + n_left, n_right, me, "right", depth + 1)
        return me

    rec(0, T, -1, "root", 0)

    # in-order append positions + static sentinel decisions (C :412-428)
    count = 0

    def inord(i: int):
        nonlocal count
        nd = nodes[i]
        if nd.left >= 0:
            inord(nd.left)
        n_left = nd.length // 2
        n_right = nd.length - n_left
        nd.sentinel = (n_right <= 1 and n_left <= 1 and count < T - 2
                       and count != 0)
        nd.inorder = count
        count += 1
        if nd.right >= 0:
            inord(nd.right)

    inord(0)
    return nodes


def flatten_positions(nodes: list[_Node], T: int):
    """Static simulation of change_mp_path: for each output position,
    (inorder pair index, 0 for .x / 1 for .y)."""
    pairs = sorted(nodes, key=lambda n: n.inorder)
    mp_path = [("S" if n.sentinel else n.inorder) for n in pairs]
    out: list[tuple[int, int]] = []
    out.append((mp_path[0], 0))
    out.append((mp_path[0], 1))
    i = 1
    while len(out) <= len(mp_path):
        if mp_path[i] == "S":
            if i + 1 >= len(mp_path):
                break
            out.append((mp_path[i + 1], 0))
            out.append((mp_path[i + 1], 1))
            i += 1
        else:
            out.append((mp_path[i], 1))
        i += 1
    out = out[:T]
    assert all(p != "S" for p, _ in out), "sentinel leaked into output"
    return out


def _groups(nodes: list[_Node]) -> list[list[_Node]]:
    """The lane groups in the order they run: level by level, each level's
    segments of one length together, shorter first."""
    out = []
    for depth in range(max(n.depth for n in nodes) + 1):
        level = [n for n in nodes if n.depth == depth]
        for length in sorted({n.length for n in level}):
            out.append([n for n in level if n.length == length])
    return out


def _plan(nodes: list[_Node], groups: list[list[_Node]], spec, ix: _Indices):
    """Register with ``ix`` each group's (S, L) time indices and the
    flattening's gather: output position i takes pair ``spec[i] = (p, w)``
    (in-order pair p, 0 for .x / 1 for .y) from the groups' x pairs
    concatenated, then their y pairs.  Returns (the windows' handles, the
    gather's handle)."""
    windows, pos = [], {}
    for group in groups:
        starts = np.asarray([n.start for n in group])
        windows.append(ix.add(starts[:, None] + np.arange(group[0].length)[None, :]))
        for n in group:
            pos[n.idx] = len(pos)
    by_inorder = sorted(nodes, key=lambda n: n.inorder)
    sel = ix.add([pos[by_inorder[p].idx] + w * len(nodes) for p, w in spec])
    return windows, sel


def _planes_from_ptrs(ptrs: torch.Tensor, mid: int, err=None):
    """(plane_x, plane_y) (S, K) int32 from the pointer rows (L-1, S, K):
    record at j == mid, gather-propagate after (reference :338-346).

    ``fold_planes`` folds the rows after the midpoint into identity planes,
    which gives plane_y; gathers compose, so plane_x is the midpoint's row
    read through plane_y."""
    _, S, K = ptrs.shape
    iota = torch.arange(K, dtype=torch.int32, device=ptrs.device).expand(S, K).contiguous()
    rows = ptrs[mid:]
    prop = torch.ones((rows.shape[0], S), dtype=torch.bool, device=ptrs.device)
    py = fold_planes(iota, rows, prop, err=err)
    return ptrs[mid - 1].gather(1, py.long()), py


def _bfs_masks(adjF: torch.Tensor, frontier0: torch.Tensor, parent_mask, hops: int):
    """(S, K) fp32 0/1: the states within 1..``hops`` edges of the one-hot
    ``frontier0`` (S, K), inside ``parent_mask`` (S, K) 0/1 (None: all).

    ``adjF`` (K, K) fp32 0/1, ``adjF[i, j]`` = edge i -> j in traversal
    direction (a transposed view for ancestors).  A matmul a hop, as many
    hops as asked: stopping when the frontier empties would read it back
    to the host every hop."""
    keep = None if parent_mask is None else parent_mask > 0
    visited = torch.zeros(frontier0.shape, dtype=torch.bool, device=frontier0.device)
    frontier = frontier0
    for _ in range(hops):
        new = ((frontier @ adjF) > 0) & ~visited
        if keep is not None:
            new &= keep
        visited |= new
        frontier = new.to(frontier0.dtype)
    return visited.to(frontier0.dtype)


def _one_hot(states: torch.Tensor, K: int) -> torch.Tensor:
    """(S, K) fp32 rows, 1 at ``states`` (S,)."""
    iota = torch.arange(K, dtype=states.dtype, device=states.device)
    return (iota[None, :] == states[:, None]).to(torch.float32)


def _flatten(pairs_x: list, pairs_y: list, sel: torch.Tensor, fill: int, T: int):
    """The (T,) int32 path: the groups' pairs gathered by ``sel`` (see
    :func:`_plan`); positions past it hold ``fill``."""
    vals = torch.cat(pairs_x + pairs_y)[sel.long()]
    out = torch.full((T,), fill, dtype=torch.int32, device=vals.device)
    out[: vals.shape[0]] = vals.to(torch.int32)
    return out


def sieve_mp_decode(logA, logB, logPi, y, A_posF, prune: bool = True) -> torch.Tensor:
    """Full SIEVE-Mp decode of the (T,) observations ``y``; the (T,) int32
    path, equal to ``oracle.sieve.sieve_mp(numerics="f32")`` when
    ``prune``.  ``A_posF`` is the (K, K) fp32 0/1 edge matrix."""
    T = int(y.shape[0])
    K = logA.shape[0]
    dev = logA.device
    if T == 1:
        # the reference's pair flattening needs two output slots
        # (SIEVE-Mp.c:470-471): decode directly
        return first_argmax(logPi + logB[:, y[0]], 0)[1][None]
    nodes = build_tree(T)
    groups = _groups(nodes)
    ix = _Indices()
    windows, sel = _plan(nodes, groups, flatten_positions(nodes, T), ix)
    ix.upload(dev)
    unif_tab = torch.from_numpy(
        np.log(1.0 / np.arange(1, K + 1, dtype=np.float64)).astype(np.float32)).to(dev)
    emits = logB.t()[y]  # (T, K)
    iota = torch.arange(K, dtype=torch.int32, device=dev)
    err = error_word(dev)

    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    masks = {0: torch.ones((K,), dtype=torch.float32, device=dev)}
    inits = {0: minus1}
    lasts = {0: minus1}
    pairs_x, pairs_y = [], []
    for group, win in zip(groups, windows):
        length, depth = group[0].length, group[0].depth
        mask = torch.stack([masks[n.idx] for n in group])  # (S, K) 0/1
        init = torch.stack([inits[n.idx] for n in group])  # (S,)
        last_f = torch.stack([lasts[n.idx] for n in group])

        # masked emissions of the group's time windows
        seg_emits = emits[ix[win]] + torch.where(mask > 0, 0.0, NEG)[:, None, :]
        ksub = torch.clamp(mask.sum(dim=1), min=1.0)
        root_pi = logPi[None, :] if depth == 0 else unif_tab[ksub.long() - 1][:, None]
        forced0 = torch.where(iota[None, :] == init[:, None], 0.0, NEG)
        d0 = torch.where((init >= 0)[:, None], forced0, root_pi) + seg_emits[:, 0]
        emitsN = seg_emits[:, 1:].transpose(0, 1).contiguous()  # (L-1, S, K)
        dfin, ptrs = maxplus_scan(logA, emitsN, d0, err=err)

        px, py = _planes_from_ptrs(ptrs, length // 2, err)
        last = torch.where(last_f >= 0, last_f,
                           first_argmax(torch.where(mask > 0, dfin, NEG), 1)[1])
        x_a = px.gather(1, last[:, None].long())[:, 0]
        x_b = py.gather(1, last[:, None].long())[:, 0]
        pairs_x.append(x_a)
        pairs_y.append(x_b)

        n_left = length // 2
        n_right = length - n_left
        if any(n.left >= 0 for n in group):
            lmask = mask
            if prune:
                onehot_a = _one_hot(x_a, K)
                lmask = torch.maximum(_bfs_masks(A_posF.t(), onehot_a, mask, n_left - 1),
                                      onehot_a)
        if any(n.right >= 0 for n in group):
            rmask = mask
            if prune:
                onehot_b = _one_hot(x_b, K)
                rmask = torch.maximum(_bfs_masks(A_posF, onehot_b, mask, n_right - 1),
                                      onehot_b)
        for s, n in enumerate(group):
            if n.left >= 0:
                masks[n.left] = lmask[s]
                inits[n.left] = init[s]  # left child keeps parent's entry
                lasts[n.left] = x_a[s]
            if n.right >= 0:
                masks[n.right] = rmask[s]
                inits[n.right] = x_b[s]
                lasts[n.right] = minus1  # re-picked by argmax (quirk :452)

    path = _flatten(pairs_x, pairs_y, ix[sel], 0, T)
    raise_on_error(err, "sieve_mp")
    return path


def _select_beam(touched: torch.Tensor, newT1: torch.Tensor, B: int):
    """(top_idx (S, B) int32, eff (S,), token mask (S, K) fp32) of the
    touched top B.

    The reference beam is ``nlargest`` over the *touched dict only*: a
    touched key whose score is still -inf IS in the dict and outranks every
    untouched state.  Two sentinels keep that order under a dense top B:
    touched -inf -> -2e38, untouched -> -3e38, so no untouched state can
    displace a touched one inside the eff = min(B, #touched) kept slots.
    The top B is ``beam_topk``'s stable sort: lowest index first on ties,
    as ``jax.lax.top_k``."""
    S = touched.shape[0]
    eff = torch.clamp(touched.sum(dim=1), max=B)
    vals = torch.where(touched, torch.where(torch.isneginf(newT1), TOUCHED_NEG, newT1),
                       UNTOUCHED_NEG)
    _, top_idx = beam_topk(vals, B)
    slot_ok = torch.arange(B, device=touched.device)[None, :] < eff[:, None]
    tokm = torch.zeros(touched.shape, dtype=torch.float32, device=touched.device)
    tokm.scatter_(1, top_idx.long(), slot_ok.to(torch.float32))  # top_idx rows are distinct
    return top_idx, eff, tokm


def _beam_max(t1tok: torch.Tensor, tok_idx: torch.Tensor, logA: torch.Tensor):
    """(val, slot) (S, K): the max over the B beam rows of ``t1tok[:, b] +
    logA[tok_idx[:, b]]`` and its lowest slot, in chunks of lanes whose
    (S, B, K) temporaries stay under ``BEAM_STEP_BYTES`` each."""
    S, B = tok_idx.shape
    lanes = max(1, BEAM_STEP_BYTES // (B * logA.shape[1] * 4))
    parts = []
    for c0 in range(0, S, lanes):
        rows = logA[tok_idx[c0:c0 + lanes].long()]  # (s, B, K)
        parts.append(first_argmax(t1tok[c0:c0 + lanes, :, None] + rows, 1))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


def sieve_bs_mp_decode(logA, logB_raw, logPi, y, A_posF, beam_width: int) -> torch.Tensor:
    """SIEVE-BS-Mp (``sieve_beam_search.py:351-501`` / ``SIEVE-BS-Mp.c``):
    fixed-median divide and conquer with static top-B beam pruning, on the
    same level-batched tree as :func:`sieve_mp_decode`; equal to
    ``oracle.framework.sieve_bs_mp``.

    Reference semantics kept: only out-edges of the current token set
    relax (states with no in-edge from the beam drop out); emission misses
    contribute 0 (``B==0`` dict fallthrough, :405-409); the beam is the
    top-``min(B, #touched)`` of touched states; the median-step beam
    becomes the right child's token set; left children inherit the
    parent's tokens; left children force ``last=x_a``, right children
    inherit the parent's ``last`` (:496).  The model Pi at every node, as
    the C binary re-applies it (SIEVE-BS-Mp.c:332).

    Returns the flattened in-order pair path ``[p0.x, p0.y, p1.y, ...]``
    (the reference's pretty_print_path layout), -1 where a segment's
    median pair was never set.
    """
    T = int(y.shape[0])
    K = logA.shape[0]
    B = min(int(beam_width), K)
    dev = logA.device
    if T == 1:
        return first_argmax(logPi + logB_raw[:, y[0]], 0)[1][None]
    nodes = build_tree(T)
    groups = _groups(nodes)
    # pretty_print_path layout: p0.x, p0.y, then .y of each later pair
    spec = ([(0, 0), (0, 1)] + [(p, 1) for p in range(1, len(nodes))])[:T]
    ix = _Indices()
    windows, sel = _plan(nodes, groups, spec, ix)
    ix.upload(dev)
    # miss-as-zero emission rows by symbol (reference acoustic dict fallthrough)
    emitQT = torch.where(logB_raw > NEG, logB_raw, 0.0).t()  # (M, K)
    iota = torch.arange(K, dtype=torch.int32, device=dev)
    slots = torch.arange(B, device=dev)
    err = error_word(dev)

    def run_group(group, mask, cur, last_f, win):
        S = len(group)
        length = group[0].length
        th = length // 2
        syms = y[ix[win]]  # (S, L) symbols of the group's windows
        T1 = torch.where(mask > 0, logPi[None, :] + emitQT[syms[:, 0]], NEG)

        # step j=1: dense (the token set may exceed B)
        T1m = torch.where(cur > 0, T1, NEG)
        zero_emit = torch.zeros((1, S, K), dtype=torch.float32, device=dev)
        val1, ptrs = maxplus_scan(logA, zero_emit, T1m, err=err)
        touched = ((cur @ A_posF) > 0) & (mask > 0)
        T1 = torch.where(touched, val1 + emitQT[syms[:, 1]], NEG)

        # median planes mirror the reference's per-step ``new_middlepath``
        # dict, which is REBUILT every step: a destination that wins no
        # candidate this step has no entry, so inheriting from it later
        # must read (-1, -1): non-winners are reset, never carried over
        if th == 1:
            won1 = touched & (val1 > NEG)
            px = torch.where(won1, ptrs[0], -1)
            py = torch.where(won1, iota[None, :], -1)
        else:
            px = torch.full((S, K), -1, dtype=torch.int32, device=dev)
            py = px
        tok_idx, eff, tokm = _select_beam(touched, T1, B)
        mid_beam = tokm if th == 1 else cur

        # steps j >= 2: the beam's gathered rows, O(S*B*K)
        for j in range(2, length):
            t1tok = torch.where(slots[None, :] < eff[:, None], T1.gather(1, tok_idx.long()),
                                NEG)
            val, slot = _beam_max(t1tok, tok_idx, logA)
            win_src = tok_idx.gather(1, slot.long())  # global sources
            touched = ((tokm @ A_posF) > 0) & (mask > 0)
            newT1 = torch.where(touched, val + emitQT[syms[:, j]], NEG)
            if j >= th:
                # per-step dict-rebuild semantics: only this step's winners
                # carry a pair forward; everyone else resets to (-1, -1)
                won = touched & (val > NEG)
                if j == th:
                    px_rec, py_rec = win_src, iota[None, :]
                else:
                    px_rec, py_rec = px.gather(1, win_src.long()), py.gather(1, win_src.long())
                px, py = torch.where(won, px_rec, -1), torch.where(won, py_rec, -1)
            tok_idx, eff, tokm = _select_beam(touched, newT1, B)
            if j == th:
                mid_beam = tokm
            T1 = newT1

        argm = first_argmax(torch.where(mask > 0, T1, NEG), 1)[1]
        last = torch.where(last_f > -2, last_f, argm)
        safe = torch.clamp(last, 0, K - 1)[:, None].long()
        x_a = torch.where(last >= 0, px.gather(1, safe)[:, 0], -1)
        x_b = torch.where(last >= 0, py.gather(1, safe)[:, 0], -1)
        return x_a, x_b, mid_beam, last

    ones = torch.ones((K,), dtype=torch.float32, device=dev)
    masks = {0: ones}
    tokens = {0: ones}
    lasts = {0: torch.full((), -2, dtype=torch.int32, device=dev)}  # -2: argmax
    pairs_x, pairs_y = [], []
    for group, win in zip(groups, windows):
        mask = torch.stack([masks[n.idx] for n in group])
        x_a, x_b, mid_beam, last = run_group(
            group, mask, torch.stack([tokens[n.idx] for n in group]),
            torch.stack([lasts[n.idx] for n in group]), win)
        pairs_x.append(x_a)
        pairs_y.append(x_b)
        length = group[0].length
        n_left = length // 2
        n_right = length - n_left
        if any(n.left >= 0 for n in group):
            # BFS bound is N_left hops w/ depth-from-1 counting ==
            # <= N_left-1 edges (single_node_ancestors :545-588)
            onehot_a = _one_hot(torch.clamp(x_a, min=0), K)
            lmask = torch.maximum(_bfs_masks(A_posF.t(), onehot_a, None, n_left - 1),
                                  onehot_a)
        if any(n.right >= 0 for n in group):
            onehot_b = _one_hot(torch.clamp(x_b, min=0), K)
            rmask = torch.maximum(_bfs_masks(A_posF, onehot_b, None, n_right - 1),
                                  onehot_b)
        for s, n in enumerate(group):
            if n.left >= 0:
                masks[n.left] = lmask[s]
                tokens[n.left] = tokens[n.idx]  # parent's tokens thread
                lasts[n.left] = x_a[s]
            if n.right >= 0:
                masks[n.right] = rmask[s]
                tokens[n.right] = mid_beam[s]
                lasts[n.right] = last[s]  # parent's computed last (:496)

    path = _flatten(pairs_x, pairs_y, ix[sel], -1, T)
    raise_on_error(err, "sieve_bs_mp")
    return path


def _memory_bs_mp(K: int, T: int, beam_width: int = 64, **_) -> int:
    return T * beam_width * 8 + 4 * K * 4


@register("sieve_bs_mp")
def _build_bs_mp(beam_width: int = 64, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        A_posF = (logA > NEG).to(torch.float32)
        return sieve_bs_mp_decode(logA, logB, logPi, y, A_posF, beam_width=beam_width)

    return Decoder("sieve_bs_mp", fn, {"beam_width": beam_width, **static}, _memory_bs_mp)


def _memory(K: int, T: int, **_) -> int:
    # per level: group pointer tables + masks + planes (dominant term: the
    # longest level's (T, K) pointer rows)
    return T * K * 4 + 4 * K * 4 + K * K * 4


@register("sieve_mp")
def _build(prune: bool = True, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        A_posF = (logA > NEG).to(torch.float32)
        return sieve_mp_decode(logA, logB, logPi, y, A_posF, prune=prune)

    return Decoder("sieve_mp", fn, {"prune": prune, **static}, _memory)
