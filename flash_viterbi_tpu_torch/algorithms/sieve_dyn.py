"""SIEVE (dynamic median) and SIEVE-DAG: a level scheduler whose node state
stays on the device.

Counterpart of ``flash_viterbi_tpu/algorithms/sieve_dyn.py``, bit for bit.
The reference has no C port: ``Sieve.sieve`` (``Base_line/Python
implementations/Viterbi.py:529-681``) and ``Sieve.sieve_dag`` (:994-1152,
with the topological preprocessing of :850-990) recurse over a
*data-dependent* split: the forward pass tracks, per end state, the
transition ``(x_a, x_b, t)`` minimizing ``max(#ancestors(x_a),
#descendants(x_b))`` (the first strictly smaller wins, no closeness
tie-break), then prunes each half's states by a breadth-first search and
recurses.

The JAX package runs the whole tree as one device program, or, under
``engine="host"``, as a level scheduler; the two give the same pairs.
PyTorch has no device loop, so the port runs the level scheduler, as its
``sieve_bs`` does:

* all ready nodes of a tree level (of every sequence of a batch) are lanes
  of one forward pass, longest first, so the lanes still running at step j
  are a prefix and each step works on that prefix alone;
* every step is tensor operations on the device: a dense (K, K) candidate
  table a lane, the lanes in chunks whose tables stay under
  ``DENSE_STEP_BYTES``, and the median carry ``(mx, my, mn, mval)``
  vectorized over the K destinations.  The original's per-destination
  update depends only on the argmax predecessor, so an argmax with
  lowest-*active*-index ties reproduces it, the all -inf column included;
* the node state (masks, scores, median carries) stays on the device; a
  level reads back four integers a node (``x_a``, ``x_b``, ``n_left``,
  ``last``) and, once its children's state masks are made, each child's
  state count;
* the children's masks are breadth-first searches on the device over the
  parent's subgraph (``A_pos`` restricted to the parent's states): the left
  child's along in-edges from ``x_a`` within ``n_left - 1`` hops, the right
  child's along out-edges from ``x_b`` within ``n_right - 1``, each plus
  its source.  A level's children search together, a frontier product a
  hop, each to its own hop limit, until a hop reaches nothing new (every
  later hop would add nothing);
* the counts: ``sieve`` takes global ``<= b``-hop counts (``sieve_bs``'s
  ``_bhop_counts``, b = floor(log2 #real states)); ``sieve_dag`` counts
  ancestors and descendants per node over its subgraph within
  ``min(L - 1, K)`` hops, K searches a lane at once, a level's lanes in
  chunks.  The 0/1 products are exact integers in fp32.

Reference quirks kept: priors are uniform over the node's states,
``float32(log(1 / k))`` from float64 on the host (an fp32 log may differ in
the last bit), unless an entry state is forced (0 there, -inf elsewhere).
The original's module-level ``initial_state`` reduces to a static edge
rule: right children are forced to the parent's ``x_b``, left children
inherit the parent's own forced state.  Left children force their end
state to ``x_a``; right ones re-pick it by argmax.  A node whose median was
never set returns silently; a node with one state or none, or one frame,
is skipped.  Padded states are dead through the ``real`` liveness mask.

Documented delta (as ``sieve_bs``): scores are fp32 where the reference's
are float64, so the decisions are identical off exact fp ties; count
comparisons are exact in both.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.maxplus import first_argmax
from ..utils.profiling import span
from .base import Decoder, register
from .sieve_bs import DENSE_STEP_BYTES, _bhop_counts, _flatten_pairs

NEG = float("-inf")


def _log_uniform(K: int) -> np.ndarray:
    """``float32(log(1 / k))`` for k = 0..K, from float64 (k = 0 is never
    read)."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 / np.maximum(np.arange(K + 1), 1)).astype(np.float32)


def _mark(dev: torch.device):
    """A point in time: a CUDA event recorded on the card's stream, the host
    clock on the CPU."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(start, end) -> float:
    """Milliseconds between two :func:`_mark` points (both events must have
    completed)."""
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


def _dag_counts(A_posF: torch.Tensor, masks: torch.Tensor, hops: np.ndarray):
    """(ancestors, descendants) (S, K) fp32 of each lane's states over its
    subgraph (``A_pos`` restricted to ``masks[s]``), within ``hops[s]`` edges,
    the source excluded unless re-reached: K searches a lane at once, a
    batched product a hop, lanes in chunks whose (s, K, K) tables stay under
    ``DENSE_STEP_BYTES``, stopping at the first hop that reaches nothing new
    (the JAX package's ``_dag_counts`` with the device engine's early
    exit)."""
    S, K = masks.shape
    dev = masks.device
    lanes = max(1, DENSE_STEP_BYTES // (K * K * 4))
    eye = torch.eye(K, dtype=torch.float32, device=dev)
    lim = torch.as_tensor(hops, device=dev)
    out = torch.empty((2, S, K), dtype=torch.float32, device=dev)
    for c0 in range(0, S, lanes):
        c1 = min(S, c0 + lanes)
        m = masks[c0:c1].to(torch.float32)
        pair = m[:, :, None] * m[:, None, :]
        for d, adj in enumerate((A_posF.t(), A_posF)):  # ancestors, then descendants
            a = adj[None] * pair
            frontier = eye[None] * m[:, :, None]
            visited = torch.zeros((c1 - c0, K, K), dtype=torch.bool, device=dev)
            for h in range(int(hops[c0:c1].max())):
                new = (torch.bmm(frontier, a) > 0) & ~visited & (h < lim[c0:c1])[:, None, None]
                with span("fvt.sync"):
                    grew = bool(new.any())
                if not grew:
                    break
                visited |= new
                frontier = new.to(torch.float32)
            out[d, c0:c1] = visited.sum(dim=2).to(torch.float32)
            del a, frontier, visited
    return out[0], out[1]


def _level_forward(logA, emitT, anc, desc, sym, lengths, masks, init, logu, last_forced):
    """The forward passes of S nodes of one level with the dynamic-median
    carry (``oracle.sieve.sieve_dynamic``'s inner loop, Viterbi.py:570-636).

    ``sym`` (S, Lmax) int64 symbols; ``lengths`` (S,) numpy, descending,
    each >= 2; ``masks`` (S, K) bool; ``init`` (S,) int64 forced entry state
    (-1: the uniform prior ``logu`` (S,) fp32); ``last_forced`` (S,) int64
    (-1: the argmax); ``anc`` and ``desc`` (S, K) fp32 (an expanded view
    where the lanes share them).  Returns (x_a, x_b, n_left, last) as a (4, S) int64 tensor;
    x_a == -1 where the median was never set.

    Scores are ``(T1[:, None] + logA) + emit[None, :]``, NaN mapped to
    -inf, as the JAX package adds and masks them.  T1 is -inf off the
    node's states, so only active sources reach a finite score: the
    destination mask on the maxima stands for the JAX package's
    (source, destination) mask, and a column whose maximum is -inf takes
    the lowest active state (np.argmax over the compacted subproblem).
    The medians of inactive destinations differ from the JAX package's, but
    an argmax never points at an inactive state, so no output reads them.
    """
    S, K = masks.shape
    dev = logA.device
    iota = torch.arange(K, device=dev)
    first_active = torch.where(masks, iota, K).amin(dim=1)
    prior = torch.where(init[:, None] < 0, logu[:, None],
                        torch.where(iota[None, :] == init[:, None], 0.0, NEG))
    T1 = torch.where(masks, prior + emitT[sym[:, 0]], NEG)
    # mx == -1 exactly where my, mn == -1 and mval == +inf (a write sets
    # all four, an inheritance copies all four): so "inherit if the
    # source has a median, else reset" is a copy of the source's carry
    mx = torch.full((S, K), -1, dtype=torch.int64, device=dev)
    my, mn = mx.clone(), mx.clone()
    mval = torch.full((S, K), float("inf"), dtype=torch.float32, device=dev)
    lanes = max(1, DENSE_STEP_BYTES // (K * K * 4))
    for j in range(1, int(lengths[0])):
        n = int(np.searchsorted(-lengths, -j, side="left"))  # lanes with L > j
        emit = emitT[sym[:n, j]]
        bests, args = [], []
        for c0 in range(0, n, lanes):
            c1 = min(n, c0 + lanes)
            scores = T1[c0:c1, :, None] + logA
            scores += emit[c0:c1, None, :]
            torch.nan_to_num_(scores, nan=NEG, posinf=float("inf"), neginf=NEG)
            best, arg = first_argmax(scores, 1)
            bests.append(best)
            args.append(arg)
            del scores
        best = bests[0] if len(bests) == 1 else torch.cat(bests)
        arg = args[0] if len(args) == 1 else torch.cat(args)
        arg = torch.where(best == NEG, first_active[:n, None], arg.to(torch.int64))
        cand = torch.maximum(anc[:n].gather(1, arg), desc[:n])
        pv = mval[:n].gather(1, arg)
        take = cand < pv
        T1[:n] = torch.where(masks[:n], best, NEG)
        mx[:n] = torch.where(take, arg, mx[:n].gather(1, arg))
        my[:n] = torch.where(take, iota, my[:n].gather(1, arg))
        mn[:n] = torch.where(take, j, mn[:n].gather(1, arg))
        mval[:n] = torch.where(take, cand, pv)
    argm = torch.where((T1 == T1.amax(dim=1, keepdim=True)) & masks, iota, K).amin(dim=1)
    last = torch.where(last_forced >= 0, last_forced, argm)[:, None]
    return torch.stack([mx.gather(1, last)[:, 0], my.gather(1, last)[:, 0],
                        mn.gather(1, last)[:, 0], last[:, 0]])


def _reach(adjF: torch.Tensor, masks: torch.Tensor, src: np.ndarray, hops: np.ndarray):
    """(c, K) bool: each search's states within ``hops[i]`` edges of
    ``src[i]`` along ``adjF`` (rows -> columns) inside ``masks[i]``, plus its
    source: ``_host_bfs`` over ``adj & outer(mask, mask)`` for c searches at
    once, a frontier product a hop, until a hop reaches nothing new."""
    c, K = masks.shape
    dev = masks.device
    s = torch.as_tensor(src, device=dev)[:, None]
    lim = torch.as_tensor(hops, device=dev)[:, None]
    frontier = torch.zeros((c, K), dtype=torch.float32, device=dev).scatter_(1, s, 1.0)
    visited = torch.zeros((c, K), dtype=torch.bool, device=dev)
    for h in range(int(hops.max())):
        new = ((frontier @ adjF) > 0) & masks & ~visited & (h < lim)
        with span("fvt.sync"):
            grew = bool(new.any())
        if not grew:
            break
        visited |= new
        frontier = new.to(torch.float32)
    return visited.scatter_(1, s, True)


def sieve_dynamic_decode(logA, logB, logPi, y, b_hops: int | None = None, dag: bool = False,
                         stats: dict | None = None) -> list[tuple[int, int]]:
    """Full SIEVE (dynamic median) or SIEVE-DAG decode of the (T,)
    observations ``y``; returns the in-order median-pair list (equal to
    ``oracle.sieve.sieve_dynamic`` / ``oracle.sieve.sieve_dag`` off exact fp
    ties)."""
    return sieve_dynamic_decode_many(logA, logB, logPi,
                                     np.asarray(torch.as_tensor(y).cpu())[None],
                                     b_hops=b_hops, dag=dag, stats=stats)[0]


def sieve_dynamic_decode_many(logA, logB, logPi, ys, b_hops: int | None = None,
                              dag: bool = False,
                              stats: dict | None = None) -> list[list[tuple[int, int]]]:
    """SIEVE / SIEVE-DAG over a (Bs, T) batch of sequences on the tables'
    device: every sequence's tree feeds one level queue, so one forward pass
    a level serves the ready nodes of the whole batch; per-sequence results
    are those of one sequence at a time.  ``stats``, if given, gets the
    nodes, levels, forward lanes, node-steps (the forwarded nodes' lengths
    summed), the global counts' hops (``sieve``) and the milliseconds of
    the counts and of the children's searches (device time on the card)."""
    ys_np = np.asarray(torch.as_tensor(ys).cpu(), dtype=np.int64)
    S, _ = ys_np.shape
    K = int(logA.shape[0])
    dev = logA.device
    fin = torch.isfinite(logA)
    A_posF = fin.to(torch.float32)
    emitT = logB.t().contiguous()  # (M, K)
    # logical (non-padding) states: padded states are all -inf everywhere
    real = fin.any(dim=1) | torch.isfinite(logB).any(dim=1) | torch.isfinite(logPi)
    logu = _log_uniform(K)
    with span("fvt.sync"):
        n_real = int(real.sum())
    t0 = _mark(dev)
    if dag:
        bhop = None
    else:
        b = max(1, int(np.floor(np.log2(max(2, n_real))))) if b_hops is None else int(b_hops)
        anc_g, desc_g, bhop = _bhop_counts(A_posF, b)
    count_marks, bfs_marks = [(t0, _mark(dev))], []

    # a node: its sequence, its segment [lo, lo + L), its forced end and
    # entry states (-1: none), its state count, and its mask's row in the
    # masks of its level
    nodes: list[dict] = []

    def new_node(seq, lo, L, last, init, msum, row):
        nodes.append({"seq": seq, "lo": lo, "L": L, "last": last, "init": init, "msum": msum,
                      "row": row, "pair": None, "left": None, "right": None})
        return len(nodes) - 1

    level = [new_node(s, 0, ys_np.shape[1], -1, -1, n_real, 0) for s in range(S)]
    level_masks = real[None, :]
    levels = lanes = node_steps = 0
    while level:
        ready = [nid for nid in level if nodes[nid]["msum"] > 1 and nodes[nid]["L"] > 1]
        if not ready:
            break
        levels += 1
        ready.sort(key=lambda nid: -nodes[nid]["L"])  # stable: longest first
        lengths = np.asarray([nodes[nid]["L"] for nid in ready], dtype=np.int64)
        lanes += len(ready)
        node_steps += int(lengths.sum())
        sym = np.zeros((len(ready), int(lengths[0])), dtype=np.int64)
        for i, nid in enumerate(ready):
            nd = nodes[nid]
            sym[i, :nd["L"]] = ys_np[nd["seq"], nd["lo"]:nd["lo"] + nd["L"]]
        row, init, last = torch.as_tensor(
            np.asarray([[nodes[nid][k] for nid in ready] for k in ("row", "init", "last")]),
            device=dev)
        masks = level_masks.index_select(0, row)
        if dag:
            m0 = _mark(dev)
            anc, desc = _dag_counts(A_posF, masks, np.minimum(lengths - 1, K))
            count_marks.append((m0, _mark(dev)))
        else:
            anc, desc = anc_g.expand(len(ready), K), desc_g.expand(len(ready), K)
        out = _level_forward(
            logA, emitT, anc, desc, torch.as_tensor(sym, device=dev), lengths, masks, init,
            torch.as_tensor(logu[[nodes[nid]["msum"] for nid in ready]], device=dev), last)
        with span("fvt.sync"):
            xa, xb, nl, _ = out.cpu().numpy()  # the level's one read back
        # the children, left ones first: (side, parent, lane, search source,
        # hops, lo, L, forced end, forced entry)
        kids = {"left": [], "right": []}
        for i, nid in enumerate(ready):
            nd = nodes[nid]
            x_a, x_b, n_left = int(xa[i]), int(xb[i]), int(nl[i])
            if x_a == -1:  # median never set: the oracle's early return
                continue
            nd["pair"] = (x_a, x_b)
            n_right = nd["L"] - n_left
            if n_left > 1:  # x_a's ancestors; its end is x_a, its entry the parent's
                kids["left"].append(("left", nid, i, x_a, n_left - 1, nd["lo"], n_left, x_a,
                                     nd["init"]))
            if n_right > 1:  # x_b's descendants; its entry is x_b, its end re-picked
                kids["right"].append(("right", nid, i, x_b, n_right - 1, nd["lo"] + n_left,
                                      n_right, -1, x_b))
        ordered = kids["left"] + kids["right"]
        if not ordered:
            break
        m0 = _mark(dev)
        found = []
        for side, adjF in (("left", A_posF.t()), ("right", A_posF)):
            if kids[side]:
                lane, src, hops = (np.asarray([k[f] for k in kids[side]]) for f in (2, 3, 4))
                found.append(_reach(adjF, masks.index_select(0, torch.as_tensor(lane, device=dev)),
                                    src, hops))
        level_masks = torch.cat(found) if len(found) > 1 else found[0]
        with span("fvt.sync"):
            msums = level_masks.sum(dim=1).cpu().numpy()
        bfs_marks.append((m0, _mark(dev)))
        level = []
        for r, (side, parent, _, _, _, lo, L, end, entry) in enumerate(ordered):
            nid = new_node(nodes[parent]["seq"], lo, L, end, entry, int(msums[r]), r)
            nodes[parent][side] = nid
            level.append(nid)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.update(nodes=len(nodes), levels=levels, forward_lanes=lanes, node_steps=node_steps,
                     bhop_hops=bhop, count_ms=sum(_ms(a, b) for a, b in count_marks),
                     bfs_ms=sum(_ms(a, b) for a, b in bfs_marks))

    def flatten(root: int) -> list[tuple[int, int]]:
        """In-order pairs (left subtree, own pair, right subtree), the
        reference's append order; a node without a pair emits nothing."""
        path: list[tuple[int, int]] = []
        stack: list[tuple[int, bool]] = [(root, False)]
        while stack:
            nid, emit = stack.pop()
            nd = nodes[nid]
            if nd["pair"] is None:
                continue
            if emit:
                path.append(nd["pair"])
                continue
            if nd["right"] is not None:
                stack.append((nd["right"], False))
            stack.append((nid, True))
            if nd["left"] is not None:
                stack.append((nd["left"], False))
        return path

    return [flatten(r) for r in range(S)]


def _memory(K: int, T: int, **_) -> int:
    # the JAX package's device engine: node masks (T, K) bool + forward
    # carries (5 K-vectors) + the two count vectors + the int32 node table
    # (~11 T-vectors)
    return T * K + 7 * K * 4 + 11 * T * 4


def _decoder(name: str, static: dict, **kw) -> Decoder:
    def fn(logA, logB, logPi, y):
        pairs = sieve_dynamic_decode(logA, logB, logPi, y, **kw)
        return torch.as_tensor(_flatten_pairs(pairs, int(y.shape[0])), device=logA.device)

    def batch_fn(logA, logB, logPi, ys):
        T = int(ys.shape[1])
        many = sieve_dynamic_decode_many(logA, logB, logPi, ys, **kw)
        return torch.as_tensor(np.stack([_flatten_pairs(p, T) for p in many]),
                               device=logA.device)

    return Decoder(name, fn, static, _memory, batch_fn=batch_fn)


@register("sieve")
def _build(b_hops: int | None = None, **static) -> Decoder:
    return _decoder("sieve", {"b_hops": b_hops, **static}, b_hops=b_hops)


@register("sieve_dag")
def _build_dag(**static) -> Decoder:
    return _decoder("sieve_dag", static, dag=True)
