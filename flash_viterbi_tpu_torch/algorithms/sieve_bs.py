"""SIEVE-BS (dynamic median): a level scheduler whose node state stays on
the device.

Counterpart of ``flash_viterbi_tpu/algorithms/sieve_bs.py``, bit for bit.
The reference (``Base_line/C implementations/SIEVE-BS.c:360-549`` /
``sieve_beam_search.py:65-261``) recurses over a *data-dependent* split
point: during each beam-pruned forward pass it tracks, per end state, the
transition minimizing ``max(#b-hop-ancestors(x_a), #b-hop-descendants(x_b))``
with a ``|j - T/2|`` closeness tie-break, then splits the segment there.

The JAX package runs the whole tree as one device program (a node stack in
``lax.while_loop``), or, under ``engine="host"``, as a level scheduler; the
two give the same pairs.  PyTorch has no device loop, so the port runs the
level scheduler:

* all ready nodes of a tree level (of every sequence of a batch) are lanes
  of one forward pass, longest first, so the lanes still running at step j
  are a prefix and each step works on that prefix alone;
* every step is tensor operations on the device (the JAX package's are XLA
  operations, no Pallas kernel): the dense first step over all token
  states, then :func:`_vec_step` over the B beam slots, lanes in chunks
  whose temporaries stay under a byte budget;
* the node state (scores, median carries, beams, token sets) stays on the
  device; a level reads back four integers a node (``x_a``, ``x_b``,
  ``n_left``, ``last``), from which the host makes the children: their
  state masks by a breadth-first search on the host (:func:`_host_reach`,
  uploaded once a level) and their token sets (the parent's, or the
  median step's beam, on the device);
* the b-hop counts are K breadth-first searches at once, a (K, K) matmul a
  hop, stopping at the first hop that reaches nothing new (every later hop
  would add nothing, so the counts are the full hop count's).

The reference's sequential candidate semantics (beam-ordered source
iteration with strictly-greater improvement, the stale-median no-write
quirk, median inheritance from the source's path) collapse to dense
operations by the record-point argument (:func:`_vec_step`); the j=1
all-sources step reduces to a first-occurrence argmax (a fresh carry: every
record writes).  The beam attached to a median is the beam recorded after
step ``med_n[h]``, so a per-step beam log replaces the reference's
per-state set copies.

Documented deltas (identical off exact fp ties): score ties resolve by
lowest state index; scores are fp32.  Reference quirks kept: the model Pi
at every node (``SIEVE-BS.c:367``, the C binary, not ``Baseline.py``'s
uniform Pi); emission misses contribute 0 (:119-123); left children force
``last=x_a``, right children inherit the parent's resolved ``last``
(:207/:259); left recursions thread the parent's token set, right
recursions get the median-step beam (:218-219); the stale-median no-write.
A node whose state set has one state or none is skipped; a one-frame node
emits the ``(-1, -1)`` sentinel.  Totality extension: where beam pruning
eliminates every median candidate (the reference crashes there) the node
emits ``(-1, -1)`` and its impossible recursion is skipped.  Padded states
are dead through the ``real`` liveness mask.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.beam import beam_topk
from ..ops.maxplus import first_argmax
from ..utils.profiling import span
from .base import Decoder, register
from .sieve import BEAM_STEP_BYTES, NEG, TOUCHED_NEG, UNTOUCHED_NEG

# bytes each (S, K, K) fp32 temporary of the dense first step may take: a
# level's lanes go through it in chunks under it (at Kp = 3968 one lane's
# candidates are 63 MB, so 4 lanes a chunk)
DENSE_STEP_BYTES = 256 * 2**20


def _beam_vals(T1: torch.Tensor, touched: torch.Tensor) -> torch.Tensor:
    """Order states as ``heapq.nlargest`` over the touched dict: finite
    scores first, then touched -inf entries, then absent states."""
    return torch.where(touched, torch.where(torch.isneginf(T1), TOUCHED_NEG, T1), UNTOUCHED_NEG)


def _bhop_counts(A_posF: torch.Tensor, hops: int):
    """(#ancestors, #descendants) (K,) fp32 within 1..``hops`` edges of each
    state, the source excluded unless re-reached (a cycle): the reference's
    per-state BFS preprocessing (SIEVE-BS.c:656-672) as K breadth-first
    searches at once, a (K, K) matmul a hop.  Each search is gated by its
    visited set, so once no frontier reaches a new state no later hop adds
    one: the loop stops there (one host read a hop), with the counts of
    all ``hops``.  Returns (anc, desc, the hops run for each)."""
    K = A_posF.shape[0]
    eye = torch.eye(K, dtype=torch.float32, device=A_posF.device)

    def reach(adjF):
        visited = torch.zeros((K, K), dtype=torch.bool, device=A_posF.device)
        frontier = eye
        for h in range(hops):
            new = ((frontier @ adjF) > 0) & ~visited
            with span("fvt.sync"):
                grew = bool(new.any())
            if not grew:
                return visited.sum(dim=1).to(torch.float32), h
            visited |= new
            frontier = new.to(torch.float32)
        return visited.sum(dim=1).to(torch.float32), hops

    desc, desc_hops = reach(A_posF)
    anc, anc_hops = reach(A_posF.t())
    return anc, desc, (anc_hops, desc_hops)


def _vec_step(T1src, srcs, src_valid, logA_rows, emit_row, mask, anc_src, desc_cnt,
              mx_src, my_src, mn_src, mval_src, j: int, Thalf, iota):
    """One beam trellis step over S lanes, vectorized over B sources x K
    destinations (``logA_rows`` (S, B, K); the other per-source inputs
    (S, B); ``emit_row``, ``mask`` (S, K); ``Thalf`` (S,)).

    Collapses the reference's *sequential* source iteration
    (``sieve_beam_search.py:151-219``) into dense operations: per
    destination, the slots that "win" (strictly improve the running score)
    are exactly the strict record points of the candidate sequence in
    source order, and each winning slot either OVERWRITES the median carry
    (writing its own median when the (pair, closeness) criterion prefers
    it, else inheriting the source's median if it has one) or (the
    reference's stale-median quirk) leaves the carry untouched.  Hence the
    final score is the max over eligible candidates and the final median
    state comes from the LAST record point whose write predicate holds;
    destinations with no writing record point end at the per-step reset
    state (-1, -1, 0, +inf).  Every median input is the PREVIOUS step's
    value gathered at the sources, which makes the collapse exact."""
    S, B, K = logA_rows.shape
    cand = T1src[:, :, None] + logA_rows + emit_row[:, None, :]
    edge = (logA_rows > NEG) & (mask > 0)[:, None, :] & src_valid[:, :, None]
    candE = torch.where(edge, cand, NEG)
    run = torch.cummax(candE, dim=1).values
    prev = torch.cat([torch.full((S, 1, K), NEG, device=candE.device), run[:, :-1]], dim=1)
    rec = candE > prev  # strict record points == the winning slots
    pair = torch.maximum(anc_src[:, :, None], desc_cnt[None, None, :])
    pv = mval_src[:, :, None]
    jf = torch.tensor(float(j), dtype=torch.float32, device=candE.device)
    closer = (torch.abs(jf - Thalf[:, None]) < torch.abs(mn_src.to(torch.float32)
                                                          - Thalf[:, None]))[:, :, None]
    take_new = (pair < pv) | ((pair == pv) & closer)
    writes = rec & (take_new | (mx_src != -1)[:, :, None])
    cidx = torch.arange(B, dtype=torch.int32, device=candE.device)[None, :, None]
    ws = torch.where(writes, cidx, -1).amax(dim=1)  # the last writing slot
    has = ws >= 0
    w = torch.clamp(ws, min=0).long()
    tn = take_new.gather(1, w[:, None, :])[:, 0]
    node_w = srcs.gather(1, w)
    nT1 = candE.amax(dim=1)
    nmx = torch.where(has, torch.where(tn, node_w, mx_src.gather(1, w)), -1)
    nmy = torch.where(has, torch.where(tn, iota[None, :], my_src.gather(1, w)), -1)
    nmn = torch.where(has, torch.where(tn, j, mn_src.gather(1, w)), 0)
    nmval = torch.where(has, torch.where(tn, torch.maximum(anc_src.gather(1, w), desc_cnt[None, :]),
                                         mval_src.gather(1, w)), float("inf"))
    return nT1, nmx.to(torch.int32), nmy.to(torch.int32), nmn.to(torch.int32), nmval


def _token_mask(bidx: torch.Tensor, eff: torch.Tensor, K: int) -> torch.Tensor:
    """(S, K) bool: the first ``eff`` of each lane's beam slots ``bidx``."""
    ok = torch.arange(bidx.shape[1], device=bidx.device)[None, :] < eff[:, None]
    tok = torch.zeros((bidx.shape[0], K), dtype=torch.bool, device=bidx.device)
    return tok.scatter_(1, bidx.long(), ok)  # a lane's slots are distinct states


def _select(T1, touched, B: int):
    """(beam slots (S, B) int32, eff (S,), token mask (S, K) bool): the top
    ``min(B, #touched)`` of the touched states, as ``jax.lax.top_k`` ranks
    them (lowest index first on ties)."""
    _, bidx = beam_topk(_beam_vals(T1, touched), B)
    eff = torch.clamp(touched.sum(dim=1), max=B)
    return bidx, eff, _token_mask(bidx, eff, T1.shape[1])


def _dense_first_step(logA, A_posF, emitQT, anc_cnt, desc_cnt, logPi, y0, y1, masks, tokens0):
    """Step j=1 over S lanes, every token state a source: (T1, touched, mx,
    my, mn, mval), each (S, K).  The median carry is fresh (mval = +inf),
    so every record point writes and the last writing record is the
    first-occurrence argmax.  Lanes go in chunks whose (s, K, K)
    candidates stay under ``DENSE_STEP_BYTES``."""
    S, K = masks.shape
    iota = torch.arange(K, dtype=torch.int32, device=logA.device)
    T1_0 = torch.where(masks, logPi[None, :] + emitQT[y0], NEG)  # model Pi at every node
    src = torch.where(tokens0 > 0, T1_0, NEG)
    emit1 = emitQT[y1]
    lanes = max(1, DENSE_STEP_BYTES // (K * K * 4))
    t1s, wins = [], []
    for c0 in range(0, S, lanes):
        # src + logA is -inf off the edges already (logA is -inf there)
        cand = src[c0:c0 + lanes, :, None] + logA[None] + emit1[c0:c0 + lanes, None, :]
        t1, win = first_argmax(cand, 1)
        t1s.append(t1)
        wins.append(win)
        del cand
    t1 = torch.where(masks, torch.cat(t1s), NEG)
    winner = torch.cat(wins)
    touched = ((tokens0 @ A_posF) > 0) & masks
    won = touched & (t1 > NEG)
    mx = torch.where(won, winner, -1).to(torch.int32)
    my = torch.where(won, iota[None, :], -1).to(torch.int32)
    mn = won.to(torch.int32)
    mval = torch.where(won, torch.maximum(anc_cnt[winner.long()], desc_cnt[None, :]),
                       float("inf"))
    return torch.where(touched, t1, NEG), touched, mx, my, mn, mval


def _level_forward(logA, A_posF, emitQT, anc_cnt, desc_cnt, logPi, ys, lengths, masks, tokens0,
                   last_forced, B: int):
    """The beam forward passes of S nodes of one level, with dynamic-median
    tracking (``viterbi_space_efficient``'s main loop, :151-219).

    ``ys`` (S, Lmax) int64 symbols, ``lengths`` (S,) descending, each >= 2;
    ``masks`` (S, K) bool; ``tokens0`` (S, K) fp32 0/1; ``last_forced``
    (S,) int32 (-1: the argmax).  Returns (x_a, x_b, n_left, last) (S,)
    int32 and the right children's token sets (S, K) fp32."""
    S, K = masks.shape
    dev = logA.device
    iota = torch.arange(K, dtype=torch.int32, device=dev)
    slots = torch.arange(B, device=dev)
    Lmax = int(lengths[0])
    Thalf = torch.as_tensor(lengths, dtype=torch.float32, device=dev) / 2.0

    T1, touched, mx, my, mn, mval = _dense_first_step(
        logA, A_posF, emitQT, anc_cnt, desc_cnt, logPi, ys[:, 0], ys[:, 1], masks, tokens0)
    bidx, eff, tokm = _select(T1, touched, B)
    beams = torch.zeros((Lmax, S, K), dtype=torch.bool, device=dev)
    beams[1] = tokm

    # steps j = 2 .. L-1, in beam order (top_k order == the reference's
    # candidate order); the lanes still running are a prefix (longest first)
    lanes = max(1, BEAM_STEP_BYTES // (B * K * 4))
    for j in range(2, Lmax):
        n = int(np.searchsorted(-lengths, -j, side="left"))  # lanes with L > j
        src_valid = slots[None, :] < eff[:n, None]
        bl = bidx[:n].long()
        parts = []
        for c0 in range(0, n, lanes):
            c1 = min(n, c0 + lanes)
            b = bl[c0:c1]
            rows = logA[b]  # (s, B, K)
            parts.append(_vec_step(
                T1[c0:c1].gather(1, b), bidx[c0:c1], src_valid[c0:c1], rows,
                emitQT[ys[c0:c1, j]], masks[c0:c1], anc_cnt[b], desc_cnt,
                mx[c0:c1].gather(1, b), my[c0:c1].gather(1, b), mn[c0:c1].gather(1, b),
                mval[c0:c1].gather(1, b), j, Thalf[c0:c1], iota)
                + (((rows > NEG) & src_valid[c0:c1, :, None]).any(dim=1) & masks[c0:c1],))
        nT1, nmx, nmy, nmn, nmval, ntouched = (
            parts[0] if len(parts) == 1 else [torch.cat(x) for x in zip(*parts)])
        # touched == reachable from the beam: the gathered rows' edges
        nT1 = torch.where(ntouched, nT1, NEG)
        nbidx, neff, ntokm = _select(nT1, ntouched, B)
        beams[j, :n] = ntokm
        T1[:n], mx[:n], my[:n], mn[:n], mval[:n] = nT1, nmx, nmy, nmn, nmval
        bidx[:n], eff[:n], touched[:n] = nbidx, neff, ntouched

    argm = first_argmax(_beam_vals(T1, touched), 1)[1]
    last = torch.where(last_forced >= 0, last_forced, argm).long()
    x_a = mx.gather(1, last[:, None])[:, 0]
    x_b = my.gather(1, last[:, None])[:, 0]
    n_left = mn.gather(1, last[:, None])[:, 0]
    lane = torch.arange(S, device=dev)
    tokens_right = torch.where((x_a != -1)[:, None], beams[n_left.long(), lane], False)
    return torch.stack([x_a, x_b, n_left, last.to(torch.int32)]), tokens_right.to(torch.float32)


def _host_bfs(adj: np.ndarray, src: int, hops: int) -> np.ndarray:
    """Visited-gated level BFS (traversal direction rows -> cols), <= ``hops``
    edge hops; the source excluded unless re-reached."""
    K = adj.shape[0]
    visited = np.zeros(K, bool)
    frontier = np.zeros(K, bool)
    frontier[src] = True
    for _ in range(max(hops, 0)):
        nxt = adj[frontier].any(axis=0) & ~visited
        if not nxt.any():
            break
        visited |= nxt
        frontier = nxt
    return visited


def _host_reach(A_pos: np.ndarray, src: int, b: int, out: bool) -> np.ndarray:
    """<= b-1 edge hops along out- (in-) edges, the reference's depth-from-1
    counting."""
    return _host_bfs(A_pos if out else A_pos.T, src, b - 1)


def sieve_bs_decode(logA, logB_raw, logPi, y, beam_width: int, b_hops: int | None = None,
                    stats: dict | None = None) -> list[tuple[int, int]]:
    """Full SIEVE-BS decode of the (T,) observations ``y``; returns the
    in-order median-pair list (equal to ``oracle.sieve_bs.sieve_bs`` off
    exact fp ties, for a uniform Pi, and to ``oracle.framework.sieve_bs``)."""
    return sieve_bs_decode_many(logA, logB_raw, logPi, np.asarray(torch.as_tensor(y).cpu())[None],
                                beam_width, b_hops=b_hops, stats=stats)[0]


def sieve_bs_decode_many(logA, logB_raw, logPi, ys, beam_width: int, b_hops: int | None = None,
                         stats: dict | None = None) -> list[list[tuple[int, int]]]:
    """SIEVE-BS over a (Bs, T) batch of sequences on the tables' device: every
    sequence's tree feeds one level queue, so one forward pass a level
    serves the ready nodes of the whole batch.  ``stats``, if given, gets
    the nodes, levels, forward lanes, the b-hop searches' hops and the
    seconds of the host's breadth-first searches."""
    ys_np = np.asarray(torch.as_tensor(ys).cpu(), dtype=np.int64)
    S, T = ys_np.shape
    K = int(logA.shape[0])
    B = min(int(beam_width), K)
    dev = logA.device

    A_posF = (logA > NEG).to(torch.float32)
    emitQT = torch.where(logB_raw > NEG, logB_raw, 0.0).t().contiguous()  # (M, K)
    # logical (non-padding) states: padded states are all -inf everywhere;
    # the model-Pi prior is -inf there too, so padding cannot flip a tie
    real = (torch.isfinite(logA).any(dim=1) | torch.isfinite(logB_raw).any(dim=1)
            | torch.isfinite(logPi))
    with span("fvt.sync"):
        A_pos_np = (logA > NEG).cpu().numpy()
        real = real.cpu().numpy()
    b = T if b_hops is None else int(b_hops)
    # a visited-gated BFS saturates after at most K productive hops, so
    # capping at K changes nothing
    anc_cnt, desc_cnt, hops_run = _bhop_counts(A_posF, min(max(b - 1, 0), K))

    nodes: list[dict] = []

    def new_node(mask, y_seg, last, tokens):
        nodes.append({"mask": mask, "y": y_seg, "last": last, "tokens": tokens, "kind": None,
                      "pair": None, "left": None, "right": None})
        return len(nodes) - 1

    roots = [new_node(real.astype(bool), ys_np[s], None, None) for s in range(S)]
    level, levels, lanes, bfs_s = list(roots), 0, 0, 0.0
    while level:
        levels += 1
        ready = []
        for nid in level:
            nd = nodes[nid]
            if nd["mask"].sum() <= 1:
                nd["kind"] = "skip"
            elif len(nd["y"]) == 1:
                # one frame: the forward loop never runs, no median is
                # recorded: the sentinel pair, no recursion
                nd["kind"] = "sentinel"
            else:
                nd["kind"] = "forward"
                ready.append(nid)
        if not ready:
            break
        ready.sort(key=lambda nid: -len(nodes[nid]["y"]))  # stable: longest first
        lanes += len(ready)
        lengths = np.asarray([len(nodes[nid]["y"]) for nid in ready], dtype=np.int64)
        sym = np.zeros((len(ready), int(lengths[0])), dtype=np.int64)
        for i, nid in enumerate(ready):
            sym[i, :lengths[i]] = nodes[nid]["y"]
        masks_np = np.stack([nodes[nid]["mask"] for nid in ready])
        masks = torch.as_tensor(masks_np, device=dev)
        tokens0 = torch.stack([masks[i].to(torch.float32) if nodes[nid]["tokens"] is None
                               else nodes[nid]["tokens"] for i, nid in enumerate(ready)])
        last_f = torch.as_tensor([-1 if nodes[nid]["last"] is None else nodes[nid]["last"]
                                  for nid in ready], dtype=torch.int32, device=dev)
        out, tokens_right = _level_forward(
            logA, A_posF, emitQT, anc_cnt, desc_cnt, logPi, torch.as_tensor(sym, device=dev),
            lengths, masks, tokens0, last_f, B)
        with span("fvt.sync"):
            xa, xb, nl, lr = out.cpu().numpy()  # the level's one read back
        nxt: list[int] = []
        t0 = time.perf_counter()
        for i, nid in enumerate(ready):
            nd = nodes[nid]
            L = len(nd["y"])
            x_a, x_b, n_left = int(xa[i]), int(xb[i]), int(nl[i])
            nd["pair"] = (x_a, x_b)
            if n_left > 1 and x_a >= 0:
                lm = _host_reach(A_pos_np, x_a, n_left, out=False)
                lm[x_a] = True
                nd["left"] = new_node(lm, nd["y"][:n_left], x_a, nd["tokens"])
                nxt.append(nd["left"])
            n_right = L - n_left
            if n_right > 1 and x_b >= 0:
                rm = _host_reach(A_pos_np, x_b, n_right, out=True)
                rm[x_b] = True
                nd["right"] = new_node(rm, nd["y"][-n_right:], int(lr[i]), tokens_right[i])
                nxt.append(nd["right"])
        bfs_s += time.perf_counter() - t0
        level = nxt
    if stats is not None:
        stats.update(nodes=len(nodes), levels=levels, forward_lanes=lanes,
                     bhop_hops=hops_run, bhop_limit=min(max(b - 1, 0), K), host_bfs_s=bfs_s)

    def flatten(root: int) -> list[tuple[int, int]]:
        """In-order pairs (left subtree, own pair, right subtree), the
        reference's append order; sentinel nodes emit (-1, -1), skipped
        nodes nothing."""
        path: list[tuple[int, int]] = []
        stack: list[tuple[int, bool]] = [(root, False)]
        while stack:
            nid, emit = stack.pop()
            nd = nodes[nid]
            if nd["kind"] == "skip":
                continue
            if nd["kind"] == "sentinel":
                path.append((-1, -1))
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

    return [flatten(r) for r in roots]


def _flatten_pairs(pairs: list[tuple[int, int]], T: int) -> np.ndarray:
    """``pretty_print_path``'s layout (Viterbi.py:827-847): p0.x, p0.y, then
    the .y of each later pair; -1 padding to T (a copy of
    ``flash_viterbi_tpu/algorithms/sieve_dyn.py:_flatten``)."""
    out = np.full((T,), -1, np.int32)
    if pairs:
        flat = [pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]]
        out[:min(len(flat), T)] = np.asarray(flat[:T], np.int32)
    return out


def _memory(K: int, T: int, beam_width: int = 64, **_) -> int:
    # the JAX package's device engine: node masks (T, K) bool + token sets
    # (T, K) f32 + the (T, K) beam-log scratch + forward carries (5
    # K-vectors) + b-hop counts + the int32 node table (~12 T-vectors)
    return T * K * (1 + 4 + 4) + 7 * K * 4 + 12 * T * 4


@register("sieve_bs")
def _build(beam_width: int = 64, b_hops: int | None = None, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        pairs = sieve_bs_decode(logA, logB, logPi, y, beam_width=beam_width, b_hops=b_hops)
        return torch.as_tensor(_flatten_pairs(pairs, int(y.shape[0])), device=logA.device)

    def batch_fn(logA, logB, logPi, ys):
        T = int(ys.shape[1])
        many = sieve_bs_decode_many(logA, logB, logPi, ys, beam_width=beam_width, b_hops=b_hops)
        return torch.as_tensor(np.stack([_flatten_pairs(p, T) for p in many]), device=logA.device)

    return Decoder("sieve_bs", fn, {"beam_width": beam_width, "b_hops": b_hops, **static},
                   _memory, batch_fn=batch_fn)
