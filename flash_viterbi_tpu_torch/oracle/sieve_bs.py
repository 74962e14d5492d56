"""Oracle ports of the SIEVE beam-search family.

Behavioral ports (from scratch, against observed semantics) of the reference
``Base_line/Python implementations/sieve_beam_search.py`` — the golden
semantics for the glib C programs SIEVE-BS / SIEVE-BS-Mp (which cannot be
compiled here: glib is absent; the reference itself verified C==Python,
``README.md:71``):

* :func:`sieve_bs`     — ``viterbi_space_efficient``  (:65-261): D&C with
  *dynamic* median selection and static top-B beam pruning.
* :func:`sieve_bs_mp`  — ``viterbi_middlepath``       (:351-501): fixed
  median at floor(T/2).
* :func:`beam_search`  — ``beam_search``              (:267-347): plain beam
  Viterbi with full tables (no C port exists).
* :func:`build_adjacency` — the ``Baseline.py:134-170`` preprocessing
  (edge lists + acoustic-cost dicts, pickled by the reference).

Tie-breaking is order-sensitive in the original (dict insertion order +
``heapq.nlargest`` stability); these ports keep the same containers and
traversal orders so outputs are identical, which the tests verify by
running the reference class in-process on shared fixtures.

Reference quirks kept on purpose:

* relaxation scans only out-edges of beam states, so states with no
  in-edge from the beam silently drop out (dict default -inf);
* a segment's first-step scores use the *root* Pi for every subproblem
  (``Pi=Pi`` threading, :233/:259 — never re-normalized, never forced);
  path forcing happens through ``activeTokensStates`` (SIEVE-BS) or the
  median-step beam (SIEVE-BS-Mp) instead;
* the left recursion anchors ``last=x_a`` but the right one passes the
  *parent's* ``last`` through unchanged (:259/:496);
* ``beam_search`` skips self-loops (``h != node_i``, :309) while the SIEVE
  variants keep them;
* emission misses contribute 0, not -inf (dict ``.keys()`` test, :119-123).

Copied from ``flash_viterbi_tpu/oracle/sieve_bs.py``, kept here because
the port never imports the JAX package; the decoders it names are the
port's (``flash_viterbi_tpu_torch/algorithms/sieve_bs.py``).
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from math import floor

import numpy as np

__all__ = ["build_adjacency", "sieve_bs", "sieve_bs_mp", "beam_search",
           "ReferenceUndefined"]


class ReferenceUndefined(ValueError):
    """The reference implementation crashes on this input.

    When beam pruning eliminates every median candidate of a subproblem,
    SIEVE-BS/SIEVE-BS-Mp recurse with the sentinel state -1 in the index
    set and the reference Python dies with ``KeyError: (0, -1)`` at the
    child's first-frame init (``sieve_beam_search.py:88``); the C
    binaries index out of bounds at the same point.  There are no
    reference semantics to mirror, so the oracle refuses loudly instead
    of inventing output (or, for SIEVE-BS, recursing forever).  The TPU
    decoders (``algorithms.sieve_bs``) are total: they emit the
    SIEVE-Mp-style ``(-1, -1)`` sentinel pair and decode the rest — a
    documented extension beyond the reference's domain.
    """


class _LazyAcoustic:
    """Dict-compatible view of one symbol's acoustic costs:
    ``.get((j, i), default)`` == ``log B[i, m]`` when ``B[i, m] > 0`` —
    the semantics of the reference's M*K^2 cross-product dict
    (``Baseline.py:140-160``) without materializing it (786M entries at
    the headline K=3965/M=50; this is what makes the ``compare`` harness
    runnable at headline configs)."""

    __slots__ = ("logb", "pos")

    def __init__(self, logb_col, pos_col):
        self.logb = logb_col
        self.pos = pos_col

    def get(self, key, default=0.0):
        i = key[1]
        return float(self.logb[i]) if self.pos[i] else default

    def __contains__(self, key):
        return bool(self.pos[key[1]])

    def __getitem__(self, key):
        if not self.pos[key[1]]:
            raise KeyError(key)
        return float(self.logb[key[1]])

    def keys(self):
        return self  # membership tests only (the reference's usage)


def build_adjacency(A, B, Pi=None, lazy: bool = True):
    """Edge lists + acoustic dicts, exactly as ``Baseline.py:140-160``.

    Returns (pi_log, A_out, A_in, acoustic) where ``A_out[i]`` is a list of
    ``(j, log A[i,j])`` in ascending j, and ``acoustic[m][(j, i)]`` is
    ``log B[i, m]``.  ``lazy=True`` (the default for oracle decoding)
    returns :class:`_LazyAcoustic` views instead of the reference's
    materialized cross-product; ``lazy=False`` reproduces the real dicts
    (needed when feeding the *reference class itself* in tests).
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    K, M = B.shape
    A_in = [[] for _ in range(K)]
    A_out = [[] for _ in range(K)]
    with np.errstate(divide="ignore"):
        logA = np.log(A)
    for i in range(K):
        (js,) = np.nonzero(A[i])
        for j in js:
            w = logA[i, j]
            A_in[j].append((i, w))
            A_out[i].append((j, w))
    if lazy:
        with np.errstate(divide="ignore"):
            logB = np.log(B)
        pos = B > 0
        acoustic = [_LazyAcoustic(logB[:, m], pos[:, m]) for m in range(M)]
    else:
        acoustic = [{} for _ in range(M)]
        for i in range(K):
            for m in range(M):
                if B[i][m] != 0:
                    w = np.log(B[i][m])
                    for j in range(K):
                        acoustic[m][(j, i)] = w
    pi = np.full(K, np.log(1.0 / K)) if Pi is None else np.log(np.asarray(Pi, dtype=np.float64))
    return pi, A_out, A_in, acoustic


class _Ctx:
    """Shared run state: adjacency, beam width, b-hop counts, pair output."""

    def __init__(self, pi, A_out, A_in, acoustic, beam_width: int):
        self.pi = pi
        self.A_out = A_out
        self.A_in = A_in
        self.acoustic = acoustic
        self.B = beam_width
        self.path: list = []
        self.b_hop_ancestors: dict = {}
        self.b_hop_descendants: dict = {}

    # -- hop-bounded reachability (sieve_beam_search.py:504-588) -----------
    def _reach(self, source: int, b: int, out: bool) -> set:
        adj = self.A_out if out else self.A_in
        visited: set = set()
        depth = {source: 1}
        found: set = set()
        queue = [source]
        while queue:
            s = queue.pop(0)
            if depth[s] < b:
                for node_id, _w in adj[s]:
                    if node_id not in visited:
                        found.add(node_id)
                        depth[node_id] = depth[s] + 1
                        queue.append(node_id)
                        visited.add(node_id)
        return found

    def preprocess(self, b: int, K: int):
        """b-hop neighborhood sizes for every state (:591-651)."""
        for s in range(K):
            self.b_hop_descendants[s] = len(self._reach(s, b, out=True))
            self.b_hop_ancestors[s] = len(self._reach(s, b, out=False))


def _emit(ctx: _Ctx, frame: int, i: int, h: int) -> float:
    """Acoustic cost with the reference's miss-as-zero fallthrough."""
    return ctx.acoustic[frame].get((i, h), 0.0)


def _top_beam(ctx: _Ctx, new_t1: dict) -> list:
    """heapq.nlargest over the dict keys — stable: earlier-inserted keys win
    ties (:172-173)."""
    eff = min(ctx.B, len(new_t1))
    return heapq.nlargest(eff, new_t1, key=new_t1.get)


# ---------------------------------------------------------------------------
# SIEVE-BS (dynamic median)  [sieve_beam_search.py:65-261]
# ---------------------------------------------------------------------------

def _sieve_bs_rec(ctx: _Ctx, indices, frames, last, active_tokens):
    T = len(frames)
    overall = set(indices)
    K = len(indices)
    if K <= 1:
        return

    T1 = {i: ctx.pi[i] + _emit(ctx, frames[0], 0, i) for i in indices}
    prev_n: dict = {}
    prev_med: dict = {}
    prev_val: dict = {}
    prev_active: dict = {}
    current = list(active_tokens) if active_tokens is not None else list(indices)

    new_med: dict = {}
    new_n: dict = {}
    active_states: dict = {}
    for j in range(1, T):
        new_med, new_n, new_val = {}, {}, {}
        updated: set = set()
        active_states = {}
        new_t1: dict = {}
        for node_i in current:
            for h, prob in ctx.A_out[node_i]:
                if h in overall:
                    cand = T1.get(node_i, float("-inf")) + prob + _emit(ctx, frames[j], node_i, h)
                    # defaultdict-touch semantics: the comparison itself
                    # inserts h (with -inf) in the reference, which affects
                    # len(new_t1) and nlargest tie order — replicate.
                    if cand > new_t1.setdefault(h, float("-inf")):
                        new_t1[h] = cand
                        pv = prev_val.get(node_i, float("inf"))
                        pair = max(ctx.b_hop_ancestors.get(node_i, 0),
                                   ctx.b_hop_descendants.get(h, 0))
                        if pair < pv:
                            new_val[h] = pair
                            new_med[h] = (node_i, h)
                            new_n[h] = j
                            updated.add(h)
                        elif pair == pv:
                            if abs(j - T / 2) < abs(prev_n.get(node_i, 0.0) - T / 2):
                                new_val[h] = pair
                                new_med[h] = (node_i, h)
                                new_n[h] = j
                                updated.add(h)
                            elif prev_med.get(node_i, (-1, -1)) != (-1, -1):
                                new_med[h] = prev_med[node_i]
                                new_n[h] = prev_n[node_i]
                                new_val[h] = prev_val[node_i]
                                updated.discard(h)
                                active_states[h] = prev_active.get(node_i, set())
                        elif prev_med.get(node_i, (-1, -1)) != (-1, -1):
                            new_med[h] = prev_med[node_i]
                            new_n[h] = prev_n[node_i]
                            new_val[h] = prev_val[node_i]
                            updated.discard(h)
                            active_states[h] = prev_active.get(node_i, set())
        current = _top_beam(ctx, new_t1)
        for h in updated:
            active_states[h] = current
        prev_n, prev_med, prev_val = new_n, new_med, new_val
        prev_active = active_states
        T1 = new_t1

    if last is None:
        last = heapq.nlargest(1, T1, key=T1.get)[0]
    x_a, x_b = new_med.get(last, (-1, -1))
    N_left = int(new_n.get(last, 0))

    if N_left > 1:
        if x_a == -1:
            raise ReferenceUndefined(
                "SIEVE-BS: beam pruned every median candidate "
                f"(T={T}, left span {N_left}); reference crashes here")
        anc = ctx._reach(x_a, N_left, out=False)
        anc.discard(-1)
        left_idx = sorted(anc | {x_a})
        _sieve_bs_rec(ctx, left_idx, frames[:N_left], x_a, active_tokens)

    ctx.path.append(new_med.get(last, (-1, -1)))

    N_right = T - N_left
    if N_right > 1:
        if x_b == -1:
            # with no recorded pair N_left is 0, so this recursion would
            # also never shrink the frame span
            raise ReferenceUndefined(
                "SIEVE-BS: beam pruned every median candidate "
                f"(T={T}, right span {N_right}); reference crashes here")
        dec = ctx._reach(x_b, N_right, out=True)
        dec.discard(-1)
        right_idx = sorted(dec | {x_b})
        # defaultdict-miss on active_states[last] yields an *empty set*
        # (not "all indices") in the reference — keep that.
        _sieve_bs_rec(ctx, right_idx, frames[-N_right:], last,
                      active_states.get(last, set()))


def sieve_bs(A, B, Pi, y, beam_width: int, b_hops: int | None = None) -> list:
    """Full SIEVE-BS run; returns the in-order median-pair list (the
    reference's ``self.path``, flattened by ``pretty_print_path``).

    Follows the Python chain's prior (Baseline.py:160: uniform log(1/K),
    the ``Pi`` argument is unused like the reference's caller); the C
    binary uses the model Pi instead (SIEVE-BS.c:367) — identical on all
    reference fixtures.  The decoder follows the C binary, so this
    oracle is a valid yardstick only for uniform model Pi."""
    pi, A_out, A_in, acoustic = build_adjacency(A, B)
    ctx = _Ctx(pi, A_out, A_in, acoustic, beam_width)
    K = len(A_out)
    ctx.preprocess(len(y) if b_hops is None else b_hops, K)
    _sieve_bs_rec(ctx, list(range(K)), list(np.asarray(y, dtype=np.int64)),
                  None, None)
    return ctx.path


# ---------------------------------------------------------------------------
# SIEVE-BS-Mp (fixed median)  [sieve_beam_search.py:351-501]
# ---------------------------------------------------------------------------

def _sieve_bs_mp_rec(ctx: _Ctx, indices, frames, last, active_tokens):
    T = len(frames)
    th = floor(T / 2)
    overall = set(indices)
    K = len(indices)
    if K <= 1:
        return

    T1 = {i: ctx.pi[i] + _emit(ctx, frames[0], 0, i) for i in indices}
    prev_mp: dict = {}
    current = list(active_tokens) if active_tokens is not None else list(indices)
    next_sub = None
    new_mp: dict = {}
    for j in range(1, T):
        new_mp = {}
        new_t1: dict = {}
        for node_i in current:
            for h, prob in ctx.A_out[node_i]:
                if h in overall:
                    cand = T1.get(node_i, float("-inf")) + prob + _emit(ctx, frames[j], node_i, h)
                    if cand > new_t1.setdefault(h, float("-inf")):
                        new_t1[h] = cand
                        if j == th:
                            new_mp[h] = (node_i, h)
                        elif j > th:
                            new_mp[h] = prev_mp.get(node_i, (-1, -1))
        current = _top_beam(ctx, new_t1)
        if j == th:
            next_sub = current
        prev_mp = new_mp
        T1 = new_t1

    if last is None:
        last = heapq.nlargest(1, T1, key=T1.get)[0]
    x_a, x_b = new_mp.get(last, (-1, -1))
    N_left = floor(T / 2)

    if N_left > 1:
        if x_a == -1:
            raise ReferenceUndefined(
                "SIEVE-BS-Mp: beam pruned every median candidate "
                f"(T={T}); reference crashes here")
        anc = ctx._reach(x_a, N_left, out=False)
        anc.discard(-1)
        left_idx = sorted(anc | {x_a})
        _sieve_bs_mp_rec(ctx, left_idx, frames[:N_left], x_a, active_tokens)

    ctx.path.append(new_mp.get(last, (-1, -1)))

    N_right = T - N_left
    if N_right > 1:
        if x_b == -1:
            raise ReferenceUndefined(
                "SIEVE-BS-Mp: beam pruned every median candidate "
                f"(T={T}); reference crashes here")
        dec = ctx._reach(x_b, N_right, out=True)
        dec.discard(-1)
        right_idx = sorted(dec | {x_b})
        _sieve_bs_mp_rec(ctx, right_idx, frames[-N_right:], last, next_sub)


def sieve_bs_mp(A, B, Pi, y, beam_width: int, b_hops: int | None = None) -> list:
    """Full SIEVE-BS-Mp run; returns the in-order median-pair list."""
    pi, A_out, A_in, acoustic = build_adjacency(A, B)
    ctx = _Ctx(pi, A_out, A_in, acoustic, beam_width)
    K = len(A_out)
    ctx.preprocess(len(y) if b_hops is None else b_hops, K)
    _sieve_bs_mp_rec(ctx, list(range(K)), list(np.asarray(y, dtype=np.int64)),
                     None, None)
    return ctx.path


# ---------------------------------------------------------------------------
# Plain beam search  [sieve_beam_search.py:267-347]
# ---------------------------------------------------------------------------

def beam_search(A, B, Pi, y, beam_width: int, initial_state: int | None = None):
    """Standard beam Viterbi with full T1/T2 tables; returns
    (path, top_loglik).  Self-loops are skipped (reference :309)."""
    pi, A_out, A_in, acoustic = build_adjacency(A, B)
    ctx = _Ctx(pi, A_out, A_in, acoustic, beam_width)
    K = len(A_out)
    y = list(np.asarray(y, dtype=np.int64))
    T = len(y)

    if initial_state is not None:
        Pi0 = defaultdict(lambda: float("-inf"))
        Pi0[initial_state] = 0.0
    else:
        Pi0 = {i: ctx.pi[i] for i in range(K)}

    T1 = {0: dict(Pi0)}
    T2 = {0: {}}
    current = list(range(K))
    # NOTE (reference quirk, :301): the forward loop iterates the *frame
    # values* y[1:] and indexes tables by the frame value j, so repeated
    # observation symbols overwrite table rows; we reproduce it verbatim.
    for j in y[1:]:
        this_t1: dict = {}
        this_t2: dict = {}
        for node_i in current:
            for h, prob in ctx.A_out[node_i]:
                if h != node_i:
                    base = T1.get(j - 1, {}).get(node_i, float("-inf"))
                    cand = base + prob + acoustic[j].get((node_i, h), 0.0)
                    if cand > this_t1.setdefault(h, float("-inf")):
                        this_t1[h] = cand
                        this_t2[h] = node_i
        T1.setdefault(j, {}).update(this_t1)
        T2.setdefault(j, {}).update(this_t2)
        eff = min(beam_width, len(this_t1))
        current = heapq.nlargest(eff, this_t1, key=this_t1.get)

    x = np.zeros(T, dtype=np.int64)
    top = heapq.nlargest(1, T1[T - 1], key=T1[T - 1].get)[0] if T1.get(T - 1) else 0
    x[-1] = int(top)
    top_ll = T1.get(T - 1, {}).get(top, float("-inf"))
    for i in range(T - 1, 0, -1):
        x[i - 1] = T2.get(i, {}).get(int(x[i]), 0)
    return x, top_ll
