"""f64 path rescoring and FLASH tie-flip arbitration, the yardsticks when
two fp32-optimal paths differ.

FLASH restarts each segment's DP from its anchor state and so rounds fp32
differently from a global sweep; at large T*K it may resolve an exact tie
the other way.  Such a path differs from vanilla but scores the same in
f64 up to :func:`score_tolerance_f64`, and equals the bit-exact f32 FLASH
mirror (``oracle.reference.flash``) or ties with it
(:func:`arbitrate_flash_tie_flip`).  Beam-family paths (SIEVE-BS and its
kin) are rescored under the reference's own quirks instead
(:func:`beam_family_score_f64`, :func:`beam_path_invariants`).  Copied from
``flash_viterbi_tpu/oracle/validate.py``.
"""

from __future__ import annotations

import math

import numpy as np


def path_score_f64(A, B_mat, Pi, y, path) -> float:
    """f64 log-score of ``path`` under probability tables (A, B, Pi)."""
    with np.errstate(divide="ignore"):
        lA = np.log(np.asarray(A, np.float64))
        lB = np.log(np.asarray(B_mat, np.float64))
        lP = np.log(np.asarray(Pi, np.float64))
    return log_path_score_f64(lA, lB, lP, y, path)


def log_path_score_f64(logA, logB, logPi, y, path) -> float:
    """f64 log-score of ``path`` under (possibly fp32) log tables.

    The path's entries are gathered first and only they are widened: the
    same float64 values summed in the same order as the JAX package's
    widening of whole tables, so the same bits, without a float64 copy of
    a (K, K) table a call (2 GiB at K=16384)."""
    lA, lB, lP = np.asarray(logA), np.asarray(logB), np.asarray(logPi)
    p = np.asarray(path)
    yv = np.asarray(y)
    f64 = np.float64
    return float(f64(lP[p[0]]) + f64(lB[p[0], yv[0]])
                 + lA[p[:-1], p[1:]].astype(f64).sum() + lB[p[1:], yv[1:]].astype(f64).sum())


def beam_family_score_f64(A, B_mat, Pi, y, path) -> tuple[float, int]:
    """f64 log-score under the SIEVE-BS family's flattened-path semantics.

    Quirks honored: a zero emission probability contributes 0, not -inf
    (``SIEVE-BS.c:428``, ``sieve_beam_search.py:119-123``); -1 fallout
    sentinels break the transition chain (``SIEVE-Mp.c:412-420``); and a
    zero-probability transition in the flattened output is a junction
    discontinuity -- beam pruning can force adjacent recursion nodes
    through unconnected states, and the reference's own output does this
    (the float64 SIEVE-BS oracle reproduces each one; the K=64, seed=7
    fixture has two).  Discontinuities contribute 0 to the score and are
    counted.  The same float64 operations in the same order as the JAX
    package's, so the same bits.

    Returns (score, junction_breaks).
    """
    with np.errstate(divide="ignore"):
        lA = np.log(np.asarray(A, np.float64))
        lB = np.log(np.asarray(B_mat, np.float64))
        lP = np.log(np.asarray(Pi, np.float64))
    lBq = np.where(np.isneginf(lB), 0.0, lB)
    p = np.asarray(path)
    yv = np.asarray(y)
    ok = p >= 0
    s = float(lP[p[0]] + lBq[p[0], yv[0]]) if ok[0] else 0.0
    pair = ok[:-1] & ok[1:]
    trans = lA[np.maximum(p[:-1], 0), np.maximum(p[1:], 0)]
    breaks = int((pair & np.isneginf(trans)).sum())
    s += float(np.where(pair & np.isfinite(trans), trans, 0.0).sum())
    s += float(np.where(ok[1:], lBq[np.maximum(p[1:], 0), yv[1:]], 0.0).sum())
    return s, breaks


def beam_path_invariants(A, B_mat, Pi, y, path) -> str:
    """Mirror-free sanity witness for a beam-family path at scales where no
    oracle is affordable: every state must be a valid id or the -1
    sentinel, and the quirk-scored f64 (:func:`beam_family_score_f64`) must
    be finite.  Junction discontinuities are reported, not failed (a
    property of the reference).  A sanity check, not a parity proof: the
    heavyweight witness at the paper's SIEVE-BS config is
    ``scripts/torch_sieve_bs_witness.py``.

    Returns ``invariants-ok:score=<f64 to 3 places>,junction_breaks=<n>``
    or ``invariants-VIOLATED``."""
    p = np.asarray(path)
    K = np.asarray(A).shape[0]
    if not bool(((p >= -1) & (p < K)).all()):
        return "invariants-VIOLATED"
    s, breaks = beam_family_score_f64(A, B_mat, Pi, y, p)
    if np.isfinite(s):
        return f"invariants-ok:score={s:.3f},junction_breaks={breaks}"
    return "invariants-VIOLATED"


def score_tolerance_f64(T: int, ref_score: float) -> float:
    """Gross-breakage bound for comparing two fp32-optimal paths' f64
    scores: tie-flip accumulation stays well under one transition's weight,
    while a wrong transition costs O(-log p) ~ 5-15 (max 2.0, or 64
    final-score ulps when the score is large)."""
    return max(2.0, 64.0 * 2.0 ** -23 * abs(ref_score))


def dp_divergence_tolerance_f64(T: int, ref_score: float) -> float:
    """Legitimate f64-score gap between two fp32-DP decoders of the same
    problem that accumulate rounding differently (other segmentations,
    restart points or sweep orders).

    The fp32 recursion rounds once a step at magnitude ~|s|*t/T and the
    argmax selects on the rounded scores, so the chosen paths' f64 scores
    drift apart about like eps*|s|*sqrt(T) with a selection factor; the
    JAX package observed gaps of ~4x that at T=65536 (checkpoint against
    flash N=8 at K=1024: 31.5 nats), and this bound is 4x the observed
    factor.  At that scale one wrong transition (~10-15 nats) lies inside
    the tolerance: a score comparison cannot catch a single-transition
    fault at long T, which bit-exactness at small scale has to.
    """
    eps = 2.0 ** -23
    return max(2.0, 16.0 * eps * abs(ref_score) * float(np.sqrt(T)))


def effective_flash_segments(T: int, num_segments: int) -> int:
    """The segment count ``flash_decode`` runs with (its clamp)."""
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    return N


# one mirror sweep costs ~T*log2(T) trellis steps of K^2 vectorized numpy;
# 4e10 cells take a minute or two on one host core: the headline
# (K=3965, T=256) is in, long-T shapes, where it would take hours, are not
FLASH_MIRROR_MAX_CELLS = 4e10


def flash_mirror_cells(K: int, T: int) -> float:
    return float(T) * K * K * (1 + math.ceil(math.log2(max(2, T))))


def arbitrate_flash_tie_flip(A, B_mat, Pi, y, path, num_segments: int,
                             max_cells: float = FLASH_MIRROR_MAX_CELLS):
    """Arbitrate a flash-against-vanilla path mismatch.

    Every flash variant resolves exact fp32 ties its own way, and all are
    legitimate: pointer mode backtracks the one-shot segment DP's pointer
    table, the C recursion (== lean mode == the f32 mirror) restarts
    midpoint DPs, and vanilla sweeps globally.  On fixtures with interior
    exact ties pointer mode can differ from both vanilla and the mirror
    while staying fp32-optimal (K=194, T=1024, seed 91031: pointer ==
    vanilla at 2 positions where lean == the mirror == the C binary flip).

    Returns:
      "mirror-exact"    — equals the f32 FLASH mirror (the C semantics);
      "tie-equivalent"  — differs from the mirror only by tie resolution:
                          no -inf transition, f64-rescored within
                          ``score_tolerance_f64`` of the mirror's path;
      False             — a genuine mismatch (invalid path or score gap);
      None              — no faithful arbitration at this shape: at most 2
                          effective segments (the mirror's single binary
                          split, reference :281, segments otherwise) or a
                          mirror above ``max_cells``.
    """
    T = len(np.asarray(y))
    n_eff = effective_flash_segments(T, num_segments)
    if n_eff <= 2:
        return None
    K = np.asarray(A).shape[0]
    if flash_mirror_cells(K, T) > max_cells:
        return None
    from .reference import flash as flash_mirror

    want = flash_mirror(A, B_mat, Pi, y, threads=n_eff, numerics="f32")
    if bool((np.asarray(path) == np.asarray(want)).all()):
        return "mirror-exact"
    s_got = path_score_f64(A, B_mat, Pi, y, path)
    s_ref = path_score_f64(A, B_mat, Pi, y, want)
    if np.isfinite(s_got) and abs(s_got - s_ref) <= score_tolerance_f64(T, s_ref):
        return "tie-equivalent"
    return False
