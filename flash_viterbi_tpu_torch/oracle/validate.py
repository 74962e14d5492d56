"""f64 path rescoring, the yardstick when two fp32-optimal paths differ.

FLASH restarts each segment's DP from its anchor state and so rounds fp32
differently from a global sweep; at large T*K it may resolve an exact tie
the other way.  Such a path differs from vanilla but scores the same in
f64 up to :func:`score_tolerance_f64`.  Copied from
``flash_viterbi_tpu/oracle/validate.py``.
"""

from __future__ import annotations

import numpy as np


def path_score_f64(A, B_mat, Pi, y, path) -> float:
    """f64 log-score of ``path`` under probability tables (A, B, Pi)."""
    with np.errstate(divide="ignore"):
        lA = np.log(np.asarray(A, np.float64))
        lB = np.log(np.asarray(B_mat, np.float64))
        lP = np.log(np.asarray(Pi, np.float64))
    return log_path_score_f64(lA, lB, lP, y, path)


def log_path_score_f64(logA, logB, logPi, y, path) -> float:
    """f64 log-score of ``path`` under (possibly fp32) log tables."""
    lA = np.asarray(logA, np.float64)
    lB = np.asarray(logB, np.float64)
    lP = np.asarray(logPi, np.float64)
    p = np.asarray(path)
    yv = np.asarray(y)
    return float(lP[p[0]] + lB[p[0], yv[0]]
                 + lA[p[:-1], p[1:]].sum() + lB[p[1:], yv[1:]].sum())


def score_tolerance_f64(T: int, ref_score: float) -> float:
    """Gross-breakage bound for comparing two fp32-optimal paths' f64
    scores: tie-flip accumulation stays well under one transition's weight,
    while a wrong transition costs O(-log p) ~ 5-15 (max 2.0, or 64
    final-score ulps when the score is large)."""
    return max(2.0, 64.0 * 2.0 ** -23 * abs(ref_score))
