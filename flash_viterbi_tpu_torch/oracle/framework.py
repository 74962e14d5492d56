"""NumPy mirror of the framework's decode semantics.

Identical fp32 operations in identical order and the lowest-index tie
rule, so a decoder's path must equal this one exactly.  A copy of
``flash_viterbi_tpu/oracle/framework.py``'s ``vanilla``, kept here because
the port never imports the JAX package.
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
