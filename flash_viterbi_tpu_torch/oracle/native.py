"""Native C vanilla oracle: the framework numerics contract at C speed.

Calls ``fv_viterbi_f32`` of the repository's ``csrc/fastio.c``, which
``runtime.native`` builds with the system C compiler into the port's build
directory (fp32 adds, emission after the max, strict '>' over ascending
sources: lowest index on ties).  It runs the K^2 T recursion in compiled C, so parity checks at the
headline shape do not wait on the numpy mirror (``oracle.framework``).
There is no fallback: without a compiler :func:`vanilla` raises, and
:func:`available` says beforehand whether it can run.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..models.hmm import _log32
from ..runtime.native import get_lib, library


def available() -> bool:
    """Whether the C library builds, loads and exports ``fv_viterbi_f32``."""
    lib = get_lib()
    return lib is not None and hasattr(lib, "fv_viterbi_f32")


def vanilla(A, B, Pi, y) -> np.ndarray:
    """Decode probability tables (A, B, Pi) and observations ``y`` under the
    framework numerics contract; returns the (T,) int64 path."""
    lib = library()
    logA = np.ascontiguousarray(_log32(A))
    logB = np.ascontiguousarray(_log32(B))
    logPi = np.ascontiguousarray(_log32(Pi))
    yv = np.ascontiguousarray(np.asarray(y, dtype=np.int32))
    K, M = logB.shape
    T = len(yv)
    path = np.empty(T, dtype=np.int32)
    scratch = np.empty((T, K), dtype=np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.fv_viterbi_f32(
        logA.ctypes.data_as(fp), logB.ctypes.data_as(fp),
        logPi.ctypes.data_as(fp), yv.ctypes.data_as(ip),
        K, M, T, path.ctypes.data_as(ip), scratch.ctypes.data_as(ip))
    if rc != 0:
        raise MemoryError("fv_viterbi_f32 could not allocate its carry buffers")
    return path.astype(np.int64)
