"""Native C vanilla oracle: the framework numerics contract at C speed.

Builds the repository's ``csrc/fastio.c`` with the system C compiler into
the port's build directory and calls its ``fv_viterbi_f32`` (fp32 adds,
emission after the max, strict '>' over ascending sources: lowest index on
ties).  It runs the K^2 T recursion in compiled C, so parity checks at the
headline shape do not wait on the numpy mirror (``oracle.framework``).
There is no fallback: a missing compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..models.hmm import _log32
from ..runtime.build import BUILD_DIR, PKG_DIR, compile_to

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "csrc", "fastio.c")
ORACLE_SO = os.path.join(BUILD_DIR, "libfvt_oracle.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _command(out: str) -> list[str]:
    cc = os.environ.get("CC", "cc")
    return [cc, "-O3", "-march=native", "-shared", "-fPIC", SOURCE, "-o", out, "-lm"]


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(ORACLE_SO)
                    or os.path.getmtime(ORACLE_SO) < os.path.getmtime(SOURCE)):
                compile_to(ORACLE_SO, _command)
            lib = ctypes.CDLL(ORACLE_SO)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.fv_viterbi_f32.restype = ctypes.c_int
            lib.fv_viterbi_f32.argtypes = [fp, fp, fp, ip, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ip, ip]
            _lib = lib
        return _lib


def vanilla(A, B, Pi, y) -> np.ndarray:
    """Decode probability tables (A, B, Pi) and observations ``y`` under the
    framework numerics contract; returns the (T,) int64 path."""
    lib = _load()
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
