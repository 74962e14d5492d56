"""ctypes bindings of the repository's ``csrc/fastio.c``: the text loaders,
the ``%.16f`` writer and the C vanilla oracle.

Counterpart of ``flash_viterbi_tpu/runtime/native.py``.  The source is
built once with the system C compiler into the port's build directory
(``build/libfvt_oracle.so``, which git ignores), rebuilt when the source
is newer, and loaded with ctypes; ``oracle.native`` (the C vanilla
oracle) and ``utils.io`` (the model files) share that one library.
:func:`library` raises where it cannot be built; :func:`get_lib` returns
None instead, and the I/O functions then return None or False, so their
callers fall back to numpy where no C compiler exists.  Host code only:
nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .build import BUILD_DIR, PKG_DIR, compile_to

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "csrc", "fastio.c")
LIBRARY = os.path.join(BUILD_DIR, "libfvt_oracle.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed: Exception | None = None

_DP = ctypes.POINTER(ctypes.c_double)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_long
_I = ctypes.c_int

# C entry point -> (restype, argtypes)
_SIGNATURES = {
    # path, out, count -> values parsed (-1: an I/O error)
    "fv_load_floats": (_L, [ctypes.c_char_p, _DP, _L]),
    "fv_load_ints": (_L, [ctypes.c_char_p, _LLP, _L]),
    # path, data, rows (0: one line), cols -> 0 on success
    "fv_save_floats": (_I, [ctypes.c_char_p, _DP, _L, _L]),
    # logA, logB, logPi, y, K, M, T, path, scratch -> 0 on success
    "fv_viterbi_f32": (_I, [_FP, _FP, _FP, _IP, _I, _I, _I, _IP, _IP]),
}


def _command(out: str) -> list[str]:
    cc = os.environ.get("CC", "cc")
    return [cc, "-O3", "-march=native", "-shared", "-fPIC", SOURCE, "-o", out, "-lm"]


def library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing or older than its
    source; raises if the compiler or the load fails (and again on every
    later call, without another attempt)."""
    global _lib, _failed
    with _lock:
        if _lib is None:
            if _failed is not None:
                raise RuntimeError(f"{SOURCE} could not be built or loaded") from _failed
            try:
                if (not os.path.exists(LIBRARY)
                        or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
                    compile_to(LIBRARY, _command)
                lib = ctypes.CDLL(LIBRARY)
            except (OSError, RuntimeError) as e:  # no compiler, a failed build or load
                _failed = e
                raise
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def get_lib() -> ctypes.CDLL | None:
    """:func:`library`, or None where it cannot be built or loaded."""
    try:
        return library()
    except (OSError, RuntimeError):
        return None


def _load(fn_name: str, path: str, count: int, dtype, ptr) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(count, dtype=dtype)
    n = getattr(lib, fn_name)(os.fsencode(path), out.ctypes.data_as(ptr), count)
    if n < 0:
        raise OSError(f"the native loader could not read {path}")
    return out[:n]


def load_floats_native(path: str, count: int) -> np.ndarray | None:
    """Up to ``count`` whitespace-separated floats of ``path`` as float64
    (fewer where the file holds fewer), or None without the library."""
    return _load("fv_load_floats", path, count, np.float64, _DP)


def load_ints_native(path: str, count: int) -> np.ndarray | None:
    """Up to ``count`` whitespace-separated integers of ``path`` as int64,
    or None without the library."""
    return _load("fv_load_ints", path, count, np.int64, _LLP)


def save_floats_native(path: str, data: np.ndarray) -> bool:
    """Write ``data`` as ``np.savetxt(path, data, fmt="%.16f")`` does, a
    row a line; a 1-D array on one line as ``np.savetxt(..., newline=" ")``
    does.  False without the library or if the write failed."""
    lib = get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float64)
    rows, cols = (0, arr.size) if arr.ndim == 1 else arr.shape
    return lib.fv_save_floats(os.fsencode(path), arr.ctypes.data_as(_DP), rows, cols) == 0
