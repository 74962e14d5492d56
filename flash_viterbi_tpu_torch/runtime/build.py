"""Build the port's CUDA kernels with ``nvcc`` at first use, load with ctypes.

Each ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together; the objects link into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds,
not minutes).  It lands in the package's ``build/`` directory, which git
ignores, and is rebuilt when any source is newer than it.  Importing this
module never runs ``nvcc``: only :func:`kernels` does, and only the CUDA
branch of a kernel wrapper calls it.

No ``--use_fast_math``: the kernels' results are bit-exact only because
every operation (fp32 add, max, compare) is correctly rounded.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNELS_SO = os.path.join(BUILD_DIR, "libfvt_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)

# C entry points: every pointer and the stream as c_void_p (a c_int would cut
# a 64-bit address); each returns the cudaError_t of its launches, but
# fvt_beam_scan_clusters, fvt_fold_planes_clusters and
# fvt_probe_alu_blocks_per_sm, which return a count
_SIGNATURES = {
    # logA, emits, delta0, dfin, ptrs, deltas, part_v, part_i, carry, count, err,
    # plan, Tm, N, K, stream, launches
    "fvt_maxplus_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _P,
                         _LL],
    # the same on a bf16 logA
    "fvt_maxplus_scan_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _P,
                              _LL],
    # logA, logBT, ys, delta0, dfin, ptrs, deltas, part_v, part_i, carry, count,
    # err, plan, Tm, N, K, stream, launches
    "fvt_maxplus_scan_eg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _I,
                            _I, _P, _LL],
    # delta, logA_block, val, ptr, plan, N, Ks, Kd, stream, launches
    "fvt_maxplus_step_block": [_P, _P, _P, _P, _IP, _I, _I, _I, _P, _LL],
    # ptrs, last, out, Tm, N, K, stream, launches
    "fvt_backtrack": [_P, _P, _P, _I, _I, _I, _P, _LL],
    # deltas, logAT, last, valid, out, err, Tm, N, K, stream, launches
    "fvt_argmax_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _LL],
    # the same on a bf16 logAT
    "fvt_argmax_walk_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _LL],
    # logA, emits, vals0, states0, valid, prop, hist, slots, planes, scratch, err,
    # plan, Tm, N, K, B, P, stream, launches
    "fvt_beam_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _I, _I, _P,
                      _LL],
    # planes, rows, prop, out, scratch, err, plan, c, R, P, K, stream, launches
    "fvt_fold_planes": [_P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _I, _P, _LL],
    # plan -> clusters of its size and shared memory the card keeps resident
    # (negative: a CUDA error)
    "fvt_fold_planes_clusters": [_IP],
    # plan -> clusters of its size and shared memory the card keeps resident
    # (negative: a CUDA error)
    "fvt_beam_scan_clusters": [_IP],
    # device, out[6] -> L2 bytes, the most of it for persisting accesses, the SM
    # clock's maximum in kHz, SMs, shared memory and registers of an SM
    "fvt_device_limits": [_I, _IP],
    # the probes (flash_viterbi_tpu_torch/probes/)
    # fvt_maxplus_scan's arguments, then the variant
    "fvt_maxplus_scan_deltas_ablation": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I,
                                         _I, _I, _I, _P, _LL],
    # x, out, n, half, R, blocks, clocks, stream, launches
    "fvt_probe_alu": [_P, _P, _I, _I, _I, _I, _P, _P, _LL],
    # -> blocks of the add+max kernel an SM keeps resident (negative: a CUDA error)
    "fvt_probe_alu_blocks_per_sm": [],
    # logA, emits, vals0, states0, hist, slots, err, plan, Tm, K, B, variant, stream,
    # launches
    "fvt_probe_beam": [_P, _P, _P, _P, _P, _P, _P, _IP, _I, _I, _I, _I, _P, _LL],
    # src, dst, plan, Tm, n, B, err, stream, launches
    "fvt_probe_copy_rows": [_P, _P, _IP, _I, _I, _I, _P, _P, _LL],
    # out, Tm, W, err, stream, launches
    "fvt_probe_copy_p4": [_P, _I, _I, _P, _P, _LL],
    # v, c, n, outv, outc, width, stream, launches
    "fvt_probe_copy_p5": [_P, _P, _I, _P, _P, _I, _P, _LL],
    # out, Tm, W, C, pub, clocks, err, stream, launches
    "fvt_probe_copy_p4_cluster": [_P, _I, _I, _I, _I, _P, _P, _P, _LL],
    # v, c, n, outv, outc, width, C, clocks, err, stream, launches
    "fvt_probe_copy_p5_cluster": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _LL],
    # table, n, hops, mode, out, clocks, stream, launches
    "fvt_probe_chase": [_P, _I, _I, _I, _P, _P, _P, _LL],
    # stream, launches
    "fvt_probe_empty": [_P, _LL],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _stale() -> bool:
    if not os.path.exists(KERNELS_SO):
        return True
    built = os.path.getmtime(KERNELS_SO)
    return any(os.path.getmtime(s) > built for s in sources() + headers())


def compile_to(out: str, command) -> str:
    """Run ``command(tmp)``, a compiler writing to the path ``tmp``, and
    rename ``tmp`` to ``out``, so a concurrent loader never sees a
    half-written library.  Returns the compiler's output; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{command(tmp)[0]} failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def _compile_objects(objdir: str) -> tuple[list[str], str]:
    """Compile every source to an object in ``objdir``, one ``nvcc`` process
    per source, all running at once.  Returns (objects, compiler output);
    raises naming each source that failed."""
    nvcc = nvcc_path()
    jobs = []
    for src in sources():
        obj = os.path.join(objdir, os.path.basename(src) + ".o")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return [obj for _, obj, _ in jobs], "".join(logs)


def build() -> float:
    """Compile the kernel library; returns the seconds ``nvcc`` took.  The
    compiler's output (with ``ptxas`` register and spill counts) is kept in
    ``build/nvcc.log``."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs, log = _compile_objects(objdir)
        log += compile_to(KERNELS_SO, lambda out: [nvcc_path(), "-shared", "-o", out, *objs])
    with open(BUILD_LOG, "w") as f:
        f.write(log)
    return time.perf_counter() - t0


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(KERNELS_SO)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fvt_error_string.argtypes = [ctypes.c_int]
            lib.fvt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = kernels().fvt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
