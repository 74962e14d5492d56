"""The scan-ablation probe: the deltas scan with and without its history
write, at three staged-chunk sizes.

Counterpart of ``scripts/vpu_probe.py:ablation`` (``_abl_kernel``) and the
shapes of its ``main()``.  It runs the production deltas scan's own step,
``scan_step<16, false, EMIT_ROWS, WRITE_HIST, KCH>`` of
``csrc/maxplus_scan.cu`` (entry ``fvt_maxplus_scan_deltas_ablation``);
with the history written and 256 rows a chunk it is the very kernel
``maxplus_scan_deltas`` launches for a group of 16 lanes.  ``dfin`` is
bit-identical to the plain version in both modes, and so is the history
where it is written.

How the Mosaic tile arguments map onto this design:

- ``BK``, the source rows of a ``logA`` tile, is the port's staged chunk
  ``KC`` (``maxplus_scan.cu:52``): the carry slice the block stages in
  shared memory per chunk of source rows, which its 16 warps then split.
  The probe runs 128, 256 (production) and 512.  1024 would need 64 KB of
  static shared memory at 16 lanes, above the 48 KB limit, so
  ``phaseA_BK1024_BI2048`` has no run.
- ``BI``, the destination columns of a tile, has no counterpart: a block
  always owns 32 destination columns for its lanes.  Variants that differ
  only in ``BI`` are one run here, named after each of them.
- ``transpose`` has no counterpart: the carry is staged in its own (lane,
  source) layout and read as a warp-wide broadcast, never transposed, so
  ``phaseA_no_transpose`` has no run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench.harness import device_name, marginal_time
from ..models.hmm import resolve_device
from ..ops.cuda.common import expect_contiguous, launch, on_cuda
from ..ops.cuda.maxplus import _check, maxplus_scan_deltas_plain

# shape name -> (K, N, Tm), from vpu_probe.py's main()
SHAPES = {"phaseA": (16384, 16, 32), "phaseA_N32": (16384, 32, 16),
          "b64_shape_K4096": (4096, 64, 64)}
KCS = (128, 256, 512)
# (shape, write_hist, KC) -> the vpu_probe.py variants it stands for
JAX_NAMES = {
    ("phaseA", True, 128): ["phaseA_baseline"],
    ("phaseA", False, 128): ["phaseA_no_hist"],
    ("phaseA_N32", True, 128): ["phaseA_N32"],
    ("phaseA", True, 256): ["phaseA_BK256", "phaseA_BK256_BI8192"],
    ("phaseA", True, 512): ["phaseA_BK512_BI2048", "phaseA_BK512_BI4096"],
    ("b64_shape_K4096", True, 256): ["b64_shape_K4096"],
    ("b64_shape_K4096", True, 512): ["b64_K4096_BK512"],
}
NO_RUN = {
    "phaseA_no_transpose": "the carry is never transposed: no counterpart",
    "phaseA_BK1024_BI2048": "KC=1024 needs 64 KB of static shared memory at 16 lanes",
}


def probe_scan_ablation_plain(logA, emits, delta0, write_hist: bool = True):
    """Plain version of :func:`probe_scan_ablation`: (dfin, deltas) of
    ``maxplus_scan_deltas_plain``, deltas None without the history."""
    dfin, deltas = maxplus_scan_deltas_plain(logA, emits, delta0)
    return dfin, deltas if write_hist else None


def probe_scan_ablation(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor,
                        write_hist: bool = True, kc: int = 256):
    """The deltas scan (``maxplus_scan_deltas``'s layouts: logA (K, K),
    emits (T', N, K), delta0 (N, K), float32) with the carry history
    written or not, staging ``kc`` source rows a chunk.

    Returns (dfin (N, K), deltas (T', N, K) or None), bit-identical to
    :func:`probe_scan_ablation_plain`.
    """
    Tm, N, K = _check(logA, emits, delta0)
    if kc not in KCS:
        raise ValueError(f"kc must be one of {KCS}, got {kc}")
    if Tm < 1:
        raise ValueError("the probe needs T' >= 1")
    if not on_cuda(logA, emits, delta0):
        return probe_scan_ablation_plain(logA, emits, delta0, write_hist)
    expect_contiguous(logA=logA, emits=emits, delta0=delta0)
    dev = delta0.device
    dfin = torch.empty((N, K), dtype=torch.float32, device=dev)
    deltas = torch.empty((Tm, N, K), dtype=torch.float32, device=dev) if write_hist else None
    work = torch.empty((2, N, K), dtype=torch.float32, device=dev)
    launch("fvt_maxplus_scan_deltas_ablation", probe_scan_ablation, dev, logA.data_ptr(),
           emits.data_ptr(), delta0.data_ptr(), dfin.data_ptr(),
           deltas.data_ptr() if write_hist else None, work.data_ptr(), Tm, N, K,
           int(write_hist), kc)
    return dfin, deltas


probe_scan_ablation.launches = 0


def inputs(K: int, N: int, Tm: int, device="cuda", seed: int = 0, cache: dict | None = None):
    """``ablation``'s inputs: logA (K, K), emits (Tm, N, K) and delta0
    (N, K), standard normal float32 drawn in that order from ``seed``.
    ``cache`` keeps each K's logA and the generator's state after it, so
    the shapes of one K share its (K, K) draw."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cache is not None and K in cache:
        logA, state = cache[K]
        rng.bit_generator.state = state
    else:
        logA = torch.as_tensor(rng.standard_normal((K, K)).astype(np.float32), device=dev)
        if cache is not None:
            cache[K] = (logA, rng.bit_generator.state)
    emits = rng.standard_normal((Tm, N, K)).astype(np.float32)
    delta0 = rng.standard_normal((N, K)).astype(np.float32)
    return logA, torch.as_tensor(emits, device=dev), torch.as_tensor(delta0, device=dev)


def work(K: int, N: int, Tm: int, write_hist: bool) -> tuple[int, int]:
    """(bytes, operations) of one call: every input and output once; an
    add and a max per (step, lane, source, destination)."""
    moved = (K * K + Tm * N * K + 2 * N * K + (Tm * N * K if write_hist else 0)) * 4
    return moved, 2 * Tm * N * K * K


def run(device="cuda", shapes=SHAPES, kcs=KCS) -> list[dict]:
    """Time chains of 1 and 3 calls (``ablation``'s) for every shape, with
    and without the history, at every KC; one record each, and one for
    each ``vpu_probe.py`` variant that has no run."""
    records = []
    cache = {}
    for shape, (K, N, Tm) in shapes.items():
        args = inputs(K, N, Tm, device, cache=cache)
        for write_hist in (True, False):
            for kc in kcs:
                def chain(k, write_hist=write_hist, kc=kc):
                    def f():
                        for _ in range(k):
                            out = probe_scan_ablation(*args, write_hist=write_hist, kc=kc)
                        return out
                    return f

                per = marginal_time(chain, 1, 3)
                moved, ops = work(K, N, Tm, write_hist)
                records.append({
                    "probe": "vpu_probe", "kernel": "probe_scan_ablation",
                    "variant": f"{shape}_{'hist' if write_hist else 'no_hist'}_KC{kc}",
                    "jax": JAX_NAMES.get((shape, write_hist, kc), []),
                    "device": device_name(args[0].device), "K": K, "N": N, "Tm": Tm,
                    "write_hist": write_hist, "KC": kc, "per_call_s": per,
                    "per_step_s": per / Tm, "counted_ops_per_s": 2 * N * K * K / (per / Tm),
                    "bytes": moved, "operations": ops})
    records += [{"probe": "vpu_probe", "kernel": "probe_scan_ablation", "variant": name,
                 "skipped": why} for name, why in NO_RUN.items()]
    return records
