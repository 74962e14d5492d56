#!/usr/bin/env python3
"""Where the port's headline decodes spend their time on the GPU.

    python3 scripts/torch_profile_decodes.py [LABEL ...]

With LABELs (as the output names the runs, e.g. ``fused`` or ``"T=16384
checkpoint"``) only those runs.  On the headline problem (K=3965 padded to 3968, M=50, T=256, prob=0.112,
seed=1), for each of ``flash`` (16 segments), ``checkpoint``, ``fused``,
``flash_bs`` (B=64, 8 segments), ``beam`` (B=64), ``flash`` lean (16
segments, lean_leaf 64 and 0), ``auto``, ``sieve_mp`` (pruned and not),
``sieve_bs_mp`` (B=64) and the recompute batch
(``fused_decode_batch(..., pointers="recompute")`` over the 16 sequences
``observations(256, 50, seed=s)``, s = 1..16): the wall time of one decode
(median of 10 CUDA-event timings of one synchronized decode after a
warmup), then torch.profiler over 3 decodes (after one profiled decode
that is thrown away: a session right after one of many thousand kernels
recorded only some of its own): each kernel's device time and launches a
decode, the device's busy time (the sum of every kernel's) and its idle
share of the wall time.  For ``flash`` and ``checkpoint``, whose
scans share one error word read once a decode, also the wall time in turns
against the same decode with every scan reading its own word (a host
synchronisation a scan): shared, per scan, per scan, shared.  Then at
T=16384 (``observations(16384, 50, seed=1)``, the same tables): ``flash``
lean, ``fused`` and ``checkpoint`` the same way, and lean mode with its
anchor and t2 folds run as the plain version's gathers and selects (a
launch or more a row) instead of the ``fold_planes`` kernel.  Prints the
card's name and power limit first.  Fails when the profiler records no
device time.  Needs the card.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flash_viterbi_tpu_torch import build  # noqa: E402
from flash_viterbi_tpu_torch.algorithms.fused import fused_decode_batch  # noqa: E402
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations  # noqa: E402
from flash_viterbi_tpu_torch.ops.cuda.fold import fold_planes_plain  # noqa: E402
from flash_viterbi_tpu_torch.utils.profiling import device_rows  # noqa: E402

DECODERS = (("flash", {"num_segments": 16}), ("checkpoint", {}), ("fused", {}),
            ("flash_bs", {"beam_width": 64, "num_segments": 8}), ("beam", {"beam_width": 64}),
            ("flash", {"num_segments": 16, "mode": "lean"}),
            ("flash", {"num_segments": 16, "mode": "lean", "lean_leaf": 0}), ("auto", {}),
            ("sieve_mp", {}), ("sieve_mp", {"prune": False}), ("sieve_bs_mp", {"beam_width": 64}))
LONG_T = 16384
LONG_DECODERS = (("flash", {"num_segments": 16, "mode": "lean"}), ("fused", {}),
                 ("checkpoint", {}))
BATCH = 16
REPS = 3


def wall_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def plain_folds():
    """Inside, lean mode folds its pointer rows with the plain version's
    gathers and selects, not the fold_planes kernel."""
    mod = importlib.import_module("flash_viterbi_tpu_torch.algorithms.flash")
    saved = mod.fold_planes
    mod.fold_planes = lambda planes, rows, prop, **kernel_only: fold_planes_plain(planes, rows,
                                                                                 prop)
    try:
        yield
    finally:
        mod.fold_planes = saved


@contextlib.contextmanager
def per_scan_reads(name: str):
    """Inside, decoder ``name``'s scans get no shared error word, so each
    scan call reads its own and raises at once."""
    mod = importlib.import_module(f"flash_viterbi_tpu_torch.algorithms.{name}")
    saved = mod.error_word, mod.raise_on_error
    mod.error_word, mod.raise_on_error = (lambda dev: None), (lambda err, what: None)
    try:
        yield
    finally:
        mod.error_word, mod.raise_on_error = saved


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the profile needs the card")
    dev = torch.device("cuda", 0)
    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    lh = hmm.log(device=dev).padded(128)
    yd = torch.as_tensor(y.astype(np.int64), device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ys = torch.as_tensor(np.stack([observations(256, 50, seed=s) for s in range(1, BATCH + 1)]),
                         dtype=torch.int64, device=dev)
    def label(name, static):
        return " ".join([name] + [f"{k}={v}" for k, v in static.items()])

    runs = [(label(name, static), contextlib.nullcontext,
             functools.partial(build(name, **static), lh.logA, lh.logB, lh.logPi, yd))
            for name, static in DECODERS]
    runs.append((f"recompute batch Bs={BATCH}", contextlib.nullcontext, functools.partial(
        fused_decode_batch, lh.logA, lh.logB, lh.logPi, ys, pointers="recompute")))
    y_long = torch.as_tensor(observations(LONG_T, 50, seed=1).astype(np.int64), device=dev)
    for name, static in LONG_DECODERS:
        runs.append((f"T={LONG_T} {label(name, static)}", contextlib.nullcontext,
                     functools.partial(build(name, **static), lh.logA, lh.logB, lh.logPi,
                                       y_long)))
    runs.append((f"T={LONG_T} flash lean, folds as gathers and selects", plain_folds,
                 functools.partial(build("flash", num_segments=16, mode="lean"),
                                   lh.logA, lh.logB, lh.logPi, y_long)))
    wanted = sys.argv[1:]
    unknown = sorted(set(wanted) - {name for name, _, _ in runs})
    if unknown:
        sys.exit(f"unknown runs {unknown}; have {[name for name, _, _ in runs]}")
    for name, ctx, run in runs:
        if wanted and name not in wanted:
            continue
        with ctx():
            profile_one(name, run)


def profile_one(name: str, run) -> None:
    """Print ``run``'s wall time, its kernels' device time and launches a
    decode, and the device's idle share (see the module's docstring)."""
    run()
    torch.cuda.synchronize()
    wall = wall_ms(run)
    for reps in (1, REPS):  # the first session is thrown away
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    kernels = device_rows(prof)
    if not kernels:
        sys.exit(f"{name}: the profiler recorded no device time")
    busy = sum(e.self_device_time_total for e in kernels) / REPS / 1e3
    print(f"{name}: wall {wall:.3f} ms a decode; device busy {busy:.3f} ms; idle "
          f"{wall - busy:.3f} ms ({(wall - busy) / wall * 100:.1f}%)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / REPS / 1e3:8.3f} ms  {e.count / REPS:6.1f} "
              f"launches  {e.key[:110]}", flush=True)
    decoder = name.split()[0]
    if name in ("flash num_segments=16", "checkpoint"):
        turns = {"shared": [], "per scan": []}
        for which in ("shared", "per scan", "per scan", "shared"):
            with per_scan_reads(decoder) if which == "per scan" else contextlib.nullcontext():
                run()
                turns[which].append(wall_ms(run))
        print(f"{name}: one error word a decode {statistics.mean(turns['shared']):.3f} ms, "
              f"one read a scan {statistics.mean(turns['per scan']):.3f} ms; in turns "
              f"{turns}", flush=True)


if __name__ == "__main__":
    main()
