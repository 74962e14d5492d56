#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flash_viterbi_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Device: the ``nvidia-smi`` name and power limit, and the torch device.
2. Build: compile the port's CUDA sources with ``nvcc``.
3. Kernels: each of the four kernels of the FLASH pointer-mode path against
   its plain PyTorch version on the card, bit-exact (tolerance 0: the
   kernels use only correctly rounded fp32 adds, maxes and compares), at
   the headline shapes, on a fixture full of exact ties, and at an
   unpadded K.  Times are the median of CUDA-event timings.
4. Slice: the headline problem (K=3965 padded to 3968, M=50, T=256,
   prob=0.112, seed=1) decoded for four requests through the public
   ``decode(..., "flash", num_segments=16, device="cuda")``.  Each path
   must equal the port's CPU decode bit for bit, and the native C vanilla
   oracle exactly or, for FLASH's legitimate fp32 tie flips, within the f64
   score tolerance (the seed-1 request exactly).  Every kernel must have
   launched during these decodes.

Prints a ``{"kernels": [...]}`` JSON line, then, last, the
``{"ok": true, "device": {...}}`` line.  Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
SEGMENTS = 16
EXTRA_SEEDS = (2, 3, 4)

# kernel name -> (CUDA source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "maxplus_scan": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                     "flash_viterbi_tpu/ops/pallas/maxplus.py:467"),
    "maxplus_scan_deltas": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                            "flash_viterbi_tpu/ops/pallas/maxplus.py:240"),
    "backtrack_batched": ("flash_viterbi_tpu_torch/csrc/backtrack.cu",
                          "flash_viterbi_tpu/ops/pallas/backtrack.py:123"),
    "argmax_walk": ("flash_viterbi_tpu_torch/csrc/argmax_walk.cu",
                    "flash_viterbi_tpu/ops/pallas/backtrack.py:594"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def elapsed_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``reps`` synchronized runs of ``fn``."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; equal entries (including equal infinities) count 0."""
    a64, b64 = a.double(), b.double()
    diff = torch.where(a64 == b64, torch.zeros_like(a64), (a64 - b64).abs())
    return float(diff.max()) if diff.numel() else 0.0


def device_phase() -> torch.device:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return torch.device("cuda", 0)


def build_phase() -> None:
    from flash_viterbi_tpu_torch.runtime import build

    secs = build.build()
    build.kernels()
    print(f"build: nvcc {secs:.1f} s", flush=True)
    with open(build.BUILD_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])


def tables(hmm, pad_to: int, device):
    from flash_viterbi_tpu_torch import LogHMM

    lh = hmm.log()
    return LogHMM(lh.logA.to(device), lh.logB.to(device), lh.logPi.to(device),
                  lh.K).padded(pad_to)


def phase_inputs(lh, y, device, seed: int):
    """The four kernels' inputs at the shapes the flash decode gives them:
    phase 1 (N=1 over T-1 steps) and phase 2 (N=16 lanes over the longest
    segment, with its ragged valid mask); lane start states drawn from
    ``seed`` stand in for the anchors."""
    from flash_viterbi_tpu_torch.algorithms.flash import (flash_midpoints,
                                                          segment_layout)

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    scan_in = (lh.logA, emits[1:].unsqueeze(1), (lh.logPi + emits[0])[None, :])
    mids = flash_midpoints(0, T - 1, SEGMENTS)
    starts, lens, Lmax = segment_layout(mids, T)
    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.integers(0, lh.K, SEGMENTS), device=device)
    idx = torch.clamp(torch.as_tensor(starts, device=device)[:, None]
                      + torch.arange(Lmax, device=device)[None, :], max=T - 1)
    seg = emits[idx]
    d0 = (lh.logA[init] + seg[:, 0]).contiguous()
    deltas_in = (lh.logA, seg[:, 1:].transpose(0, 1).contiguous(), d0)
    valid = (torch.arange(1, Lmax, device=device)[:, None]
             <= torch.as_tensor(lens, device=device)[None, :] - 1)
    return scan_in, deltas_in, valid


def compare(name: str, kernel, plain, args, device, reps: int = 0) -> dict:
    """Run a kernel and its plain version on the same inputs; require
    bit-equal outputs; optionally time both."""
    got, want = kernel(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{name}: kernel differs from its plain version (max abs err {err})")
    rec = {"name": name, "max_abs_err": err}
    if reps:
        rec["ms"] = elapsed_ms(lambda: kernel(*args), device, reps)
        rec["plain_ms"] = elapsed_ms(lambda: plain(*args), device, max(1, reps // 3))
    return rec


def check_all(scan_in, deltas_in, valid, device, reps: int = 0) -> list[dict]:
    """All four kernels against their plain versions: the pointer scan and
    the backtrack on ``scan_in``, the deltas scan and the walk (with the
    ``valid`` mask) on ``deltas_in``."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    recs = [compare("maxplus_scan", k.maxplus_scan, km.maxplus_scan_plain,
                    scan_in, device, reps),
            compare("maxplus_scan_deltas", k.maxplus_scan_deltas,
                    km.maxplus_scan_deltas_plain, deltas_in, device, reps)]
    dfin, ptrs = k.maxplus_scan(*scan_in)
    last = mp.first_argmax(dfin, 1)[1]
    recs.append(compare("backtrack_batched", k.backtrack_batched,
                        kb.backtrack_batched_plain, (ptrs, last), device, reps))
    dfinN, deltas = k.maxplus_scan_deltas(*deltas_in)
    lastN = mp.first_argmax(dfinN, 1)[1]
    logAT = deltas_in[0].t().contiguous()
    recs.append(compare("argmax_walk", k.argmax_walk, kb.argmax_walk_plain,
                        (deltas, logAT, lastN, valid), device, reps))
    return recs


def tie_fixture(device, K: int = 1000, N: int = 20, Tm: int = 21, seed: int = 5):
    """Integer-valued tables: exact fp32 ties everywhere.  K is not a
    multiple of the kernels' 32-column tile and N needs two lane groups."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    logA = put(np.round(rng.standard_normal((K, K)) * 2) / 2)
    emits = put(np.round(rng.standard_normal((Tm, N, K))))
    delta0 = put(np.round(rng.standard_normal((N, K))))
    valid = torch.as_tensor(rng.random((Tm, N)) < 0.8, device=device)
    return (logA, emits, delta0), valid


def hbm_read_gbps(device) -> float:
    """Measured read bandwidth: a max-reduction over 2 GiB of fp32."""
    x = torch.empty(2**29, dtype=torch.float32, device=device).uniform_()
    ms = elapsed_ms(lambda: torch.amax(x), device, 10)
    return x.numel() * 4 / (ms * 1e-3) / 1e9


def kernel_phase(hmm, y, device) -> dict[str, dict]:
    """Kernels against plain versions; returns per-kernel records timed at
    the headline shapes, with the worst error over every fixture."""
    timed = check_all(*phase_inputs(tables(hmm, 128, device), y, device, seed=0),
                      device, reps=9)
    ties, valid = tie_fixture(device)
    others = (check_all(*phase_inputs(tables(hmm, 1, device), y, device, seed=1),
                        device)
              + check_all(ties, ties, valid, device))
    recs = {r["name"]: r for r in timed}
    for r in others:
        recs[r["name"]]["max_abs_err"] = max(recs[r["name"]]["max_abs_err"],
                                             r["max_abs_err"])
    for name, r in recs.items():
        print(f"kernel {name}: bit-exact on 3 fixtures; {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f} ms) at the headline shape", flush=True)
    return recs


def slice_phase(hmm, requests, device, cpu_device) -> dict[str, int]:
    """Decode every request on ``device``; check against the CPU decode,
    the C oracle and the analytic memory; return the kernel launches."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms.flash import _memory
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.oracle import native
    from flash_viterbi_tpu_torch.oracle.validate import (path_score_f64,
                                                         score_tolerance_f64)

    K, T = hmm.K, len(requests[0])
    k.reset_launches()
    results = [decode(hmm, y, "flash", num_segments=SEGMENTS, device=device)
               for y in requests]
    launches = k.launch_counts()
    print(f"slice: kernel launches over {len(requests)} decodes (warmups "
          f"included): {launches}", flush=True)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    want_mem = _memory(K=K, T=T, num_segments=SEGMENTS)
    for i, (y, r) in enumerate(zip(requests, results)):
        cpu = decode(hmm, y, "flash", num_segments=SEGMENTS, device=cpu_device,
                     warmup=False)
        require(np.array_equal(r.path, cpu.path),
                f"request {i}: {device} path differs from the CPU decode")
        oracle = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)
        if np.array_equal(r.path, oracle):
            verdict = "exact"
        else:
            require(i > 0, "the seed-1 request must equal the C oracle exactly")
            s_got = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, r.path)
            s_ref = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
            tol = score_tolerance_f64(T, s_ref)
            require(bool(np.isfinite(s_got)) and abs(s_got - s_ref) <= tol,
                    f"request {i}: f64 score {s_got} vs oracle {s_ref} (tol {tol})")
            verdict = (f"tie-equivalent ({int((r.path != oracle).sum())} positions, "
                       f"f64 score gap {abs(s_got - s_ref):.3g})")
        require(r.memory_bytes == want_mem,
                f"request {i}: memory {r.memory_bytes} != {want_mem}")
        require(r.path.shape == (T,) and bool(((r.path >= 0) & (r.path < K)).all()),
                f"request {i}: path out of range")
        print(f"request {i}: time_s {r.time_s:.6f}, "
              f"{K * K * T / r.time_s / 1e9:.2f} G updates/s, oracle {verdict}, "
              f"cpu decode {cpu.time_s:.2f} s, memory {r.memory_bytes}", flush=True)
    return launches


def main() -> None:
    device = device_phase()
    build_phase()

    from flash_viterbi_tpu_torch.models.generate import (make_sparse_hmm,
                                                         observations)

    hmm, y1 = make_sparse_hmm(**HEADLINE)
    requests = [y1] + [observations(HEADLINE["T"], HEADLINE["M"], seed=s)
                       for s in EXTRA_SEEDS]
    recs = kernel_phase(hmm, y1, device)
    gbps = hbm_read_gbps(device)
    Kp, steps = tables(hmm, 128, "cpu").Kp, HEADLINE["T"] - 1
    floor_ms = steps * Kp * Kp * 4 / (gbps * 1e9) * 1e3
    print(f"HBM read {gbps:.1f} GB/s measured; phase-1 floor at K={Kp}: "
          f"{steps} steps x {Kp * Kp * 4 / 2**20:.0f} MiB = {floor_ms:.3f} ms",
          flush=True)
    launches = slice_phase(hmm, requests, device, torch.device("cpu"))

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": recs[name]["max_abs_err"], "ms": recs[name]["ms"],
         "plain_ms": recs[name]["plain_ms"]} for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
