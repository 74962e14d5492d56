#!/usr/bin/env python3
"""Config-5's full shape through ``flash_long`` on one NVIDIA GPU.

    python3 scripts/torch_longform.py [--batch 8] [--segments 4] [--T 65536]

Config-5 (``BENCHMARK``'s K=16384, M=50, prob=0.112, seed=1, T=65536) through
the port's ``flash_long``: one sequence by ``flash_decode_long``, then a
batch of ``--batch`` sequences (the seed-1 sequence first, then
``observations(T, 50, seed=s)``) by ``flash_decode_long_batched`` at two
phase-2 budgets, ``PHASE2_BYTES`` (6 GiB) and 24 GiB.  Each decode prints
its time by CUDA events, split into phase 1 (A and B for the batch) and
phase 2, and its peak allocation above the tables beside ``memory:`` (flash
pointer mode's at the segments).  The batch's first row must equal the
single decode, and both batches must be equal, bit for bit; every path
has a finite fp32 score.  Prints the card's name and power limit first and
one JSON line last.  Needs the card (about 4 GiB of pointer rows for the
single decode, up to ~30 GiB for the batch at the 24 GiB budget).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flash_viterbi_tpu_torch.algorithms import longform  # noqa: E402
from flash_viterbi_tpu_torch.algorithms.flash import _memory  # noqa: E402
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations  # noqa: E402
from flash_viterbi_tpu_torch.ops import maxplus as mp  # noqa: E402
from flash_viterbi_tpu_torch.runtime import build  # noqa: E402

CONFIG5 = dict(K=16384, M=50, prob=0.112, seed=1)
BUDGETS = (longform.PHASE2_BYTES, 24 * 2**30)


class PhaseClock:
    """CUDA events at the start and end of each ``longform._phase2`` call,
    and before each carry-history scan call (the batched decode's phase A
    is its first len(groups) scans)."""

    def __init__(self):
        self.phase2, self.scans = [], []
        self._phase2, self._scan = longform._phase2, longform.maxplus_scan_deltas

        def phase2(*args, **kw):
            start = self._event()
            out = self._phase2(*args, **kw)
            self.phase2.append((start, self._event()))
            return out

        def scan(*args, **kw):
            self.scans.append(self._event())
            return self._scan(*args, **kw)

        longform._phase2, longform.maxplus_scan_deltas = phase2, scan

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def reset(self):
        self.phase2.clear()
        self.scans.clear()


def timed(fn, device):
    """(result, start and end events, peak bytes above what was allocated
    before) of one call of ``fn``."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = PhaseClock._event()
    out = fn()
    end = PhaseClock._event()
    end.synchronize()
    return out, start, end, torch.cuda.max_memory_allocated(device) - before


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--T", type=int, default=65536)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the script needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    T, N, K = args.T, args.segments, CONFIG5["K"]
    t0 = time.perf_counter()
    hmm, y = make_sparse_hmm(**CONFIG5, T=T)
    lh = hmm.log(device="cpu")  # K=16384: no padding
    ys = np.stack([y] + [observations(T, CONFIG5["M"], seed=s) for s in range(2, args.batch + 1)])
    del hmm
    logA, logB, logPi = (t.to(device) for t in (lh.logA, lh.logB, lh.logPi))
    yd = torch.as_tensor(ys.astype(np.int64), device=device)
    print(f"tables K={K}, T={T}, {len(ys)} sequences made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    build.kernels()
    logAT = logA.t().contiguous()
    clock = PhaseClock()
    record = {"card": card, "K": K, "T": T, "segments": N, "group_steps": longform.GROUP_STEPS,
              "memory": _memory(K=K, T=T, num_segments=N)}

    def score(path, b):
        return float(mp.path_score(logA, logB, logPi, yd[b], path))

    single, s0, s1, peak = timed(lambda: longform.flash_decode_long(
        logA, logB, logPi, yd[0], num_segments=N, transposed=lambda a: logAT), device)
    p2 = clock.phase2[0][0].elapsed_time(clock.phase2[0][1])
    total = s0.elapsed_time(s1)
    record["single"] = {"ms": total, "phase1_ms": total - p2, "phase2_ms": p2, "peak": peak,
                        "score": score(single, 0)}
    print(f"single sequence: {total:.1f} ms (phase 1 {total - p2:.1f}, phase 2 {p2:.1f}), "
          f"{K * K * T / total / 1e6:.2f} G updates/s, peak +{peak} bytes ({peak / 2**30:.2f} "
          f"GiB) above the tables against memory: {record['memory']}; fp32 score "
          f"{record['single']['score']}", flush=True)
    first = single.cpu().numpy()
    del single
    groups = len(longform._groups(T - 1, longform.GROUP_STEPS))
    paths = []
    for budget in BUDGETS:
        longform.PHASE2_BYTES = budget
        clock.reset()
        torch.cuda.empty_cache()
        batch, b0, b1, peak = timed(lambda: longform.flash_decode_long_batched(
            logA, logB, logPi, yd, num_segments=N, transposed=lambda a: logAT), device)
        total = b0.elapsed_time(b1)
        a_ms = b0.elapsed_time(clock.scans[groups])
        b_ms = clock.scans[groups].elapsed_time(clock.phase2[0][0])
        p2 = sum(s.elapsed_time(e) for s, e in clock.phase2)
        subs = len(clock.phase2)
        scores = [score(batch[b], b) for b in range(len(ys))]
        if not all(np.isfinite(scores)):
            sys.exit(f"batch at {budget} bytes: path scores {scores}")
        paths.append(batch.cpu().numpy())
        record[f"batch_{budget}"] = {"ms": total, "phaseA_ms": a_ms, "phaseB_ms": b_ms,
                                     "phase2_ms": p2, "phase2_sub_batches": subs, "peak": peak,
                                     "scores": scores}
        print(f"batch of {len(ys)}, phase-2 budget {budget / 2**30:.0f} GiB ({subs} sub-batches): "
              f"{total:.1f} ms ({total / len(ys):.1f} a sequence; phase A {a_ms:.1f}, phase B "
              f"{b_ms:.1f}, phase 2 {p2:.1f}), {K * K * T * len(ys) / total / 1e6:.2f} G "
              f"updates/s, peak +{peak} bytes ({peak / 2**30:.2f} GiB) above the tables against "
              f"memory: {len(ys) * record['memory']}; fp32 scores finite", flush=True)
        del batch
    if not (np.array_equal(paths[0], paths[1]) and np.array_equal(paths[0][0], first)):
        sys.exit("the batches differ from each other or from the single decode")
    print("the batch's first row equals the single decode, and the two budgets' batches are "
          "equal", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
