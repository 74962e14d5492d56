#!/usr/bin/env python3
"""The rows ``algorithm="auto"``'s order comes from, on the GPU.

    python3 scripts/torch_auto_sweep.py [--csv-dir DIR] [--K 256,1024] [--T 16,256]

Runs the port's ``bench.harness.sweep`` over ``auto``'s candidates:
``fused``, ``checkpoint``, ``flash`` pointer at 8, 16 and 32 segments and
``flash`` lean at its default leaf (8 segments), at K in {256, 1024, 3965,
8192, 16384} x T in {16, 32, 256, 2048, 8192, 16384}, M=50, prob=0.112,
seed=1, on ``cuda``.  A cell is dropped when a candidate's
``auto.device_working_set`` exceeds 40 GiB.  Prints the card's name and
power limit first, then one row a run (the median time of the harness's
timed decodes, their least and most beside it), and writes the CSV (one file a
decoder) to ``--csv-dir``, by default the ignored ``.local/auto_sweep``.
Needs the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flash_viterbi_tpu_torch.algorithms.auto import device_working_set  # noqa: E402
from flash_viterbi_tpu_torch.bench.harness import RunConfig, sweep  # noqa: E402

KS = (256, 1024, 3965, 8192, 16384)
TS = (16, 32, 256, 2048, 8192, 16384)
# (label, algorithm, static keywords, segments): auto's candidates
CANDIDATES = (("fused", "fused", {}, 8), ("checkpoint", "checkpoint", {}, 8),
              ("flash N=8", "flash", {}, 8), ("flash N=16", "flash", {}, 16),
              ("flash N=32", "flash", {}, 32), ("flash lean", "flash", {"mode": "lean"}, 8))
MAX_WORKING_SET = 40 * 1024 ** 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv-dir", default=os.path.join(".local", "auto_sweep"))
    ap.add_argument("--K", default=",".join(map(str, KS)))
    ap.add_argument("--T", default=",".join(map(str, TS)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the sweep needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    for K in map(int, args.K.split(",")):
        Kp = -(-K // 128) * 128
        for T in map(int, args.T.split(",")):
            sets = {label: device_working_set(alg, {"num_segments": n, **kw}, Kp, T)
                    for label, alg, kw, n in CANDIDATES}
            if max(sets.values()) > MAX_WORKING_SET:
                print(f"K={K} T={T}: dropped, working sets {sets}", flush=True)
                continue
            for label, alg, kw, n in CANDIDATES:
                row = sweep([RunConfig(algorithm=alg, K=K, M=50, T=T, prob=0.112, seed=1,
                                       num_segments=n, extra=dict(kw))],
                            csv_dir=args.csv_dir, verbose=False)[0]
                print(f"{label:11s} K={K:<6d} T={T:<6d} time={row['time'] * 1e3:10.3f} ms "
                      f"({min(row['times']) * 1e3:.3f}-{max(row['times']) * 1e3:.3f})  "
                      f"{row['updates_per_s'] / 1e9:8.2f} G upd/s  working set "
                      f"{sets[label]}  parity={row['parity']}", flush=True)
    print(f"sweep: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
