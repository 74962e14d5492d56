#!/usr/bin/env python3
"""How many of its kernels a torch.profiler session records, against the
launches the process made before it, on one NVIDIA GPU.

    python3 scripts/torch_profiler_records.py [--rounds 5]

Builds the kernels, puts the headline tables on the card (K=3965 padded
to 3968, T=256, request 0 of ``chip_smoke.py``), and profiles three fused
decodes a session, four sessions at a time: first in the fresh process,
then after each of ``--rounds`` ``decode(..., "sieve_bs", beam_width=32)``
calls, each with its warmup (~50k launches a decode by torch.profiler in
``chip_smoke.py``, no hand kernel).  Prints the card's name and power
limit first, then one JSON line a set of sessions: the kernels each
session recorded.  Why ``chip_smoke.py`` runs its launch-heavy decodes
after its in-process profiler sessions, and its device trace in a fresh
process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SESSIONS = 4
DECODES = 3  # fused decodes a session


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the script needs the card")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.runtime import build as kernels
    from flash_viterbi_tpu_torch.utils.profiling import device_rows

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip(),
          flush=True)
    device = torch.device("cuda", 0)
    kernels.kernels()
    hmm, requests = chip_smoke.headline()
    y = requests[0]
    lh = chip_smoke.tables(hmm, 128, device)
    yd = torch.as_tensor(y.astype(np.int64), device=device)
    fused = build("fused")
    fused(lh.logA, lh.logB, lh.logPi, yd)
    torch.cuda.synchronize(device)

    def sessions(label: str) -> None:
        counts = []
        for _ in range(SESSIONS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(DECODES):
                    fused(lh.logA, lh.logB, lh.logPi, yd)
                torch.cuda.synchronize(device)
            counts.append(sum(e.count for e in device_rows(prof)))
        print(json.dumps({"after": label, "fused_decodes_a_session": DECODES,
                          "kernels_a_session": counts}), flush=True)

    sessions("a fresh process")
    for i in range(args.rounds):
        decode(hmm, y, "sieve_bs", beam_width=32, device=device)
        sessions(f"{i + 1} sieve_bs decodes with their warmups")


if __name__ == "__main__":
    main()
