#!/usr/bin/env python3
"""Time the port's scan kernels of one checkout on the GPU, to compare two
checkouts in turns on one card.

    python3 scripts/torch_scan_turns.py CHECKOUT [CHECKOUT ...]

For each CHECKOUT (a directory holding ``flash_viterbi_tpu_torch``), in
the order given, a fresh process builds that checkout's kernels, prints
each kernel whose ``ptxas`` report shows a spill, and prints the median of
9 CUDA-event runs of ``maxplus_scan`` (N=1, T'=255) and
``maxplus_scan_deltas`` (N=16, T'=16) on the headline tables (K=3965
padded to 3968, M=50, prob=0.112, seed=1).  Pass the checkouts as A B B A
to read a change against its parent.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys


def time_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.runtime import build

    dev = torch.device("cuda", 0)
    build.kernels()
    fn = None
    with open(build.BUILD_LOG) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
            fn = m.group(1) if m else fn
            if "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  spill in {fn}: {line.strip().split('ptxas info    : ')[-1]}")
    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    lh = hmm.log(device=dev).padded(128)
    e = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=dev)].contiguous()
    scan_in = (lh.logA, e[1:].unsqueeze(1), (lh.logPi + e[0])[None].contiguous())
    d16 = (lh.logA[torch.arange(16, device=dev) * 200] + e[0]).contiguous()
    deltas_in = (lh.logA, e[1:17].unsqueeze(1).expand(16, 16, -1).contiguous(), d16)

    def ms(fn, reps: int = 9) -> float:
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    print(f"{root}: maxplus_scan N=1 T'=255 {ms(lambda: k.maxplus_scan(*scan_in)):.4f} ms; "
          f"maxplus_scan_deltas N=16 T'=16 {ms(lambda: k.maxplus_scan_deltas(*deltas_in)):.4f} ms",
          flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(os.path.abspath(sys.argv[2]))
        return
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main()
