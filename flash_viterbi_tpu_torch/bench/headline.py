"""Headline benchmark: FLASH pointer-mode decode, K=3965, T=256 (paper config).

Counterpart of ``bench.py`` at the repository's root::

    python -m flash_viterbi_tpu_torch.bench.headline [--smoke] [--cpu]

Prints ONE JSON line with ``bench.py``'s keys: trellis updates (K²·T)/s
of one decode on one card, compared with the reference C SIEVE-Mp
baseline at the same config (672.6 s, 5.98 M updates/s, a CPU figure —
see BASELINE.md), with the path's exact parity against the native C
vanilla oracle.

Timing: ``wall_s`` is one decode's latency, the median of ``TIMED`` decodes
after a warmup, each timed with CUDA events on the card (``perf_counter``
on the CPU; ``algorithms.base.timed``).  ``chain_wall_s`` is the slope of
chains of ``K1`` and ``K2`` decodes (``bench.harness.marginal_time``),
which keeps the launch gaps between decodes and drops the fixed cost of a
synchronisation; ``chain_updates_per_s`` is its rate.

``--smoke`` runs a small problem (K=256, M=10, T=64, prob=0.2); ``--cpu``
decodes on the CPU with the kernels' plain versions.  Without ``--cpu``
the decode runs on the card, and the script fails where there is none.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

HEADLINE = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
SMOKE = dict(K=256, M=10, T=64, prob=0.2, seed=1)
BASELINE_UPDATES_PER_S = (3965.0**2 * 256.0) / 672.6  # C SIEVE-Mp, reference README.md:79
NUM_SEGMENTS = 16
TIMED = 5  # single decodes wall_s is the median of
K1, K2 = 1, 5  # chain lengths for the chain slope
SMOKE_K1, SMOKE_K2 = 1, 17  # a tiny decode: a longer chain clears the timer's noise


def run(smoke: bool = False, cpu: bool = False) -> dict:
    """Decode the headline (or smoke) problem with ``flash`` at 16 segments
    in pointer mode and return the JSON row."""
    from ..algorithms.base import build, check_observations, timed, upload
    from ..models.generate import make_sparse_hmm
    from ..models.hmm import resolve_device
    from ..oracle import native
    from .harness import device_name, marginal_time

    cfg = SMOKE if smoke else HEADLINE
    k1, k2 = (SMOKE_K1, SMOKE_K2) if smoke else (K1, K2)
    K, T = cfg["K"], cfg["T"]
    dev = resolve_device("cpu" if cpu else "cuda")
    print(f"# device: {device_name(dev)}", file=sys.stderr)

    hmm, y = make_sparse_hmm(**cfg)
    dec = build("flash", num_segments=NUM_SEGMENTS, mode="pointer")
    yv = check_observations(y, hmm.M)
    _, lh = upload(hmm, dev, 128)
    args = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(yv, device=dev))

    times = []
    for i in range(TIMED):
        out, secs, _ = timed(lambda: dec(*args), dev, warmup=i == 0)
        times.append(secs)
    wall = statistics.median(times)
    path = out.cpu().numpy()[:T]

    def make_chain(k):
        def chain():
            p = None
            for _ in range(k):
                p = dec(*args)
            return p
        return chain

    chain_wall = marginal_time(make_chain, k1, k2)

    want = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    parity = bool(np.array_equal(path, want))
    if not parity:
        print(f"# PARITY FAILURE: {int((path != want).sum())}/{T} mismatches",
              file=sys.stderr)

    updates_per_s = K * K * T / wall
    return {
        "metric": "trellis_updates_per_s",
        "value": updates_per_s,
        "unit": "updates/s",
        "vs_baseline": updates_per_s / BASELINE_UPDATES_PER_S,
        "wall_s": wall,
        "config": f"K={K},T={T},prob={cfg['prob']},flash N={NUM_SEGMENTS} mode=pointer",
        "exact_path_parity": parity,
        "device": device_name(dev),
        "wall_s_times": times,
        "chain_wall_s": chain_wall,
        "chain_updates_per_s": K * K * T / chain_wall,
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    row = run(smoke="--smoke" in argv, cpu="--cpu" in argv)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
