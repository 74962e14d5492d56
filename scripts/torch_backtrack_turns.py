#!/usr/bin/env python3
"""Time the port's pointer walk (``backtrack_batched``) of one checkout or
several on the GPU, to compare them in turns on one card; or sweep its plans.

    python3 scripts/torch_backtrack_turns.py CHECKOUT [CHECKOUT ...]
    python3 scripts/torch_backtrack_turns.py --sweep [OUT.jsonl]

It prints the card's name and power limit first.  For each CHECKOUT (a
directory holding ``flash_viterbi_tpu_torch``), in the order given, a fresh
process builds that checkout's kernels and times ``backtrack_batched`` on
pointer tables drawn on the card from fixed seeds (every checkout gets the
same) at the main path's shapes (``SHAPES``: fused and flash at the
headline, fused at T=16384, checkpoint's segments at T=256 and T=16384,
beam, the store batches of 16 and 64, a ``flash_long`` group at K=16384)
two ways: the device time a call of chains of 20 queued behind a sleep of
the card (back to back, as a decode calls it) and the median of 9
CUDA-event runs around one call (the host's launch cost included), each
checked against the checkout's plain version once.  Then the headline ``fused`` and ``checkpoint`` decodes (K=3965
padded to 3968, M=50, prob=0.112, seed=1) at T=256 and T=16384
(``observations(16384, 50, seed=1)``), the median of 5 decodes'
``time_s`` each after a warmup.  Pass the checkouts as A B B A to read a
change against its parent.

``--sweep`` times this checkout's walk under every plan it can run at
``SWEEP_SHAPES`` (the serial walk, the card's plan, and chunked plans of L
rows from 4 to 512 and S slices in 1, 2, 4, 8, 16), device time back to
back, each held to the plain walk; one JSON line a plan, then a line a
shape that sets the card's plan beside the serial walk and the fastest
plan swept (``"summary"``), and a last line with the worst ratio of the
card's plan to the fastest; all of it to OUT.jsonl as well where given.
``backtrack_plan``'s rule is checked against these lines
(``results/torch_backtrack_sweep.jsonl``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = ((255, 1, 3968), (16383, 1, 3968), (16, 1, 3968), (15, 1, 3968), (256, 1, 3968),
          (255, 1, 64), (255, 16, 3968), (255, 64, 3968), (4096, 1, 16384))
SWEEP_SHAPES = tuple((Tm, 1, 3968) for Tm in (8, 16, 24, 32, 48, 64, 128, 255, 1024, 4096,
                                             16383)) + tuple(
    (255, N, 3968) for N in (2, 4, 8, 16, 32, 64)) + ((255, 1, 64), (1023, 1, 64),
                                                     (255, 16, 64), (4095, 1, 16384),
                                                     (16383, 4, 3968))
DECODE_T = (256, 16384)


def queued_ms(fn, k: int = 20, reps: int = 5) -> float:
    """Median milliseconds a call over chains of ``k`` calls queued behind
    a ~20 ms sleep of the card: the device's time a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(40_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def event_ms(fn, reps: int = 9) -> float:
    """Median milliseconds of ``reps`` CUDA-event runs around one call."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def table(Tm: int, N: int, K: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    ptrs = torch.randint(0, K, (Tm, N, K), generator=g, device="cuda", dtype=torch.int32)
    last = torch.randint(0, K, (N,), generator=g, device="cuda", dtype=torch.int32)
    return ptrs, last


def time_checkout(root: str) -> None:
    """Time ``root``'s walk at SHAPES and its decodes (module docstring)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.runtime import build

    t0 = time.perf_counter()
    build.kernels()
    print(f"checkout {root}: kernels loaded (built if stale) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    walk = kb.backtrack_batched
    for i, (Tm, N, K) in enumerate(SHAPES):
        ptrs, last = table(Tm, N, K, seed=100 + i)
        if not torch.equal(walk(ptrs, last), kb.backtrack_batched_plain(ptrs, last)):
            raise SystemExit(f"{root}: backtrack_batched differs from its plain version at "
                             f"{(Tm, N, K)}")
        q, e = queued_ms(lambda: walk(ptrs, last)), event_ms(lambda: walk(ptrs, last))
        plan = kb.backtrack_plan(Tm, N, K, 132) if hasattr(kb, "backtrack_plan") else None
        print(json.dumps({"checkout": root, "shape": [Tm, N, K], "queued_ms": q,
                          "event_ms": e, "plan": None if plan is None else plan._asdict()}),
              flush=True)
        del ptrs, last
    torch.cuda.empty_cache()
    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    for T in DECODE_T:
        yy = np.asarray(y if T == 256 else observations(T, 50, seed=1), dtype=np.int64)
        for name in ("fused", "checkpoint"):
            decode(hmm, yy, name, device="cuda")
            times = [decode(hmm, yy, name, device="cuda").time_s * 1e3 for _ in range(5)]
            print(json.dumps({"checkout": root, "decode": name, "T": T,
                              "time_ms": statistics.median(times), "runs_ms": times}),
                  flush=True)


def sweep(out: str | None, card_name: str) -> None:
    """Time every plan this checkout's walk can run at SWEEP_SHAPES on the
    card ``card_name`` (its name and power limit, the file's first line)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

    sms = sm_count(torch.device("cuda", 0))
    lines, summaries = [], []
    for i, (Tm, N, K) in enumerate(SWEEP_SHAPES):
        ptrs, last = table(Tm, N, K, seed=200 + i)
        want = kb.backtrack_batched_plain(ptrs, last)
        plans = {"serial": kb.serial_plan(Tm, N), "card": kb.backtrack_plan(Tm, N, K, sms)}
        for L in (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 512):
            for S in (1, 2, 4, 8, 16):
                if L < Tm:
                    try:
                        plans[f"L={L} S={S}"] = kb.backtrack_plan(Tm, N, K, sms, L=L, S=S)
                    except ValueError:
                        pass
        for label, plan in plans.items():
            got = kb.backtrack_batched(ptrs, last, plan=plan)
            if not torch.equal(got, want):
                raise SystemExit(f"{label} at {(Tm, N, K)} differs from the plain version")
            ms = queued_ms(lambda: kb.backtrack_batched(ptrs, last, plan=plan))
            line = {"shape": [Tm, N, K], "plan": label, **plan._asdict(), "ms": ms}
            lines.append(line)
            print(json.dumps(line), flush=True)
        shape = [line for line in lines if line["shape"] == [Tm, N, K]]
        best = min(shape, key=lambda line: line["ms"])
        card = next(line for line in shape if line["plan"] == "card")
        serial = next(line for line in shape if line["plan"] == "serial")
        line = {"summary": [Tm, N, K], "card": {f: card[f] for f in ("G", "L", "S")},
                "card_ms": card["ms"], "serial_ms": serial["ms"], "best": best["plan"],
                "best_ms": best["ms"], "card_over_best": card["ms"] / best["ms"],
                "card_over_serial": card["ms"] / serial["ms"]}
        summaries.append(line)
        print(json.dumps(line), flush=True)
        del ptrs, last, want
        torch.cuda.empty_cache()
    worst = max(summaries, key=lambda line: line["card_over_best"])
    tail = {"shapes": len(summaries), "plans": len(lines), "worst_card_over_best":
            worst["card_over_best"], "at": worst["summary"], "card_slower_than_serial": [
                line["summary"] for line in summaries
                if line["card"]["G"] > 1 and line["card_over_serial"] > 1]}
    print(json.dumps(tail), flush=True)
    if out:
        with open(out, "w") as f:
            f.writelines(json.dumps(line) + "\n"
                         for line in [{"card": card_name}] + lines + summaries + [tail])


def main() -> None:
    args = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args[:1] == ["--sweep"]:
        sweep(args[1] if len(args) > 1 else None, card)
        return
    if args[:1] == ["--child"]:
        time_checkout(args[1])
        return
    if not args:
        raise SystemExit(__doc__)
    for root in args:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              cwd=root)
        if proc.returncode:
            raise SystemExit(f"{root}: exit {proc.returncode}")


if __name__ == "__main__":
    main()
