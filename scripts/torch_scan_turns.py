#!/usr/bin/env python3
"""Time the port's scan kernels of one checkout on the GPU, to compare two
checkouts in turns on one card.

    python3 scripts/torch_scan_turns.py CHECKOUT [CHECKOUT ...]

It prints the card's name and power limit first.  For each CHECKOUT (a
directory holding ``flash_viterbi_tpu_torch``), in the order given, a fresh
process builds that checkout's kernels, prints each kernel whose ``ptxas``
report shows a spill, the registers and spill stores of every ``scan_step``
instantiation (as ``<L, WITH_PTR, EMIT, WRITE_HIST, KC>``, the last two at
their defaults 1, 256 where a checkout predates them; since the step block
left it, the scan-ablation probe's alone), of every ``scan_persistent``
one (as ``<LG, WITH_PTR, EMIT>``) and of every ``step_block_kernel`` one
(as ``<LG>``), where the checkout has those kernels.  It times
``maxplus_step_block`` at the sharded decode's shapes ((N, Ks, Kd) = (1,
3968, 3968), (16, 3968, 992), (1, 16384, 4096), and the (1, 1, 2) and (1,
2, 2) meshes' (1, 3968, 1984), (16, 3968, 1984), (8, 3968, 1984);
standard normal inputs drawn on the card) three ways: the median of 9
CUDA-event runs around one call each (the host's launch cost included),
the device time a call of chains of 20 queued behind a sleep of the card
(back to back, as a decode calls it), and the device time with L2 flushed
before each call.  Then the median of 9 CUDA-event runs of
``maxplus_scan`` (N=1, T'=255) and
``maxplus_scan_deltas`` (N=16, T'=16) on the headline tables (K=3965
padded to 3968, M=50, prob=0.112, seed=1), and of both at K=16384 (N=1 and
N=16, T'=32, standard normal tables drawn on the card); then, with the
checkout's own ``chip_smoke.py`` input helpers, ``beam_scan`` at flash_bs's
phase-1 shape (N=1, T'=255, B=64, 7 planes) and segment shape (8 ragged
lanes, T'=32) and at Kp=17000 (B=64, T'=4, values in halves drawn on the
card), and ``argmax_walk`` at flash's shape (16 ragged lanes, T'=16) and at
the recompute batch's (16 sequences, T'=255).  Then ``fold_planes`` at its
three decode shapes (lean phase 1's chunk and the round shape from the
checkout's ``chip_smoke.fold_inputs``, and ``sieve_mp``'s top level: the
last 128 pointer rows of the headline's N=1 scan folded into one identity
plane) the three ways the step block is timed, with a shared error word
where the checkout's wrapper takes one; the headline ``flash_bs``
(beam_width=64, num_segments=8), ``beam`` (beam_width=64), lean
(num_segments=16) and ``sieve_mp`` decodes and lean mode at T=16384 on the
headline tables, the median
of 5 decodes' ``time_s`` each after a warmup; and it prints the registers
and spills of the beam scan's and the fold's kernels.  Pass the
checkouts as A B B A to read a change against its parent.
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
    kernels = {"scan_step": {}, "scan_persistent": {}, "step_block_kernel": {},
               "beam_cluster_kernel": {}, "fold": {}}
    with open(build.BUILD_LOG) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
            fn = m.group(1) if m else fn
            if "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  spill in {fn}: {line.strip().split('ptxas info    : ')[-1]}")
            t = re.search(r"scan_stepILi(\d+)ELb(\d)ELNS_4EmitE(\d)E(?:Lb(\d)ELi(\d+)E)?", fn or "")
            q = re.search(r"scan_persistentILi(\d+)ELb(\d)ELNS_4EmitE(\d)E", fn or "")
            b = re.search(r"step_block_kernelILi(\d+)E", fn or "")
            c = re.search(r"(beam_cluster_kernel|fold_cluster_kernel|fold_kernel)"
                          r"((?:IL[bi]\d+E(?:L[bi]\d+E)*E)?)", fn or "")
            if t:
                L, ptr, emit, write_hist, kc = t.groups()
                name, key = "scan_step", f"<{L},{ptr},{emit},{write_hist or 1},{kc or 256}>"
            elif q:
                name, key = "scan_persistent", "<{},{},{}>".format(*q.groups())
            elif b:
                name, key = "step_block_kernel", f"<{b.group(1)}>"
            elif c:
                name = "beam_cluster_kernel" if c.group(1).startswith("beam") else "fold"
                key = c.group(1) + "<{}>".format(",".join(re.findall(r"L[bi](\d+)E", c.group(2))))
            else:
                continue
            r = re.search(r"Used (\d+) registers|(\d+) bytes spill stores", line)
            if r:
                kernels[name].setdefault(key, ["?", "?"])[0 if r.group(1) else 1] = (
                    r.group(1) or r.group(2))
    for name, found in kernels.items():
        if found:
            print(f"  ptxas {name} " + "; ".join(f"{k}: {v[0]} registers, {v[1]} B spilled"
                                                 for k, v in sorted(found.items())))
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

    def cold(fn, flush, reps: int = 9) -> float:
        """Device time of a call after ``flush`` is overwritten, the runs
        queued behind a sleep of the card so the host's launch is hidden."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        events = []
        for _ in range(reps):
            flush.fill_(0.0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def queued(fn, k: int = 20, reps: int = 5) -> float:
        """Device time a call: chains of k calls queued behind a sleep of the
        card, so they run back to back while the host enqueues them."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(40_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / k)
        return statistics.median(times)

    flush = torch.empty(32 * 2**20, device=dev)  # 128 MiB, more than the 50 MB L2
    gs = torch.Generator(device=dev).manual_seed(992)
    for N, Ks, Kd in ((1, 3968, 3968), (16, 3968, 992), (1, 16384, 4096), (1, 3968, 1984),
                      (16, 3968, 1984), (8, 3968, 1984)):
        step_in = (torch.randn((N, Ks), generator=gs, device=dev),
                   torch.randn((Ks, Kd), generator=gs, device=dev))
        timed = ms(lambda: k.maxplus_step_block(*step_in))
        warm = queued(lambda: k.maxplus_step_block(*step_in))
        flushed = cold(lambda: k.maxplus_step_block(*step_in), flush)
        print(f"{root}: maxplus_step_block ({N}, {Ks}, {Kd}) {timed:.4f} ms a timed call, "
              f"{warm:.4f} ms of device time back to back (queued), {flushed:.4f} ms with L2 "
              f"flushed", flush=True)
    del flush, step_in
    print(f"{root}: maxplus_scan N=1 T'=255 {ms(lambda: k.maxplus_scan(*scan_in)):.4f} ms; "
          f"maxplus_scan_deltas N=16 T'=16 {ms(lambda: k.maxplus_scan_deltas(*deltas_in)):.4f} ms",
          flush=True)
    del lh, e, scan_in, d16, deltas_in
    g = torch.Generator(device=dev).manual_seed(16384)
    K, Tm = 16384, 32
    logA = torch.randn((K, K), generator=g, device=dev)
    big = {N: (logA, torch.randn((Tm, N, K), generator=g, device=dev),
               torch.randn((N, K), generator=g, device=dev)) for N in (1, 16)}
    print(f"{root}: K={K}, T'={Tm}: maxplus_scan N=1 "
          f"{ms(lambda: k.maxplus_scan(*big[1]), 5):.4f} ms; maxplus_scan_deltas N=1 "
          f"{ms(lambda: k.maxplus_scan_deltas(*big[1]), 5):.4f} ms; N=16 "
          f"{ms(lambda: k.maxplus_scan_deltas(*big[16]), 5):.4f} ms", flush=True)
    del logA, big
    torch.cuda.empty_cache()

    import chip_smoke as cs
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    lh = hmm.log(device=dev).padded(128)
    phase1 = cs.beam_inputs(lh, y, dev)
    segment = cs.beam_segment_inputs(lh, y, dev, seed=2)
    Kb = 17000
    logA = torch.round(torch.randn((Kb, Kb), generator=g, device=dev) * 2) / 2
    emits = torch.round(torch.randn((4, 1, Kb), generator=g, device=dev))
    large = (logA, emits, *beam_topk(torch.round(torch.randn((1, Kb), generator=g,
                                                              device=dev)), 64))
    print(f"{root}: beam_scan phase-1 {ms(lambda: k.beam_scan(*phase1)):.4f} ms; segment "
          f"{ms(lambda: k.beam_scan(*segment)):.4f} ms; Kp={Kb}, T'=4 "
          f"{ms(lambda: k.beam_scan(*large), 5):.4f} ms", flush=True)
    del logA, emits, large
    torch.cuda.empty_cache()
    logAT = lh.logA.t().contiguous()
    _, deltas_in, valid = cs.phase_inputs(lh, y, dev, seed=0)
    dfin, deltas = k.maxplus_scan_deltas(*deltas_in)
    flash_walk = (deltas, logAT, mp.first_argmax(dfin, 1)[1], valid)
    batch_in = cs.batch_inputs(lh, cs.batch_seqs()[:16], dev)[0]
    dfin, deltas16 = k.maxplus_scan_deltas(*batch_in)
    batch_walk = (deltas16, logAT, mp.first_argmax(dfin, 1)[1], None)
    print(f"{root}: argmax_walk flash shape {ms(lambda: k.argmax_walk(*flash_walk)):.4f} ms; "
          f"N=16, T'=255 {ms(lambda: k.argmax_walk(*batch_walk)):.4f} ms", flush=True)
    del logAT, deltas_in, valid, dfin, deltas, flash_walk, batch_in, deltas16, batch_walk

    import functools
    import inspect

    from flash_viterbi_tpu_torch.ops.cuda.maxplus import error_word

    fold = k.fold_planes
    if "err" in inspect.signature(fold).parameters:
        fold = functools.partial(fold, err=error_word(dev))
    phase1, rnd = cs.fold_inputs(lh, y, dev)[:2]
    _, ptrs = k.maxplus_scan(*cs.phase_inputs(lh, y, dev, seed=0)[0])
    top = (torch.arange(lh.Kp, dtype=torch.int32, device=dev)[None].contiguous(),
           ptrs[-128:].contiguous(), torch.ones((128, 1), dtype=torch.bool, device=dev))
    flush = torch.empty(32 * 2**20, device=dev)
    for label, args in (("phase-1 chunk", phase1), ("round shape", rnd),
                        ("sieve_mp top level", top)):
        print(f"{root}: fold_planes {label} (P={args[0].shape[0]}, c={args[1].shape[0]}, "
              f"R={args[1].shape[1]}) {ms(lambda: fold(*args)):.4f} ms a timed call, "
              f"{queued(lambda: fold(*args)):.4f} ms of device time back to back (queued), "
              f"{cold(lambda: fold(*args), flush):.4f} ms with L2 flushed", flush=True)
    del flush

    import flash_viterbi_tpu_torch as fvt
    from flash_viterbi_tpu_torch.models.generate import observations

    def decode_ms(yy, algorithm, **static) -> float:
        fvt.decode(hmm, yy, algorithm, device="cuda", **static)
        return statistics.median(fvt.decode(hmm, yy, algorithm, device="cuda", warmup=False,
                                            **static).time_s * 1e3 for _ in range(5))

    long_y = observations(16384, 50, seed=1)
    print(f"{root}: decodes, median of 5: flash_bs "
          f"{decode_ms(y, 'flash_bs', beam_width=64, num_segments=8):.3f} ms; beam "
          f"{decode_ms(y, 'beam', beam_width=64):.3f} ms; lean "
          f"{decode_ms(y, 'flash', mode='lean', num_segments=16):.3f} ms; sieve_mp "
          f"{decode_ms(y, 'sieve_mp'):.3f} ms; lean T=16384 "
          f"{decode_ms(long_y, 'flash', mode='lean', num_segments=16):.3f} ms", flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(os.path.abspath(sys.argv[2]))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main()
