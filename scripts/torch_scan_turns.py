#!/usr/bin/env python3
"""Time the port's scan kernels of one checkout on the GPU, to compare two
checkouts in turns on one card.

    python3 scripts/torch_scan_turns.py [--scans-only] CHECKOUT [CHECKOUT ...]

It prints the card's name and power limit first.  For each CHECKOUT (a
directory holding ``flash_viterbi_tpu_torch``), in the order given, a fresh
process builds that checkout's kernels, prints each kernel whose ``ptxas``
report shows a spill, the registers and spill stores of every
``scan_persistent`` instantiation (as ``<LG, WITH_PTR, EMIT, PARTS>``,
PARTS 15, every part, where a checkout predates it: the production
instances and the scan-ablation probe's; the bf16-table instances, where
the checkout has them, as ``<LG, WITH_PTR, EMIT, PARTS, bf16>``) and the
length of its SASS (``cuobjdump -sass`` instructions), and of every
``step_block_kernel`` one (as ``<LG>``), where the checkout has those
kernels.  With
``--scans-only`` it then times the scans and the headline ``flash``,
``checkpoint`` and ``fused`` decodes alone (below).  Else it times
``maxplus_step_block`` at the sharded decode's shapes ((N, Ks, Kd) = (1,
3968, 3968), (16, 3968, 992), (1, 16384, 4096), and the (1, 1, 2) and (1,
2, 2) meshes' (1, 3968, 1984), (16, 3968, 1984), (8, 3968, 1984);
standard normal inputs drawn on the card) three ways: the median of 9
CUDA-event runs around one call each (the host's launch cost included),
the device time a call of chains of 20 queued behind a sleep of the card
(back to back, as a decode calls it), and the device time with L2 flushed
before each call.  Then the median of 9 CUDA-event runs of
``maxplus_scan`` (N=1, T'=255),
``maxplus_scan_emitgather`` (N=1, T'=255, the headline symbols) and
``maxplus_scan_deltas`` (N=16, T'=16) on the headline tables (K=3965
padded to 3968, M=50, prob=0.112, seed=1); where the checkout has the
bf16-table instances, the pointer scan (N=1, T'=255) and the deltas scan
(N=16, T'=16) in turns on the fp32 and the bf16 table (fp32, bf16, bf16,
fp32, the median of 9 each); the scan and the deltas scan at K=16384 (N=1
and N=16, T'=32, standard normal tables drawn on the card; the deltas scan
at N=16 on the bf16 table too, where the checkout has it), and the
headline ``flash`` (num_segments=16), ``checkpoint`` and
``fused`` decodes, the median of 5 decodes' ``time_s`` each after a
warmup; then, with the
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
import shutil
import statistics
import subprocess
import sys


SCAN = re.compile(r"scan_persistentILi(\d+)ELb(\d)ELNS_4EmitE(\d)E(?:Li(\d+)E)?"
                  r"(?:(13__nv_bfloat16)|f)?(Lb1E)?")


def scan_key(fn: str) -> str | None:
    """``<LG,WITH_PTR,EMIT,PARTS>`` of a mangled scan_persistent name, with
    ``,bf16`` before the ``>`` for a bf16-table instance (an fp32 one keys
    as in checkouts that have no table type) and ``,ring`` for a ring-route
    instance (the others key as in checkouts that have no ring)."""
    q = SCAN.search(fn)
    if not q:
        return None
    return "<{},{},{},{}{}{}>".format(*q.groups()[:3], q.group(4) or 15,
                                      ",bf16" if q.group(5) else "",
                                      ",ring" if q.group(6) else "")


def sass_lengths(lib: str) -> dict[str, int]:
    """Instructions of each scan_persistent instance in ``lib``'s SASS."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        key = scan_key(part.split(None, 1)[0])
        if key:
            out[key] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", part))
    return out


def time_checkout(root: str, scans_only: bool = False) -> None:
    sys.path.insert(0, root)
    import torch

    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.runtime import build

    dev = torch.device("cuda", 0)
    build.kernels()
    fn = None
    kernels = {"scan_persistent": {}, "step_block_kernel": {}, "beam_cluster_kernel": {},
               "fold": {}}
    with open(build.BUILD_LOG) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
            fn = m.group(1) if m else fn
            if "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"  spill in {fn}: {line.strip().split('ptxas info    : ')[-1]}")
            q = scan_key(fn or "")
            b = re.search(r"step_block_kernelILi(\d+)E", fn or "")
            c = re.search(r"(beam_cluster_kernel|fold_cluster_kernel|fold_kernel)"
                          r"((?:IL[bi]\d+E(?:L[bi]\d+E)*E)?)", fn or "")
            if q:
                name, key = "scan_persistent", q
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
    print("  SASS scan_persistent " + "; ".join(
        f"{k}: {n} instructions" for k, n in sorted(sass_lengths(build.KERNELS_SO).items())),
        flush=True)
    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    lh = hmm.log(device=dev).padded(128)
    e = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=dev)].contiguous()
    scan_in = (lh.logA, e[1:].unsqueeze(1), (lh.logPi + e[0])[None].contiguous())
    d16 = (lh.logA[torch.arange(16, device=dev) * 200] + e[0]).contiguous()
    deltas_in = (lh.logA, e[1:17].unsqueeze(1).expand(16, 16, -1).contiguous(), d16)
    eg_in = (lh.logA, lh.logB.t().contiguous(),
             torch.as_tensor(y[1:], dtype=torch.int32, device=dev)[:, None].contiguous(),
             scan_in[2])

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

    import flash_viterbi_tpu_torch as fvt

    def decode_ms(yy, algorithm, **static) -> float:
        fvt.decode(hmm, yy, algorithm, device="cuda", **static)
        return statistics.median(fvt.decode(hmm, yy, algorithm, device="cuda", warmup=False,
                                            **static).time_s * 1e3 for _ in range(5))

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

    print(f"{root}: maxplus_scan N=1 T'=255 {ms(lambda: k.maxplus_scan(*scan_in)):.4f} ms; "
          f"maxplus_scan_emitgather N=1 T'=255 "
          f"{ms(lambda: k.maxplus_scan_emitgather(*eg_in)):.4f} ms; "
          f"maxplus_scan_deltas N=16 T'=16 {ms(lambda: k.maxplus_scan_deltas(*deltas_in)):.4f} ms",
          flush=True)
    bf16 = hasattr(k, "maxplus_scan_bf16")
    if bf16:
        table = {"fp32": lh.logA, "bf16": lh.logA.to(torch.bfloat16)}
        for label, fn, args in (("maxplus_scan N=1 T'=255", k.maxplus_scan, scan_in),
                                ("maxplus_scan_deltas N=16 T'=16", k.maxplus_scan_deltas,
                                 deltas_in)):
            runs = {"fp32": [], "bf16": []}
            for p in ("fp32", "bf16", "bf16", "fp32"):
                runs[p].append(ms(lambda: fn(table[p], *args[1:])))
            steps = args[1].shape[0]
            fp, bt = (statistics.mean(runs[p]) for p in ("fp32", "bf16"))
            print(f"{root}: {label} in turns: fp32 {fp:.4f} ms ({fp / steps * 1e3:.3f} us a "
                  f"step), bf16 {bt:.4f} ms ({bt / steps * 1e3:.3f} us a step), bf16/fp32 "
                  f"{bt / fp:.3f}; runs {runs}", flush=True)
        del table
    del e, scan_in, d16, deltas_in, eg_in
    g = torch.Generator(device=dev).manual_seed(16384)
    K, Tm = 16384, 32
    logA = torch.randn((K, K), generator=g, device=dev)
    big = {N: (logA, torch.randn((Tm, N, K), generator=g, device=dev),
               torch.randn((N, K), generator=g, device=dev)) for N in (1, 16)}
    print(f"{root}: K={K}, T'={Tm}: maxplus_scan N=1 "
          f"{ms(lambda: k.maxplus_scan(*big[1]), 5):.4f} ms; maxplus_scan_deltas N=1 "
          f"{ms(lambda: k.maxplus_scan_deltas(*big[1]), 5):.4f} ms; N=16 "
          f"{ms(lambda: k.maxplus_scan_deltas(*big[16]), 5):.4f} ms", flush=True)
    if bf16:
        half = logA.to(torch.bfloat16)
        print(f"{root}: K={K}, T'={Tm}, bf16 table: maxplus_scan N=1 "
              f"{ms(lambda: k.maxplus_scan(half, *big[1][1:]), 5):.4f} ms; maxplus_scan_deltas "
              f"N=16 {ms(lambda: k.maxplus_scan_deltas(half, *big[16][1:]), 5):.4f} ms",
              flush=True)
        del half
    del logA, big
    torch.cuda.empty_cache()
    print(f"{root}: decodes, median of 5: flash {decode_ms(y, 'flash', num_segments=16):.3f} ms; "
          f"checkpoint {decode_ms(y, 'checkpoint'):.3f} ms; fused {decode_ms(y, 'fused'):.3f} ms",
          flush=True)
    if scans_only:
        return

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
    del flush, step_in, lh

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

    from flash_viterbi_tpu_torch.models.generate import observations

    long_y = observations(16384, 50, seed=1)
    print(f"{root}: decodes, median of 5: flash_bs "
          f"{decode_ms(y, 'flash_bs', beam_width=64, num_segments=8):.3f} ms; beam "
          f"{decode_ms(y, 'beam', beam_width=64):.3f} ms; lean "
          f"{decode_ms(y, 'flash', mode='lean', num_segments=16):.3f} ms; sieve_mp "
          f"{decode_ms(y, 'sieve_mp'):.3f} ms; lean T=16384 "
          f"{decode_ms(long_y, 'flash', mode='lean', num_segments=16):.3f} ms", flush=True)


def main() -> None:
    args = sys.argv[1:]
    scans_only = "--scans-only" in args
    args = [a for a in args if a != "--scans-only"]
    if len(args) > 1 and args[0] == "--one":
        time_checkout(os.path.abspath(args[1]), scans_only)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                       + (["--scans-only"] if scans_only else []), check=True)


if __name__ == "__main__":
    main()
