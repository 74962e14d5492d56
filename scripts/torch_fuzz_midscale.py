"""Randomized drive of the PyTorch port's decoders through its CUDA kernels.

The port's counterpart of ``scripts/fuzz_midscale.py`` and
``scripts/fuzz_hunt.py``: random problems, drawn from a seed as those
scripts draw them, through the public ``decode`` / ``decode_batch`` on the
card, each path held to the C vanilla oracle, the f32 FLASH mirror's
arbitration (``oracle.validate``) or a numpy mirror (``oracle.framework``,
``oracle.sieve``).  Regimes (``--regime``):

* ``midscale`` (default 40 rounds from seed0 90000): K 128-512, T
  128-1024, the fp32 tie-flip regime.  vanilla, checkpoint and fused equal
  the C oracle; flash pointer and lean equal it or pass the tie-flip
  arbitration; at seed % 4 == 0 flash_bs and beam equal their mirrors; at
  seed % 5 == 0 and T <= 256 sieve_mp its f32 oracle; at seed % 3 == 0 a
  fused batch of two sequences equals the per-sequence decodes under both
  pointer modes; at seed % 2 == 0 fused and flash at precision="bf16"
  equal the fp32 decode of the table rounded to bfloat16 (padded to 128
  and unpadded).
* ``small`` (150 rounds from seed0 50000): K 8-139, T 2-79 and a random
  ``pad_to`` of 1, 8 or 128: the exact family and auto (flash, flash_bs
  and beam arbitrated), flash_bs at the drawn beam, sieve_bs_mp, sieve_bs
  and sieve_mp against their mirrors.
* ``wide`` (24 rounds from seed0 70000): K 513-4608, T 64-256, segments
  4, 8 or 16, where the scan's plan, the bf16 tile copy and the beam's
  cluster change; midscale's checks but sieve_mp.  The C oracle runs in
  worker processes beside the card's decodes.

Every draw prints one line: its parameters, its failures and what it
reached on the card (the persistent scan's plans, the bf16 tile copy's
path and whether the wrapper copied a misaligned table, the beam scan's
cluster size, the fold's cluster size); the run ends with the distinct
plans seen and a ``DONE:`` line.  Any exception fails its draw and the run
goes on, but a CUDA error, which leaves the context unusable, stops the run
at that draw.  Imports only the port and numpy, never JAX::

    python3 scripts/torch_fuzz_midscale.py [n_rounds] [seed0] [--regime R]
        [--device cuda|cpu]

``--device cpu`` runs the kernels' plain versions; without a card the
default is an error, not the CPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REGIMES = {"midscale": (40, 90_000), "small": (150, 50_000), "wide": (24, 70_000)}
WIDE_WORKERS = 3          # C-oracle worker processes of a wide run
WORKER_THREADS = 2


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def is_cuda_error(e: BaseException) -> bool:
    """An error that leaves the CUDA context unusable for the rest of the
    process (a kernel fault), as opposed to a refusal or a mismatch."""
    return "CUDA error" in str(e) or type(e).__name__ == "AcceleratorError"


def problem(regime: str, seed: int):
    """(the draw's parameters, the RandomState to draw the rest from): the
    first draws of ``fuzz_midscale.py:59-66`` (midscale), ``fuzz_hunt.py:
    44-52`` (small) or the wide regime's."""
    rng = np.random.RandomState(seed)
    if regime == "midscale":
        p = dict(K=int(rng.randint(128, 513)), M=int(rng.randint(8, 51)),
                 T=int(rng.choice([128, 256, 512, 1024])), prob=float(rng.uniform(0.05, 0.3)),
                 segs=int(rng.choice([4, 6, 8])))
    elif regime == "small":
        K = int(rng.randint(8, 140))
        p = dict(K=K, M=int(rng.randint(2, 20)), T=int(rng.randint(2, 80)),
                 prob=float(rng.uniform(0.05, 0.8)))
        p["bw"] = int(rng.randint(2, max(3, K // 2)))
        p["segs"] = int(rng.randint(2, 9))
    elif regime == "wide":
        p = dict(K=int(rng.randint(513, 4609)), T=int(rng.choice([64, 128, 256])),
                 M=int(rng.randint(8, 51)), prob=float(rng.uniform(0.05, 0.3)),
                 segs=int(rng.choice([4, 8, 16])))
    else:
        raise ValueError(f"unknown regime {regime!r}; have {sorted(REGIMES)}")
    return p, rng


def make(p: dict, seed: int):
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # rows with no edge are NaN on purpose
        return make_sparse_hmm(K=p["K"], M=p["M"], T=p["T"], prob=p["prob"], seed=seed)


def oracle_path(regime: str, seed: int) -> np.ndarray:
    """The C vanilla oracle's path of the draw (a worker's job)."""
    from flash_viterbi_tpu_torch.oracle import native

    hmm, y = make(problem(regime, seed)[0], seed)
    return native.vanilla(hmm.A, hmm.B, hmm.Pi, y)


class Coverage:
    """What the card's decodes reached, read at the kernels' wrappers:
    each persistent-scan launch's plan (``launch_scan``), the bf16 tile
    copy's path over that plan's tiles (4-byte pairs where K, the tile's
    first column and the stride are even, else 2-byte copies; only tiles
    with rows in shared memory copy), whether the bf16 wrapper copied a
    misaligned table (``_bf16_table``), the beam scan's cluster size C and
    the fold's cluster size G (their ``_card_plan``).  ``install`` wraps
    those functions in their modules and ``uninstall`` puts them back;
    ``take`` returns and clears a draw's record and adds it to the totals."""

    KEYS = ("scan", "bf16_tile", "bf16_table", "beam_C", "fold_G")

    def __init__(self):
        self.draw = {k: Counter() for k in self.KEYS}
        self.total = {k: Counter() for k in self.KEYS}
        self.draws_with = {k: Counter() for k in self.KEYS}
        self._undo = []

    @staticmethod
    def scan_key(plan, K: int) -> str:
        """A plan's shape, not its K: lanes x columns a thread, column
        groups (and whether a block walks several tiles), how a tile's rows
        are held, the combine, the table's element size and the streamed
        rows' load.  The source ranges, which follow K, are left out."""
        rows = ("smem" if plan.rows_streamed == 0 else
                "streamed" if plan.rows_smem == 0 else "smem+streamed")
        several = "+multi" if plan.R * plan.C > plan.blocks else ""
        load = "vec" if K % plan.cols == 0 else "clamped"
        return (f"L{plan.lanes}c{plan.cols}/C{plan.C}{several}/{rows}/"
                f"{'2ph' if plan.two_phase else '1ph'}/{'bf16' if plan.elem_bytes == 2 else 'f32'}"
                f"/{load}")

    @staticmethod
    def bf16_paths(plan, K: int) -> set:
        if plan.elem_bytes != 2 or plan.rows_smem == 0:
            return set()
        return {"pairs" if ((K | c0 | plan.stride) & 1) == 0 else "2-byte"
                for c0 in plan.col_edges[:-1]}

    def install(self) -> "Coverage":
        from flash_viterbi_tpu_torch.ops.cuda import beam, fold
        from flash_viterbi_tpu_torch.ops.cuda import maxplus as mx

        launch_scan, bf16_table = mx.launch_scan, mx._bf16_table
        beam_plan, fold_plan = beam._card_plan, fold._card_plan

        def on_scan(fn_name, counter, inputs, delta0, hist, plan, err, *extra):
            K = delta0.shape[1]
            self.draw["scan"][self.scan_key(plan, K)] += 1
            for path in self.bf16_paths(plan, K):
                self.draw["bf16_tile"][path] += 1
            return launch_scan(fn_name, counter, inputs, delta0, hist, plan, err, *extra)

        def on_bf16(logA):
            out = bf16_table(logA)
            self.draw["bf16_table"]["copied" if out is not logA else "aligned"] += 1
            return out

        def on_beam(*args):
            plan = beam_plan(*args)
            self.draw["beam_C"][f"C{plan.C}"] += 1
            return plan

        def on_fold(*args):
            plan = fold_plan(*args)
            self.draw["fold_G"][f"G{plan.G}"] += 1
            return plan

        self._undo = [(mx, "launch_scan", launch_scan), (mx, "_bf16_table", bf16_table),
                      (beam, "_card_plan", beam_plan), (fold, "_card_plan", fold_plan)]
        mx.launch_scan, mx._bf16_table = on_scan, on_bf16
        beam._card_plan, fold._card_plan = on_beam, on_fold
        return self

    def uninstall(self) -> None:
        for module, name, fn in self._undo:
            setattr(module, name, fn)
        self._undo = []

    def take(self) -> dict:
        got = {k: dict(v) for k, v in self.draw.items() if v}
        for k, v in self.draw.items():
            self.total[k].update(v)
            self.draws_with[k].update(set(v))
            v.clear()
        return got

    @staticmethod
    def line(rec: dict) -> str:
        if not rec:
            return "cover: none (plain versions)"
        parts = []
        for k in Coverage.KEYS:
            if rec.get(k):
                parts.append(f"{k} " + ",".join(sorted(rec[k])))
        return "cover: " + "; ".join(parts)

    def summary(self) -> str:
        out = [f"{len(self.total['scan'])} distinct scan plans"]
        for k in self.KEYS:
            seen = ", ".join(f"{key} ({self.draws_with[k][key]} draws)"
                             for key in sorted(self.total[k]))
            out.append(f"{k}: {seen or 'none'}")
        return "COVERAGE: " + "; ".join(out)


def draw_line(d: "Draw", rec: dict, secs: float) -> str:
    """A draw's line: its verdict, parameters, tie flips and coverage."""
    return (f"{'FAIL ' + str(len(d.failures)) if d.failures else 'ok'} {d.ctx}"
            f"{' flips=' + ','.join(d.flips) if d.flips else ''} {Coverage.line(rec)} "
            f"{secs:.1f} s")


class Draw:
    """One draw's checks: failures and tie flips, printed as they come."""

    def __init__(self, ctx: str):
        self.ctx = ctx
        self.failures: list[str] = []
        self.flips: list[str] = []

    def check(self, name: str, ok, extra: str = "") -> None:
        if not bool(ok):
            self.failures.append(f"{name}{' ' + extra if extra else ''}")
            print(f"FAIL {name}: {self.ctx}{' ' + extra if extra else ''}", flush=True)


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool((a == b).all())


def flash_verdict(hmm, y, path, segs: int) -> str | bool | None:
    from flash_viterbi_tpu_torch.oracle.validate import arbitrate_flash_tie_flip

    return arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, np.asarray(path), segs)


def arbitrated(hmm, y, path, segs: int) -> tuple[bool, object]:
    """``fuzz_midscale.py``'s rule for a flash path off vanilla: the tie-flip
    arbitration's "mirror-exact" or "tie-equivalent", or None where at most
    two effective segments leave no faithful mirror."""
    from flash_viterbi_tpu_torch.oracle.validate import effective_flash_segments

    verdict = flash_verdict(hmm, y, path, segs)
    ok = verdict in ("mirror-exact", "tie-equivalent") or (
        verdict is None and effective_flash_segments(len(y), segs) <= 2)
    return ok, verdict


def bf16_checks(d: Draw, hmm, y, segs: int, dev) -> None:
    """fused and flash (pointer) at precision="bf16" against the fp32
    decode of the same table rounded to bfloat16, padded to 128 and
    unpadded (odd K reaches the kernels' 2-byte paths)."""
    from flash_viterbi_tpu_torch import LogHMM, decode

    lh = hmm.log(device=dev)
    rounded = LogHMM(lh.logA.to(torch.bfloat16).float(), lh.logB, lh.logPi, lh.K)
    for pad in (128, 1):
        for alg, kw in (("fused", {}), ("flash", {"num_segments": segs})):
            got = decode(hmm, y, alg, pad_to=pad, warmup=False, device=dev,
                         precision="bf16", **kw).path
            want = decode(rounded, y, alg, pad_to=pad, warmup=False, device=dev, **kw).path
            d.check(f"bf16:{alg}:pad{pad}", same(got, want))


def beam_checks(d: Draw, hmm, y, bw: int, segs: int, dev, pad: int = 128) -> None:
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.oracle import framework as ofw

    T = len(y)
    r = decode(hmm, y, "flash_bs", beam_width=bw, num_segments=segs, pad_to=pad,
               warmup=False, device=dev)
    m = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, num_segments=segs)
    d.check("flash_bs-mirror", same(r.path, np.asarray(m)[:T]), f"bw={bw} pad={pad}")
    r = decode(hmm, y, "beam", beam_width=bw, pad_to=pad, warmup=False, device=dev)
    m = ofw.beam(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    d.check("beam-mirror", same(r.path, np.asarray(m)[:T]), f"bw={bw} pad={pad}")


def sieve_mp_check(d: Draw, hmm, y, dev, pad: int = 128) -> None:
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.oracle.sieve import sieve_mp

    r = decode(hmm, y, "sieve_mp", pad_to=pad, warmup=False, device=dev)
    m = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    d.check("sieve_mp-oracle", same(r.path, np.asarray(m)[:len(y)]), f"pad={pad}")


def midscale_round(d: Draw, regime: str, seed: int, p: dict, rng, hmm, y, want, dev) -> None:
    """``fuzz_midscale.py:68-138``'s checks on the port (the sharded one is
    ``torch_fuzz_sharded.py``'s), and the bf16 one."""
    from flash_viterbi_tpu_torch import decode, decode_batch

    T, segs = p["T"], p["segs"]
    for alg in ("vanilla", "checkpoint", "fused"):
        r = decode(hmm, y, alg, warmup=False, device=dev)
        d.check(f"exact:{alg}", same(r.path, want))
    for mode in ("pointer", "lean"):
        r = decode(hmm, y, "flash", num_segments=segs, mode=mode, warmup=False, device=dev)
        if same(r.path, want):
            continue
        ok, verdict = arbitrated(hmm, y, r.path, segs)
        d.flips.append(f"{mode}:{verdict}")
        d.check(f"flash:{mode}:arbitration", ok, f"verdict={verdict}")
    if seed % 4 == 0:
        beam_checks(d, hmm, y, int(rng.choice([16, 32, 64])), segs, dev)
    if regime == "midscale" and seed % 5 == 0 and T <= 256:
        sieve_mp_check(d, hmm, y, dev)
    if seed % 3 == 0:
        y2 = np.random.RandomState(seed + 1).randint(0, p["M"], size=T).astype(np.int32)
        p1 = decode(hmm, y, "fused", warmup=False, device=dev).path
        p2 = decode(hmm, y2, "fused", warmup=False, device=dev).path
        for pointers in ("store", "recompute"):
            rb = decode_batch(hmm, np.stack([np.asarray(y, np.int32), y2]), "fused",
                              pointers=pointers, warmup=False, device=dev)
            d.check(f"batch==per-seq:{pointers}", same(rb.path[0], p1) and same(rb.path[1], p2))
    if seed % 2 == 0:
        bf16_checks(d, hmm, y, segs, dev)


def small_round(d: Draw, seed: int, p: dict, rng, hmm, y, want, dev) -> None:
    """``fuzz_hunt.py:60-137``'s checks on the port (the sharded one is
    ``torch_fuzz_sharded.py``'s)."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms.auto import choose
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs
    from flash_viterbi_tpu_torch.oracle import framework as ofw

    K, T, bw, segs = p["K"], p["T"], p["bw"], p["segs"]
    pad = int(rng.choice([1, 8, 128]))
    d.ctx += f" pad={pad}"
    for alg, kw in [("vanilla", {}), ("checkpoint", {}), ("fused", {}),
                    ("flash", {"num_segments": segs}),
                    ("flash", {"num_segments": segs, "mode": "lean"}),
                    ("flash_bs", {"beam_width": K, "num_segments": segs}),
                    ("beam", {"beam_width": K}),
                    ("auto", {})]:
        r = decode(hmm, y, alg, pad_to=pad, warmup=False, device=dev, **kw)
        ok = same(r.path, want)
        if not ok:
            # the flash family may legitimately tie-flip against vanilla; a
            # full beam reorders tied states by score, and its contract is
            # its own mirror (fuzz_hunt.py:67-99)
            routed, rkw = (alg, kw) if alg != "auto" else choose(K, T)
            rkw = {**rkw, **kw}
            if routed == "flash":
                verdict = flash_verdict(hmm, y, r.path, rkw.get("num_segments", 8))
                if verdict is not None:
                    ok = bool(verdict)
                    d.flips.append(f"{alg}:{rkw.get('mode', 'pointer')}:{verdict}")
            elif routed == "flash_bs":
                m = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=rkw.get("beam_width", K),
                                 num_segments=rkw.get("num_segments", 8))
                ok = same(r.path, np.asarray(m)[:T])
            elif routed == "beam":
                m = ofw.beam(hmm.A, hmm.B, hmm.Pi, y, beam_width=rkw.get("beam_width", K))
                ok = same(r.path, np.asarray(m)[:T])
        d.check(f"exact:{alg}:{kw}", ok)
    r = decode(hmm, y, "flash_bs", beam_width=bw, num_segments=segs, pad_to=pad,
               warmup=False, device=dev)
    m = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, num_segments=segs)
    d.check("flash_bs-mirror", same(r.path, np.asarray(m)[:T]))
    r = decode(hmm, y, "sieve_bs_mp", beam_width=bw, pad_to=pad, warmup=False, device=dev)
    m = ofw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    d.check("sieve_bs_mp-mirror", same(r.path, np.asarray(m)[:T]))
    pairs = ofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    r = decode(hmm, y, "sieve_bs", beam_width=bw, pad_to=pad, warmup=False, device=dev)
    if pairs:
        d.check("sieve_bs-mirror", same(r.path, _flatten_pairs(pairs, T)))
    else:
        d.check("sieve_bs-mirror-empty", (np.asarray(r.path) == -1).all() or T == 1)
    sieve_mp_check(d, hmm, y, dev, pad)


def one_round(seed: int, regime: str = "midscale", device="cuda", oracle=None) -> Draw:
    """Draw ``seed`` of ``regime`` and run its checks on ``device``;
    ``oracle()``, if given, returns the C vanilla oracle's path (a worker
    made it), else it is made here.  Returns the draw's record."""
    p, rng = problem(regime, seed)
    ctx = f"seed={seed} " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in p.items())
    d = Draw(ctx)
    hmm, y = make(p, seed)
    if oracle is None:
        from flash_viterbi_tpu_torch.oracle import native

        want = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    else:
        want = oracle()
    dev = torch.device(device)
    if regime == "small":
        small_round(d, seed, p, rng, hmm, y, want, dev)
    else:
        midscale_round(d, regime, seed, p, rng, hmm, y, want, dev)
    return d


def _worker_init() -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(WORKER_THREADS)


def run(n_rounds: int, seed0: int, regime: str, device: str) -> int:
    """The run's loop; returns the exit code."""
    t_start = time.perf_counter()
    print(f"# torch_fuzz_midscale: regime {regime}, {n_rounds} rounds from seed0 {seed0}, "
          f"device {device}", flush=True)
    if device == "cuda":
        print(f"# card: {card_line()}", flush=True)
    cov = Coverage().install() if device == "cuda" else None
    seeds = [seed0 + i for i in range(n_rounds)]
    pool, futures = None, {}
    if regime == "wide":  # the C oracle beside the card's decodes
        pool = concurrent.futures.ProcessPoolExecutor(
            WIDE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
        futures = {s: pool.submit(oracle_path, regime, s) for s in seeds}
    failures, flip_rounds, verdicts = [], 0, Counter()
    try:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            oracle = futures[seed].result if futures else None
            try:
                d = one_round(seed, regime, device, oracle)
            except Exception as e:  # any exception fails the draw
                what = f"{type(e).__name__}: {e}"
                print(f"[{i}] FAIL seed={seed} {regime}: {what}", flush=True)
                traceback.print_exc()
                failures.append((seed, [what]))
                if is_cuda_error(e):
                    print(f"STOP: a CUDA error leaves the context unusable; draw seed={seed} "
                          f"regime={regime}", flush=True)
                    break
                if cov is not None:
                    cov.take()
                continue
            if d.failures:
                failures.append((seed, d.failures))
            if d.flips:
                flip_rounds += 1
                verdicts.update(v.rsplit(":", 1)[1] for v in d.flips)
            rec = cov.take() if cov is not None else {}
            print(f"[{i}] {draw_line(d, rec, time.perf_counter() - t0)}", flush=True)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    if cov is not None:
        print(cov.summary(), flush=True)
    print(f"DONE: {regime} {n_rounds} rounds from seed0 {seed0} on {device}: "
          f"{len(failures)} failed draws {failures}; {flip_rounds} rounds with flash tie "
          f"flips {dict(verdicts)}; {time.perf_counter() - t_start:.1f} s", flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rounds", nargs="?", type=int)
    ap.add_argument("seed0", nargs="?", type=int)
    ap.add_argument("--regime", choices=sorted(REGIMES), default="midscale")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_fuzz_midscale: no CUDA device (use --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 2
    n, s0 = REGIMES[args.regime]
    return run(args.n_rounds if args.n_rounds is not None else n,
               args.seed0 if args.seed0 is not None else s0, args.regime, args.device)


if __name__ == "__main__":
    sys.exit(main())
