#!/usr/bin/env python3
"""The rows the port's routing and chunk figures come from, on the GPU.

    python3 scripts/torch_route_sweep.py [--only FIGURE[,FIGURE...]] [--out OUT.jsonl]
    python3 scripts/torch_route_sweep.py --summarize IN.jsonl OUT.jsonl

One sub-sweep a figure (``FIGURES``), each forcing the figure's choices
through the modules' internals, never through an entry point's keyword:

* ``fused``: the single-sequence route, ``fused._walk(..., pointers=...)``
  "store" (pointer scan, ``backtrack_batched``) against "recompute"
  (carry-history scan, ``argmax_walk``), fp32, at ``FUSED_K`` x ``FUSED_T``.
* ``batch``: ``fused_decode_batch(..., pointers=...)``, both routes, at
  ``BATCH_BS`` x ``BATCH_K`` x ``BATCH_T`` (the batch of 64 at K >= 8192
  only at T=256).
* ``snapshot``: ``checkpoint_decode(..., step=s)`` at the steps of
  :func:`snapshot_steps` at ``SNAPSHOT_K`` x ``SNAPSHOT_T`` (K=16384 only
  up to T=4096: a decode there takes 2.9 s at T=4096, the step moves it by
  its launches alone, and T=16384 and 65536 would take 25 minutes).
* ``lean``: ``flash`` lean at 8 segments (``auto``'s candidate) under
  ``flash.LEAN_CHUNK``, ``flash.LEAF_LANES`` and ``lean_leaf``, each varied
  alone from the module's values (``LEAN_CHOICES``), patched in this
  process, at ``LEAN_K`` x ``LEAN_T`` less K=16384, T=16384 (~11 s a
  decode); each choice's peak above the tables beside ``lean_working_set``.
  Another leaf splits the sequence elsewhere, so its path may differ from
  the module's by an fp32 tie flip: it must then lie within
  ``dp_divergence_tolerance_f64`` of its f64 score (the row says which).
* ``sharded``: ``sharded._CHUNK``, ``_GROUP_BYTES`` and ``_EMIT_BYTES``,
  each varied alone (``SHARDED_CHOICES``), at config-5's cut (K=16384,
  T=4096, two sequences, one microbatch, 16 segments) on the (1, 1, 1)
  mesh in this process, and at the headline's four requests on (1, 1, 2)
  and (1, 2, 1) as gloo ranks on the one card (this script once a rank),
  each choice's peak beside its time.

Tables: ``make_sparse_hmm(K, M=50, prob=0.112, seed=1)`` (K=3968 is the
headline's K=3965 padded), padded to a multiple of 64; observations
``observations(T, 50, seed=s)``.  Timing: each choice is run once (its
warmup; where a peak is recorded, measured there), then the choices are
timed in turns, in order and then reversed (a, b, b, a), ``TURN_REPS``
decodes a turn, each decode between CUDA events after a synchronize: 6
decodes a choice.  A row a (figure, shape, choice): the median, every
decode's ms by turn, the spread (the larger of the least-to-most range of
its decodes and ``SPREAD_FLOOR`` of the median), the choice's device
working set (the formula where the module has one, else the measured
peak).  Then a line a (figure, shape): the fastest choice and every choice
within its spread (medians closer than the sum of the two choices'
spreads), and of those the one with the smallest working set.
``--summarize`` recomputes the spreads and those lines from the rows'
decodes (``turns_ms``), needing no card.  ``tests/
test_torch_routes.py`` holds each rule to ``results/torch_route_sweep.jsonl``.
Prints the card's name and power limit first.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flash_viterbi_tpu_torch.algorithms import checkpoint, flash, fused  # noqa: E402
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations  # noqa: E402
from flash_viterbi_tpu_torch.parallel import sharded  # noqa: E402

FIGURES = ("fused", "batch", "snapshot", "lean", "sharded")
M, PROB = 50, 0.112
TURN_REPS = 3

FUSED_K = (64, 256, 512, 1024, 1152, 1280, 1536, 1792, 2048, 2176, 2560, 3072, 3968)
FUSED_T = (32, 64, 128, 256, 2048, 16384)
BATCH_BS = (2, 3, 4, 5, 6, 8, 16, 32, 64)
BATCH_K = (64, 256, 512, 1024, 2048, 3968, 8192, 16384)
BATCH_T = (256, 2048)
# a spread no figure may rest on a gap below: the larger of the range of
# the choice's decodes and this share of its median, where a decode's
# tables land moving it by 2-4% across processes (PERF.md section 7)
SPREAD_FLOOR = 0.02
SNAPSHOT_K = (1024, 3968, 16384)
SNAPSHOT_T = (1024, 4096, 16384, 65536)
SNAPSHOT_MAX_T = {16384: 4096}
LEAN_K = (3968, 8192, 16384)
LEAN_T = (256, 2048, 16384)
LEAN_SKIP = ((16384, 16384),)
LEAN_SEGMENTS = 8
# (label, LEAN_CHUNK, LEAF_LANES, lean_leaf); None keeps the module's value
LEAN_CHOICES = (("module", None, None, None),
                ("chunk=32", 32, None, None), ("chunk=128", 128, None, None),
                ("chunk=256", 256, None, None),
                ("lanes=16", None, 16, None), ("lanes=64", None, 64, None),
                ("leaf=32", None, None, 32), ("leaf=128", None, None, 128))
# (label, _CHUNK, _GROUP_BYTES, _EMIT_BYTES); None keeps the module's value
SHARDED_CHOICES = (("module", None, None, None),
                   ("chunk=128", 128, None, None), ("chunk=256", 256, None, None),
                   ("chunk=1024", 1024, None, None), ("chunk=2048", 2048, None, None),
                   ("group=256MiB", None, 256 << 20, None), ("group=4GiB", None, 4 << 30, None),
                   ("emit=16MiB", None, None, 16 << 20), ("emit=256MiB", None, None, 256 << 20))
CONFIG5_CUT = dict(K=16384, T=4096, batch=2, segments=16)
HEADLINE = dict(K=3965, T=256, segments=16)
RANK_MESHES = ((1, 1, 2), (1, 2, 1))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def event_ms(run, device) -> float:
    """Milliseconds of one ``run()`` between CUDA events after a
    synchronize."""
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def peak_of(run, device) -> int:
    """Bytes ``run()`` allocates above what was allocated before it, at
    most."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    run()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - before


def in_turns(choices: dict, device, reps: int = TURN_REPS, setup=None) -> dict:
    """{label: (ms of every timed decode by turn, peak bytes of the
    warmup)}: each choice run once (``setup(label)`` first, if given), then
    timed in the order given and reversed, ``reps`` decodes a turn."""
    peaks, times = {}, {label: [[], []] for label in choices}
    for label, run in choices.items():
        if setup:
            setup(label)
        peaks[label] = peak_of(run, device)
    order = list(choices)
    for k, turn in enumerate((order, order[::-1])):
        for label in turn:
            if setup:
                setup(label)
            for _ in range(reps):
                times[label][k].append(event_ms(choices[label], device))
    if setup:
        setup(None)
    return {label: (times[label], peaks[label]) for label in choices}


def spread(turns: list, ms: float) -> float:
    """A choice's spread: the range of its decodes in both turns, at least
    ``SPREAD_FLOOR`` of its median ``ms``."""
    runs = turns[0] + turns[1]
    return max(max(runs) - min(runs), SPREAD_FLOOR * ms)


def within(a: dict, b: dict) -> bool:
    """Two rows' medians closer than the sum of their spreads."""
    return abs(a["ms"] - b["ms"]) <= a["spread_ms"] + b["spread_ms"]


def summary(rows: list[dict]) -> dict:
    """The fastest row of one (figure, shape), the rows within its spread,
    and of those the one with the smallest working set (the faster on a
    tie)."""
    fastest = min(rows, key=lambda r: r["ms"])
    near = [r for r in rows if within(r, fastest)]
    lean = min(near, key=lambda r: (r["working_set"], r["ms"]))
    return {"summary": rows[0]["figure"], "shape": rows[0]["shape"],
            "fastest": fastest["choice"], "fastest_ms": fastest["ms"],
            "within_spread": [r["choice"] for r in near], "smallest_within": lean["choice"],
            "smallest_within_ms": lean["ms"]}


class Sink:
    """Rows printed as they come and kept for the output file."""

    def __init__(self, card: str):
        self.lines = [{"card": card}]

    def cell(self, figure: str, shape: dict, timed: dict, working_set, paths=None) -> None:
        rows = []
        for label, (turns, peak) in timed.items():
            ms = statistics.median(turns[0] + turns[1])
            row = {"figure": figure, "shape": shape, "choice": label, "ms": ms,
                   "spread_ms": spread(turns, ms), "turns_ms": turns, "peak_bytes": peak,
                   "working_set": working_set(label, peak),
                   "path": (paths or {}).get(label, "equal")}
            rows.append(row)
            print(json.dumps(row), flush=True)
        line = summary(rows)
        print(json.dumps(line), flush=True)
        self.lines += rows + [line]

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in self.lines)


class Tables:
    """Padded log tables on ``device`` by K, one K at a time."""

    def __init__(self, device):
        self.device, self.K, self.lh = device, None, None

    def drop(self) -> None:
        self.K, self.lh = None, None
        torch.cuda.empty_cache()

    def __call__(self, K: int):
        if K != self.K:
            self.drop()
            hmm, _ = make_sparse_hmm(K=3965 if K == 3968 else K, M=M, T=2, prob=PROB, seed=1)
            self.lh = hmm.log(device=self.device).padded(64)
            self.K = K
        return self.lh


def ys_on(T: int, Bs: int, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([observations(T, M, seed=s) for s in range(1, Bs + 1)])
                           .astype(np.int64), device=device)


def fused_sweep(sink: Sink, tables: Tables, device, Ks=FUSED_K, Ts=FUSED_T) -> None:
    """The single sequence's two routes, as ``fused_decode`` runs each."""
    for K in Ks:
        lh = tables(K)
        for T in Ts:
            y = ys_on(T, 1, device)[0]

            def route(pointers):
                def run():
                    emits = lh.logB.t()[y]
                    delta0 = lh.logPi + emits[0]
                    return fused._walk(lh.logA, emits[1:].unsqueeze(1), delta0[None, :],
                                       pointers)[0]
                return run

            routes = {p: route(p) for p in ("store", "recompute")}
            paths = {p: run() for p, run in routes.items()}
            assert torch.equal(paths["store"], paths["recompute"]), (K, T)
            sink.cell("fused", {"K": K, "T": T}, in_turns(routes, device),
                      lambda p, _: route_working_set(p, K, T, 1))


def route_working_set(pointers: str, K: int, T: int, Bs: int) -> int:
    """The route's device tensors beside the tables: the (T, Bs, K)
    emissions and the (T-1, Bs, K) pointers or carry history; recompute
    also makes the walk's transposed (K, K) logA."""
    ws = (2 * T - 1) * Bs * K * 4
    return ws + K * K * 4 if pointers == "recompute" else ws


def batch_sweep(sink: Sink, tables: Tables, device, Ks=BATCH_K, Ts=BATCH_T,
                Bss=BATCH_BS) -> None:
    for K in Ks:
        lh = tables(K)
        for T in Ts:
            for Bs in Bss:
                if Bs == 64 and K >= 8192 and T != 256:
                    continue
                ys = ys_on(T, Bs, device)
                routes = {p: (lambda p=p: fused.fused_decode_batch(lh.logA, lh.logB, lh.logPi,
                                                                    ys, pointers=p))
                          for p in ("store", "recompute")}
                paths = {p: run() for p, run in routes.items()}
                assert torch.equal(paths["store"], paths["recompute"]), (K, T, Bs)
                del paths
                sink.cell("batch", {"K": K, "T": T, "Bs": Bs}, in_turns(routes, device),
                          lambda p, _: route_working_set(p, K, T, Bs))
                del ys, routes


def snapshot_steps(T: int) -> list[int]:
    """The swept snapshot steps at T, each below T, in order."""
    r = math.isqrt(T)
    return sorted({s for s in (r, T // 64, 2 * r, 4 * r, 512, 1024, 2048) if 1 <= s < T})


def snapshot_working_set(K: int, T: int, step: int) -> int:
    """The snapshots and one chunk's pointer table (``auto.device_working_set``)."""
    return (T // step + 1) * K * 4 + step * K * 4


def snapshot_sweep(sink: Sink, tables: Tables, device, Ks=SNAPSHOT_K, Ts=SNAPSHOT_T) -> None:
    for K in Ks:
        lh = tables(K)
        for T in Ts:
            if T > SNAPSHOT_MAX_T.get(K, T):
                continue
            y = ys_on(T, 1, device)[0]
            runs = {f"step={s}": (lambda s=s: checkpoint.checkpoint_decode(
                lh.logA, lh.logB, lh.logPi, y, step=s)) for s in snapshot_steps(T)}
            paths = [run() for run in runs.values()]
            assert all(torch.equal(p, paths[0]) for p in paths), (K, T)
            del paths
            sink.cell("snapshot", {"K": K, "T": T}, in_turns(runs, device),
                      lambda label, _: snapshot_working_set(K, T, int(label.split("=")[1])))


def score_f64(lh, y, path) -> float:
    """The f64 log score of ``path`` under the fp32 tables on the card
    (the path's entries gathered, then widened)."""
    p = path.long()
    return float(lh.logPi[p[0]].double() + lh.logB[p[0], y[0]].double()
                 + lh.logA[p[:-1], p[1:]].double().sum() + lh.logB[p[1:], y[1:]].double().sum())


def tie_flip(lh, y, got, want, where) -> str:
    """A path that differs from ``want``'s: the f64 score gap, which must
    lie within ``dp_divergence_tolerance_f64``."""
    from flash_viterbi_tpu_torch.oracle.validate import dp_divergence_tolerance_f64

    s_got, s_want = score_f64(lh, y, got), score_f64(lh, y, want)
    tol = dp_divergence_tolerance_f64(len(y), s_want)
    assert abs(s_got - s_want) <= tol, (where, s_got, s_want, tol)
    return (f"tie-equivalent: {int((got != want).sum())} positions, f64 score gap "
            f"{abs(s_got - s_want):.6g} (tolerance {tol:.6g})")


def patched(module, names: tuple, values: tuple):
    """A ``setup(label)`` for :func:`in_turns` that sets ``module``'s
    ``names`` to a choice's values (None keeps the module's), and back
    to the module's own for ``label=None``."""
    own = {n: getattr(module, n) for n in names}

    def setup(choice):
        for n, v in zip(names, values.get(choice, (None,) * len(names))):
            setattr(module, n, own[n] if v is None else v)
    return setup, own


def lean_sweep(sink: Sink, tables: Tables, device, Ks=LEAN_K, Ts=LEAN_T,
               choices=LEAN_CHOICES) -> None:
    knobs = {c[0]: (c[1], c[2]) for c in choices}
    setup, own = patched(flash, ("LEAN_CHUNK", "LEAF_LANES"), knobs)
    leaf = {c[0]: c[3] or flash.LEAN_LEAF for c in choices}
    for K in Ks:
        lh = tables(K)
        kept = flash._Transposed()
        for T in Ts:
            if (K, T) in LEAN_SKIP:
                continue
            y = ys_on(T, 1, device)[0]
            kept(kept.cast(lh.logA, "fp32"))  # the decoder keeps it; not in a peak
            runs = {c[0]: (lambda c=c: flash.flash_decode(
                lh.logA, lh.logB, lh.logPi, y, LEAN_SEGMENTS, "lean", leaf[c[0]], kept))
                for c in choices}
            paths, want = {}, None
            for label, run in runs.items():
                setup(label)
                got = run()
                want = got if want is None else want
                if not torch.equal(got, want):
                    paths[label] = tie_flip(lh, y, got, want, (K, T, label))
            setup(None)

            def working_set(label, _):
                setup(label)
                ws = flash.lean_working_set(K, T, LEAN_SEGMENTS, leaf[label])
                setup(None)
                return ws

            sink.cell("lean", {"K": K, "T": T, "segments": LEAN_SEGMENTS},
                      in_turns(runs, device, setup=setup), working_set, paths)
        del kept
    for n, v in own.items():
        setattr(flash, n, v)


SHARDED_NAMES = ("_CHUNK", "_GROUP_BYTES", "_EMIT_BYTES")


def sharded_choices(choices=SHARDED_CHOICES) -> dict:
    return {c[0]: tuple(c[1:]) for c in choices}


def sharded_sweep(sink: Sink, device, choices=SHARDED_CHOICES, cut=CONFIG5_CUT,
                  meshes=RANK_MESHES, head=HEADLINE) -> None:
    """Config-5's cut on (1, 1, 1) here, then the headline on each of
    ``meshes`` as gloo ranks on the card."""
    from flash_viterbi_tpu_torch.parallel.multihost import launch_workers

    setup, _ = patched(sharded, SHARDED_NAMES, sharded_choices(choices))
    hmm, y = make_sparse_hmm(K=cut["K"], M=M, T=cut["T"], prob=PROB, seed=1)
    lh = hmm.log(device=device)
    del hmm
    ys = np.stack([y] + [observations(cut["T"], M, seed=s) for s in range(2, cut["batch"] + 1)])
    mesh = sharded.make_mesh()
    runs = {c[0]: (lambda: sharded.flash_decode_sharded(
        mesh, lh.logA, lh.logB, lh.logPi, ys, num_segments=cut["segments"],
        microbatch=cut["batch"])) for c in choices}
    sink.cell("sharded", {"mesh": [1, 1, 1], "K": cut["K"], "T": cut["T"], "Bs": cut["batch"],
                          "segments": cut["segments"]},
              checked_turns(runs, device, setup), lambda _, peak: peak)
    del lh, runs
    torch.cuda.empty_cache()
    for shape in meshes:
        with tempfile.TemporaryDirectory() as out:
            with open(os.path.join(out, "job.json"), "w") as f:
                json.dump({"mesh": shape, "choices": [list(c) for c in choices],
                           "device": str(device), "problem": head}, f)
            launch_workers(os.path.abspath(__file__), int(np.prod(shape)), out, timeout=900)
            with open(os.path.join(out, "rank0.json")) as f:
                timed = {k: tuple(v) for k, v in json.load(f).items()}
        sink.cell("sharded", {"mesh": list(shape), "K": -(-head["K"] // 128) * 128,
                              "T": head["T"], "Bs": 4, "segments": head["segments"]},
                  timed, lambda _, peak: peak)


def checked_turns(runs: dict, device, setup) -> dict:
    """:func:`in_turns` after checking that every choice gives the first's
    paths."""
    want = None
    for label, run in runs.items():
        setup(label)
        got = run()
        want = got if want is None else want
        assert torch.equal(got, want), label
    setup(None)
    return in_turns(runs, device, setup=setup)


def rank_main(init_method: str, rank: str, world: str, outdir: str) -> None:
    """One rank of a headline world (``sharded_sweep``): every choice of
    the job's in turns; rank 0 writes the times and its peaks."""
    from flash_viterbi_tpu_torch.parallel import multihost

    with open(os.path.join(outdir, "job.json")) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    device = torch.device(job["device"])
    torch.cuda.set_device(device)
    multihost.initialize(init_method, int(world), int(rank), backend="gloo")
    mesh = sharded.make_mesh(*job["mesh"])
    head = job["problem"]
    hmm, y1 = make_sparse_hmm(K=head["K"], M=M, T=head["T"], prob=PROB, seed=1)
    lh = hmm.log(device=device).padded(128)
    ys = np.stack([y1] + [observations(head["T"], M, seed=s) for s in (2, 3, 4)])
    choices = [tuple(c) for c in job["choices"]]
    setup, _ = patched(sharded, SHARDED_NAMES, sharded_choices(choices))
    runs = {c[0]: (lambda: sharded.flash_decode_sharded(
        mesh, lh.logA, lh.logB, lh.logPi, ys, num_segments=head["segments"]))
        for c in choices}
    timed = checked_turns(runs, device, setup)
    if int(rank) == 0:
        with open(os.path.join(outdir, "rank0.json"), "w") as f:
            json.dump(timed, f)
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


def summarize(src: str, dst: str) -> None:
    """``src``'s rows with their spreads and summary lines recomputed."""
    with open(src) as f:
        lines = [json.loads(line) for line in f]
    out, cell = [], []
    for line in lines + [{}]:
        if "figure" in line:
            line["spread_ms"] = spread(line["turns_ms"], line["ms"])
            if cell and (cell[0]["figure"], cell[0]["shape"]) != (line["figure"], line["shape"]):
                out.append(summary(cell))
                cell = []
            cell.append(line)
            out.append(line)
        elif "summary" not in line:
            if cell:
                out.append(summary(cell))
                cell = []
            out += [line] if line else []
    with open(dst, "w") as f:
        f.writelines(json.dumps(line) + "\n" for line in out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(FIGURES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--summarize", nargs=2, metavar=("IN", "OUT"))
    args = ap.parse_args()
    if args.summarize:
        summarize(*args.summarize)
        return
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the sweep needs the card")
    card = card_line()
    print(card, flush=True)
    from flash_viterbi_tpu_torch.runtime import build

    build.kernels()
    device = torch.device("cuda", 0)
    sink, tables = Sink(card), Tables(device)
    t0 = time.perf_counter()
    for figure in args.only.split(","):
        t1 = time.perf_counter()
        if figure == "sharded":
            tables.drop()
            sharded_sweep(sink, device)
        else:
            {"fused": fused_sweep, "batch": batch_sweep, "snapshot": snapshot_sweep,
             "lean": lean_sweep}[figure](sink, tables, device)
        print(f"{figure}: {time.perf_counter() - t1:.1f} s", flush=True)
        if args.out:
            sink.write(args.out)
    print(f"sweep: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and not sys.argv[1].startswith("-"):  # a rank of sharded_sweep
        rank_main(*sys.argv[1:])
    else:
        main()
