"""The port's ``fvt.*`` spans against the device's timeline, in one cell of
the benchmark (``BENCHMARK.json``, ``fvbench/``).

    python3 scripts/torch_trace_spans.py --workload <cell> --seed <n> --out DIR
    python3 scripts/torch_trace_spans.py --read DIR [tag ...]

The first form (card only) sets the cell up as ``fvbench.run`` does, runs
its traced window (the traffic's ``trace_requests`` requests right after
warm-up) under one ``torch.profiler`` session, keeps the session's Chrome
trace as ``DIR/<cell>.<seed>.json.gz`` beside ``<cell>.<seed>.meta.json``
(sequences, requests, the window's length by the host's clock, launches),
and prints the readings below as one JSON line.  The second reads saved
traces again, with no card.

A request's port span is the longest ``fvt.*`` span inside its
``fvbench.call``.  A device operation belongs to every span open on the
host when its launch (the ``cuda_runtime`` or ``cuda_driver`` event of its
``correlation``) started.  Readings (ms; idle is time inside a span when no
device operation runs):

* ``host_prelaunch_ms``, ``call_gap_ms``: medians over the requests of the
  idle time in the port span before, and after, the first of the port's
  own kernels (``fvbench/kernels.json``'s patterns) starts;
  ``idle_in_port_ms`` both summed over the requests, beside
  ``idle_in_call_ms``, the idle stretches whose midpoint lies in a
  ``fvbench.call`` (what the benchmark's breakdown gives that span);
* ``port_gaps_ms``: the idle time in the port spans, a request, split at
  every span's edges and each piece named by the innermost ``fvt.*`` span
  open over it (``(own)``: the port span's own time);
* ``device_ms_per_seq``: the device time a sequence launched under each
  span name (nested spans each count it);
* ``spans_per_request``: how many of each span a request opened, which
  shows ``auto``'s decision (``fvt.auto.<decoder>``), ``fused``'s route
  (``fvt.kernel.maxplus_scan``: store, ``maxplus_scan_deltas``:
  recompute) and the transposed tables made; ``syncs_per_seq``: the
  ``fvt.sync`` spans (the host waiting on the device) a sequence;
* ``lost_records``: the port's kernels launched in the window (the
  meta's launches) that the session did not record (``fvbench.trace.
  lost_records``); where it is not empty, a lost kernel's time reads as
  idle and the other readings are not to be trusted.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Ev:
    __slots__ = ("name", "cat", "start", "end", "corr")

    def __init__(self, name, cat, start, end, corr=None):
        self.name, self.cat, self.start, self.end, self.corr = name, cat, start, end, corr

    @property
    def dur(self) -> float:
        return self.end - self.start


def port_kernels() -> dict:
    """``fvbench/kernels.json``: wrapper name -> its kernels' name pattern."""
    with open(os.path.join(ROOT, "fvbench", "kernels.json")) as f:
        return json.load(f)


def port_pattern() -> re.Pattern:
    return re.compile("|".join(sorted(set(port_kernels().values()))))


def load(events) -> dict:
    """The Chrome trace's ``traceEvents`` split into device operations (by
    start), launches by correlation id, ``fvt.*`` spans and ``fvbench.*``
    spans (by start); times in seconds."""
    ops, launches, port, harness = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = str(e.get("cat", "")), str(e.get("name", ""))
        start = float(e["ts"]) * 1e-6
        ev = Ev(name, cat, start, start + float(e.get("dur", 0.0)) * 1e-6,
                (e.get("args") or {}).get("correlation"))
        if cat in DEVICE_CATS:
            ops.append(ev)
        elif cat in LAUNCH_CATS and ev.corr is not None:
            launches[ev.corr] = ev
        elif cat == "user_annotation" and name.startswith("fvt."):
            port.append(ev)
        elif cat == "user_annotation" and name.startswith("fvbench."):
            harness.append(ev)
    key = lambda e: (e.start, -e.end)  # noqa: E731 - outer before inner
    return {"ops": sorted(ops, key=key), "launches": launches,
            "port": sorted(port, key=key), "harness": sorted(harness, key=key)}


def busy_intervals(ops) -> list[list[float]]:
    """The union of the operations' times, as disjoint [start, end]."""
    out: list[list[float]] = []
    for e in ops:
        if out and e.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end)
        else:
            out.append([e.start, e.end])
    return out


def idle_pieces(busy, a: float, b: float) -> list[tuple[float, float]]:
    """The idle (start, end) stretches of [a, b]."""
    pieces, cur = [], a
    i = bisect.bisect_left([x[1] for x in busy], a)
    while cur < b:
        if i >= len(busy) or busy[i][0] >= b:
            pieces.append((cur, b))
            break
        s, e = busy[i]
        if s > cur:
            pieces.append((cur, min(s, b)))
        cur = max(cur, e)
        i += 1
    return [p for p in pieces if p[1] > p[0]]


def innermost(spans, t: float):
    """The shortest of ``spans`` open at ``t``, or None."""
    best = None
    for s in spans:
        if s.start <= t <= s.end and (best is None or s.dur < best.dur):
            best = s
    return best


def read(tr: dict, sequences: int, port_rx: re.Pattern) -> dict:
    """The readings of one loaded trace (see the module's docstring)."""
    ops, port, harness = tr["ops"], tr["port"], tr["harness"]
    busy = busy_intervals(ops)
    calls = [s for s in harness if s.name == "fvbench.call"]
    pre, gap, gaps, counts = [], [], {}, {}
    requests = []
    for c in calls:
        inside = [s for s in port if c.start <= s.start and s.end <= c.end]
        if not inside:
            continue
        root = max(inside, key=lambda s: s.dur)
        kids = [s for s in inside if root.start <= s.start and s.end <= root.end]
        requests.append((root, kids))
        for s in kids:
            counts[s.name] = counts.get(s.name, 0) + 1
        first = next((o for o in ops if o.start >= root.start and port_rx.search(o.name)), None)
        split = first.start if first is not None and first.start <= root.end else root.end
        pieces = idle_pieces(busy, root.start, root.end)
        pre.append(sum(min(b, split) - a for a, b in pieces if a < split))
        gap.append(sum(b - max(a, split) for a, b in pieces if b > split))
        edges = sorted({t for s in kids for t in (s.start, s.end)})
        for a, b in pieces:
            i, j = bisect.bisect_right(edges, a), bisect.bisect_left(edges, b)
            cuts = [a] + edges[i:j] + [b]
            for x, y in zip(cuts, cuts[1:]):
                s = innermost(kids, (x + y) / 2)
                name = s.name + (" (own)" if s is root else "")
                gaps[name] = gaps.get(name, 0.0) + (y - x)
    call_idle = 0.0
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        mid = (b0 + a1) / 2
        if any(c.start <= mid <= c.end for c in calls):
            call_idle += a1 - b0
    device: dict[str, float] = {}
    unmatched = 0
    for o in ops:
        launch = tr["launches"].get(o.corr)
        if launch is None:
            unmatched += 1
            continue
        for root, kids in requests:
            if root.start <= launch.start <= root.end:
                for n in {s.name for s in kids if s.start <= launch.start <= s.end}:
                    device[n] = device.get(n, 0.0) + o.dur
                break
    n = max(len(requests), 1)
    seqs = max(sequences, 1)
    by_value = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
    return {
        "requests": len(requests), "sequences": sequences,
        "busy_ms": 1e3 * sum(b - a for a, b in busy),
        "host_prelaunch_ms": 1e3 * statistics.median(pre) if pre else None,
        "call_gap_ms": 1e3 * statistics.median(gap) if gap else None,
        "idle_in_port_ms": 1e3 * (sum(pre) + sum(gap)),
        "idle_in_call_ms": 1e3 * call_idle,
        "port_gaps_ms": {k: 1e3 * v / n for k, v in by_value(gaps)},
        "device_ms_per_seq": {k: 1e3 * v / seqs for k, v in by_value(device)},
        "spans_per_request": {k: v / n for k, v in sorted(counts.items())},
        "syncs_per_seq": counts.get("fvt.sync", 0) / seqs,
        "ops": len(ops), "ops_without_launch": unmatched,
    }


def read_saved(path: str, port_rx: re.Pattern) -> dict:
    """Read ``<tag>.json.gz`` beside ``<tag>.meta.json``."""
    with open(path[:-len(".json.gz")] + ".meta.json") as f:
        meta = json.load(f)
    with gzip.open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    sys.path.insert(0, ROOT)
    from fvbench.trace import lost_records

    tr = load(events)
    out = {"cell": meta.get("cell"), "seed": meta.get("seed"), "window_s": meta.get("window_s")}
    out.update(read(tr, int(meta["sequences"]), port_rx))
    out["lost_records"] = lost_records(tr["ops"], meta.get("launches", {}), port_kernels())
    return out


def run(cell_name: str, seed: int, out: str) -> dict:
    """One traced window of ``cell_name`` on the card, saved under ``out``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from fvbench import run as bench

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: --workload needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip(),
          file=sys.stderr, flush=True)
    os.makedirs(out, exist_ok=True)
    cell = bench.load_cell(cell_name)
    s = bench.prepare(cell, seed, "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w = bench.run_window(s, cell, 1e9, traced=True)
        torch.cuda.synchronize()
    tag = os.path.join(out, f"{cell_name}.{seed}")
    prof.export_chrome_trace(tag + ".json")
    with open(tag + ".json", "rb") as f, gzip.open(tag + ".json.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.unlink(tag + ".json")
    meta = {"cell": cell_name, "seed": seed, "sequences": w.sequences,
            "requests": len(w.paths), "window_s": w.seconds, "launches": w.launches,
            "failed": w.failed}
    with open(tag + ".meta.json", "w") as f:
        json.dump(meta, f)
    return read_saved(tag + ".json.gz", port_pattern())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--read", metavar="DIR")
    ap.add_argument("tags", nargs="*")
    args = ap.parse_args(argv)
    if args.read:
        rx = port_pattern()
        for path in sorted(glob.glob(os.path.join(args.read, "*.json.gz"))):
            tag = os.path.basename(path)[:-len(".json.gz")]
            if not args.tags or any(t in tag for t in args.tags):
                print(json.dumps({"tag": tag, **read_saved(path, rx)}), flush=True)
        return 0
    if not (args.workload and args.out):
        ap.error("give --workload and --out, or --read DIR")
    print(json.dumps(run(args.workload, args.seed, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
