"""The traced run's reading of a ``torch.profiler`` session: the device's
operations and the harness's own spans, on one clock.

The session is written as a Chrome trace to a temporary file (in
``TMPDIR``), read back and deleted.  Device operations are its events of
the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; spans are the
``user_annotation`` events the harness opens around its calls
(:data:`SPANS`).  Times are seconds.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's spans around a request: the observations to the card, the
#: port's call, the paths to the host, the harness's own bookkeeping
SPANS = ("fvbench.copy_in", "fvbench.call", "fvbench.copy_out", "fvbench.host")


@dataclass
class Event:
    name: str
    cat: str
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Trace:
    """What the per-layer metrics read (``metrics/<name>.py``)."""

    ops: list            # device operations (Event), by start
    spans: list          # the harness's spans (Event), by start
    window_s: float      # the profiled sub-window's length by the host's clock
    sequences: int       # sequences completed in it
    floor_s: float       # the floor of their work (bounds.floor_s, summed)
    K: int = 0           # the cell's logical states, symbols and positions,
    M: int = 0           # sequences a request, and its decoder (run.Cell.decoder),
    T: int = 0           # for readers that work out a floor of their own
    Bs: int = 1
    decoder: dict | None = None
    card: object = None  # bounds.Card of the card traced

    @property
    def kernels(self) -> list:
        return [e for e in self.ops if e.cat == "kernel"]

    def matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [e for e in self.kernels if rx.search(e.name)]

    @property
    def busy_s(self) -> float:
        return union_s(self.ops)


def union_s(events) -> float:
    """Seconds covered by at least one of ``events``."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.start):
        if e.end > end:
            total += e.end - max(e.start, end)
            end = e.end
    return total


def read_chrome(path: str) -> tuple[list, list]:
    """(device operations, harness spans) of a Chrome trace file."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ev = Event(str(e.get("name", "")), str(e.get("cat", "")),
                   float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6)
        if ev.cat in DEVICE_CATS:
            ops.append(ev)
        elif ev.cat == "user_annotation" and ev.name in SPANS:
            spans.append(ev)
    return sorted(ops, key=lambda e: e.start), sorted(spans, key=lambda e: e.start)


@contextlib.contextmanager
def session():
    """A profiler over the block; yields a dict that holds, after the
    block, the session's ``ops`` and ``spans``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["ops"], out["spans"] = read_chrome(path)
    finally:
        os.unlink(path)


def lost_records(ops: list, launches: dict, kernels: dict) -> list[str]:
    """The port's wrappers whose launches in the session outnumber the
    kernels the session recorded under their names (``kernels``: wrapper
    name -> kernel name pattern); also the total, where the session's
    kernels of every name are fewer than the launches of every wrapper."""
    names = [e.name for e in ops if e.cat == "kernel"]
    lost = []
    by_pattern: dict[str, int] = {}
    for wrapper, n in launches.items():
        if n and wrapper in kernels:
            by_pattern[kernels[wrapper]] = by_pattern.get(kernels[wrapper], 0) + n
    for pattern, n in by_pattern.items():
        got = sum(1 for name in names if re.search(pattern, name))
        if got < n:
            lost.append(f"{pattern}: {got} recorded of {n} launched")
    if len(names) < sum(launches.values()):
        lost.append(f"all kernels: {len(names)} recorded of {sum(launches.values())} launched")
    return lost


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time inside the sub-window summed by the harness span
    the host was in (``host.other`` outside every span)."""
    by_op: dict[str, float] = {}
    for e in tr.ops:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.dur
    gaps: dict[str, float] = {}
    if tr.ops:
        ivals, end = [], float("-inf")
        for e in sorted(tr.ops, key=lambda e: e.start):
            if end != float("-inf") and e.start > end:
                ivals.append((end, e.start))
            end = max(end, e.end)
        for a, b in ivals:
            mid = (a + b) / 2
            name = next((s.name for s in tr.spans if s.start <= mid <= s.end), "host.other")
            gaps[name] = gaps.get(name, 0.0) + (b - a)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k[:120], v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}
