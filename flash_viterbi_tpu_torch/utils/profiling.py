"""Observability: phase timers, device traces, memory reports.

Counterpart of ``flash_viterbi_tpu/utils/profiling.py``.  The reference's
only instrumentation is one wall-clock bracket around ``calc()`` plus the
analytic ``memory:`` figure every algorithm computes for itself
(SURVEY.md §5).  Here:

* :class:`PhaseTimer` — named phase brackets with a structured dict/JSON
  export, the derived ``trellis_updates_per_s`` included.
* :func:`profile_flash` — a FLASH decode's phase 1 and the whole decode,
  each timed as the slope of chains of calls.
* :func:`device_trace` — a ``torch.profiler`` session written as a Chrome
  trace.
* :func:`memory_report` — the analytic working set beside the card's
  allocator statistics.
* :func:`span`, :func:`traced` — the port's own ``fvt.*`` ranges, written
  into any ``torch.profiler`` session (:func:`device_trace`'s too) on the
  clock of the device's operations, and nothing when no session records.
* :func:`device_rows` — a session's ``key_averages()`` rows of device
  work, without the device-side projections of these ranges.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

from ..models.hmm import resolve_device

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler session
    records, else one shared null context: off, a span costs one flag read.
    The port's spans are named ``fvt.*``, and nest on the calling thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: each call of the function as a :func:`span` ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def device_rows(prof) -> list:
    """The rows of ``prof.key_averages()`` that hold device time: the
    kernels, copies and fills.  A ``record_function`` range that launched
    device work (each ``fvt.*`` span among them) also has a CUDA row, its
    length on the device, flagged ``is_user_annotation``: it is left out,
    as the profiler's own table leaves it out of its device total."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


@dataclass
class PhaseTimer:
    """Named wall-clock phases with structured export."""

    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)

    def report(self, K: int | None = None, T: int | None = None) -> dict:
        total = sum(self.phases.values())
        out = {"total_s": total,
               "phases": {n: self.phases[n] for n in self._order}}
        if K and T and total > 0:
            out["trellis_updates_per_s"] = K * K * T / total
        return out

    def json(self, **kw) -> str:
        return json.dumps(self.report(**kw))


def profile_flash(hmm, y, num_segments: int = 8, pad_to: int = 128,
                  reps: int = 3, device="cuda") -> dict:
    """Per-phase times of a FLASH pointer-mode decode on ``device``: phase 1
    (``flash.phase1_anchors``: the emission gather, one pointer scan over
    every step and one backtrack) and the whole decode (``flash_decode``),
    each the slope of chains of 1 and 3 calls (``bench.harness.
    marginal_time``; CUDA events on the card, ``perf_counter`` on the CPU).

    Phase 1 runs as a program of its own, so the whole decode minus phase 1
    is ``phase2_and_backtrack_s``.
    """
    from ..algorithms import flash as F
    from ..algorithms.base import check_observations, upload
    from ..bench.harness import marginal_time
    from ..runtime import build as kernel_build

    dev = resolve_device(device)
    if dev.type == "cuda":
        kernel_build.kernels()
    yv = check_observations(y, hmm.M)
    K_logical, lh = upload(hmm, dev, pad_to)
    T = int(len(yv))
    yd = torch.as_tensor(yv, device=dev)
    mids_l = F.flash_midpoints(0, T - 1, num_segments) if num_segments > 1 else []
    mids = torch.tensor(mids_l, dtype=torch.int64, device=dev)
    transposed = F._Transposed()

    def phase1():
        emits = lh.logB.t()[yd].contiguous()
        last, anchors = F.phase1_anchors(lh.logA, lh.logPi, emits, mids)
        return torch.cat([anchors, last[None]])

    def full():
        return F.flash_decode(lh.logA, lh.logB, lh.logPi, yd, num_segments=num_segments,
                              mode="pointer", transposed=transposed)

    def chained(fn):
        def make_chain(k):
            def chain():
                out = None
                for _ in range(k):
                    out = fn()
                return out
            return chain
        return make_chain

    t_phase1 = marginal_time(chained(phase1), 1, 3, reps)
    t_full = marginal_time(chained(full), 1, 3, reps)
    return {
        "phase1_s": t_phase1,
        "phase2_and_backtrack_s": max(t_full - t_phase1, 0.0),
        "total_s": t_full,
        "trellis_updates_per_s": K_logical * K_logical * T / t_full
        if t_full > 0 else float("inf"),
        "num_segments": num_segments,
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` session over the block (the card's kernels where
    CUDA is available), written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_report(decoder=None, K: int | None = None, T: int | None = None,
                  device="cuda", M: int = 0) -> dict:
    """Analytic and live device memory figures.

    On the card: the allocator's current and peak allocated bytes and the
    card's total memory, under the JAX package's keys, and
    ``live_array_bytes``, the bytes allocated to tensors now.  On the CPU
    the analytic figure and a ``live_array_bytes`` of 0.

    For an ``auto`` decoder built with a ``memory_budget_bytes``: the
    budget (``budget_bytes``), the candidate it chooses at (K, T)
    (``chosen``: name and keywords; K as the decode sees it, padded) and
    that candidate's figure held against the budget
    (``budget_figure_bytes``, ``auto.device_peak_bytes`` with ``M``
    symbols, on the card's SMs where there is one)."""
    dev = resolve_device(device)
    out: dict = {}
    if decoder is not None and K and T:
        out["analytic_bytes"] = decoder.analytic_memory(K=K, T=T)
        budget = decoder.static.get("memory_budget_bytes") if decoder.name == "auto" else None
        if budget is not None:
            from ..algorithms import auto
            from ..ops.cuda.common import H100_SMS
            from ..ops.cuda.maxplus import sm_count

            sms = sm_count(dev) if dev.type == "cuda" else H100_SMS
            static = {k: v for k, v in decoder.static.items()
                      if k not in ("memory_budget_bytes", "beam_width")}
            name, kw = auto.choose(K, T, budget, decoder.static.get("beam_width"), static,
                                   M=M, sms=sms)
            out["budget_bytes"] = int(budget)
            out["chosen"] = [name, kw]
            out["budget_figure_bytes"] = auto.device_peak_bytes(name, kw, K, T, M, sms)
    if dev.type != "cuda":
        out["live_array_bytes"] = 0
        return out
    stats = torch.cuda.memory_stats(dev)
    out["device_bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    out["device_peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    out["device_bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
    out["live_array_bytes"] = int(torch.cuda.memory_allocated(dev))
    return out
