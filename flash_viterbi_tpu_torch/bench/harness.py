"""Marginal timing of chained calls.

Counterpart of ``flash_viterbi_tpu/bench/harness.py:marginal_time`` with
the same signature.  A probe's kernel runs for microseconds, shorter than
one call can be timed well, so a chain of k calls is timed at two lengths
and the slope is the time per call: launch gaps between calls stay in it,
the fixed cost of the first launch and the final synchronisation drops
out.  On the card each chain is timed with CUDA events; on the CPU with
``time.perf_counter``.  The device is the one the chain's result lies on.
The rest of the JAX harness (``RunConfig``, ``run_one``, ``sweep``, the
CSV) is not ported yet.
"""

from __future__ import annotations

import statistics
import time

import torch


def _device_of(out) -> torch.device:
    """The device of the first tensor in ``out`` (a tensor or a nest of
    tuples and lists); the CPU when it holds none."""
    if torch.is_tensor(out):
        return out.device
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _device_of(x)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def device_name(dev: torch.device) -> str:
    """What a result names as the device it ran on."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def marginal_time(make_chain, k1: int = 1, k2: int = 5, reps: int = 3) -> float:
    """Seconds per call: the slope between chains of ``k1`` and ``k2``
    calls, each the median of ``reps`` timed runs.

    ``make_chain(k)`` returns a callable that makes k calls and returns a
    result on the device they ran on.  Both chains run once untimed first
    (kernels build at their first launch).
    """
    f1, f2 = make_chain(k1), make_chain(k2)
    f1()
    dev = _device_of(f2())

    def run(f) -> float:
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(dev))
                f()
                end.record(torch.cuda.current_stream(dev))
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                f()
                times.append(time.perf_counter() - t0)
        return statistics.median(times)

    return max((run(f2) - run(f1)) / (k2 - k1), 1e-9)
