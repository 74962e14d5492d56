"""The add+max throughput probe: CUDA kernel and its plain version.

Counterpart of ``scripts/vpu_probe.py:vpu_peak`` (``_vpu_kernel``): four
independent chains of ``y = max(y + x, y)`` a element, R rounds, over a
(rows, cols) float32 block, and the chains' sum.  The kernel is
``csrc/probe_alu.cu``: one launch of the card's resident grid
(:func:`alu_plan`), a thread interleaving two elements' chains.  One cell
is one add and one max, the work of a max-plus trellis cell; an operation
is one of the two.

The TPU probe's chains round-tripped VMEM, so it measured a memory rate
(``vpu_probe.py:76-82``); the kernel keeps them in registers, so its rate
is the card's issue rate for this instruction mix, at most 64 cells a
clock an SM (``bench/bounds.py``).  Each record gives the device's time a
call back to back (``bench.harness.queued_ms``), the slope of chains of
calls (the host's launch path in it), and from the kernel's own clock
readout the cycles of a call, the cells a clock an SM and the SM clock
those cycles imply over the device time.  At the TPU probe's shape (R=64)
a call lasts a few microseconds; the rate is also read at ``RATE_R``
rounds, where the ramp at a call's start and end no longer counts.
"""

from __future__ import annotations

import functools
import os
import re
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from ..bench.harness import device_name, marginal_time, queued_ms
from ..models.hmm import resolve_device
from ..ops.cuda.common import expect, expect_contiguous, launch, on_cuda
from ..ops.cuda.maxplus import sm_count
from ..runtime import build

SCALES = (0.5, 0.25, 0.125, 0.0625)
ROWS, COLS, R = 512, 512, 64  # vpu_peak's defaults
RATE_R = 4096
THREADS = 256  # threads of a block (csrc: THREADS)


def cells(n: int, rounds: int) -> int:
    """Add+max cells of one call over n elements."""
    return len(SCALES) * rounds * n


def operations(n: int, rounds: int) -> int:
    """Every fp32 operation of one call: the cells' adds and maxes, the
    four scalings and the three adds of the sum."""
    return 2 * cells(n, rounds) + (len(SCALES) + 3) * n


class AluPlan(NamedTuple):
    """The kernel's grid over n elements: ``blocks`` blocks of
    ``THREADS``, pairs of elements p and p + ``half``."""

    blocks: int
    half: int


def alu_plan(n: int, blocks_per_sm: int, sms: int) -> AluPlan:
    """The resident grid (``blocks_per_sm`` x ``sms`` blocks) over ``n``
    elements in pairs."""
    if n < 1 or blocks_per_sm < 1 or sms < 1:
        raise ValueError(f"need n, blocks_per_sm, sms >= 1, got {n}, {blocks_per_sm}, {sms}")
    return AluPlan(blocks=blocks_per_sm * sms, half=(n + 1) // 2)


def thread_elements(plan: AluPlan, n: int, block: int, thread: int) -> list[int]:
    """The elements thread ``thread`` of block ``block`` computes, in its
    order: the kernel's walk (global warp = warp x blocks + block, 32
    consecutive pairs a warp, striding over all warps)."""
    lane, warp = thread % 32, thread // 32
    all_warps = plan.blocks * (THREADS // 32)
    got = []
    for gw in range(warp * plan.blocks + block, -(-plan.half // 32), all_warps):
        p = gw * 32 + lane
        if p < plan.half:
            got += [p, p + plan.half] if p + plan.half < n else [p]
    return got


@functools.lru_cache(maxsize=None)
def _blocks_per_sm() -> int:
    got = build.kernels().fvt_probe_alu_blocks_per_sm()
    build.check(max(0, -got), "fvt_probe_alu_blocks_per_sm")
    if got < 1:
        raise RuntimeError("alu_kernel: no block of it fits an SM")
    return got


def probe_alu_plain(x: torch.Tensor, rounds: int = R) -> torch.Tensor:
    """Plain version of :func:`probe_alu`, in ``_vpu_kernel``'s order."""
    ys = [x * c for c in SCALES]
    for _ in range(rounds):
        ys = [torch.maximum(y + x, y) for y in ys]
    return ((ys[0] + ys[1]) + ys[2]) + ys[3]


def probe_alu(x: torch.Tensor, rounds: int = R, *, clocks: torch.Tensor | None = None
              ) -> torch.Tensor:
    """The add+max chains over ``x`` (any shape, float32): ``rounds``
    rounds of four chains a element, returning their sum, bit-identical
    to :func:`probe_alu_plain`.  ``clocks``, on the card only: an int64
    tensor of :func:`clock_buffer`'s shape that the kernel fills with each
    block's start and end clock and its SM."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if not on_cuda(x):
        if clocks is not None:
            raise ValueError("the clock readout is the kernel's: the CPU has none")
        return probe_alu_plain(x, rounds)
    expect_contiguous(x=x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = alu_plan(x.numel(), _blocks_per_sm(), sm_count(x.device))
    if clocks is not None:
        expect("clocks", clocks, torch.int64, (plan.blocks, 3))
        expect_contiguous(clocks=clocks)
    launch("fvt_probe_alu", probe_alu, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
           plan.half, rounds, plan.blocks, None if clocks is None else clocks.data_ptr())
    return out


probe_alu.launches = 0


def clock_buffer(device) -> torch.Tensor:
    """A (blocks, 3) int64 tensor for :func:`probe_alu`'s ``clocks``."""
    dev = torch.device(device)
    return torch.zeros((_blocks_per_sm() * sm_count(dev), 3), dtype=torch.int64, device=dev)


def clock_stats(clocks: torch.Tensor) -> dict:
    """From a filled clock buffer: ``cycles``, the longest span from the
    first start to the last end of the blocks of one SM (each SM's own
    counter), and ``sms``, the SMs the blocks ran on."""
    c = clocks.cpu().numpy()
    spans = {}
    for start, end, sm in c:
        lo, hi = spans.get(int(sm), (start, end))
        spans[int(sm)] = (min(lo, start), max(hi, end))
    return {"cycles": int(max(hi - lo for lo, hi in spans.values())), "sms": len(spans)}


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def sass_counts() -> dict[str, int]:
    """Opcodes of the built ``alu_kernel`` (``cuobjdump -sass`` of the
    kernel library): how many FADD, FMNMX, FFMA and FMUL it holds."""
    build.kernels()
    sass = subprocess.run([cuobjdump_path(), "-sass", build.KERNELS_SO], check=True,
                          capture_output=True, text=True).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if part.split(None, 1)[0].find("alu_kernel") >= 0), None)
    if body is None:
        raise RuntimeError("alu_kernel not found in the kernel library's SASS")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body)
    return {op: ops.count(op) for op in ("FADD", "FMNMX", "FFMA", "FMUL")}


def inputs(rows: int = ROWS, cols: int = COLS, device="cuda", seed: int = 0) -> torch.Tensor:
    """The probe's (rows, cols) float32 block, uniform in [0, 1) from
    ``seed``."""
    x = np.random.default_rng(seed).random((rows, cols)).astype(np.float32)
    return torch.as_tensor(x, device=resolve_device(device))


def run(device="cuda", rows: int = ROWS, cols: int = COLS, rounds: int = R,
        rate_rounds: int = RATE_R) -> list[dict]:
    """Time ``rounds`` (variant ``vpu_peak``) and ``rate_rounds``
    (``vpu_peak_rate``, the rate to quote): the device's time a call back
    to back, and the slope of chains of 16 and 128 calls (``vpu_peak``'s);
    on the card also one call's clock readout.  One record each."""
    x = inputs(rows, cols, device)
    records = []
    for variant, r in (("vpu_peak", rounds), ("vpu_peak_rate", rate_rounds)):
        def chain(k, r=r):
            def f():
                for _ in range(k):
                    out = probe_alu(x, r)
                return out
            return f

        per = marginal_time(chain, 16, 128)
        dev_s = queued_ms(lambda r=r: probe_alu(x, r), x.device) * 1e-3
        n = x.numel()
        rec = {"probe": "vpu_probe", "variant": variant, "kernel": "probe_alu",
               "device": device_name(x.device), "shape": [rows, cols], "R": r,
               "per_call_s": per, "back_to_back_s": dev_s, "cells_per_s": cells(n, r) / dev_s,
               "ops_per_s": 2 * cells(n, r) / dev_s, "bytes": 2 * n * 4,
               "operations": operations(n, r)}
        if x.device.type == "cuda":
            clocks = clock_buffer(x.device)
            probe_alu(x, r, clocks=clocks)
            st = clock_stats(clocks)
            rec.update(cycles=st["cycles"], sms=st["sms"],
                       cells_per_clock_sm=cells(n, r) / (st["cycles"] * sm_count(x.device)),
                       sm_clock_hz=st["cycles"] / dev_s)
        records.append(rec)
    return records
