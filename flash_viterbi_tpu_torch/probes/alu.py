"""The add+max throughput probe: CUDA kernel and its plain version.

Counterpart of ``scripts/vpu_probe.py:vpu_peak`` (``_vpu_kernel``): four
independent chains of ``y = max(y + x, y)`` a element, R rounds, over a
(rows, cols) float32 block, and the chains' sum.  The kernel is
``csrc/probe_alu.cu``.  One cell is one add and one max, the work of a
max-plus trellis cell; an operation is one of the two.

The TPU probe's chains round-tripped VMEM, so it measured a memory rate
(``vpu_probe.py:76-82``); the kernel keeps them in registers, so its rate
is the card's for this instruction mix, the denominator of the scans'
operation bound.  At the TPU probe's shape (R=64) a call lasts a few
microseconds; the rate is read at ``RATE_R`` rounds, where launch gaps no
longer count.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
import torch

from ..bench.harness import device_name, marginal_time
from ..models.hmm import resolve_device
from ..ops.cuda.common import expect_contiguous, launch, on_cuda
from ..runtime import build

SCALES = (0.5, 0.25, 0.125, 0.0625)
ROWS, COLS, R = 512, 512, 64  # vpu_peak's defaults
RATE_R = 4096


def cells(n: int, rounds: int) -> int:
    """Add+max cells of one call over n elements."""
    return len(SCALES) * rounds * n


def operations(n: int, rounds: int) -> int:
    """Every fp32 operation of one call: the cells' adds and maxes, the
    four scalings and the three adds of the sum."""
    return 2 * cells(n, rounds) + (len(SCALES) + 3) * n


def probe_alu_plain(x: torch.Tensor, rounds: int = R) -> torch.Tensor:
    """Plain version of :func:`probe_alu`, in ``_vpu_kernel``'s order."""
    ys = [x * c for c in SCALES]
    for _ in range(rounds):
        ys = [torch.maximum(y + x, y) for y in ys]
    return ((ys[0] + ys[1]) + ys[2]) + ys[3]


def probe_alu(x: torch.Tensor, rounds: int = R) -> torch.Tensor:
    """The add+max chains over ``x`` (any shape, float32): ``rounds``
    rounds of four chains a element, returning their sum, bit-identical
    to :func:`probe_alu_plain`."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if not on_cuda(x):
        return probe_alu_plain(x, rounds)
    expect_contiguous(x=x)
    out = torch.empty_like(x)
    launch("fvt_probe_alu", probe_alu, x.device, x.data_ptr(), out.data_ptr(), x.numel(), rounds)
    return out


probe_alu.launches = 0


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
    """Time chains of 16 and 128 calls (``vpu_peak``'s) at ``rounds``
    (variant ``vpu_peak``) and at ``rate_rounds`` (``vpu_peak_rate``, the
    rate to quote); one record each."""
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
        n = x.numel()
        records.append({"probe": "vpu_probe", "variant": variant, "kernel": "probe_alu",
                        "device": device_name(x.device), "shape": [rows, cols], "R": r, "per_call_s": per,
                        "cells_per_s": cells(n, r) / per, "ops_per_s": 2 * cells(n, r) / per,
                        "bytes": 2 * n * 4, "operations": operations(n, r)})
    return records
