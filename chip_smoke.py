#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flash_viterbi_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Device: the ``nvidia-smi`` name and power limit, and the torch device.
2. Build: compile the port's CUDA sources with ``nvcc``, one process per
   source, all at once.
3. Kernels: each of the six kernels against its plain PyTorch version on
   the card, bit-exact (tolerance 0: the kernels use only correctly
   rounded fp32 adds, maxes and compares), at the headline shapes, at an
   unpadded K, on a fixture full of exact ties, and (the four PR 1
   kernels) at the batch phase's 64 lanes.  The beam scan is held on five
   fixtures: flash_bs's phase-1 shape (N=1, T'=255, Kp=3968, B=64, 7
   anchor planes), its segment shape (8 ragged lanes), the unpadded
   K=3965, sparse integer-valued ties (K=1000, B=128, fewer than B finite
   scores) and B=1; ``beam_topk``, the stable sort that makes a decode's
   first beam, is held to the kernel's select on a row of ties, -inf and
   -0.0; a select too large for one block must raise.  Times are the
   median of CUDA-event timings, each beside its bound (the bytes the
   function must move at 3.35 TB/s or its operations at 67 TFLOP/s fp32,
   whichever is larger, counted from this run's inputs); the
   emission-gather scan is also timed in turns with the pointer scan at
   the same shape.
4. FLASH slice: the headline problem (K=3965 padded to 3968, M=50, T=256,
   prob=0.112, seed=1) decoded for four requests through the public
   ``decode(..., "flash", num_segments=16, device="cuda")``.  Each path
   must equal the port's CPU decode bit for bit, and the native C vanilla
   oracle exactly or, for FLASH's legitimate fp32 tie flips, within the f64
   score tolerance (the seed-1 request exactly).
5. Checkpoint slice: the same four requests through ``decode(...,
   "checkpoint")`` and ``decode(..., "fused")`` on the card; checkpoint
   must equal fused bit for bit and the C oracle under the rule above, and
   each ``memory:`` figure its analytic value.
6. Beam: the four requests through ``decode(..., "flash_bs",
   beam_width=64, num_segments=8)`` and ``decode(..., "beam",
   beam_width=64)``; each path must equal the port's CPU decode and its
   numpy mirror exactly (-1 segments included), and ``memory:`` its
   analytic value (12656 and 133120).  The f64 score gap to the C vanilla
   oracle's path is printed, as information on beam quality.
7. Long T: T=16384 through the registered checkpoint and fused decoders on
   tables already on the card; equal paths, and the checkpoint decode's
   peak allocation under 32 MiB above what was allocated before it.
8. Batch: ``decode_batch(..., "fused")`` over 16 and 64 sequences in both
   pointer modes; every row must equal that sequence's single decode.
9. Sharded, one rank: ``decode_batch(hmm, requests, mesh=make_mesh(1, 1,
   1), num_segments=16, device="cuda")`` on the four headline requests;
   every row must equal the C oracle under the rule of phase 4, request 0
   the port's CPU sharded decode bit for bit, ``memory:`` 4 x flash's.
10. Sharded, several ranks on the one card: meshes (1, 1, 2) and (1, 2, 2)
   over gloo (``launch_workers`` starts this script once a rank, with
   arguments), every rank on ``cuda:0`` holding only its column shard of
   ``logA`` and ``logB``; each rank's paths must equal phase 9's bit for
   bit.  Per-rank times are of ranks time-sliced on one card, not of
   several cards.
11. Config-5's K: K=16384, M=50, prob=0.112, seed=1, 2 sequences in one
   microbatch, 16 segments, T cut from 65536 to 4096 (8 chunks of 512) to
   keep the run short; mesh (1, 1, 1) in this process, then (1, 1, 4) as 4 ranks on the
   card, each memory-mapping the tables from ``.npy`` files and uploading
   only its 256 MiB column shard.  Equal paths, in range, finite scores.

The kernel phase also holds ``maxplus_step_block`` bit-exact on four
fixtures: the (1, 1, 1) boundary step (N=1, Ks=Kd=3968), 16 phase-2 lanes
on one of 4 state ranks (Kd=992), config-5's K on one of 4 state ranks
(Ks=16384, Kd=4096) and an integer-valued tie fixture (N=20, Ks=1000,
Kd=250, duplicated source rows, an all -inf source row and column).

Probes (after the kernel phase): the counterparts of the JAX package's
``scripts/`` probes (``flash_viterbi_tpu_torch.probes``).  Every probe
kernel that computes a defined function is held bit-exact against its
plain version on the card: the add+max chains at R=64 and R=4096; the
scan ablation on its three shapes, with and without the history, at every
staged chunk (K=16384 compared at T'=4: the plain version's (K, K)
temporary is 1 GiB a lane-step); the beam probes ``full``, ``sort``,
``pick``, ``nosmem`` and ``blockm`` against the plain beam scan and the
production ``beam_scan`` on the probes' fixture and on a tie fixture; p1
and p3 on the TPU probe's fixture and on a beam scan's rows, p4, p5 on its
forced tie.  Then the probe path, ``probes.run()``, is driven between a
reset and a read of the launch counters: every probe kernel must launch.
Each variant's time is printed beside its bound, counted as in
``compare``; the measured add+max rate gives the scans' operation bound
beside the one at the published fp32 rate.

Launch counters are set to 0 before each phase and read after it; every
kernel of that phase's path must have launched.  Prints a ``{"kernels":
[...]}`` JSON line (launches summed over the decode phases of this
process, and the probe kernels' over the probe path), then, last, the
``{"ok": true, "device": {...}}`` line.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HEADLINE = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
SEGMENTS = 16
EXTRA_SEEDS = (2, 3, 4)
LONG_T = 16384
LONG_T_PEAK_BYTES = 32 * 2**20
BATCHES = (16, 64)
BEAM_WIDTH = 64
BEAM_SEGMENTS = 8
BEAM_MEMORY = {"flash_bs": 12656, "beam": 133120}
RANK_MESHES = ((1, 1, 2), (1, 2, 2))
# config-5 (K=16384, T=65536, 256 sequences) with T cut to 4096 and 2
# sequences: its K, the size state sharding exists for, in a short run;
# both sequences in one microbatch, so each trellis step serves both
CONFIG5 = dict(K=16384, M=50, T=4096, prob=0.112, seed=1)
CONFIG5_BATCH = 2
CONFIG5_MICROBATCH = 2
CONFIG5_MESH = (1, 1, 4)
RANK_TIMEOUT_S = 300.0
SHARDED_NEEDS = ("maxplus_step_block", "maxplus_scan", "backtrack_batched",
                 "maxplus_scan_deltas", "argmax_walk")

# published peaks of one H100 SXM at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# kernel name -> (CUDA source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "maxplus_scan": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                     "flash_viterbi_tpu/ops/pallas/maxplus.py:467"),
    "maxplus_scan_deltas": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                            "flash_viterbi_tpu/ops/pallas/maxplus.py:240"),
    "maxplus_scan_emitgather": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                                "flash_viterbi_tpu/ops/pallas/maxplus.py:597"),
    "maxplus_step_block": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                           "flash_viterbi_tpu/ops/pallas/maxplus.py:720"),
    "backtrack_batched": ("flash_viterbi_tpu_torch/csrc/backtrack.cu",
                          "flash_viterbi_tpu/ops/pallas/backtrack.py:123"),
    "argmax_walk": ("flash_viterbi_tpu_torch/csrc/argmax_walk.cu",
                    "flash_viterbi_tpu/ops/pallas/backtrack.py:594"),
    "beam_scan": ("flash_viterbi_tpu_torch/csrc/beam_scan.cu",
                  "flash_viterbi_tpu/ops/pallas/beam.py:205"),
}
# the probes' kernels (flash_viterbi_tpu_torch/probes/), the same way
PROBE_KERNELS = {
    "probe_alu": ("flash_viterbi_tpu_torch/csrc/probe_alu.cu", "scripts/vpu_probe.py:67"),
    "probe_scan_ablation": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                            "scripts/vpu_probe.py:142"),
    "probe_beam_parts": ("flash_viterbi_tpu_torch/csrc/probe_beam.cu",
                         "scripts/beam_profile.py:120"),
    "probe_beam_select": ("flash_viterbi_tpu_torch/csrc/probe_beam.cu",
                          "scripts/beam_profile2.py:161"),
    "probe_copy_p1": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:52"),
    "probe_copy_p3": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:98"),
    "probe_copy_p4": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:126"),
    "probe_copy_p5": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:154"),
}
# the record of probes.run() whose time stands for each probe kernel: the
# production configuration where there is one, else the beam scan's rows
PROBE_TIMED = {"probe_alu": "vpu_peak", "probe_scan_ablation": "phaseA_hist_KC256",
               "probe_beam_parts": "full", "probe_beam_select": "pick",
               "probe_copy_p1": "p1_beam_rows", "probe_copy_p3": "p3_beam_rows",
               "probe_copy_p4": "p4", "probe_copy_p5": "p5"}
# the scan ablation's plain version is compared at this many steps at K=16384
PROBE_SCAN_COMPARE_TM = 4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def elapsed_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``reps`` synchronized runs of ``fn``."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; equal entries (including equal infinities) count 0."""
    a64, b64 = a.double(), b.double()
    diff = torch.where(a64 == b64, torch.zeros_like(a64), (a64 - b64).abs())
    return float(diff.max()) if diff.numel() else 0.0


def device_phase() -> torch.device:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return torch.device("cuda", 0)


def build_phase() -> None:
    from flash_viterbi_tpu_torch.runtime import build

    secs = build.build()
    build.kernels()
    print(f"build: nvcc {secs:.1f} s", flush=True)
    with open(build.BUILD_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])


def tables(hmm, pad_to: int, device):
    return hmm.log(device=device).padded(pad_to)


def phase_inputs(lh, y, device, seed: int):
    """The four kernels' inputs at the shapes the flash decode gives them:
    phase 1 (N=1 over T-1 steps) and phase 2 (N=16 lanes over the longest
    segment, with its ragged valid mask); lane start states drawn from
    ``seed`` stand in for the anchors."""
    from flash_viterbi_tpu_torch.algorithms.flash import (flash_midpoints,
                                                          segment_layout)

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    scan_in = (lh.logA, emits[1:].unsqueeze(1), (lh.logPi + emits[0])[None, :])
    mids = flash_midpoints(0, T - 1, SEGMENTS)
    starts, lens, Lmax = segment_layout(mids, T)
    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.integers(0, lh.K, SEGMENTS), device=device)
    idx = torch.clamp(torch.as_tensor(starts, device=device)[:, None]
                      + torch.arange(Lmax, device=device)[None, :], max=T - 1)
    seg = emits[idx]
    d0 = (lh.logA[init] + seg[:, 0]).contiguous()
    deltas_in = (lh.logA, seg[:, 1:].transpose(0, 1).contiguous(), d0)
    valid = (torch.arange(1, Lmax, device=device)[:, None]
             <= torch.as_tensor(lens, device=device)[None, :] - 1)
    return scan_in, deltas_in, valid


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def work_scan(args, outs):
    """maxplus_scan / maxplus_scan_deltas: every input and output once;
    an add and a max per (step, lane, source, destination)."""
    Tm, N, K = args[1].shape
    return nbytes(*args, *outs), 2 * Tm * N * K * K


def work_emitgather(args, outs):
    """The gather scan: as the scan, with only the logBT rows its symbols
    name."""
    logA, _, ys, delta0 = args
    Tm, N = ys.shape
    K = logA.shape[0]
    rows = int(torch.unique(ys).numel())
    return nbytes(logA, ys, delta0, *outs) + rows * K * 4, 2 * Tm * N * K * K


def work_backtrack(args, outs):
    """The pointer walk: one 4-byte pointer per (step, lane) it follows."""
    ptrs, last = args
    Tm, N, _ = ptrs.shape
    return Tm * N * 4 + nbytes(last, *outs), 0


def work_walk(args, outs):
    """The argmax walk: per walked row one carry row, and the logAT rows of
    the states it walks from (each distinct row once)."""
    deltas, logAT, last, valid = args
    Tm, N, K = deltas.shape
    v = torch.ones((Tm, N), dtype=torch.bool, device=deltas.device) if valid is None else valid
    walked = int(v.sum())
    rows = int(torch.unique(outs[0][:, 1:].t()[v]).numel())
    return (walked + rows) * K * 4 + nbytes(last, valid, *outs), 2 * walked * K


def work_beam(args, outs):
    """The beam scan: the distinct logA rows its beams fold (each once),
    the emission row of each real step, the small inputs and the outputs;
    an add and a compare per (step, slot, column) and a select of K."""
    logA, emits, vals0, states0, valid, prop = args
    Tm, N, K = emits.shape
    B = vals0.shape[1]
    v = torch.ones((Tm, N), dtype=torch.bool, device=emits.device) if valid is None else valid
    beams = torch.cat([states0[None], outs[0][:-1]])  # the beam each step folds
    rows = int(torch.unique(beams[v]).numel())
    steps = int(v.sum())
    return ((rows + steps) * K * 4 + nbytes(vals0, states0, valid, prop, *outs),
            steps * (2 * B * K + K))


def work_step_block(args, outs):
    """The step block: the carry, the column shard and both outputs once;
    an add and a max per (lane, source, destination)."""
    delta, logA_block = args
    return nbytes(*args, *outs), 2 * delta.shape[0] * logA_block.numel()


WORK = {"maxplus_scan": work_scan, "maxplus_scan_deltas": work_scan,
        "maxplus_scan_emitgather": work_emitgather, "maxplus_step_block": work_step_block,
        "backtrack_batched": work_backtrack, "argmax_walk": work_walk, "beam_scan": work_beam}


def bound(moved: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the published
    memory rate and the operations over the published fp32 rate."""
    by_bytes, by_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def compare(name: str, kernel, plain, args, device, reps: int = 0) -> dict:
    """Run a kernel and its plain version on the same inputs; require
    bit-equal outputs; optionally time both and bound the kernel: the
    larger of its bytes over the published memory rate and its operations
    over the published fp32 rate, counted from these inputs."""
    got, want = kernel(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{name}: kernel differs from its plain version (max abs err {err})")
    rec = {"name": name, "max_abs_err": err}
    if reps:
        rec["ms"] = elapsed_ms(lambda: kernel(*args), device, reps)
        rec["plain_ms"] = elapsed_ms(lambda: plain(*args), device, max(1, reps // 3))
        moved, ops = WORK[name](args, got)
        bound_ms, bound_by = bound(moved, ops)
        rec.update(bound_ms=bound_ms, bound_by=bound_by, bytes=moved, operations=ops,
                   # no single PyTorch call computes a max-plus scan, a
                   # pointer walk, a beam scan, or a max with its lowest index
                   library_ms=None)
    return rec


def check_all(scan_in, deltas_in, valid, device, reps: int = 0) -> list[dict]:
    """All four kernels against their plain versions: the pointer scan and
    the backtrack on ``scan_in``, the deltas scan and the walk (with the
    ``valid`` mask) on ``deltas_in``."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    recs = [compare("maxplus_scan", k.maxplus_scan, km.maxplus_scan_plain,
                    scan_in, device, reps),
            compare("maxplus_scan_deltas", k.maxplus_scan_deltas,
                    km.maxplus_scan_deltas_plain, deltas_in, device, reps)]
    dfin, ptrs = k.maxplus_scan(*scan_in)
    last = mp.first_argmax(dfin, 1)[1]
    recs.append(compare("backtrack_batched", k.backtrack_batched,
                        kb.backtrack_batched_plain, (ptrs, last), device, reps))
    dfinN, deltas = k.maxplus_scan_deltas(*deltas_in)
    lastN = mp.first_argmax(dfinN, 1)[1]
    logAT = deltas_in[0].t().contiguous()
    recs.append(compare("argmax_walk", k.argmax_walk, kb.argmax_walk_plain,
                        (deltas, logAT, lastN, valid), device, reps))
    return recs


def tie_fixture(device, K: int = 1000, N: int = 20, Tm: int = 21, seed: int = 5):
    """Integer-valued tables: exact fp32 ties everywhere.  K is not a
    multiple of the kernels' 32-column tile and N needs two lane groups."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    logA = put(np.round(rng.standard_normal((K, K)) * 2) / 2)
    emits = put(np.round(rng.standard_normal((Tm, N, K))))
    delta0 = put(np.round(rng.standard_normal((N, K))))
    valid = torch.as_tensor(rng.random((Tm, N)) < 0.8, device=device)
    return (logA, emits, delta0), valid


def hbm_read_gbps(device) -> float:
    """Measured read bandwidth: a max-reduction over 2 GiB of fp32."""
    x = torch.empty(2**29, dtype=torch.float32, device=device).uniform_()
    ms = elapsed_ms(lambda: torch.amax(x), device, 10)
    return x.numel() * 4 / (ms * 1e-3) / 1e9


def eg_inputs(lh, y, device):
    """The emission-gather scan's inputs for one chunk over steps 1..T-1
    of ``y`` (N=1): logA, logBT, the (T-1, 1) int32 symbols, and the
    step-0 carry."""
    logBT = lh.logB.t().contiguous()
    yd = torch.as_tensor(y, dtype=torch.int32, device=device)
    delta0 = (lh.logPi + logBT[yd[0].long()])[None, :].contiguous()
    return lh.logA, logBT, yd[1:, None].contiguous(), delta0


def tie_eg_inputs(ties, device, M: int = 7, seed: int = 6):
    """The tie fixture's logA and carries with an integer-valued (M, K)
    logBT and (T', N) symbols drawn from ``seed``."""
    logA, emits, delta0 = ties
    Tm, N, K = emits.shape
    rng = np.random.default_rng(seed)
    logBT = torch.as_tensor(np.round(rng.standard_normal((M, K))).astype(np.float32),
                            device=device)
    ys = torch.as_tensor(rng.integers(0, M, (Tm, N)).astype(np.int32), device=device)
    return logA, logBT, ys, delta0


def batch_seqs() -> np.ndarray:
    """The batch phase's (max(BATCHES), T) sequences,
    ``observations(T, M, seed=s)`` for s = 1, 2, ..."""
    from flash_viterbi_tpu_torch.models.generate import observations

    return np.stack([observations(HEADLINE["T"], HEADLINE["M"], seed=s)
                     for s in range(1, max(BATCHES) + 1)])


def batch_inputs(lh, seqs, device):
    """The four kernels' inputs at the shapes ``fused_decode_batch`` gives
    them for ``seqs``: one lane per sequence over T-1 steps, every row of
    the walk valid."""
    ys = torch.as_tensor(seqs.astype(np.int64), device=device)
    emits = lh.logB.t()[ys.t()].contiguous()
    scan_in = (lh.logA, emits[1:], (lh.logPi[None, :] + emits[0]).contiguous())
    return scan_in, scan_in, None


def beam_inputs(lh, y, device, B: int = BEAM_WIDTH, P: int = BEAM_SEGMENTS - 1):
    """The beam scan's inputs at flash_bs's phase-1 shape: N=1 over T-1
    steps from the top B of the first scores, with P anchor planes."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    vals0, states0 = beam_topk((lh.logPi + emits[0])[None, :], B)
    prop = torch.as_tensor(prop_schedule(flash_midpoints(0, T - 1, P + 1), T), device=device)
    return lh.logA, emits[1:].unsqueeze(1), vals0, states0, None, prop


def beam_segment_inputs(lh, y, device, seed: int, B: int = BEAM_WIDTH,
                        segments: int = BEAM_SEGMENTS):
    """The beam scan's inputs at flash_bs's segment shape: one lane per
    segment over Lmax-1 steps with the ragged valid mask; start rows from
    logA at states drawn from ``seed`` stand in for the anchors."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, segment_layout
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    starts, lens, Lmax = segment_layout(flash_midpoints(0, T - 1, segments), T)
    init = torch.as_tensor(np.random.default_rng(seed).integers(0, lh.K, segments),
                           device=device)
    idx = torch.clamp(torch.as_tensor(starts, device=device)[:, None]
                      + torch.arange(Lmax, device=device)[None, :], max=T - 1)
    seg = emits[idx]
    vals0, states0 = beam_topk(lh.logA[init] + seg[:, 0], B)
    valid = (torch.arange(1, Lmax, device=device)[:, None]
             <= torch.as_tensor(lens, device=device)[None, :] - 1)
    return lh.logA, seg[:, 1:].transpose(0, 1).contiguous(), vals0, states0, valid, None


def beam_tie_inputs(ties, valid, device, B: int = 128, P: int = 3, seed: int = 7):
    """The tie fixture's tables made sparse (0.4% of the edges) and its
    start rows cut to ~0.5% finite scores, so the early beams hold fewer
    than B finite scores; with its valid mask and P planes."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    logA, emits, delta0 = ties
    Tm, K = emits.shape[0], logA.shape[0]
    rng = np.random.default_rng(seed)
    neg = torch.tensor(float("-inf"), device=device)
    sparse = torch.where(torch.as_tensor(rng.random((K, K)) < 0.004, device=device),
                         logA, neg)
    start = torch.where(torch.as_tensor(rng.random(tuple(delta0.shape)) < 0.005,
                                        device=device), delta0, neg)
    vals0, states0 = beam_topk(start, B)
    prop = torch.as_tensor(prop_schedule(flash_midpoints(0, Tm, P + 1), Tm + 1),
                           device=device)
    return sparse, emits, vals0, states0, valid, prop


def beam_select_checks(device) -> None:
    """``beam_topk`` on the card against the kernel's own select: a one-step
    scan over all-zero transitions from an all-zero beam selects the top B
    of its emission row.  The row holds ties, -inf and -0.0.  Then a select
    too large for one block must raise, naming the limit."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.beam import beam_topk
    from flash_viterbi_tpu_torch.ops.cuda import beam as kb

    K = 1000
    row = np.random.default_rng(11).choice(
        np.array([1.0, 0.5, 0.0, -0.0, -2.0, -np.inf], np.float32), K)
    row_d = torch.as_tensor(row, device=device)
    zerosA = torch.zeros((K, K), device=device)
    for B in (1, 128, K):
        hist, _, _ = k.beam_scan(zerosA, row_d[None, None, :],
                                 torch.zeros((1, B), device=device),
                                 torch.zeros((1, B), dtype=torch.int32, device=device))
        card = beam_topk(row_d[None], B)[1]
        cpu = beam_topk(torch.as_tensor(row)[None], B)[1]
        require(torch.equal(hist[0], card) and torch.equal(card.cpu(), cpu),
                f"beam_topk on the card differs from the kernel's select at B={B}")
    big = 17000  # the next power of two's keys alone exceed a block's memory
    try:
        k.beam_scan(torch.empty((big, big), device=device),
                    torch.zeros((1, 1, big), device=device),
                    torch.zeros((1, 1), device=device),
                    torch.zeros((1, 1), dtype=torch.int32, device=device))
    except ValueError as e:
        require(str(kb.SMEM_LIMIT) in str(e), f"the limit is not named: {e}")
    else:
        require(False, f"beam_scan at Kp={big} did not raise")
    print("beam select: beam_topk on the card equals the kernel's select at "
          "B = 1, 128, 1000; Kp=17000 raises", flush=True)


def step_block_inputs(lh, y, device):
    """maxplus_step_block's inputs on the headline tables at the sharded
    decode's shapes: the (1, 1, 1) mesh's boundary step (the N=1 first
    carry against the whole table) and 16 phase-2 lanes (phase_inputs'
    carries) against the first of 4 state ranks' column shards."""
    scan_in, deltas_in, _ = phase_inputs(lh, y, device, seed=3)
    return ((scan_in[2], lh.logA),
            (deltas_in[2], lh.logA[:, :lh.Kp // 4].contiguous()))


def step_block_config5_inputs(device, seed: int = 5):
    """One carry against config-5's K on one of 4 state ranks: a (16384,
    4096) block, 11.2% of it finite (the generator's edge density), drawn
    on the card from ``seed``."""
    K, Kd = CONFIG5["K"], CONFIG5["K"] // CONFIG5_MESH[2]
    g = torch.Generator(device=device).manual_seed(seed)
    block = torch.randn((K, Kd), generator=g, device=device)
    keep = torch.rand((K, Kd), generator=g, device=device) < CONFIG5["prob"]
    block = torch.where(keep, block, torch.tensor(float("-inf"), device=device))
    return torch.randn((1, K), generator=g, device=device), block


def step_block_tie_inputs(device, N: int = 20, Ks: int = 1000, Kd: int = 250,
                          seed: int = 8):
    """Integer-valued carries and block (exact ties everywhere); source row
    17 repeats row 3 in both; source row 9 and column 5 are all -inf; Kd is
    not a multiple of the 32-column tile and N needs two lane groups."""
    rng = np.random.default_rng(seed)
    block = np.round(rng.standard_normal((Ks, Kd)) * 2) / 2
    delta = np.round(rng.standard_normal((N, Ks)))
    block[17], delta[:, 17] = block[3], delta[:, 3]
    block[9], block[:, 5] = -np.inf, -np.inf
    return tuple(torch.as_tensor(x.astype(np.float32), device=device) for x in (delta, block))


def kernel_phase(hmm, y, device) -> dict[str, dict]:
    """Kernels against plain versions; returns per-kernel records timed at
    the headline shapes, with the worst error over every fixture."""
    from flash_viterbi_tpu_torch.ops import beam as bp
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    def check_eg(args, reps: int = 0) -> dict:
        return compare("maxplus_scan_emitgather", k.maxplus_scan_emitgather,
                       km.maxplus_scan_emitgather_plain, args, device, reps)

    def check_beam(args, reps: int = 0) -> dict:
        return compare("beam_scan", k.beam_scan, bp.beam_scan_plain, args, device, reps)

    def check_step(args, reps: int = 0) -> dict:
        return compare("maxplus_step_block", k.maxplus_step_block,
                       km.maxplus_step_block_plain, args, device, reps)

    head, unpadded = tables(hmm, 128, device), tables(hmm, 1, device)
    scan_in, deltas_in, valid = phase_inputs(head, y, device, seed=0)
    eg_in = eg_inputs(head, y, device)
    boundary, lanes16 = step_block_inputs(head, y, device)
    timed = (check_all(scan_in, deltas_in, valid, device, reps=9) + [check_eg(eg_in, 9)]
             + [check_beam(beam_inputs(head, y, device), 9), check_step(boundary, 9)])
    config5_block = step_block_config5_inputs(device)
    steps = [check_step(lanes16, 9), check_step(config5_block, 9)]
    ties, valid = tie_fixture(device)
    beam_seg, beam_b1 = beam_segment_inputs(head, y, device, seed=2), beam_inputs(
        head, y, device, B=1)
    others = (check_all(*phase_inputs(unpadded, y, device, seed=1), device)
              + check_all(ties, ties, valid, device)
              + check_all(*batch_inputs(head, batch_seqs(), device), device)
              + [check_eg(eg_inputs(unpadded, y, device)),
                 check_eg(tie_eg_inputs(ties, device)),
                 check_beam(beam_seg),
                 check_beam(beam_inputs(unpadded, y, device)),
                 check_beam(beam_tie_inputs(ties, valid, device)),
                 check_beam(beam_b1),
                 check_step(step_block_tie_inputs(device))] + steps)
    for args, r in zip((boundary, lanes16, config5_block),
                       [timed[-1]] + steps):
        (N, Ks), Kd = args[0].shape, args[1].shape[1]
        print(f"maxplus_step_block at (N, Ks, Kd) = ({N}, {Ks}, {Kd}): {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.3f} ms); bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']} ({r['bytes']} bytes)", flush=True)
    beam_select_checks(device)
    # attribution: at B=1 the fold reads one row a step, so the time is the
    # select and the step's fixed cost
    print(f"beam_scan at the segment shape (8 lanes, T'={beam_seg[1].shape[0]}): "
          f"{elapsed_ms(lambda: k.beam_scan(*beam_seg), device, 9):.3f} ms; at the "
          f"phase-1 shape with B=1: {elapsed_ms(lambda: k.beam_scan(*beam_b1), device, 9):.3f}"
          f" ms", flush=True)
    recs = {r["name"]: dict(r, fixtures=1) for r in timed}
    for r in others:
        rec = recs[r["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["fixtures"] += 1
    for name, r in recs.items():
        print(f"kernel {name}: bit-exact on {r['fixtures']} fixtures; {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f} ms) at the headline shape; bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({r['bytes']} bytes, "
              f"{r['operations']} operations)", flush=True)

    # the two pointer scans at one shape, timed in turns
    turns = {"maxplus_scan": [], "maxplus_scan_emitgather": []}
    for name, fn, args in (("maxplus_scan", k.maxplus_scan, scan_in),
                           ("maxplus_scan_emitgather", k.maxplus_scan_emitgather, eg_in),
                           ("maxplus_scan_emitgather", k.maxplus_scan_emitgather, eg_in),
                           ("maxplus_scan", k.maxplus_scan, scan_in)):
        turns[name].append(elapsed_ms(lambda: fn(*args), device, 9))
    scan_ms, eg_ms = (statistics.mean(turns[n]) for n in turns)
    print(f"in turns at N=1, T'={len(y) - 1}, Kp={head.Kp}: maxplus_scan_emitgather "
          f"{eg_ms:.3f} ms vs maxplus_scan {scan_ms:.3f} ms "
          f"({(eg_ms / scan_ms - 1) * 100:+.2f}%); runs {turns}", flush=True)
    return recs


def probe_check_phase(device) -> dict[str, dict]:
    """Every probe kernel that computes a defined function against its
    plain version on the card, bit for bit, on every fixture; the beam
    probes also against the production beam_scan.  Returns per-kernel
    records: the worst error, the fixtures and the plain version's time
    at the probe's timed shape."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.probes import alu, beam, copy, scan

    recs = {name: {"max_abs_err": 0.0, "fixtures": 0} for name in PROBE_KERNELS}

    def hold(name: str, got, want) -> None:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            require((g is None) == (w is None), f"{name}: outputs differ in kind")
            if g is None:
                continue
            err = max_abs_err(g, w)
            require(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w),
                    f"{name}: kernel differs from its plain version (max abs err {err})")
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
        recs[name]["fixtures"] += 1

    x = alu.inputs(device=device)
    for r in (alu.R, alu.RATE_R):
        hold("probe_alu", alu.probe_alu(x, r), alu.probe_alu_plain(x, r))
    recs["probe_alu"]["plain_ms"] = elapsed_ms(lambda: alu.probe_alu_plain(x, alu.R), device, 3)

    cache = {}
    for shape, (K, N, Tm) in scan.SHAPES.items():
        Tc = min(Tm, PROBE_SCAN_COMPARE_TM) if K > 4096 else Tm
        args = scan.inputs(K, N, Tc, device, cache=cache)
        dfin, deltas = scan.probe_scan_ablation_plain(*args)
        for write_hist in (True, False):
            for kc in scan.KCS:
                hold("probe_scan_ablation", scan.probe_scan_ablation(*args, write_hist, kc),
                     (dfin, deltas if write_hist else None))
        print(f"probe scan ablation {shape} (K={K}, N={N}, T'={Tc}): dfin and the history "
              f"bit-exact, with and without it, at KC = {scan.KCS}", flush=True)
    K, N, Tm = scan.SHAPES["phaseA"]
    full = scan.inputs(K, N, Tm, device, cache=cache)
    recs["probe_scan_ablation"]["plain_ms"] = elapsed_ms(
        lambda: scan.probe_scan_ablation_plain(*full), device, 1)
    del cache, full, args, dfin, deltas

    ties = [a if a.dtype != torch.float32 else torch.round(a * 2) / 2 + 0.0
            for a in beam.inputs(beam.B, 3968, beam.TM, device, seed=1)]
    for args in (beam.inputs(device=device), tuple(ties)):
        want = beam.probe_beam_plain(*args)
        hist, slots, _ = k.beam_scan(*args)
        require(torch.equal(hist * 256 + slots, want),
                "beam_scan differs from the plain beam scan on a probe fixture")
        hold("probe_beam_parts", beam.probe_beam_parts(*args, "full"), want)
        for variant in ("sort", "pick", "nosmem", "blockm"):
            hold("probe_beam_select", beam.probe_beam_select(*args, variant), want)
    args = beam.inputs(device=device)
    plain_ms = elapsed_ms(lambda: beam.probe_beam_plain(*args), device, 3)
    recs["probe_beam_parts"]["plain_ms"] = recs["probe_beam_select"]["plain_ms"] = plain_ms
    print("probe beam: full, sort, pick, nosmem and blockm equal the plain beam scan and "
          "beam_scan (hist * 256 + slots) on the probes' fixture (B=64, K=4096, T'=255) and "
          "a tie fixture (K=3968, values in halves)", flush=True)

    rows = copy.beam_rows(device=device)
    for x in (copy.fixture(device=device), rows):
        hold("probe_copy_p1", copy.probe_copy_p1(x), x.clone())
        hold("probe_copy_p3", copy.probe_copy_p3(x), x.clone())
    for name in ("probe_copy_p1", "probe_copy_p3"):
        recs[name]["plain_ms"] = elapsed_ms(lambda: rows.clone(), device, 9)
        out = torch.empty_like(rows)
        recs[name]["library_ms"] = elapsed_ms(lambda: out.copy_(rows), device, 9)
    hold("probe_copy_p4", copy.probe_copy_p4(device=device),
         copy.probe_copy_p4_plain(device=device))
    hold("probe_copy_p4", copy.probe_copy_p4(255, 32, device=device),
         copy.probe_copy_p4_plain(255, 32, device=device))
    recs["probe_copy_p4"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p4_plain(device=device), device, 9)
    v, c = copy.p5_fixture(device=device)
    hold("probe_copy_p5", copy.probe_copy_p5(v, c), copy.probe_copy_p5_plain(v, c))
    best = min(zip(-v.cpu().numpy().ravel(), c.cpu().numpy().ravel()))
    require(int(copy.probe_copy_p5(v, c)[1][0, 0]) == best[1], "p5: not the numpy winner")
    recs["probe_copy_p5"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p5_plain(v, c), device, 9)
    print("probe copies: p1 and p3 on the TPU probe's fixture and on 255 rows of 3968 floats, "
          "p4 at (4, 8) and (255, 32), p5 on its forced tie: bit-exact, no mbarrier wait "
          "timed out", flush=True)
    return recs


def probe_phase(device, probe_recs: dict[str, dict], kernel_recs: dict[str, dict]) -> dict:
    """The probe path, ``probes.run()``, between a reset and a read of the
    launch counters: every probe kernel must launch.  Prints each
    variant's time beside its bound, the measured add+max rate and the
    scans' operation bound at it; fills ``probe_recs`` with each probe
    kernel's time and bound.  Returns the launches."""
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.probes import alu

    t0 = time.perf_counter()
    records, launches = drive("probes", PROBE_KERNELS, lambda: probes.run(device=device))
    timed = {}
    for rec in records:
        if "skipped" in rec:
            print(f"probe {rec['probe']} {rec['variant']}: no run ({rec['skipped']})")
            continue
        ms = rec["per_call_s"] * 1e3
        bound_ms, bound_by = bound(rec["bytes"], rec["operations"])
        timed.setdefault(rec["kernel"], {})[rec["variant"]] = (ms, bound_ms, bound_by)
        print(f"probe {rec['probe']} {rec['variant']} {rec.get('jax', '')}: {ms:.4f} ms a call; "
              f"bound {bound_ms:.6f} ms by {bound_by} ({rec['bytes']} bytes, "
              f"{rec['operations']} operations); {json.dumps(rec)}", flush=True)
    print(f"probes: {time.perf_counter() - t0:.1f} s", flush=True)
    steps = next(r["Tm"] for r in records if r.get("kernel") == "probe_beam_parts")
    us = {v: t[0] / steps * 1e3 for k in ("probe_beam_parts", "probe_beam_select")
          for v, t in timed[k].items()}
    print(f"beam step split, us a step (B=64, K=4096, T'={steps}): whole step {us['full']:.2f}; "
          f"row reads ~ full - no-dma = {us['full'] - us['no-dma']:.2f}; fold ~ full - no-fold "
          f"= {us['full'] - us['no-fold']:.2f}; select (sort) ~ full - no-pick = "
          f"{us['full'] - us['no-pick']:.2f}; selects in place of the sort: "
          + ", ".join(f"{v} {us[v] - us['sort']:+.2f}" for v in
                      ("pick", "nosmem", "blockm", "onereduce")), flush=True)
    for name, variant in PROBE_TIMED.items():
        ms, bound_ms, bound_by = timed[name][variant]
        probe_recs[name].update(ms=ms, bound_ms=bound_ms, bound_by=bound_by, timed=variant)
        probe_recs[name].setdefault("library_ms", None)

    rate = next(r for r in records if r["variant"] == "vpu_peak_rate")
    print(f"add+max rate (probe_alu, R={rate['R']}, {rate['shape']}): "
          f"{rate['cells_per_s']:.6g} cells/s, {rate['ops_per_s']:.6g} operations/s "
          f"({rate['ops_per_s'] / PEAK_FP32_PER_S * 100:.1f}% of the published "
          f"{PEAK_FP32_PER_S:.3g} fp32 FLOP/s)", flush=True)
    for name in ("maxplus_scan", "maxplus_scan_deltas", "maxplus_scan_emitgather"):
        ops = kernel_recs[name]["operations"]
        print(f"{name}: operation bound {ops / PEAK_FP32_PER_S * 1e3:.5f} ms at the published "
              f"fp32 rate, {ops / rate['ops_per_s'] * 1e3:.5f} ms at the measured add+max "
              f"rate ({ops} operations; {kernel_recs[name]['ms']:.3f} ms measured)", flush=True)
    try:
        print(f"probe_alu SASS: {alu.sass_counts()}", flush=True)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"probe_alu SASS: not read ({e})", flush=True)
    return launches


def nonzero(counts: dict[str, int]) -> dict[str, int]:
    return {n: c for n, c in counts.items() if c}


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launches, the probes' included."""
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.ops import cuda as k

    return {**k.launch_counts(), **probes.launch_counts()}


def reset_launches() -> None:
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.ops import cuda as k

    k.reset_launches()
    probes.reset_launches()


def drive(label: str, needed, run):
    """Run one phase between a reset and a read of the launch counters;
    require every kernel in ``needed`` to have launched.  Returns
    (``run()``'s result, the counts)."""
    reset_launches()
    out = run()
    launches = launch_counts()
    print(f"{label}: kernel launches (warmups included): {nonzero(launches)}",
          flush=True)
    missing = [n for n in needed if launches[n] == 0]
    require(not missing, f"{label}: a kernel of the path never launched: {missing}")
    return out, launches


def oracle_verdict(hmm, y, path, oracle, exact: bool) -> str:
    """Hold ``path`` to the C oracle's: equal, or (unless ``exact``) an
    fp32 tie flip within the f64 score tolerance."""
    from flash_viterbi_tpu_torch.oracle.validate import (path_score_f64,
                                                         score_tolerance_f64)

    if np.array_equal(path, oracle):
        return "exact"
    require(not exact, "the seed-1 request must equal the C oracle exactly")
    s_got = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
    s_ref = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
    tol = score_tolerance_f64(len(y), s_ref)
    require(bool(np.isfinite(s_got)) and abs(s_got - s_ref) <= tol,
            f"f64 score {s_got} vs oracle {s_ref} (tol {tol})")
    return (f"tie-equivalent ({int((path != oracle).sum())} positions, "
            f"f64 score gap {abs(s_got - s_ref):.3g})")


def slice_phase(hmm, requests, oracles, device, cpu_device) -> dict[str, int]:
    """Decode every request with FLASH on ``device``; check against the CPU
    decode, the C oracle and the analytic memory; return the launches."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms.flash import _memory

    K, T = hmm.K, len(requests[0])
    results, launches = drive(
        f"flash, {len(requests)} decodes",
        ("maxplus_scan", "maxplus_scan_deltas", "backtrack_batched", "argmax_walk"),
        lambda: [decode(hmm, y, "flash", num_segments=SEGMENTS, device=device)
                 for y in requests])
    want_mem = _memory(K=K, T=T, num_segments=SEGMENTS)
    for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
        cpu = decode(hmm, y, "flash", num_segments=SEGMENTS, device=cpu_device,
                     warmup=False)
        require(np.array_equal(r.path, cpu.path),
                f"request {i}: {device} path differs from the CPU decode")
        verdict = oracle_verdict(hmm, y, r.path, oracle, exact=i == 0)
        require(r.memory_bytes == want_mem,
                f"request {i}: memory {r.memory_bytes} != {want_mem}")
        require(r.path.shape == (T,) and bool(((r.path >= 0) & (r.path < K)).all()),
                f"request {i}: path out of range")
        print(f"request {i}: time_s {r.time_s:.6f}, "
              f"{K * K * T / r.time_s / 1e9:.2f} G updates/s, oracle {verdict}, "
              f"cpu decode {cpu.time_s:.2f} s, memory {r.memory_bytes}, "
              f"launches {nonzero(r.extra['launches'])}", flush=True)
    return launches


def checkpoint_phase(hmm, requests, oracles, device) -> list[dict[str, int]]:
    """Decode every request with checkpoint and with fused on ``device``;
    checkpoint must equal fused bit for bit and the C oracle; returns the
    launches of both."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms import checkpoint, fused

    K, T = hmm.K, len(requests[0])
    ck, ck_launches = drive(
        f"checkpoint, {len(requests)} decodes",
        ("maxplus_scan_emitgather", "backtrack_batched"),
        lambda: [decode(hmm, y, "checkpoint", device=device) for y in requests])
    fu, fu_launches = drive(
        f"fused, {len(requests)} decodes", ("maxplus_scan", "backtrack_batched"),
        lambda: [decode(hmm, y, "fused", device=device) for y in requests])
    for i, (y, c, f, oracle) in enumerate(zip(requests, ck, fu, oracles)):
        require(np.array_equal(c.path, f.path),
                f"request {i}: checkpoint path differs from fused")
        verdict = oracle_verdict(hmm, y, c.path, oracle, exact=i == 0)
        require(c.memory_bytes == checkpoint._memory(K=K, T=T),
                f"request {i}: checkpoint memory {c.memory_bytes}")
        require(f.memory_bytes == fused._memory(K=K, T=T),
                f"request {i}: fused memory {f.memory_bytes}")
        print(f"request {i}: checkpoint {c.time_s * 1e3:.3f} ms "
              f"(memory {c.memory_bytes}, launches {nonzero(c.extra['launches'])}), "
              f"fused {f.time_s * 1e3:.3f} ms (memory {f.memory_bytes}, launches "
              f"{nonzero(f.extra['launches'])}); equal paths, oracle {verdict}", flush=True)
    return [ck_launches, fu_launches]


def beam_phase(hmm, requests, oracles, device, cpu_device) -> list[dict[str, int]]:
    """Decode every request with flash_bs and with beam on ``device``; each
    path must equal the CPU decode and the numpy mirror exactly, and each
    ``memory:`` its analytic value.  Prints the f64 score gap to the C
    oracle's path.  Returns the launches of both."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms import beam, flash_bs
    from flash_viterbi_tpu_torch.oracle import framework
    from flash_viterbi_tpu_torch.oracle.validate import path_score_f64

    K, T = hmm.K, len(requests[0])
    all_launches = []
    for name, static, mirror, memory in (
            ("flash_bs", {"beam_width": BEAM_WIDTH, "num_segments": BEAM_SEGMENTS},
             framework.flash_bs, flash_bs._memory),
            ("beam", {"beam_width": BEAM_WIDTH}, framework.beam, beam._memory)):
        results, launches = drive(
            f"{name}, {len(requests)} decodes", ("beam_scan", "backtrack_batched"),
            lambda: [decode(hmm, y, name, device=device, **static) for y in requests])
        all_launches.append(launches)
        want_mem = memory(K=K, T=T, **static)
        require(want_mem == BEAM_MEMORY[name], f"{name}: analytic memory {want_mem}")
        for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
            cpu = decode(hmm, y, name, device=cpu_device, warmup=False, **static)
            require(np.array_equal(r.path, cpu.path),
                    f"{name} request {i}: {device} path differs from the CPU decode")
            require(np.array_equal(r.path, mirror(hmm.A, hmm.B, hmm.Pi, y, **static)),
                    f"{name} request {i}: path differs from the numpy mirror")
            require(r.memory_bytes == want_mem,
                    f"{name} request {i}: memory {r.memory_bytes} != {want_mem}")
            require(r.path.shape == (T,) and bool(((r.path >= -1) & (r.path < K)).all()),
                    f"{name} request {i}: path out of range")
            misses = int((r.path == -1).sum())
            gap = "n/a (-1 positions)" if misses else repr(
                path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
                - path_score_f64(hmm.A, hmm.B, hmm.Pi, y, r.path))
            print(f"{name} request {i}: {r.time_s * 1e3:.3f} ms, -1 positions {misses}, "
                  f"f64 score gap to the C oracle {gap}, memory {r.memory_bytes}, "
                  f"launches {nonzero(r.extra['launches'])}, cpu decode "
                  f"{cpu.time_s:.2f} s; equal to the CPU decode and the mirror",
                  flush=True)
    return all_launches


def long_t_phase(hmm, device) -> dict[str, int]:
    """T=16384 through the registered checkpoint and fused decoders on
    tables already on the card: equal paths, and the checkpoint decode's
    peak allocation above what was allocated before it under 32 MiB."""
    from flash_viterbi_tpu_torch import build
    from flash_viterbi_tpu_torch.models.generate import observations
    from flash_viterbi_tpu_torch.ops import maxplus as mp

    lh = tables(hmm, 128, device)
    y = observations(LONG_T, HEADLINE["M"], seed=1)
    args = (lh.logA, lh.logB, lh.logPi,
            torch.as_tensor(y.astype(np.int64), device=device))
    rows = {}

    def run():
        for name in ("checkpoint", "fused"):
            dec = build(name)
            dec(*args)  # warmup
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            path = dec(*args)
            end.record()
            end.synchronize()
            rows[name] = (path, start.elapsed_time(end),
                          torch.cuda.max_memory_allocated(device) - before)

    _, launches = drive(f"long T={LONG_T}",
                        ("maxplus_scan_emitgather", "backtrack_batched", "maxplus_scan"),
                        run)
    (ck, ck_ms, ck_peak), (fu, fu_ms, fu_peak) = rows["checkpoint"], rows["fused"]
    require(torch.equal(ck, fu), f"T={LONG_T}: checkpoint path differs from fused")
    require(ck.shape == (LONG_T,) and bool(((ck >= 0) & (ck < hmm.K)).all()),
            f"T={LONG_T}: path out of range")
    score = float(mp.path_score(*args, ck))
    require(np.isfinite(score), f"T={LONG_T}: path score {score}")
    require(ck_peak < LONG_T_PEAK_BYTES,
            f"T={LONG_T}: checkpoint peak {ck_peak} bytes above the tables")
    K2T = hmm.K * hmm.K * LONG_T
    print(f"long T={LONG_T}, Kp={lh.Kp}: checkpoint {ck_ms:.3f} ms "
          f"({K2T / ck_ms / 1e6:.2f} G updates/s), peak +{ck_peak} bytes "
          f"({ck_peak / 2**20:.2f} MiB); fused {fu_ms:.3f} ms "
          f"({K2T / fu_ms / 1e6:.2f} G updates/s), peak +{fu_peak} bytes "
          f"({fu_peak / 2**20:.2f} MiB); equal paths, fp32 score {score}", flush=True)
    return launches


def batch_phase(hmm, device) -> list[dict[str, int]]:
    """``decode_batch(..., "fused")`` over 16 and 64 headline sequences in
    both pointer modes; every row must equal the sequence's single fused
    decode on the card.  Returns the launches of each batch."""
    from flash_viterbi_tpu_torch import build, decode_batch
    from flash_viterbi_tpu_torch.algorithms import fused

    K, T = hmm.K, HEADLINE["T"]
    log_tables = hmm.log(device=device)
    lh = tables(hmm, 128, device)
    seqs = batch_seqs()
    single = build("fused")
    singles = np.stack([
        single(lh.logA, lh.logB, lh.logPi,
               torch.as_tensor(s.astype(np.int64), device=device)).cpu().numpy()
        for s in seqs])
    all_launches = []
    for pointers, needed in (("recompute", ("maxplus_scan_deltas", "argmax_walk")),
                             ("store", ("maxplus_scan", "backtrack_batched"))):
        for Bs in BATCHES:
            r, launches = drive(
                f"batch Bs={Bs} pointers={pointers}", needed,
                lambda: decode_batch(log_tables, seqs[:Bs], "fused", device=device,
                                     pointers=pointers))
            all_launches.append(launches)
            require(np.array_equal(r.path, singles[:Bs]),
                    f"batch Bs={Bs} {pointers}: a row differs from its single decode")
            require(r.memory_bytes == Bs * fused._memory(K=K, T=T),
                    f"batch Bs={Bs} {pointers}: memory {r.memory_bytes}")
            print(f"batch Bs={Bs} pointers={pointers}: {r.time_s * 1e3:.3f} ms, "
                  f"{r.time_s * 1e3 / Bs:.3f} ms per sequence, "
                  f"{K * K * T * Bs / r.time_s / 1e9:.2f} G updates/s; "
                  f"rows equal the single decodes", flush=True)
    return all_launches


def sharded_phase(hmm, requests, oracles, device, cpu_device):
    """The four requests through ``decode_batch`` on a (1, 1, 1) mesh on
    ``device``: every row against the C oracle, request 0 against the CPU
    sharded decode bit for bit, ``memory:`` 4 x flash's.  Returns (the
    (4, T) paths, the launches)."""
    from flash_viterbi_tpu_torch import decode_batch, make_mesh
    from flash_viterbi_tpu_torch.algorithms.flash import _memory

    K, T = hmm.K, len(requests[0])
    ys = np.stack(requests)
    r, launches = drive(f"sharded (1, 1, 1), {len(ys)} sequences", SHARDED_NEEDS,
                        lambda: decode_batch(hmm, ys, mesh=make_mesh(1, 1, 1),
                                             num_segments=SEGMENTS, device=device))
    cpu = decode_batch(hmm, ys[:1], mesh=make_mesh(1, 1, 1), num_segments=SEGMENTS,
                       device=cpu_device, warmup=False)
    require(np.array_equal(r.path[:1], cpu.path),
            "sharded request 0: the card's path differs from the CPU sharded decode")
    require(r.memory_bytes == len(ys) * _memory(K=K, T=T, num_segments=SEGMENTS),
            f"sharded: memory {r.memory_bytes}")
    require(r.algorithm == "batched:flash"
            and r.extra["mesh"] == {"data": 1, "seq": 1, "state": 1},
            f"sharded: {r.algorithm}, mesh {r.extra['mesh']}")
    require(r.path.shape == ys.shape and bool(((r.path >= 0) & (r.path < K)).all()),
            "sharded: paths out of range")
    verdicts = [oracle_verdict(hmm, y, path, oracle, exact=i == 0)
                for i, (y, path, oracle) in enumerate(zip(requests, r.path, oracles))]
    print(f"sharded (1, 1, 1), {len(ys)} sequences: {r.time_s * 1e3:.3f} ms "
          f"({K * K * T * len(ys) / r.time_s / 1e9:.2f} G updates/s), memory "
          f"{r.memory_bytes}, launches {nonzero(r.extra['launches'])}; oracle "
          f"{verdicts}; request 0 equals the CPU sharded decode ({cpu.time_s:.2f} s)",
          flush=True)
    return r.path, launches


def run_ranks(job: dict) -> tuple[list[dict], float]:
    """Start one process per rank of ``job["mesh"]``, all on this card,
    joined over gloo (``launch_workers``: this script with rank arguments,
    a file:// store).  Returns each rank's record (its paths, decode ms,
    launches) and the seconds the ranks took, start-up included."""
    from flash_viterbi_tpu_torch.parallel.multihost import launch_workers

    n = int(np.prod(job["mesh"]))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        launch_workers(os.path.abspath(__file__), n, out, timeout=RANK_TIMEOUT_S,
                       env={"FVT_SMOKE_JOB": json.dumps(job)})
        wall = time.perf_counter() - t0
        recs = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                rec = json.load(f)
            rec["paths"] = np.load(os.path.join(out, f"rank{r}.npy"))
            recs.append(rec)
    return recs, wall


def check_ranks(label: str, recs: list[dict], want: np.ndarray, wall: float) -> None:
    """Every rank's paths must equal ``want`` bit for bit, and every rank
    must have launched the step block."""
    for rec in recs:
        require(np.array_equal(rec["paths"], want),
                f"{label} rank {rec['rank']}: paths differ from the one-rank run")
        require(rec["launches"].get("maxplus_step_block", 0) > 0,
                f"{label} rank {rec['rank']}: maxplus_step_block never launched")
    times = ", ".join(f"rank {rec['rank']} {tuple(rec['coords'])}: {rec['ms']:.3f} ms"
                      for rec in recs)
    print(f"{label}, {len(recs)} ranks time-sliced on one card (not several cards): "
          f"{times}; launches of rank 0 {recs[0]['launches']}; column shard of logA "
          f"{recs[0]['shard_bytes']} bytes a rank; every rank's paths equal the "
          f"one-rank run; {wall:.1f} s with start-up", flush=True)


def multi_rank_phase(want: np.ndarray) -> None:
    """The headline requests on each mesh of RANK_MESHES, every rank on this
    card; each rank's paths must equal the one-rank phase's."""
    for shape in RANK_MESHES:
        recs, wall = run_ranks({"mesh": shape, "problem": "headline",
                                "segments": SEGMENTS, "microbatch": 1, "warmup": True})
        check_ranks(f"sharded {shape}", recs, want, wall)


def config5_phase(device) -> dict[str, int]:
    """Config-5's K (T cut to 4096, 2 sequences): the (1, 1, 1) mesh in this
    process, then CONFIG5_MESH as ranks on the card, each uploading only its
    column shard of the tables, memory-mapped from .npy files.  Equal paths,
    in range, finite fp32 scores.  Returns the (1, 1, 1) run's launches."""
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.parallel.sharded import flash_decode_sharded, make_mesh

    t0 = time.perf_counter()
    hmm, y = make_sparse_hmm(**CONFIG5)
    lh = hmm.log(device="cpu")  # K=16384: no padding
    del hmm
    ys = np.stack([y] + [observations(CONFIG5["T"], CONFIG5["M"], seed=s)
                         for s in range(2, CONFIG5_BATCH + 1)])
    gen_s = time.perf_counter() - t0
    K, T = CONFIG5["K"], CONFIG5["T"]
    with tempfile.TemporaryDirectory() as tables:
        for name, t in (("logA", lh.logA), ("logB", lh.logB), ("logPi", lh.logPi)):
            np.save(os.path.join(tables, f"{name}.npy"), t.numpy())
        np.save(os.path.join(tables, "ys.npy"), ys)
        logA, logB, logPi = (t.to(device) for t in (lh.logA, lh.logB, lh.logPi))
        del lh

        def run():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            paths = flash_decode_sharded(make_mesh(), logA, logB, logPi, ys,
                                         num_segments=SEGMENTS,
                                         microbatch=CONFIG5_MICROBATCH)
            end.record()
            end.synchronize()
            return paths, start.elapsed_time(end)

        (paths, ms), launches = drive(f"config-5 K={K}, T={T}, (1, 1, 1)", SHARDED_NEEDS, run)
        yd = torch.as_tensor(ys.astype(np.int64), device=device)
        scores = [float(mp.path_score(logA, logB, logPi, yd[b], paths[b]))
                  for b in range(len(ys))]
        require(tuple(paths.shape) == ys.shape and bool(((paths >= 0) & (paths < K)).all()),
                "config-5: paths out of range")
        require(all(np.isfinite(scores)), f"config-5: path scores {scores}")
        print(f"config-5 K={K}, T={T} (cut from 65536), {len(ys)} sequences in "
              f"microbatches of {CONFIG5_MICROBATCH}, {SEGMENTS} segments, (1, 1, 1): "
              f"{ms:.3f} ms, no warmup "
              f"({K * K * T * len(ys) / ms / 1e6:.2f} G updates/s), fp32 scores {scores}; "
              f"tables made in {gen_s:.1f} s", flush=True)
        want = paths.cpu().numpy()
        del logA, logB, logPi, paths
        torch.cuda.empty_cache()
        recs, wall = run_ranks({"mesh": CONFIG5_MESH, "problem": tables,
                                "segments": SEGMENTS, "microbatch": CONFIG5_MICROBATCH,
                                "warmup": False})
    check_ranks(f"config-5 {CONFIG5_MESH}, no warmup", recs, want, wall)
    return launches


def headline() -> tuple:
    """(HMM, the four requests: the seed-1 sequence and
    ``observations(T, M, seed=s)`` for s in EXTRA_SEEDS)."""
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations

    hmm, y1 = make_sparse_hmm(**HEADLINE)
    return hmm, [y1] + [observations(HEADLINE["T"], HEADLINE["M"], seed=s)
                        for s in EXTRA_SEEDS]


def rank_main(init_method: str, rank: str, world: str, outdir: str) -> None:
    """One rank of a multi-rank phase, started by ``run_ranks`` with the job
    in ``FVT_SMOKE_JOB``: join the gloo world, upload this rank's column
    shard of the tables to ``cuda:0``, decode (after a warmup if the job
    asks), and write the paths, the decode's CUDA-event time and the
    launches of the timed decode into ``outdir``."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.parallel import multihost
    from flash_viterbi_tpu_torch.parallel.sharded import flash_decode_sharded, make_mesh

    job = json.loads(os.environ["FVT_SMOKE_JOB"])
    rank = int(rank)
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    multihost.initialize(init_method, int(world), rank, backend="gloo")
    mesh = make_mesh(*job["mesh"])
    if job["problem"] == "headline":
        hmm, requests = headline()
        lh = hmm.log(device="cpu").padded(128)
        logA, logB, logPi = (t.numpy() for t in (lh.logA, lh.logB, lh.logPi))
        ys = np.stack(requests)
    else:
        logA, logB, logPi, ys = (np.load(os.path.join(job["problem"], f"{n}.npy"), mmap_mode="r")
                                 for n in ("logA", "logB", "logPi", "ys"))
    Kd = logA.shape[0] // mesh.shape["state"]
    lo = mesh.coords[2] * Kd

    def upload(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    logA_l, logB_l, logPi_d = upload(logA[:, lo:lo + Kd]), upload(logB[lo:lo + Kd]), upload(logPi)
    ys = np.asarray(ys)

    def run():
        return flash_decode_sharded(mesh, logA_l, logB_l, logPi_d, ys,
                                    num_segments=job["segments"],
                                    microbatch=job["microbatch"])

    if job["warmup"]:
        run()
    k.reset_launches()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    paths = run()
    end.record()
    end.synchronize()
    np.save(os.path.join(outdir, f"rank{rank}.npy"), paths.cpu().numpy())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "coords": mesh.coords, "ms": start.elapsed_time(end),
                   "launches": nonzero(k.launch_counts()),
                   "shard_bytes": logA_l.numel() * logA_l.element_size()}, f)
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


def main() -> None:
    t_start = time.perf_counter()
    device = device_phase()
    build_phase()

    from flash_viterbi_tpu_torch.oracle import native

    hmm, requests = headline()
    y1 = requests[0]
    recs = kernel_phase(hmm, y1, device)
    t0 = time.perf_counter()
    probe_recs = probe_check_phase(device)
    print(f"probe kernels against their plain versions: {time.perf_counter() - t0:.1f} s",
          flush=True)
    probe_launches = probe_phase(device, probe_recs, recs)
    gbps = hbm_read_gbps(device)
    Kp, steps = tables(hmm, 128, "cpu").Kp, HEADLINE["T"] - 1
    floor_ms = steps * Kp * Kp * 4 / (gbps * 1e9) * 1e3
    print(f"HBM read {gbps:.1f} GB/s measured; the scan's per-step streaming "
          f"floor at K={Kp}: {steps} steps x {Kp * Kp * 4 / 2**20:.0f} MiB = "
          f"{floor_ms:.3f} ms at the measured rate, "
          f"{steps * Kp * Kp * 4 / PEAK_BYTES_PER_S * 1e3:.3f} ms at the published "
          f"3.35 TB/s", flush=True)
    t0 = time.perf_counter()
    oracles = [native.vanilla(hmm.A, hmm.B, hmm.Pi, y) for y in requests]
    print(f"C oracle: {len(requests)} decodes in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cpu = torch.device("cpu")
    launches = ([slice_phase(hmm, requests, oracles, device, cpu)]
                + checkpoint_phase(hmm, requests, oracles, device)
                + beam_phase(hmm, requests, oracles, device, cpu)
                + [long_t_phase(hmm, device)]
                + batch_phase(hmm, device))
    sharded_paths, sharded_launches = sharded_phase(hmm, requests, oracles, device, cpu)
    multi_rank_phase(sharded_paths)
    launches += [sharded_launches, config5_phase(device), probe_launches]
    recs.update(probe_recs)
    table = {**KERNELS, **PROBE_KERNELS}
    total = {name: sum(run[name] for run in launches) for name in table}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": table[name][0],
         "replaces": table[name][1], "launches": total[name],
         **{key: recs[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")}}
        for name in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 5:  # one rank of a multi-rank phase (run_ranks)
        rank_main(*sys.argv[1:])
    else:
        main()
