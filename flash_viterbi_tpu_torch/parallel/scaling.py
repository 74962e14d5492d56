"""Scaling model and measurement for the (data, seq, state) mesh.

Counterpart of ``flash_viterbi_tpu/parallel/scaling.py``: the same
formulas, fields and JSON schema, with the constants of an NVIDIA H100.
The BASELINE target is >= 80% scaling efficiency to >= 2 hosts at
K=16384, T=65536, 256 sequences.  This module provides

(a) an analytic model of the pipelined sharded decode
    (``parallel.sharded``): per-device trellis-update counts including the
    pipeline fill bubble, per-device memory (segment pointer tables, plane
    stores), and byte counts of every collective the decode issues; and
(b) *work counters* (``work_report``) from the same static plan, and a
    parity sweep (``measure_virtual``) that runs the sharded decode on
    every mesh shape as ranks of a gloo world and asserts bit-identical
    paths across the shapes.

Calibration: ``CHIP_UPDATES_PER_S`` is the fused decode's measured rate
on one card, not a data-sheet constant: 3965² x 16383 updates in 228.059
ms, the T=16384 fused decode on the headline tables
(``scripts/torch_profile_decodes.py``, NVIDIA H100 80GB HBM3, power limit
700.00 W); the headline T=256 decode, 3.812 ms in the same run, gives
1.05e12.  ``NVLINK_BYTES_PER_S`` is NVLink 4's published 450 GB/s a
direction (900 GB/s both ways, H100 SXM5): a data-sheet figure, not
measured, since one card has no link to measure.

Model summary (see ``analyze`` for the formulas):

* phase 1 is a pipeline over ``n_seq`` equal time blocks; with ``n_mb``
  microbatches in flight the bubble multiplies phase-1 device work by
  ``(n_mb + n_seq - 1) / n_mb``: for a single sequence this term reports
  the serial chain, for the 256-sequence config-5 batch it is a few
  percent.
* phase 2 is embarrassingly parallel over (data, seq) and state-sharded.
* state axis: 2 all_gathers (delta fp32 + ptr int32) per trellis step in
  both phases; ``8*K*(t-1)/t`` bytes per step per device.
* seq axis: one (mb, K) fp32 hop per pipeline tick, the (n_seq, Bd, K)
  boundary-plane gather, and the final (Bd, T) int32 sum.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The fused decode's rate on one NVIDIA H100 80GB HBM3 (700 W power limit):
# 3965^2 * 16383 trellis updates in 228.059 ms (module docstring).
CHIP_UPDATES_PER_S = 1.13e12
# NVLink 4, published, one direction (H100 SXM5); not measured.
NVLINK_BYTES_PER_S = 4.5e11

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scaling_worker.py")
JOB_ENV = "FVT_SCALING_JOB"


@dataclasses.dataclass
class ScalingReport:
    n_data: int
    n_seq: int
    n_state: int
    K: int
    T: int
    batch: int
    microbatch: int
    num_segments: int
    # per-device accounting
    updates_per_device: float          # trellis updates (phase 1 + 2 + bubble)
    ideal_updates_per_device: float    # 2*B*T*K^2 / n_devices
    ici_bytes_per_device: float        # interconnect bytes (JAX's field name)
    ptr_bytes_per_device: int          # phase-2 pointer tables (peak)
    plane_bytes_per_device: int        # phase-1 plane store
    # derived
    compute_s: float
    comm_s: float
    modeled_wall_s: float
    modeled_efficiency: float          # ideal_time(n devices) / modeled wall

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(mesh_shape: tuple[int, int, int], K: int, T: int, batch: int,
            microbatch: int = 1, num_segments: int | None = None,
            chip_updates_per_s: float = CHIP_UPDATES_PER_S,
            ici_bytes_per_s: float = NVLINK_BYTES_PER_S) -> ScalingReport:
    """Per-device model of one pipelined sharded decode; ``ici_bytes_per_s``
    is the interconnect's rate a direction (the JAX package's name)."""
    d, s, t = mesh_shape
    B, mb = batch, microbatch
    if B % d:
        raise ValueError("data axis size must divide the batch")
    Bd = B // d
    mb = min(mb, Bd)
    if Bd % mb:
        # mirror the implementation (sharded._flash_decode_pipelined): a
        # non-dividing microbatch is not a runnable config, so modeling it
        # would silently drop Bd % mb sequences from the accounting
        raise ValueError(
            f"microbatch {mb} must divide the per-data-shard batch {Bd}")
    n_mb = Bd // mb
    if num_segments is None:
        num_segments = 4 * s
    L = T // s

    # --- per-device update counts (what the implementation actually runs) ---
    # phase 1: every device computes (n_mb + s - 1) ticks of mb*L steps of
    # K*K/t updates (invalid pipeline ticks still execute).
    ticks = n_mb + s - 1
    spd = max(1, num_segments // s)
    upd_p1 = ticks * mb * max(L - 1, 1) * K * (K / t)
    # phase 2: Bd sequences x spd segments x (Lseg-1) steps, state-sharded
    upd_p2 = Bd * max(L - spd, 1) * K * (K / t)
    updates = upd_p1 + upd_p2
    # ideal = the same two passes' step counts with zero bubble/imbalance
    ideal = B * K * K * ((T - 1) + max(T - num_segments, 1)) / (d * s * t)

    # --- per-device interconnect bytes ---
    # state axis: delta fp32 + ptr int32 all_gather per step, both phases,
    # plus the boundary gathers: phase 1 adds 2 fp32 + 1 int32 (mb, K)
    # gathers per pipeline tick (delta0 init + final-boundary delta +
    # boundary ptr), phase 2 adds 2 fp32 per decoded (sequence, segment)
    # lane (init + final-argmax delta).  Phase 2 runs L - spd real steps
    # per sequence.
    frac_t = (t - 1) / t if t > 1 else 0.0
    steps_p1 = ticks * mb * max(L - 1, 1)
    steps_p2 = Bd * max(L - spd, 1)
    rows_state = (2 * (steps_p1 + steps_p2)      # per-step delta + ptr
                  + 3 * mb * ticks               # phase-1 tick boundaries
                  + 2 * Bd * spd)                # phase-2 lane boundaries
    bytes_state = rows_state * K * 4 * frac_t
    # seq axis: (mb, K) fp32 hop per tick; (s, Bd, K) plane + final
    # gathers; (Bd, T) int32 sum (log2 s stages, bidirectional halving)
    bytes_seq = 0.0
    if s > 1:
        bytes_seq += ticks * mb * K * 4                  # delta hops
        bytes_seq += (s - 1) * Bd * K * 4                # beta plane gather
        # finals: argmaxed locally before the gather (sharded.py), so the
        # collective ships (n_mb, mb) int32 per device, not (.., K) fp32
        bytes_seq += (s - 1) * Bd * 4
        bytes_seq += math.ceil(math.log2(s)) * Bd * T * 4  # path sum
    ici_bytes = bytes_state + bytes_seq

    # --- per-device memory (the terms that gate config-5 shapes) ---
    Lseg = max(1, L // spd)
    ptr_bytes = mb * spd * max(Lseg - 1, 1) * K * 4      # phase-2 pointer table
    plane_bytes = ticks * mb * spd * K * 4               # stacked plane store

    compute_s = updates / chip_updates_per_s
    comm_s = ici_bytes / ici_bytes_per_s
    wall = compute_s + comm_s
    ideal_wall = ideal / chip_updates_per_s
    return ScalingReport(
        n_data=d, n_seq=s, n_state=t, K=K, T=T, batch=B, microbatch=mb,
        num_segments=num_segments,
        updates_per_device=updates, ideal_updates_per_device=ideal,
        ici_bytes_per_device=ici_bytes,
        ptr_bytes_per_device=int(ptr_bytes),
        plane_bytes_per_device=int(plane_bytes),
        compute_s=compute_s, comm_s=comm_s, modeled_wall_s=wall,
        modeled_efficiency=ideal_wall / wall if wall else 0.0,
    )


def work_report(mesh_shape: tuple[int, int, int], K: int, T: int, batch: int,
                microbatch: int = 1, num_segments: int | None = None) -> dict:
    """Per-device work counters of the pipelined plan (no wall clocks):
    update counts, collective bytes, and memory — the load-bearing numbers
    the efficiency claim rests on."""
    rep = analyze(mesh_shape, K, T, batch, microbatch, num_segments)
    return {
        "mesh": dict(zip(("data", "seq", "state"), mesh_shape)),
        "updates_per_device": rep.updates_per_device,
        "ideal_updates_per_device": rep.ideal_updates_per_device,
        "work_balance": rep.ideal_updates_per_device / rep.updates_per_device,
        "ici_bytes_per_device": rep.ici_bytes_per_device,
        "ptr_bytes_per_device": rep.ptr_bytes_per_device,
        "plane_bytes_per_device": rep.plane_bytes_per_device,
        "modeled_efficiency": rep.modeled_efficiency,
    }


def single_chip_wall_model(K: int, T: int,
                           chip_updates_per_s: float = CHIP_UPDATES_PER_S
                           ) -> float:
    """Modeled single-card fused decode wall (seconds): the calibration
    anchor, to reproduce the measured fused rows within ~25%."""
    return (T - 1) * K * K / chip_updates_per_s


def common_segments(mesh_shapes, T: int) -> int:
    """One segment count valid for every shape (a multiple of each seq
    axis, <= T//2), so every sharding decodes the same tree: a fixed 8
    would let ``flash_decode_sharded`` renegotiate per shape, diverging
    from the counters and from the base path on fp ties."""
    lcm = 1
    for shape in mesh_shapes:
        lcm = math.lcm(lcm, shape[1])
    segs = max(lcm, (min(8, T // 2) // lcm) * lcm)
    if T < 2 * segs:
        raise ValueError(f"T={T} too short for a common segment count "
                         f"(seq axes need a multiple of {lcm})")
    return segs


def measure_virtual(mesh_shapes, K: int = 64, M: int = 8, T: int = 64,
                    prob: float = 0.3, batch: int = 8, seed: int = 7,
                    device="cuda"):
    """Run the sharded decode on each mesh shape; returns rows of (shape,
    paths_equal, work counters).

    Each shape runs as the ranks of its own gloo world
    (``multihost.launch_workers`` with ``scaling_worker.py``), all worlds
    at once; every rank decodes on ``device`` (on the card, every rank
    on ``cuda:0``).  ``paths_equal``: every rank's (batch, T) paths equal
    rank 0's of the first shape.  Ranks sharing one device measure its
    time-slicing, so no wall time is reported: correctness across
    shardings and the analytic counters are the artifact."""
    from ..models.hmm import resolve_device
    from .multihost import launch_workers

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..runtime import build as kernel_build

        kernel_build.kernels()  # once here, so the ranks find the library built
    segs = common_segments(mesh_shapes, T)
    shapes = [tuple(int(x) for x in shape) for shape in mesh_shapes]

    with tempfile.TemporaryDirectory() as root:
        def run(i: int) -> list[np.ndarray]:
            shape = shapes[i]
            n = int(np.prod(shape))
            job = dict(shape=shape, K=K, M=M, T=T, prob=prob, batch=batch, seed=seed,
                       segments=segs, device=dev.type)
            out = os.path.join(root, str(i))
            launch_workers(WORKER, n, out, env={JOB_ENV: json.dumps(job)})
            return [np.load(os.path.join(out, f"paths.rank{r}.npy")) for r in range(n)]

        with ThreadPoolExecutor(max_workers=len(shapes)) as pool:
            paths = list(pool.map(run, range(len(shapes))))

    base = paths[0][0]
    rows = []
    for shape, ranks in zip(shapes, paths):
        row = {"shape": shape,
               "paths_equal": all(np.array_equal(p, base) for p in ranks)}
        row.update(work_report(shape, K, T, batch, num_segments=segs))
        rows.append(row)
    return rows
