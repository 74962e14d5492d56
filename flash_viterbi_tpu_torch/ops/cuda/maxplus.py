"""The fused max-plus scans and the state-sharded step: CUDA kernels and
their plain versions.

Counterparts of ``flash_viterbi_tpu/ops/pallas/maxplus.py``'s
``maxplus_scan``, ``maxplus_scan_deltas``, ``maxplus_scan_emitgather`` and
``maxplus_step_block``, with the same signatures and layouts.  The kernels
are in ``csrc/maxplus_scan.cu``: the three scans run ``scan_persistent``,
one cooperative launch a call over the tiling of :func:`scan_plan`; the
step block runs ``step_block_kernel``, one launch a call over the tiling
of :func:`step_plan`.

The pointer and deltas scans also take a bfloat16 ``logA`` (``precision=
"bf16"``, as the Pallas scans load a bf16 tile): on CUDA tensors they hand
it to ``scan_persistent``'s bf16 instances, whose wrappers
:func:`maxplus_scan_bf16` and :func:`maxplus_scan_deltas_bf16` count their
own launches.  Each table value is widened to fp32 before the add, so the
result is the fp32 scan of the table rounded to bf16, bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils.profiling import span, traced
from .. import maxplus as mp
from .common import SMEM_LIMIT, expect, expect_contiguous, launch, on_cuda

THREADS = 512        # threads of a block of the persistent scan (csrc: PT)
LANES_MAX = 16       # lanes a group; more lanes go in groups, one after another
MIN_TILE_ROWS = 16   # source rows a tile keeps at least: small K takes fewer blocks
# logA's dtypes the pointer and deltas scans take
TABLE_DTYPES = (torch.float32, torch.bfloat16)
STATIC_SMEM = 1024   # bytes kept free for the kernel's static shared memory
SYNC_ERR = 32        # the error word's index in a call's own barrier words
# Above this many bytes of partials a block would read each step to form its
# range's carry on its own (K x lanes floats), the scan combines each entry
# once instead, between two barriers.  On an H100 on read was the faster at
# 1 and 2 lanes of K=3968 (15872 and 31744 bytes) and two-phase from 4 lanes
# (63488 bytes) up, and at K=16384 from 2 lanes; at one lane of K=16384
# (65536 bytes) the two were even (chip_smoke.py:combine_turns)
TWO_PHASE_BYTES = 48_000
STEP_THREADS = 256      # threads of a step-block tile (csrc: SB_THREADS)
STEP_WARPS = STEP_THREADS // 32  # warps of a tile, each folding a slice of its rows
STEP_UNITS = 32         # column units of a step-block tile: one a thread of a warp
STEP_CLUSTER_MAX = 16   # source ranges of a column group: a cluster (non-portable above 8)
STEP_MIN_ROWS = 4       # source rows a warp's slice keeps at least: small Ks takes fewer ranges
# Tiles an SM should hold at once: one where a step is a chase of bytes (few
# lanes), two from STEP_DENSE_LANES lanes up, where it is a chase of
# instructions and a second block hides the first's stalls.  On an H100 at
# Ks=3968 one lane ran fastest on 124-128 tiles (Kd = 1984, 3968) and 16
# lanes on 248 or more (Kd = 992, 1984) (scripts/torch_step_variants.py)
STEP_DENSE_LANES = 8
# The ring route (scan_plan(..., deltas=True)): the fp32 deltas scan where
# the plan above would hold no tile row in shared memory, at these lanes a
# group (csrc: the RING instances of scan_persistent)
RING_LANES = (4, 8, 16)
RING_STAGE_ROWS = 8     # table rows of a ring stage (csrc: RING_STAGE_ROWS)
RING_STAGES_MAX = 32    # stages the ring's barriers allow (csrc: RING_STAGES_MAX)
# table bytes a block keeps in flight at least: one lane's 512 threads x 8
# rows x 16 bytes, which streamed a 1 GiB logA at ~3.1 TB/s on an H100
RING_MIN_BYTES = 65536


class ScanPlan(NamedTuple):
    """How the persistent scan tiles logA over the SMs.

    Tile q covers the source rows ``row_edges[q // C]`` up to
    ``row_edges[q // C + 1]`` and the destination columns ``col_edges[q %
    C]`` up to ``col_edges[q % C + 1]``.  ``blocks`` blocks are launched;
    block b walks tiles b, b + blocks, ... (one tile each unless K needs
    more column groups than there are SMs).  A block with one tile keeps
    its first ``rows_smem`` rows in shared memory (rows ``stride`` floats
    apart) and streams up to ``rows_streamed`` rows each step.  Shared
    memory holds the carry of ``carry_rows`` source rows at once: a step
    folds a tile in passes of that many rows (one pass unless the range's
    carry would take more than half of shared memory).  A thread owns
    ``cols`` neighbouring columns for each of ``lanes`` lanes.  After a step
    each block forms the carry of its source range from the R partials of
    each entry, or, with ``two_phase``, combines its share of the entries
    once and publishes them behind a second barrier; ``team`` threads
    combine an entry.  ``smem`` is the dynamic shared memory of a block, in
    bytes.  The table's values are ``elem_bytes`` bytes each (4 fp32, 2
    bf16): the tile rows in shared memory are of that size.

    ``ring_rows`` > 0 marks the ring route (:func:`ring_plan`): no tile row
    in shared memory, every block one tile whose columns are whole quads of
    4, and a ring of ``ring_rows`` table rows (``stride`` floats each, in
    stages of ``RING_STAGE_ROWS``) that a producer warp fills beside the
    folding threads; always two-phase."""

    lanes: int
    cols: int
    R: int
    C: int
    blocks: int
    row_edges: tuple
    col_edges: tuple
    stride: int
    rows_smem: int
    rows_streamed: int
    carry_rows: int
    team: int
    two_phase: bool
    smem: int
    elem_bytes: int = 4
    ring_rows: int = 0

    @property
    def tiles(self) -> int:
        return self.R * self.C

    def c_args(self):
        """The int array the C entry points take (csrc: PlanField)."""
        fields = (self.lanes, self.R, self.C, self.blocks, self.rows_smem, self.stride,
                  self.carry_rows, self.team, int(self.two_phase), self.smem, self.ring_rows)
        return (ctypes.c_int * len(fields))(*fields)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan_lanes(N: int) -> int:
    """Lanes of a group of an N-lane scan: the kernel's instantiation."""
    return min(LANES_MAX, _pow2_at_least(N))


def combine_team(entries: int, R: int) -> int:
    """Threads that combine one carry entry's R partials when a block has
    ``entries`` to combine: enough to give every thread work, a power of
    two within a warp, no more than R needs."""
    if entries >= THREADS:
        return 1
    return min(32, _pow2_at_least(R), 1 << ((THREADS // entries).bit_length() - 1))


def scan_plan(K: int, N: int, sm_count: int, smem_bytes: int = SMEM_LIMIT,
              two_phase: bool | None = None, elem_bytes: int = 4,
              deltas: bool = False) -> ScanPlan:
    """The tiling of a (K, K) logA for an N-lane scan on ``sm_count`` SMs
    with ``smem_bytes`` of shared memory a block.

    Column groups are as wide as a block's threads can own (``THREADS *
    cols`` columns); source ranges split the rest of the SMs, keeping at
    least ``MIN_TILE_ROWS`` rows a tile, so small K takes fewer blocks.
    Where K needs more column groups than there are SMs (K > 270336 at one
    lane, 67584 at 16), one range spans every row and each block walks
    several groups, all streamed.  Edges split evenly (``r * K // R``), so
    tiles differ by at most a row or a column unit.  ``two_phase`` chooses
    the combine; by default the plan takes two-phase above
    ``TWO_PHASE_BYTES`` of partials.  ``elem_bytes`` is the size of a table
    value, 4 (fp32) or 2 (bf16): shared memory then holds twice the rows,
    and a bf16 tile's ``stride`` is even, so that the kernel copies the
    tile in 4-byte pairs.  ``deltas``: the plan is for the deltas scan,
    which takes :func:`ring_plan` where :func:`ring_route` says so."""
    if K < 1 or N < 1 or sm_count < 1:
        raise ValueError(f"need K, N, sm_count >= 1, got {K}, {N}, {sm_count}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"elem_bytes must be 4 (fp32) or 2 (bf16), got {elem_bytes}")
    lanes = plan_lanes(N)
    cols = 4 if lanes <= 4 else 2 if lanes == 8 else 1
    units = -(-K // cols)
    C = -(-units // THREADS)
    R = max(1, min(sm_count // C, K // MIN_TILE_ROWS))
    blocks = min(R * C, sm_count)
    row_edges = tuple(r * K // R for r in range(R + 1))
    col_edges = tuple(min(K, (c * units // C) * cols) for c in range(C + 1))
    kr_max = -(-K // R)
    stride = -(-units // C) * cols
    if elem_bytes == 2:
        stride += stride % 2
    room = smem_bytes - STATIC_SMEM
    if -(-kr_max * lanes // 4) * 16 <= room // 2:
        carry_rows = kr_max
    else:  # a tall range: its carry in passes, and no tile rows in shared memory
        carry_rows = min(kr_max, room // (lanes * 4) // 4 * 4)
    carry = -(-carry_rows * lanes // 4) * 16  # bytes, padded to 16
    # a block that walks several tiles keeps none in shared memory
    rows_smem = (max(0, min(kr_max, (room - carry) // (stride * elem_bytes)))
                 if R * C == blocks else 0)
    if two_phase is None:
        two_phase = K * lanes * 4 > TWO_PHASE_BYTES
    # the entries a block combines: its share of all, or its range's a pass
    entries = -(-lanes * K // blocks) if two_phase else carry_rows * lanes
    team = combine_team(entries, R)
    plan = ScanPlan(lanes=lanes, cols=cols, R=R, C=C, blocks=blocks, row_edges=row_edges,
                    col_edges=col_edges, stride=stride, rows_smem=rows_smem,
                    rows_streamed=kr_max - rows_smem, carry_rows=carry_rows, team=team,
                    two_phase=two_phase, smem=carry + rows_smem * stride * elem_bytes,
                    elem_bytes=elem_bytes)
    if deltas and ring_route(plan):
        return ring_plan(K, N, sm_count, smem_bytes) or plan
    return plan


def ring_route(plan: ScanPlan) -> bool:
    """Whether the fp32 deltas scan leaves ``plan`` (a resident-route
    plan) for the ring: where the range's carry fills shared memory, so no
    tile row is held there and every row streams every step, and every
    block has one tile; two-phase, at ``RING_LANES`` lanes."""
    return (plan.elem_bytes == 4 and plan.lanes in RING_LANES and plan.two_phase
            and plan.rows_smem == 0 and plan.tiles == plan.blocks)


def ring_plan(K: int, N: int, sm_count: int, smem_bytes: int = SMEM_LIMIT) -> ScanPlan | None:
    """The ring route's tiling of a (K, K) fp32 logA for an N-lane deltas
    scan, or None where it does not fit ``sm_count`` SMs and ``smem_bytes``.

    A thread owns 2 columns from 8 lanes (at 16, halving the ranges' carry
    against the resident route's 1) and 4 at 4; column groups are whole
    quads of 4 columns, so that a tile row's slice is one bulk copy of
    16-byte-aligned bytes wherever K % 4 == 0.  Ranges as in :func:`scan_plan`.  A ring row
    takes ``stride`` floats: the slice and up to 3 floats on each side, where
    the slice's ends fall between 16-byte boundaries.  Shared memory holds
    the range's carry in one pass where a ring of ``RING_MIN_BYTES`` still
    fits beside it, the ring taking the rest (whole stages, at most
    ``RING_STAGES_MAX``); else a ring of ``RING_MIN_BYTES`` and the carry in
    passes of whole stages."""
    lanes = plan_lanes(N)
    cols = 2 if lanes >= 8 else 4
    quads = -(-K // 4)
    C = -(-quads // (THREADS * cols // 4))
    if C > sm_count:
        return None
    R = max(1, min(sm_count // C, K // MIN_TILE_ROWS))
    row_edges = tuple(r * K // R for r in range(R + 1))
    col_edges = tuple(min(K, (c * quads // C) * 4) for c in range(C + 1))
    width = max(b - a for a, b in zip(col_edges, col_edges[1:]))
    stride = -(-(width + 6) // 4) * 4
    row_bytes = stride * 4
    kr_max = -(-K // R)
    room = smem_bytes - STATIC_SMEM
    sr = RING_STAGE_ROWS
    ring_min = -(-RING_MIN_BYTES // (width * 4 * sr)) * sr
    one_pass = -(-kr_max * lanes // 4) * 16
    if one_pass + ring_min * row_bytes <= room:
        carry_rows = kr_max
        ring_rows = min((room - one_pass) // row_bytes // sr * sr, RING_STAGES_MAX * sr)
    else:
        ring_rows = ring_min
        carry_rows = (room - ring_rows * row_bytes) // (lanes * 4) // sr * sr
        if carry_rows < sr:
            return None
    blocks = R * C
    return ScanPlan(lanes=lanes, cols=cols, R=R, C=C, blocks=blocks, row_edges=row_edges,
                    col_edges=col_edges, stride=stride, rows_smem=0, rows_streamed=kr_max,
                    carry_rows=carry_rows, team=combine_team(-(-lanes * K // blocks), R),
                    two_phase=True,
                    smem=-(-carry_rows * lanes // 4) * 16 + ring_rows * row_bytes,
                    ring_rows=ring_rows)


def streamed_bytes(plan: ScanPlan) -> int:
    """Bytes of logA the persistent scan streams a step under ``plan``:
    every tile's rows past those held in shared memory."""
    total = 0
    for r in range(plan.R):
        rows = plan.row_edges[r + 1] - plan.row_edges[r]
        for c in range(plan.C):
            cols = plan.col_edges[c + 1] - plan.col_edges[c]
            total += max(0, rows - plan.rows_smem) * cols * plan.elem_bytes
    return total


class StepPlan(NamedTuple):
    """How the step block tiles a (Ks, Kd) ``logA_blk`` for N lanes.

    The lanes go in ``groups`` groups of ``lanes`` (the last may be
    short); tile (r, c) of a group covers the source rows ``row_edges[r]``
    up to ``row_edges[r + 1]`` and the columns ``col_edges[c]`` up to
    ``col_edges[c + 1]``, at most ``STEP_UNITS * cols`` of them.  A tile is
    one block of ``STEP_THREADS`` threads: a thread owns ``cols``
    neighbouring columns for every lane of the group, and warp w folds the
    slice :meth:`warp_edges` of the tile's rows.  Where ``R > 1`` the R
    tiles of a column group are one thread-block cluster that combines
    their partials (``combine == "cluster"``); at ``R == 1`` nothing
    combines across blocks (``"none"``)."""

    lanes: int
    cols: int
    groups: int
    R: int
    C: int
    row_edges: tuple
    col_edges: tuple

    @property
    def combine(self) -> str:
        return "cluster" if self.R > 1 else "none"

    @property
    def blocks(self) -> int:
        return self.R * self.C * self.groups

    def warp_edges(self, r: int) -> tuple:
        """The first row of each warp's slice of source range r, and the
        range's end: warp w folds rows ``e[w]`` up to ``e[w + 1]``."""
        r0, r1 = self.row_edges[r], self.row_edges[r + 1]
        return tuple(r0 + w * (r1 - r0) // STEP_WARPS for w in range(STEP_WARPS + 1))

    def c_args(self):
        """The int array fvt_maxplus_step_block takes (csrc: StepField)."""
        fields = (self.lanes, self.R, self.C, self.groups)
        return (ctypes.c_int * len(fields))(*fields)


def step_plan(N: int, Ks: int, Kd: int, sm_count: int, R: int | None = None) -> StepPlan:
    """The tiling of one N-lane step against a (Ks, Kd) column shard on
    ``sm_count`` SMs.

    Lanes and columns a thread owns are :func:`scan_plan`'s (4 columns at
    up to 4 lanes, 2 at 8, 1 at 16); column groups are a warp's columns.
    ``R`` (by default) is the number of source ranges, up to
    ``STEP_CLUSTER_MAX`` and keeping ``STEP_MIN_ROWS`` rows a warp, that
    spreads the blocks most evenly over the SMs' slots (one a SM below
    ``STEP_DENSE_LANES`` lanes, two from there): the least of (blocks on
    the busiest slot) / R, the fewest ranges among equals.  Edges split
    evenly (``r * Ks // R``), so tiles differ by at most a row or a column
    unit."""
    if min(N, Ks, Kd, sm_count) < 1:
        raise ValueError(f"need N, Ks, Kd, sm_count >= 1, got {N}, {Ks}, {Kd}, {sm_count}")
    lanes = plan_lanes(N)
    cols = 4 if lanes <= 4 else 2 if lanes == 8 else 1
    units = -(-Kd // cols)
    C = -(-units // STEP_UNITS)
    groups = -(-N // lanes)
    r_max = max(1, min(STEP_CLUSTER_MAX, Ks // (STEP_WARPS * STEP_MIN_ROWS)))
    slots = sm_count * (2 if lanes >= STEP_DENSE_LANES else 1)
    if R is None:
        R = min(range(1, r_max + 1), key=lambda r: (-(-r * C * groups // slots) / r, r))
    elif not 1 <= R <= min(STEP_CLUSTER_MAX, Ks):
        raise ValueError(f"R must lie in [1, {min(STEP_CLUSTER_MAX, Ks)}], got {R}")
    return StepPlan(lanes=lanes, cols=cols, groups=groups, R=R, C=C,
                    row_edges=tuple(r * Ks // R for r in range(R + 1)),
                    col_edges=tuple(min(Kd, (c * units // C) * cols) for c in range(C + 1)))


def _check(logA, emits, delta0, tables=TABLE_DTYPES) -> tuple[int, int, int]:
    if emits.dim() != 3:
        raise ValueError(f"emits must be (T', N, K), got {tuple(emits.shape)}")
    Tm, N, K = emits.shape
    if K < 1 or N < 1:
        raise ValueError(f"empty state or lane dimension: {tuple(emits.shape)}")
    expect("logA", logA, tables, (K, K))
    expect("emits", emits, torch.float32, (Tm, N, K))
    expect("delta0", delta0, torch.float32, (N, K))
    return Tm, N, K


def maxplus_scan_plain(logA, emits, delta0):
    """Plain version of :func:`maxplus_scan` (and :func:`maxplus_scan_bf16`),
    one lane at a time (scratch stays at one (K, K) tensor).  A bf16
    ``logA`` is promoted in ``delta + logA``: the fp32 sums of the bf16
    values, as JAX promotes the Pallas scan's bf16 tile."""
    Tm, N, K = _check(logA, emits, delta0)
    dfin = torch.empty_like(delta0)
    ptrs = torch.empty((Tm, N, K), dtype=torch.int32, device=emits.device)
    for n in range(N):
        dfin[n], ptrs[:, n] = mp.forward_scan(delta0[n], logA, emits[:, n])
    return dfin, ptrs


def maxplus_scan_deltas_plain(logA, emits, delta0):
    """Plain version of :func:`maxplus_scan_deltas` (and
    :func:`maxplus_scan_deltas_bf16`), one lane at a time; a bf16 ``logA``
    is promoted in the sum, as in :func:`maxplus_scan_plain`."""
    Tm, N, K = _check(logA, emits, delta0)
    dfin = torch.empty_like(delta0)
    deltas = torch.empty((Tm, N, K), dtype=torch.float32, device=emits.device)
    for n in range(N):
        d = delta0[n]
        for t in range(Tm):
            deltas[t, n] = d
            d = mp.maxplus_step_noptr(d, logA, emits[t, n])
        dfin[n] = d
    return dfin, deltas


def _check_eg(logA, logBT, ys, delta0) -> tuple[int, int, int]:
    if ys.dim() != 2 or logBT.dim() != 2:
        raise ValueError(f"ys must be (T', N) and logBT (M, K), got "
                         f"{tuple(ys.shape)} and {tuple(logBT.shape)}")
    Tm, N = ys.shape
    M, K = logBT.shape
    if K < 1 or N < 1 or M < 1:
        raise ValueError(f"empty state, lane or symbol dimension: M={M}, N={N}, K={K}")
    expect("logA", logA, torch.float32, (K, K))
    expect("logBT", logBT, torch.float32, (M, K))
    expect("ys", ys, torch.int32, (Tm, N))
    expect("delta0", delta0, torch.float32, (N, K))
    if ys.device.type == "cpu" and bool(((ys < 0) | (ys >= M)).any()):
        raise ValueError(f"symbols outside [0, {M}) in ys")
    return Tm, N, K


def maxplus_scan_emitgather_plain(logA, logBT, ys, delta0):
    """Plain version of :func:`maxplus_scan_emitgather`: gathers each
    lane's emission rows, then runs the forward scan one lane at a time."""
    Tm, N, K = _check_eg(logA, logBT, ys, delta0)
    dfin = torch.empty_like(delta0)
    ptrs = torch.empty((Tm, N, K), dtype=torch.int32, device=ys.device)
    for n in range(N):
        dfin[n], ptrs[:, n] = mp.forward_scan(delta0[n], logA,
                                              logBT[ys[:, n].to(torch.int64)])
    return dfin, ptrs


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of ``device``, which the scan plan fills."""
    return _device_sms(device.index if device.index is not None
                       else torch.cuda.current_device())


# the plan of each shape a process scans or steps, made once (a call's host
# time is part of its latency)
_cached_plan = functools.lru_cache(maxsize=256)(scan_plan)
_cached_step_plan = functools.lru_cache(maxsize=256)(step_plan)


def error_word(device) -> torch.Tensor:
    """A zeroed error word that several scan calls can share (``err=``):
    the kernels set it when a grid barrier times out, and nothing reads it
    until :func:`raise_on_error`, so a decode of many calls synchronises
    with the host once, not once a call."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def raise_on_error(err: torch.Tensor, what: str) -> None:
    """Read ``err`` (a host synchronisation on the card) and raise if a
    kernel that shared it timed out at a grid barrier (the scans) or at a
    copy's barrier (the beam scan, the argmax walk)."""
    with span("fvt.sync"):
        code = int(err[0])
    if code:
        raise RuntimeError(f"{what}: a grid barrier or a copy barrier of a kernel timed out "
                           f"(error word {code}); the outputs are not valid")


def scan_scratch_bytes(K: int, N: int, device, with_ptr: bool) -> int:
    """Bytes of scratch one N-lane scan call on ``device`` allocates beside
    its outputs: the plan's partials (with their indices for a pointer
    scan), a two-phase plan's carry and the barrier words.  0 on the CPU,
    whose plain version keeps none past a step.  For the fp32 table's plan
    (a deltas scan's may take the ring route); a bf16 table's partials and
    carry are fp32 too, under the resident route's ranges, which are never
    more than the ring's: the count bounds them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return plan_scratch_bytes(K, N, sm_count(dev), with_ptr)


def plan_scratch_bytes(K: int, N: int, sms: int, with_ptr: bool, elem_bytes: int = 4) -> int:
    """:func:`scan_scratch_bytes` on a card of ``sms`` SMs, for the plan of
    a table of ``elem_bytes``-byte values (pure Python)."""
    plan = _cached_plan(K, N, sms, elem_bytes=elem_bytes, deltas=not with_ptr)
    part = 2 * plan.R * plan.lanes * K * 4
    return (part * (2 if with_ptr else 1) + (plan.lanes * K * 4 if plan.two_phase else 0)
            + (SYNC_ERR + 1) * 4)


def _scan_cuda(fn_name: str, counter, inputs: dict, delta0, Tm: int,
               with_ptr: bool, plan: ScanPlan | None, err: torch.Tensor | None):
    """Launch C entry point ``fn_name`` on ``inputs`` (logA and the
    emission operands, in its argument order) with ``plan`` (by default
    the plan for this card) and its scratch.  With no ``err``, read the
    call's own error word and raise if a grid barrier timed out; else the
    kernel sets ``err`` and the caller reads it.  Returns (dfin, ptrs) or
    (dfin, deltas)."""
    N, K = delta0.shape
    expect_contiguous(delta0=delta0, **inputs)
    dev = delta0.device
    hist = torch.empty((Tm, N, K), device=dev,
                       dtype=torch.int32 if with_ptr else torch.float32)
    if Tm == 0:
        return delta0, hist
    elem = inputs["logA"].element_size()
    if plan is None:
        plan = _cached_plan(K, N, sm_count(dev), elem_bytes=elem, deltas=not with_ptr)
    elif plan.row_edges[-1] != K or plan.col_edges[-1] != K or plan.lanes != plan_lanes(N):
        raise ValueError(f"the plan is for K={plan.row_edges[-1]} at {plan.lanes} lanes, "
                         f"not for K={K}, N={N}")
    elif plan.elem_bytes != elem:
        raise ValueError(f"the plan is for {plan.elem_bytes}-byte table values, logA has "
                         f"{elem}-byte ones")
    elif plan.ring_rows and with_ptr:
        raise ValueError("a ring plan is for the fp32 deltas scan alone")
    return launch_scan(fn_name, counter, inputs, delta0, hist, plan, err)


def launch_scan(fn_name: str, counter, inputs: dict, delta0, hist, plan: ScanPlan,
                err: torch.Tensor | None, *extra):
    """Launch ``fn_name`` (``fvt_maxplus_scan``'s arguments, then ``extra``)
    under ``plan``, whose shape the caller has checked, with the scratch it
    needs; the history ``hist`` (T', N, K) holds pointers (int32) or
    carries (float32).  ``err`` as in :func:`maxplus_scan`.  Returns (dfin,
    hist)."""
    N, K = delta0.shape
    Tm = hist.shape[0]
    with_ptr = hist.dtype == torch.int32
    dev = delta0.device
    if err is not None:
        expect("err", err, torch.int32, (1,))
        if err.device != dev:
            raise ValueError(f"the error word is on {err.device}, the scan on {dev}")
    dfin = torch.empty((N, K), dtype=torch.float32, device=dev)
    # the scratch scan_scratch_bytes counts
    part_v = torch.empty((2, plan.R, plan.lanes, K), dtype=torch.float32, device=dev)
    part_i = (torch.empty((2, plan.R, plan.lanes, K), dtype=torch.int32, device=dev)
              if with_ptr else None)
    carry = (torch.empty((plan.lanes, K), dtype=torch.float32, device=dev)
             if plan.two_phase else None)
    # the barrier's count at [0]; the call's own error word at [SYNC_ERR],
    # 128 bytes on, where the caller passed none
    sync = torch.zeros(SYNC_ERR + 1, dtype=torch.int32, device=dev)
    err_ptr = sync[SYNC_ERR:].data_ptr() if err is None else err.data_ptr()
    with span("fvt.scan.ring") if plan.ring_rows else contextlib.nullcontext():
        launch(fn_name, counter, dev, *(t.data_ptr() for t in inputs.values()),
               delta0.data_ptr(), dfin.data_ptr(),
               hist.data_ptr() if with_ptr else None,
               None if with_ptr else hist.data_ptr(),
               part_v.data_ptr(), None if part_i is None else part_i.data_ptr(),
               None if carry is None else carry.data_ptr(), sync.data_ptr(), err_ptr,
               plan.c_args(), Tm, N, K, *extra)
    if err is None:
        raise_on_error(sync[SYNC_ERR:], fn_name)
    return dfin, hist


def _bf16_table(logA: torch.Tensor) -> torch.Tensor:
    """A bf16 table as the kernels read it: 16-byte aligned (a view of
    another base is copied)."""
    return logA.clone() if logA.data_ptr() % 16 else logA


@traced("fvt.kernel.maxplus_scan")
def maxplus_scan(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor, *,
                 plan: ScanPlan | None = None, err: torch.Tensor | None = None):
    """Run the N-lane forward scan.

    Args:
      logA:   (K, K) fp32 or bf16, source k rows -> dest i columns; a bf16
        table goes to :func:`maxplus_scan_bf16` on CUDA tensors.
      emits:  (T', N, K) fp32 log emission rows for steps 1..T'.
      delta0: (N, K) fp32 scores at step 0.
      plan:   the kernel's tiling (default: :func:`scan_plan` for the card).
      err:    an :func:`error_word` shared by several calls, read by the
        caller with :func:`raise_on_error`; by default the call reads its
        own and raises.  The CPU's plain version ignores both.

    Returns:
      (delta_final (N, K) fp32, ptrs (T', N, K) int32).
    """
    _check(logA, emits, delta0)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_plain(logA, emits, delta0)
    if logA.dtype == torch.bfloat16:
        return maxplus_scan_bf16(logA, emits, delta0, plan=plan, err=err)
    return _scan_cuda("fvt_maxplus_scan", maxplus_scan,
                      {"logA": logA, "emits": emits}, delta0, emits.shape[0], True, plan, err)


@traced("fvt.kernel.maxplus_scan_bf16")
def maxplus_scan_bf16(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor, *,
                      plan: ScanPlan | None = None, err: torch.Tensor | None = None):
    """:func:`maxplus_scan` on a (K, K) bfloat16 ``logA``, its own kernel
    instance and launch count; ``plan``, when given, is made with
    ``elem_bytes=2``.  The CPU's plain version is :func:`maxplus_scan_plain`."""
    _check(logA, emits, delta0, torch.bfloat16)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_plain(logA, emits, delta0)
    return _scan_cuda("fvt_maxplus_scan_bf16", maxplus_scan_bf16,
                      {"logA": _bf16_table(logA), "emits": emits}, delta0, emits.shape[0], True,
                      plan, err)


@traced("fvt.kernel.maxplus_scan_deltas")
def maxplus_scan_deltas(logA: torch.Tensor, emits: torch.Tensor,
                        delta0: torch.Tensor, *, plan: ScanPlan | None = None,
                        err: torch.Tensor | None = None):
    """Forward scan emitting the carry history instead of pointers.

    Returns (delta_final (N, K), deltas (T', N, K) fp32) with
    ``deltas[t]`` = the carry before step t (``deltas[0] == delta0``).
    Scores are bit-identical to :func:`maxplus_scan`'s; ``logA`` (fp32 or
    bf16, which goes to :func:`maxplus_scan_deltas_bf16`), ``plan`` and
    ``err`` as there.
    """
    _check(logA, emits, delta0)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_deltas_plain(logA, emits, delta0)
    if logA.dtype == torch.bfloat16:
        return maxplus_scan_deltas_bf16(logA, emits, delta0, plan=plan, err=err)
    return _scan_cuda("fvt_maxplus_scan", maxplus_scan_deltas,
                      {"logA": logA, "emits": emits}, delta0, emits.shape[0], False, plan, err)


@traced("fvt.kernel.maxplus_scan_deltas_bf16")
def maxplus_scan_deltas_bf16(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor,
                             *, plan: ScanPlan | None = None, err: torch.Tensor | None = None):
    """:func:`maxplus_scan_deltas` on a (K, K) bfloat16 ``logA``, its own
    kernel instance and launch count, as :func:`maxplus_scan_bf16`."""
    _check(logA, emits, delta0, torch.bfloat16)
    if not on_cuda(logA, emits, delta0):
        return maxplus_scan_deltas_plain(logA, emits, delta0)
    return _scan_cuda("fvt_maxplus_scan_bf16", maxplus_scan_deltas_bf16,
                      {"logA": _bf16_table(logA), "emits": emits}, delta0, emits.shape[0], False,
                      plan, err)


@traced("fvt.kernel.maxplus_scan_emitgather")
def maxplus_scan_emitgather(logA: torch.Tensor, logBT: torch.Tensor,
                            ys: torch.Tensor, delta0: torch.Tensor, *,
                            plan: ScanPlan | None = None, err: torch.Tensor | None = None):
    """The pointer scan with each step's emission row gathered in the
    kernel, so no (T', N, K) emission buffer is built.

    Args:
      logA:   (K, K) fp32.
      logBT:  (M, K) fp32, the transposed emission table ``logB.T``.
      ys:     (T', N) int32 symbols for steps 1..T', each in [0, M).  CPU
        tensors are checked; on CUDA the check would cost a device sync,
        so the caller validates the symbols before upload.
      delta0: (N, K) fp32.

    Returns (delta_final (N, K) fp32, ptrs (T', N, K) int32), bit-identical
    to :func:`maxplus_scan` on the gathered emissions; ``plan`` and ``err``
    as there.
    """
    Tm, _, _ = _check_eg(logA, logBT, ys, delta0)
    if not on_cuda(logA, logBT, ys, delta0):
        return maxplus_scan_emitgather_plain(logA, logBT, ys, delta0)
    return _scan_cuda("fvt_maxplus_scan_eg", maxplus_scan_emitgather,
                      {"logA": logA, "logBT": logBT, "ys": ys}, delta0, Tm, True, plan, err)


def _check_step(delta, logA_block) -> tuple[int, int, int]:
    if delta.dim() != 2 or logA_block.dim() != 2:
        raise ValueError(f"delta must be (N, Ks) and logA_block (Ks, Kd), got "
                         f"{tuple(delta.shape)} and {tuple(logA_block.shape)}")
    N, Ks = delta.shape
    Kd = logA_block.shape[1]
    if N < 1 or Ks < 1 or Kd < 1:
        raise ValueError(f"empty lane, source or destination dimension: "
                         f"N={N}, Ks={Ks}, Kd={Kd}")
    expect("delta", delta, torch.float32, (N, Ks))
    expect("logA_block", logA_block, torch.float32, (Ks, Kd))
    return N, Ks, Kd


def step_block_supported(Ks: int, Kd: int) -> bool:
    """The kernel takes every positive shape (kept for parity with the JAX
    package, whose Pallas tiling refuses some)."""
    return Ks >= 1 and Kd >= 1


def maxplus_step_block_plain(delta, logA_block):
    """Plain version of :func:`maxplus_step_block`, one lane at a time
    (scratch stays at one (Ks, Kd) tensor)."""
    N, _, Kd = _check_step(delta, logA_block)
    val = torch.empty((N, Kd), dtype=torch.float32, device=delta.device)
    ptr = torch.empty((N, Kd), dtype=torch.int32, device=delta.device)
    for n in range(N):
        val[n], ptr[n] = mp.first_argmax(delta[n][:, None] + logA_block, 0)
    return val, ptr


@traced("fvt.kernel.maxplus_step_block")
def maxplus_step_block(delta: torch.Tensor, logA_block: torch.Tensor, *,
                       plan: StepPlan | None = None):
    """One trellis step against a column shard of logA.

    Args:
      delta:      (N, Ks) fp32 full-source carry.
      logA_block: (Ks, Kd) fp32, a column slice ``logA[:, lo:lo+Kd]``.
      plan:       the kernel's tiling (default: :func:`step_plan` for the
        card); the CPU's plain version ignores it.

    Returns:
      (val (N, Kd) fp32 pre-emission scores,
       ptr (N, Kd) int32 global source indices, the lowest attaining each max).
    """
    N, Ks, Kd = _check_step(delta, logA_block)
    if not on_cuda(delta, logA_block):
        return maxplus_step_block_plain(delta, logA_block)
    expect_contiguous(delta=delta, logA_block=logA_block)
    dev = delta.device
    if plan is None:
        plan = _cached_step_plan(N, Ks, Kd, sm_count(dev))
    elif (plan.row_edges[-1], plan.col_edges[-1], plan.lanes, plan.groups) != (
            Ks, Kd, plan_lanes(N), -(-N // plan_lanes(N))):
        raise ValueError(f"the plan is for Ks={plan.row_edges[-1]}, Kd={plan.col_edges[-1]} "
                         f"at {plan.groups} groups of {plan.lanes} lanes, not for N={N}, "
                         f"Ks={Ks}, Kd={Kd}")
    val = torch.empty((N, Kd), dtype=torch.float32, device=dev)
    ptr = torch.empty((N, Kd), dtype=torch.int32, device=dev)
    launch("fvt_maxplus_step_block", maxplus_step_block, dev, delta.data_ptr(),
           logA_block.data_ptr(), val.data_ptr(), ptr.data_ptr(), plan.c_args(), N, Ks, Kd)
    return val, ptr


maxplus_scan.launches = 0
maxplus_scan_deltas.launches = 0
maxplus_scan_bf16.launches = 0
maxplus_scan_deltas_bf16.launches = 0
maxplus_scan_emitgather.launches = 0
maxplus_step_block.launches = 0
