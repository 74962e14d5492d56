"""The beam scan: CUDA kernel and its plain version.

Counterpart of ``flash_viterbi_tpu/ops/pallas/beam.py``'s ``beam_scan`` and
``beam_scan_planes`` in one function over a lane dimension N; the kernel is
``csrc/beam_scan.cu``: one thread-block cluster of C CTAs a lane, each CTA
owning a contiguous slice of the columns, with a cluster-wide radix select.
:func:`beam_plan` (pure Python) chooses C, the slices and where each CTA
keeps its state.  Unlike the Pallas kernel it serves every beam width
1 <= B <= Kp at every Kp.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...runtime import build
from ...utils.profiling import traced
from ..beam import beam_scan_plain
from .common import SMEM_LIMIT, expect, expect_contiguous, launch, on_cuda
from .maxplus import error_word, raise_on_error, sm_count

THREADS = 512        # threads of a CTA (csrc: THREADS)
JMAX = 4             # columns a thread folds at once (csrc: JMAX)
CLUSTER_MAX = 16     # CTAs of a cluster (a non-portable size above 8)
MIN_COLS = 128       # columns a CTA keeps at least: small Kp takes fewer CTAs
ROWS_A_GROUP = 8     # beam rows a ring group
GROUPS_MAX = 16      # ring groups (csrc: GROUPS_MAX)
STATIC_SMEM = 4096   # bytes kept free for the kernel's static shared memory


class BeamPlan(NamedTuple):
    """How the beam scan splits a lane over a cluster.

    CTA r of a lane's cluster of ``C`` owns the columns ``col_edges[r]`` up
    to ``col_edges[r + 1]`` (multiples of 4 but the last), at most ``width``.
    It folds them in chunks of ``cw`` columns (one chunk unless ``width``
    exceeds a thread's JMAX columns), the beam rows arriving in a ring of
    ``g`` groups of ``rg`` rows.  Its keys, slots and copy of the beam,
    ``state_words`` int32, live in shared memory where ``state_smem``, else
    in a global scratch of one region a (lane, CTA).  ``smem`` is the
    dynamic shared memory of a CTA in bytes; ``lda`` the row stride of the
    logA the kernel reads (Kp rounded up to 4)."""

    C: int
    col_edges: tuple
    width: int
    cw: int
    rg: int
    g: int
    state_smem: bool
    state_words: int
    smem: int
    lda: int

    def c_args(self):
        """The int array the C entry points take (csrc: PlanField)."""
        fields = (self.C, self.width, self.cw, self.rg, self.g, int(self.state_smem),
                  self.state_words, self.smem, self.lda)
        return (ctypes.c_int * len(fields))(*fields)


def cluster_cap(Kp: int) -> int:
    """The largest cluster a Kp-column lane takes: CLUSTER_MAX, at most one
    CTA per MIN_COLS columns and per 4 columns."""
    return max(1, min(CLUSTER_MAX, -(-Kp // 4), Kp // MIN_COLS))


def beam_plan(Kp: int, B: int, N: int, sms: int, P: int = 0, C: int | None = None,
              active: dict | None = None, smem_bytes: int = SMEM_LIMIT) -> BeamPlan:
    """The split of an N-lane, width-B beam scan over Kp columns (P planes)
    on a card of ``sms`` SMs.

    ``C`` by default is the largest power of two up to :func:`cluster_cap`
    whose N clusters are all resident at once: ``active[C]`` clusters of
    size C fit the card (the wrapper asks the card; without it, ``sms //
    C``), else 1.  Column edges split the 4-column units evenly (``r *
    units // C * 4``, the kernel's own formula).  The state stays in shared
    memory while it fits beside one ring group; the ring takes the rest, up
    to a whole fold's groups."""
    if Kp < 1 or N < 1 or sms < 1 or not 1 <= B <= Kp:
        raise ValueError(f"need Kp, N, sms >= 1 and 1 <= B <= Kp, got Kp={Kp}, B={B}, "
                         f"N={N}, sms={sms}")
    units = -(-Kp // 4)
    if C is None:
        active = active or {}
        C = next((c for c in (16, 8, 4, 2) if c <= cluster_cap(Kp)
                  and active.get(c, sms // c) >= N), 1)
    elif not 1 <= C <= min(CLUSTER_MAX, units):
        raise ValueError(f"a cluster of {C} CTAs for {Kp} columns: need 1 <= C <= "
                         f"{min(CLUSTER_MAX, units)}")
    col_edges = tuple(min(Kp, r * units // C * 4) for r in range(C + 1))
    width = -(-units // C) * 4
    cw = min(width, THREADS * JMAX)
    rg = min(ROWS_A_GROUP, B)
    items = -(-B // rg) * -(-width // cw)  # ring items a fold of the widest CTA
    state_words = -(-(2 * width + 7 * B + 2 * P * B) // 4) * 4
    group_bytes = rg * cw * 4
    room = smem_bytes - STATIC_SMEM
    state_smem = state_words * 4 + group_bytes <= room
    avail = room - (state_words * 4 if state_smem else 0)
    g = max(1, min(items, GROUPS_MAX, avail // group_bytes))
    return BeamPlan(C=C, col_edges=col_edges, width=width, cw=cw, rg=rg, g=g,
                    state_smem=state_smem, state_words=state_words,
                    smem=g * group_bytes + (state_words * 4 if state_smem else 0),
                    lda=units * 4)


@functools.lru_cache(maxsize=256)
def _clusters(index: int, plan: BeamPlan) -> int:
    """Clusters of ``plan`` that card ``index`` keeps resident at once."""
    with torch.cuda.device(index):
        got = build.kernels().fvt_beam_scan_clusters(plan.c_args())
    if got < 0:
        build.check(-got, "fvt_beam_scan_clusters")
    return got


@functools.lru_cache(maxsize=256)
def _card_plan(index: int, sms: int, Kp: int, B: int, N: int, P: int) -> BeamPlan:
    """beam_plan with the card's resident clusters for every cluster size."""
    active = {c: _clusters(index, beam_plan(Kp, B, N, sms, P, C=c))
              for c in (16, 8, 4, 2) if c <= cluster_cap(Kp)}
    return beam_plan(Kp, B, N, sms, P, active=active)


def _check(logA, emits, vals0, states0, valid, prop) -> tuple[int, int, int, int, int]:
    if emits.dim() != 3 or vals0.dim() != 2:
        raise ValueError(f"emits must be (T', N, Kp) and vals0 (N, B), got "
                         f"{tuple(emits.shape)} and {tuple(vals0.shape)}")
    Tm, N, Kp = emits.shape
    B = vals0.shape[1]
    if N < 1 or not 1 <= B <= Kp:
        raise ValueError(f"need N >= 1 and 1 <= B <= Kp, got N={N}, B={B}, Kp={Kp}")
    expect("logA", logA, torch.float32, (Kp, Kp))
    expect("emits", emits, torch.float32, (Tm, N, Kp))
    expect("vals0", vals0, torch.float32, (N, B))
    expect("states0", states0, torch.int32, (N, B))
    if valid is not None:
        expect("valid", valid, torch.bool, (Tm, N))
    P = 0
    if prop is not None:
        if prop.dim() != 2:
            raise ValueError(f"prop must be (T', P), got {tuple(prop.shape)}")
        P = prop.shape[1]
        expect("prop", prop, torch.bool, (Tm, P))
    return Tm, N, Kp, B, P


@traced("fvt.kernel.beam_scan")
def beam_scan(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
              states0: torch.Tensor, valid: torch.Tensor | None = None,
              prop: torch.Tensor | None = None, *, plan: BeamPlan | None = None,
              err: torch.Tensor | None = None):
    """Run the N-lane top-B beam recursion.

    Args:
      logA:    (Kp, Kp) f32, source rows -> destination columns.
      emits:   (T', N, Kp) f32 emission rows for steps 1..T'.
      vals0:   (N, B) f32 initial beam scores, descending.
      states0: (N, B) int32 initial beam states.
      valid:   optional (T', N) bool; False keeps the lane's beam and
        planes at that row and writes ``hist = states``, ``slots = iota``.
      prop:    optional (T', P) bool anchor schedule: True propagates plane
        p by winning slot, False records the previous beam's states.
      plan:    the kernel's split (default: :func:`beam_plan` for the card);
        a cluster size the card cannot keep resident raises.
      err:     an error word (``maxplus.error_word``) shared by several
        calls and read by the caller; by default the call reads its own and
        raises if a ring wait timed out.  The CPU's plain version ignores
        ``plan`` and ``err``.

    Returns (hist (T', N, B) int32, slots (T', N, B) int32, planes
    (N, P, B) int32), bit-identical to :func:`beam_scan_plain`.
    """
    Tm, N, Kp, B, P = _check(logA, emits, vals0, states0, valid, prop)
    tensors = (logA, emits, vals0, states0) + tuple(x for x in (valid, prop)
                                                    if x is not None)
    if not on_cuda(*tensors):
        return beam_scan_plain(logA, emits, vals0, states0, valid, prop)
    dev = emits.device
    hist = torch.empty((Tm, N, B), dtype=torch.int32, device=dev)
    slots = torch.empty((Tm, N, B), dtype=torch.int32, device=dev)
    planes = torch.full((N, P, B), -1, dtype=torch.int32, device=dev)
    if Tm == 0:
        return hist, slots, planes
    expect_contiguous(logA=logA, emits=emits, vals0=vals0, states0=states0)
    if plan is None:
        plan = _card_plan(dev.index, sm_count(dev), Kp, B, N, P)
    elif plan.col_edges[-1] != Kp or plan.state_words < 2 * plan.width + 7 * B + 2 * P * B:
        raise ValueError(f"the plan is for Kp={plan.col_edges[-1]}, not for Kp={Kp}, "
                         f"B={B}, P={P}")
    if _clusters(dev.index, plan) < 1:
        raise RuntimeError(f"the card cannot keep one cluster of {plan.C} CTAs with "
                           f"{plan.smem} bytes of shared memory resident")
    # bulk copies read rows of a 16-byte-aligned logA whose stride is a
    # multiple of 4 floats: pad an odd-sized or misaligned table
    if plan.lda != Kp:
        logA = F.pad(logA, (0, plan.lda - Kp))
    elif logA.data_ptr() % 16:
        logA = logA.clone()
    scratch = (None if plan.state_smem else
               torch.empty(N * plan.C * plan.state_words, dtype=torch.int32, device=dev))
    own = err is None
    if own:
        err = error_word(dev)
    else:
        expect("err", err, torch.int32, (1,))
    if valid is not None:
        valid = valid.contiguous()
    if prop is not None:
        prop = prop.contiguous()
    launch("fvt_beam_scan", beam_scan, dev, logA.data_ptr(), emits.data_ptr(),
           vals0.data_ptr(), states0.data_ptr(),
           None if valid is None else valid.data_ptr(),
           None if prop is None else prop.data_ptr(),
           hist.data_ptr(), slots.data_ptr(), planes.data_ptr(),
           None if scratch is None else scratch.data_ptr(), err.data_ptr(),
           plan.c_args(), Tm, N, Kp, B, P)
    if own:
        raise_on_error(err, "beam_scan")
    return hist, slots, planes


beam_scan.launches = 0
