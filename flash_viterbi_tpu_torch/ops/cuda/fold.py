"""Folding pointer rows into index planes: a CUDA kernel and its plain version.

The FLASH decode's lean mode carries index planes through a scan: the
anchor planes of its first pass and the t2 planes of its splitting rounds
(``flash_viterbi_tpu/algorithms/flash.py:185-190`` and ``:396-401``, a
``lax.scan`` each).  ``fold_planes`` applies a chunk of a scan's pointer
rows to the planes in one launch (kernel ``csrc/fold_planes.cu``: a
thread-block cluster of G CTAs a plane, each folding a contiguous range of
the rows into an index map, the maps joined pairwise); :func:`fold_plan`
(pure Python) chooses G, the ranges and where the maps live.  Its plain
version is the same fold as a loop of gathers and selects.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...runtime import build
from ...utils.profiling import traced
from .common import SMEM_LIMIT, expect, expect_contiguous, launch, on_cuda
from .maxplus import error_word, raise_on_error, sm_count

THREADS = 512       # threads of a CTA (csrc: THREADS)
CLUSTER_MAX = 16    # CTAs a plane (a non-portable cluster size above 8)
RING_MAX = 8        # pointer rows a CTA's ring holds (csrc: RING_MAX)
MIN_ROWS = 4        # rows a CTA folds at least: a short chunk takes fewer CTAs
STATIC_SMEM = 1024  # bytes kept free for the kernel's static shared memory
FOLD_SMEM = SMEM_LIMIT - STATIC_SMEM  # dynamic shared memory a CTA may take


class FoldPlan(NamedTuple):
    """How the fold splits a plane's rows over a cluster.

    CTA g of a plane's cluster of ``G`` folds the rows ``row_edges[g]`` up
    to ``row_edges[g + 1]`` into an index map.  Its two map buffers (2 K
    int32) live in shared memory where ``maps_smem``, else in a global
    scratch of one region a (plane, CTA); its rows arrive through a ring of
    ``ring`` rows in shared memory (0: read from global memory where they
    are used).  ``smem`` is the dynamic shared memory of a CTA in bytes."""

    G: int
    row_edges: tuple
    maps_smem: bool
    ring: int
    smem: int

    def c_args(self):
        """The int array the C entry points take (csrc: PlanField)."""
        fields = (self.G, self.ring, int(self.maps_smem), self.smem, *self.row_edges)
        return (ctypes.c_int * len(fields))(*fields)


def fold_plan(P: int, c: int, R: int, K: int, sms: int, smem_bytes: int = FOLD_SMEM,
              G: int | None = None, active: dict | None = None) -> FoldPlan:
    """The split of a fold of ``c`` rows (``R`` a step: 1 or P) into P
    planes of K entries on a card of ``sms`` SMs.

    ``G`` by default is the largest power of two up to CLUSTER_MAX that
    leaves every CTA MIN_ROWS rows or more, keeps the P·G CTAs within the
    SMs and keeps all P clusters resident at once (``active[G]`` clusters of
    size G fit the card, the wrapper asks it; without it, ``sms // G``);
    else 1, as where P alone fills the card.  The ranges split the rows
    evenly in order (``g * c // G``).  The maps stay in shared memory where
    their 8 K bytes fit ``smem_bytes``; the ring takes what is left, up to
    a CTA's rows, where K is a multiple of 4 (a bulk copy moves multiples of
    16 bytes)."""
    if P < 1 or c < 1 or K < 1 or sms < 1 or R not in (1, P):
        raise ValueError(f"need P, c, K, sms >= 1 and R = 1 or P, got P={P}, c={c}, R={R}, "
                         f"K={K}, sms={sms}")
    if G is None:
        active = active or {}
        G = next((g for g in (16, 8, 4, 2) if g <= c // MIN_ROWS and P * g <= sms
                  and active.get(g, sms // g) >= P), 1)
    elif not 1 <= G <= min(CLUSTER_MAX, c):
        raise ValueError(f"a cluster of {G} CTAs for {c} rows: need 1 <= G <= "
                         f"{min(CLUSTER_MAX, c)}")
    row_edges = tuple(g * c // G for g in range(G + 1))
    maps = 2 * K * 4
    maps_smem = maps <= smem_bytes
    room = smem_bytes - (maps if maps_smem else 0)
    most = max(b - a for a, b in zip(row_edges, row_edges[1:]))
    ring = min(RING_MAX, most, room // (4 * K)) if K % 4 == 0 else 0
    return FoldPlan(G=G, row_edges=row_edges, maps_smem=maps_smem, ring=ring,
                    smem=(maps if maps_smem else 0) + ring * 4 * K)


def _check(planes, rows, prop) -> tuple[int, int, int, int]:
    if planes.dim() != 2 or rows.dim() != 3 or prop.dim() != 2:
        raise ValueError(f"planes must be (P, K), rows (c, R, K) and prop (c, P), got "
                         f"{tuple(planes.shape)}, {tuple(rows.shape)}, {tuple(prop.shape)}")
    P, K = planes.shape
    c, R, _ = rows.shape
    if R not in (1, P):
        raise ValueError(f"rows must hold one row a step or one a plane (R = 1 or {P}), "
                         f"got R={R}")
    expect("planes", planes, torch.int32, (P, K))
    expect("rows", rows, torch.int32, (c, R, K))
    expect("prop", prop, torch.bool, (c, P))
    return c, R, P, K


def fold_planes_plain(planes: torch.Tensor, rows: torch.Tensor, prop: torch.Tensor):
    """Plain version of :func:`fold_planes`, one row at a time."""
    for t in range(rows.shape[0]):
        row = rows[t].expand_as(planes)
        moved = planes.gather(1, row.to(torch.int64))
        planes = torch.where(prop[t][:, None], moved, row)
    return planes


@functools.lru_cache(maxsize=64)
def _clusters(index: int, G: int, maps_smem: bool, smem: int) -> int:
    """Clusters of G CTAs with ``smem`` bytes that card ``index`` keeps
    resident at once."""
    plan = FoldPlan(G=G, row_edges=tuple(range(G + 1)), maps_smem=maps_smem, ring=0,
                    smem=smem)
    with torch.cuda.device(index):
        got = build.kernels().fvt_fold_planes_clusters(plan.c_args())
    if got < 0:
        build.check(-got, "fvt_fold_planes_clusters")
    return got


@functools.lru_cache(maxsize=256)
def _card_plan(index: int, sms: int, P: int, c: int, R: int, K: int) -> FoldPlan:
    """fold_plan with the card's resident clusters for every cluster size."""
    active = {}
    for g in (16, 8, 4, 2):
        if g <= c:
            p = fold_plan(P, c, R, K, sms, G=g)
            active[g] = _clusters(index, g, p.maps_smem, p.smem)
    return fold_plan(P, c, R, K, sms, active=active)


@traced("fvt.kernel.fold_planes")
def fold_planes(planes: torch.Tensor, rows: torch.Tensor, prop: torch.Tensor, *,
                plan: FoldPlan | None = None, err: torch.Tensor | None = None) -> torch.Tensor:
    """Fold ``c`` pointer rows into ``P`` index planes.

    Args:
      planes: (P, K) int32 index planes.
      rows:   (c, R, K) int32 pointer rows, a scan's ``ptrs``: R = 1 gives
        every plane the same row of a step, R = P a row a plane.
      prop:   (c, P) bool: at step t plane p propagates (follows the row,
        ``plane[row[k]]``) where True and records (takes ``row[k]``) where
        False.
      plan:   the kernel's split (default: :func:`fold_plan` for the card);
        a cluster size the card cannot keep resident raises.
      err:    an error word (``maxplus.error_word``) shared by several
        calls and read by the caller; by default the call reads its own and
        raises if a ring wait timed out.  The CPU's plain version ignores
        ``plan`` and ``err``.

    Returns the (P, K) int32 planes after the c steps.  A pointer outside
    [0, K) on the card gives -1 (the CPU's plain version raises).
    """
    c, R, P, K = _check(planes, rows, prop)
    if not on_cuda(planes, rows, prop):
        return fold_planes_plain(planes, rows, prop)
    if c == 0 or P == 0:
        return planes.clone()
    expect_contiguous(planes=planes, rows=rows, prop=prop)
    dev = planes.device
    if plan is None:
        plan = _card_plan(dev.index, sm_count(dev), P, c, R, K)
    elif (plan.row_edges[-1] != c or (plan.maps_smem and 2 * K * 4 > FOLD_SMEM)
          or plan.smem != (2 * K * 4 if plan.maps_smem else 0) + plan.ring * 4 * K):
        raise ValueError(f"the plan is for c={plan.row_edges[-1]} rows, not for c={c}, K={K}")
    if _clusters(dev.index, plan.G, plan.maps_smem, plan.smem) < 1:
        raise RuntimeError(f"the card cannot keep one cluster of {plan.G} CTAs with "
                           f"{plan.smem} bytes of shared memory resident")
    if plan.ring and rows.data_ptr() % 16:  # bulk copies read 16-byte-aligned rows
        rows = rows.clone()
    scratch = (None if plan.maps_smem else
               torch.empty((P, plan.G, 2, K), dtype=torch.int32, device=dev))
    own = err is None
    if own:
        err = error_word(dev)
    else:
        expect("err", err, torch.int32, (1,))
    out = torch.empty_like(planes)
    launch("fvt_fold_planes", fold_planes, dev, planes.data_ptr(), rows.data_ptr(),
           prop.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
           err.data_ptr(), plan.c_args(), c, R, P, K)
    if own:
        raise_on_error(err, "fold_planes")
    return out


fold_planes.launches = 0
