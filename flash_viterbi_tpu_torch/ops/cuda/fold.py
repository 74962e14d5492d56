"""Folding pointer rows into index planes: a CUDA kernel and its plain version.

The FLASH decode's lean mode carries index planes through a scan: the
anchor planes of its first pass and the t2 planes of its splitting rounds
(``flash_viterbi_tpu/algorithms/flash.py:185-190`` and ``:396-401``, a
``lax.scan`` each).  ``fold_planes`` applies a chunk of a scan's pointer
rows to the planes in one launch (kernel ``csrc/fold_planes.cu``); its
plain version is the same fold as a loop of gathers and selects.
"""

from __future__ import annotations

import functools

import torch

from ...runtime import build
from .common import expect, expect_contiguous, launch, on_cuda


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


@functools.lru_cache(maxsize=None)
def _smem(index: int, K: int) -> int:
    with torch.cuda.device(index):
        return build.kernels().fvt_fold_planes_smem(K)


def fold_planes(planes: torch.Tensor, rows: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Fold ``c`` pointer rows into ``P`` index planes.

    Args:
      planes: (P, K) int32 index planes.
      rows:   (c, R, K) int32 pointer rows, a scan's ``ptrs``: R = 1 gives
        every plane the same row of a step, R = P a row a plane.
      prop:   (c, P) bool: at step t plane p propagates (follows the row,
        ``plane[row[k]]``) where True and records (takes ``row[k]``) where
        False.

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
    smem = _smem(dev.index if dev.index is not None else torch.cuda.current_device(), K)
    if smem < 0:
        raise RuntimeError("fold_planes: could not read the card's shared memory limit")
    scratch = None if smem else torch.empty((P, 2, K), dtype=torch.int32, device=dev)
    out = torch.empty_like(planes)
    launch("fvt_fold_planes", fold_planes, dev, planes.data_ptr(), rows.data_ptr(),
           prop.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
           c, R, P, K)
    return out


fold_planes.launches = 0
