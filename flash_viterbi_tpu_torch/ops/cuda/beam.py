"""The beam scan: CUDA kernel and its plain version.

Counterpart of ``flash_viterbi_tpu/ops/pallas/beam.py``'s ``beam_scan`` and
``beam_scan_planes`` in one function over a lane dimension N; the kernel is
``csrc/beam_scan.cu``.  Unlike the Pallas kernel it serves every beam
width 1 <= B <= Kp at every Kp: a lane's select works in shared memory
where it fits a block, and in an L2-resident global scratch where it does
not (Kp > 16384 at B=64).
"""

from __future__ import annotations

import torch

from ...runtime import build
from ..beam import beam_scan_plain
from .common import SMEM_LIMIT, expect, expect_contiguous, launch, on_cuda


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


def beam_scan(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
              states0: torch.Tensor, valid: torch.Tensor | None = None,
              prop: torch.Tensor | None = None):
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
    # a lane's working set above a block's shared memory goes to a scratch
    # region of its own
    need = build.kernels().fvt_beam_scan_smem(Kp, B, P)
    scratch = (torch.empty((N, -(-need // 8)), dtype=torch.int64, device=dev)
               if need > SMEM_LIMIT else None)
    expect_contiguous(logA=logA, emits=emits, vals0=vals0, states0=states0)
    if valid is not None:
        valid = valid.contiguous()
    if prop is not None:
        prop = prop.contiguous()
    launch("fvt_beam_scan", beam_scan, dev, logA.data_ptr(), emits.data_ptr(),
           vals0.data_ptr(), states0.data_ptr(),
           None if valid is None else valid.data_ptr(),
           None if prop is None else prop.data_ptr(),
           hist.data_ptr(), slots.data_ptr(), planes.data_ptr(),
           None if scratch is None else scratch.data_ptr(), Tm, N, Kp, B, P)
    return hist, slots, planes


beam_scan.launches = 0
