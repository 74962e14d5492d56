"""Top-B beam recursion in plain PyTorch.

Counterpart of ``flash_viterbi_tpu/algorithms/flash_bs.py``'s ``beam_topk``
and ``beam_step`` and of the recursion that
``flash_viterbi_tpu/ops/pallas/beam.py`` fuses, written over a leading lane
dimension N.  One beam step from ``(vals, states)`` (N, B)::

    full[n, i] = max_b ( vals[n, b] + logA[states[n, b], i] ) + emit[n, i]
    slot[n, i] = lowest b attaining that max (0 when every candidate is -inf)
    (vals', states') = the top B of full[n]: value descending, index ascending

Ties in the top B keep the lower state index, as ``jax.lax.top_k`` does;
the order is a stable descending sort, never ``torch.topk``, which promises
no tie order.  -0.0 ranks equal to +0.0, as in the Pallas kernel and the
numpy mirror (log tables never hold -0.0).  Inputs hold no NaN.
"""

from __future__ import annotations

import torch

from .maxplus import first_argmax


def beam_topk(full: torch.Tensor, B: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals, states int32) of the top ``B`` along the last dimension of
    ``full`` (..., Kp): value descending, lowest index first on ties."""
    vals, idx = torch.sort(full + 0.0, dim=-1, descending=True, stable=True)
    return vals[..., :B].contiguous(), idx[..., :B].to(torch.int32).contiguous()


def beam_step(vals: torch.Tensor, states: torch.Tensor, logA: torch.Tensor,
              emit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One beam step over N lanes: vals (N, B) f32, states (N, B) int32,
    logA (Kp, Kp), emit (N, Kp) -> (full (N, Kp) f32, slot (N, Kp) int32).
    The emission is added after the max."""
    scores = vals[:, :, None] + logA[states.to(torch.int64)]  # (N, B, Kp)
    best, slot = first_argmax(scores, 1)
    return best + emit, slot


def beam_scan_plain(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
                    states0: torch.Tensor, valid: torch.Tensor | None = None,
                    prop: torch.Tensor | None = None):
    """The N-lane beam recursion over ``emits`` (T', N, Kp).

    ``valid`` (T', N) bool: a False row keeps the lane's beam and planes,
    writes ``hist = states`` and ``slots = iota``.  ``prop`` (T', P) bool:
    after each step, plane p takes ``planes[p][slot]`` where ``prop[t, p]``
    (propagate) and the previous beam's ``states[slot]`` where not (record).

    Returns (hist (T', N, B) int32 beam states after each step, slots
    (T', N, B) int32 winning previous-beam slot of each entry, planes
    (N, P, B) int32 after the last step; -1 where never recorded).
    """
    Tm, N, _ = emits.shape
    B = vals0.shape[1]
    P = 0 if prop is None else prop.shape[1]
    dev = emits.device
    hist = torch.empty((Tm, N, B), dtype=torch.int32, device=dev)
    slots = torch.empty((Tm, N, B), dtype=torch.int32, device=dev)
    planes = torch.full((N, P, B), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(B, dtype=torch.int32, device=dev).expand(N, B)
    vals, states = vals0, states0.to(torch.int32)
    for t in range(Tm):
        full, slot = beam_step(vals, states, logA, emits[t])
        nv, ns = beam_topk(full, B)
        bs = slot.gather(1, ns.to(torch.int64))
        if P:
            moved = planes.gather(2, bs.to(torch.int64)[:, None, :].expand(N, P, B))
            rec = states.gather(1, bs.to(torch.int64))[:, None, :]
            new_planes = torch.where(prop[t][None, :, None], moved, rec)
        if valid is not None:
            keep = ~valid[t][:, None]
            nv = torch.where(keep, vals, nv)
            ns = torch.where(keep, states, ns)
            bs = torch.where(keep, iota, bs)
            if P:
                new_planes = torch.where(keep[:, :, None], planes, new_planes)
        if P:
            planes = new_planes
        hist[t], slots[t] = ns, bs
        vals, states = nv, ns
    return hist, slots, planes
