"""FLASH-BS: top-B beam pruning over the anchored two-phase decode.

Counterpart of ``flash_viterbi_tpu/algorithms/flash_bs.py``:

* **Phase 1**: one beam scan (``beam_scan``, N=1 lane over T-1 steps) with
  the P = N_seg-1 anchor planes folded in.  The final beam's slot 0 is the
  last state; each plane's slot 0 is its anchor.
* **Segment phase**: the N_seg anchored segments are stacked as lanes of one
  beam scan over Lmax-1 steps; a valid mask stops each lane at its own
  length.  Each segment walks its beam-space slot pointers back
  (``backtrack_batched`` on the (T', N, B) slot table) from the lowest slot
  whose final state is the forced end state, or is -1 throughout when that
  state fell out of its beam.
* The segment paths are gathered into the output.

The initial top-B selections are ``beam_topk``, a stable descending sort:
the tie order of the kernel's select.  On CUDA tensors every beam scan and
walk launches a hand-written kernel; on CPU tensors each runs its plain
version.  Both give the path the JAX decoder gives, bit for bit.  JAX's
``use_pallas`` switch routes nothing here (it is recorded, as any extra
keyword is): on the card the kernel is the path.
"""

from __future__ import annotations

import torch

from ..ops import maxplus as mp
from ..ops.beam import beam_topk
from ..ops.cuda import backtrack_batched, beam_scan
from ..ops.cuda.maxplus import error_word, raise_on_error
from .base import Decoder, register
from .flash import _threadpool_sizeof, flash_midpoints, prop_schedule, segment_layout


def walk_beam(states_hist, slot_ptrs, end_slot):
    """States along the beam-space pointers: ``states_hist`` (L, N, B)
    int32 beams, ``slot_ptrs`` (L-1, N, B) int32 winning slots
    (``beam_scan``'s second output), ``end_slot`` (N,) int32 -> (N, L)
    int32 paths."""
    slots = backtrack_batched(slot_ptrs, end_slot)  # (N, L)
    return states_hist.gather(2, slots.t()[:, :, None].to(torch.int64))[:, :, 0].t()


def phase1_beam(logA, logPi, emits, prop, B: int, err=None):
    """Beam forward pass over all T with the anchor planes of ``prop``
    (T-1, P); returns (last () int32, anchors (P,) int32).  ``err`` is the
    beam scan's error word, as ``beam_scan`` takes it."""
    vals0, states0 = beam_topk((logPi + emits[0])[None, :], B)
    hist, _, planes = beam_scan(logA, emits[1:].unsqueeze(1), vals0, states0, prop=prop,
                                err=err)
    final = hist[-1] if hist.shape[0] else states0
    return final[0, 0], planes[0, :, 0]


def segment_beam(logA, logPi, emits, starts, lens, init_states, end_states,
                 Lmax: int, T: int, B: int, err=None):
    """Forced-boundary beam decode of N segments as lanes; returns (N, Lmax)
    paths, a segment -1 throughout when its end state left its beam.

    ``init_states[s]`` is the state at ``starts[s]-1`` (ignored for segment
    0, which starts from ``logPi``); ``end_states[s]`` the state at the
    segment's last position.  ``err`` as in :func:`phase1_beam`.
    """
    N = starts.shape[0]
    dev = emits.device
    idx = torch.clamp(starts[:, None] + torch.arange(Lmax, device=dev)[None, :],
                      max=T - 1)
    seg = emits[idx]  # (N, Lmax, K)
    first = torch.arange(N, device=dev) == 0
    start = torch.where(first[:, None], logPi[None, :],
                        logA[init_states.clamp(min=0).to(torch.int64)])
    vals0, states0 = beam_topk(start + seg[:, 0], B)
    valid = torch.arange(1, Lmax, device=dev)[:, None] <= (lens - 1)[None, :]
    hist, slot_ptrs, _ = beam_scan(logA, seg[:, 1:].transpose(0, 1).contiguous(),
                                   vals0, states0, valid=valid, err=err)
    states_hist = torch.cat([states0[None], hist])  # (Lmax, N, B)
    match = states_hist[-1] == end_states[:, None]
    end_slot = mp.first_argmax(match.to(torch.int32), 1)[1]
    paths = walk_beam(states_hist, slot_ptrs, end_slot)
    return torch.where(match.any(1)[:, None], paths, -1)


def flash_bs_decode(logA, logB, logPi, y, beam_width: int, num_segments: int = 8):
    T = y.shape[0]
    B = min(int(beam_width), logA.shape[0])  # on the padded tables, as in JAX
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    dev = logA.device
    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts_l, lens_l, Lmax = segment_layout(mids, T)
    # every index tensor is built before the first launch: a host-to-device
    # copy in mid-decode would wait for the kernels queued before it
    order = [s * Lmax + j for s, ln in enumerate(lens_l) for j in range(ln)]
    starts, lens, order = (torch.tensor(v, dtype=torch.int64, device=dev)
                           for v in (starts_l, lens_l, order))
    prop = torch.as_tensor(prop_schedule(mids, T), device=dev)  # (T-1, P) bool
    emits = logB.t()[y].contiguous()  # (T, K)
    err = error_word(dev)  # both beam scans', read once at the end

    last, anchors = phase1_beam(logA, logPi, emits, prop, B, err)
    init_states = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev), anchors])
    end_states = torch.cat([anchors, last[None]])
    paths = segment_beam(logA, logPi, emits, starts, lens, init_states, end_states,
                         Lmax, T, B, err)
    out = paths.reshape(-1)[order]
    raise_on_error(err, "flash_bs")
    return out


def _memory(K: int, T: int, beam_width: int = 64, num_segments: int = 8, **_) -> int:
    """Reference-exact (FLASH_BS_Viterbi_multithread.c:548-576):
    max(phase-1 heap planes, per-thread heap double buffers) +
    sizeof(ThreadPool) + the sizeof-of-expression bug (+8).
    element = {float, int, int} = 12 bytes."""
    B, N = min(beam_width, K), max(1, num_segments)
    phase1 = 0
    if N > 2 and T >= 2 * N:
        phase1 = (N - 1) * 4 + 2 * (N - 1) * (B + 1) * 12
    tmp = N * 2 * (B + 1) * 12
    return max(phase1, tmp) + _threadpool_sizeof(N) + 8


@register("flash_bs")
def _build(beam_width: int = 64, num_segments: int = 8, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return flash_bs_decode(logA, logB, logPi, y, beam_width=beam_width,
                               num_segments=num_segments)

    return Decoder("flash_bs", fn, {"beam_width": beam_width,
                                    "num_segments": num_segments, **static}, _memory)
