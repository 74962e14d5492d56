"""Plain beam-search Viterbi over the full tables.

Counterpart of ``flash_viterbi_tpu/algorithms/beam.py``: the top-B beam
recursion over all T in one beam scan (``beam_scan``, N=1, no planes), then
one walk of the beam-space slot pointers from slot 0, the best final state
(``backtrack_batched`` with K = B).  O(T*B) memory.  With ``beam_width``
at least K it equals ``vanilla``.  JAX's ``use_pallas`` switch routes
nothing here (it is recorded, as any extra keyword is): on the card the
kernel is the path.
"""

from __future__ import annotations

import torch

from ..ops.beam import beam_topk
from ..ops.cuda import beam_scan
from ..ops.cuda.maxplus import error_word, raise_on_error
from .base import Decoder, register
from .flash_bs import walk_beam


def beam_decode(logA, logB, logPi, y, beam_width: int):
    B = min(int(beam_width), logA.shape[0])  # clamp: beam cannot exceed K
    emits = logB.t()[y].contiguous()  # (T, K)
    vals0, states0 = beam_topk((logPi + emits[0])[None, :], B)
    err = error_word(logA.device)  # read once, after the walk is queued
    hist, slot_ptrs, _ = beam_scan(logA, emits[1:].unsqueeze(1), vals0, states0, err=err)
    states_hist = torch.cat([states0[None], hist])  # (T, 1, B)
    end_slot = torch.zeros((1,), dtype=torch.int32, device=logA.device)
    path = walk_beam(states_hist, slot_ptrs, end_slot)[0]
    raise_on_error(err, "beam")
    return path


def _memory(K: int, T: int, beam_width: int = 64, **_) -> int:
    """Derived from the decoder's live buffers (no reference counterpart —
    the reference beam_search keeps full T1/T2 dicts): states_hist (T, B)
    int32 + slot_ptrs (T-1, B) int32 ~= T*B*8, plus the double-buffered
    beam registers (vals+states, two steps live under scan) 2*(B*4+B*4)
    and the top-k temporary (B*8)."""
    B = beam_width
    return T * B * 8 + 4 * B * 8


@register("beam")
def _build(beam_width: int = 64, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return beam_decode(logA, logB, logPi, y, beam_width=beam_width)

    return Decoder("beam", fn, {"beam_width": beam_width, **static}, _memory)
