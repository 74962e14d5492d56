"""Vanilla Viterbi: one forward scan with a full pointer table + backtrack.

Counterpart of ``flash_viterbi_tpu/algorithms/vanilla.py`` (O(K^2 T) time,
O(K T) memory), on the plain max-plus primitives; like the JAX decoder it
uses no kernel.
"""

from __future__ import annotations

from ..ops import maxplus as mp
from .base import Decoder, register


def vanilla_decode(logA, logB, logPi, y):
    emits = logB.t()[y]  # (T, K)
    delta0 = logPi + emits[0]
    delta, ptrs = mp.forward_scan(delta0, logA, emits[1:])
    last = mp.argmax_final(delta)
    return mp.backtrack(ptrs, last)


def _memory(K: int, T: int, **_) -> int:
    # reference-exact: sizeof(T1)+sizeof(T2) with T1[K][T] float,
    # T2[K][T] int (vanilla Viterbi.c:122-123,172)
    return K * T * 4 + K * T * 4


@register("vanilla")
def _build(**static) -> Decoder:
    return Decoder("vanilla", vanilla_decode, static, _memory)
