"""The least time a card could take for a decode's work, from the work
alone (the arithmetic of ``flash_viterbi_tpu_torch/bench/bounds.py``,
copied so that the yardstick stays the benchmark's).

A decode of Bs sequences of T steps over K states does Bs·(T−1)·K²
add+max cells: each an fp32 add and an fp32 max, two issue slots.  An SM
issues one warp instruction a clock on each of its four sub-partitions,
128 operations, so 64 cells a clock (the published 67 TFLOP/s of an H100
counts a fused multiply-add as two operations; no cell is one).  Its bytes
are every input read once and every output written once: ``logA``,
``logB`` and ``Pi`` in float32, the observations and the paths as int32.
The floor is the larger of the two times.

Unlike the program's bounds, this floor counts no re-read of ``logA``
where it exceeds what the card holds on chip: a decode whose lanes or
segments share each read of the table can beat that re-read floor.

A FLASH-BS decode (:func:`beam_floor_s`) of a beam of B over N segments
does B·K cells a step: phase 1's T−1 steps and the segments' Σ(lenₛ−1) =
T−N.  Its bytes are the rows of ``logA`` its beams can reach, each read
once (B a step, at most K), ``logB`` and ``Pi``, and the observations and
paths moved once.
"""

from __future__ import annotations

from typing import NamedTuple

CELLS_PER_CLOCK_SM = 64
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's published device-memory rate, at 700 W


class Card(NamedTuple):
    sms: int
    clock_hz: float  # the SM clock's maximum
    bytes_per_s: float = HBM_BYTES_PER_S

    @property
    def cells_per_s(self) -> float:
        return CELLS_PER_CLOCK_SM * self.sms * self.clock_hz


# An H100 SXM by its data sheet: 132 SMs at up to 1.98 GHz.
H100 = Card(sms=132, clock_hz=1.98e9)


def cells(K: int, T: int, Bs: int = 1) -> int:
    return Bs * max(T - 1, 0) * K * K


def io_bytes(K: int, M: int, T: int, Bs: int = 1) -> int:
    """logA, logB and Pi read once, the observations read and the paths
    written once."""
    return 4 * (K * K + K * M + K) + 2 * 4 * Bs * T


def floor_s(K: int, M: int, T: int, Bs: int = 1, on: Card = H100) -> tuple[float, str]:
    """(seconds, what bounds it) of one decode of Bs sequences."""
    by_cells = cells(K, T, Bs) / on.cells_per_s
    by_bytes = io_bytes(K, M, T, Bs) / on.bytes_per_s
    return max(by_cells, by_bytes), "operations" if by_cells >= by_bytes else "bytes"



def beam_steps(T: int, N: int) -> int:
    """Beam steps of one FLASH-BS decode of T positions in N segments (N as
    the decode runs it): phase 1's T−1 and the segments' T−N."""
    return max(T - 1, 0) + max(T - N, 0)


def beam_floor_s(K: int, M: int, T: int, B: int, N: int, on: Card = H100,
                 Bs: int = 1) -> tuple[float, str]:
    """(seconds, what bounds it) of one FLASH-BS decode of Bs sequences with
    a beam of B over N segments."""
    B = min(B, K)
    steps = beam_steps(T, N)
    by_cells = Bs * steps * B * K / on.cells_per_s
    rows = min(K, Bs * steps * B)
    by_bytes = (4 * (rows * K + K * M + K) + 2 * 4 * Bs * T) / on.bytes_per_s
    return max(by_cells, by_bytes), "operations" if by_cells >= by_bytes else "bytes"
