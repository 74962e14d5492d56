"""The least time a card could take for a kernel's work: its bytes at the
memory rate or its operations at the issue rate, whichever is larger.

Bytes: each input read once and each output written once, but for a
table that a scan needs whole every step.  Where such a table exceeds what
the card holds on chip (the shared memory and registers of every SM, and
the L2), every step after the first must read at least the excess from
device memory again (:func:`table_bytes`): at K=16384 a (K, K) logA is
1.07 GB against an H100's 118 MB on chip.  A table counts at its own
element size: a bf16 logA (``precision="bf16"``) is half the bytes, 31.5
MB at K=3968 (on chip, read once, like the fp32 one's 63 MB) and 537 MB at
K=16384, whose excess a step halves.

Operations: an fp32 add, max, compare or multiply is one instruction of
one thread, and an SM issues one warp instruction a clock on each of its
four sub-partitions: 128 operations a clock.  The published 67 TFLOP/s
fp32 of an H100 is that issue rate with a fused multiply-add counted as two
operations; no kernel of the port does one (a max-plus cell is an FADD and
an FMNMX), so their peak is half of it: 64 add+max cells a clock an SM,
16.7 T cells/s at 132 SMs and the 1.98 GHz maximum SM clock.  A bf16
table's widening to fp32 (one integer instruction a table value a step)
is not counted: the bound is a floor for the function, whose arithmetic
is the fp32 add and max; the widening is a move of bits that a kernel
shares across all N lanes of a value (1/(2N) of the cells' operations),
and leaving it out can only make the floor lower, never above what the
card could do.

Some kernels are held by neither: a one-launch probe whose steps each wait
for the last is bound by its chain of dependent latencies
(:func:`p4_floor_s`, :func:`p5_floor_s`, from latencies chased on the
card by ``probes/copy.py:latencies``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

OPS_PER_CLOCK_SM = 128  # four sub-partitions, one 32-thread warp instruction a clock each
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's published device-memory rate, at 700 W


class Card(NamedTuple):
    """What the bounds need of a card."""

    sms: int
    clock_hz: float      # the SM clock's maximum
    on_chip_bytes: int   # shared memory and registers of every SM, and the L2
    bytes_per_s: float = HBM_BYTES_PER_S

    @property
    def ops_per_s(self) -> float:
        return OPS_PER_CLOCK_SM * self.sms * self.clock_hz


# An H100 SXM by its data sheet: 132 SMs at up to 1.98 GHz, each with 228 KB
# of shared memory and 65,536 registers, and a 50 MiB L2.  The bounds of a
# run without a card, and of the tests.
H100 = Card(sms=132, clock_hz=1.98e9, on_chip_bytes=132 * (233472 + 65536 * 4) + 50 * 2**20)


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> Card:
    from ..runtime import build

    out = (ctypes.c_int * 6)()
    build.check(build.kernels().fvt_device_limits(index, out), "fvt_device_limits")
    l2, _, khz, sms, smem, regs = out
    return Card(sms=sms, clock_hz=khz * 1e3, on_chip_bytes=sms * (smem + 4 * regs) + l2)


def card(device) -> Card:
    """The card of ``device`` as it reports itself (SMs, the maximum SM
    clock, shared memory, registers and L2) with the published memory
    rate; :data:`H100` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100
    return _limits(dev.index if dev.index is not None else torch.cuda.current_device())


def table_bytes(nbytes: int, steps: int, on: Card = H100) -> int:
    """Bytes a scan must move of a table it reads whole every one of
    ``steps`` steps: once where it fits on chip, else once and then, every
    later step, all of it that the chip cannot hold."""
    return nbytes + max(0, steps - 1) * max(0, nbytes - on.on_chip_bytes)


def bound(moved: int, ops: int, on: Card = H100) -> tuple[float, str]:
    """(ms, what bounds it): the larger of ``moved`` bytes at the memory
    rate and ``ops`` operations at the issue rate."""
    by_bytes, by_ops = moved / on.bytes_per_s * 1e3, ops / on.ops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# a p5 thread's shuffle rounds: five within each warp, five across the warps
P5_SHUFFLE_ROUNDS = 10


def p4_floor_s(Tm: int, C: int, lat_s: dict[str, float]) -> float:
    """The dependent-chain floor of p4 as a cluster of C CTAs: Tm publish
    round trips, each one dependent load of the memory it publishes
    through, shared memory at C = 1 and a peer CTA's at C > 1 (``lat_s``:
    seconds a dependent step, keyed as ``probes.copy.CHASES``)."""
    return Tm * lat_s["dsmem" if C > 1 else "smem"]


def p5_floor_s(n: int, C: int, lat_s: dict[str, float], threads: int = 256,
               on: Card = H100) -> float:
    """The floor of p5 as a cluster of C CTAs of ``threads``: the larger of
    its chain, a thread's ceil(n / (C * threads)) dependent compares, the
    shuffle rounds and (C > 1) one round trip through a peer's shared
    memory, and its 8n bytes at the memory rate."""
    chain = (-(-n // (C * threads)) * lat_s["better"] + P5_SHUFFLE_ROUNDS * lat_s["shfl"]
             + (lat_s["dsmem"] if C > 1 else 0.0))
    return max(chain, 8 * n / on.bytes_per_s)
