"""The floor of the completed requests' reads of ``logA`` over the device's
busy time, in %.  An exact decode of one sequence a request at a K whose
padded float32 table exceeds what the card holds on chip reads, each of
its T−1 steps, at least the part of the table that does not fit there
(:func:`reread_floor_s`), however it is implemented: a decode that shares
reads between sequences could read higher, never above 100%.  Layer:
device (the whole decode)."""

#: the port's padding of the state count (``decode``'s ``pad_to``)
PAD = 128
#: bytes an H100 SXM holds on chip: 132 SMs' 228 KB of shared memory and
#: 256 KB of registers, and the 50 MB L2
ON_CHIP_BYTES = 132 * (233472 + 4 * 65536) + 50 * 2**20
#: the H100 SXM's published device-memory rate, at 700 W
HBM_BYTES_PER_S = 3.35e12


def reread_floor_s(K: int, T: int) -> float:
    """Seconds one sequence's steps take to read the part of the padded
    float32 ``logA`` that does not fit on chip, once a step."""
    Kp = -(-K // PAD) * PAD
    return max(T - 1, 0) * max(0, Kp * Kp * 4 - ON_CHIP_BYTES) / HBM_BYTES_PER_S


def read(tr):
    floor = reread_floor_s(tr.K, tr.T)
    if not tr.ops or not tr.sequences or tr.busy_s <= 0 or floor <= 0:
        return None
    return 100.0 * (tr.sequences / tr.Bs) * floor / tr.busy_s
