"""The floor of the forward recursion's work (``bounds.floor_s`` of the
completed sequences) over the device time of the scan kernels,
``csrc/maxplus_scan.cu:scan_persistent`` (every instance: pointer, deltas
and gather modes, fp32 and bf16 tables), in %.  Layer: kernels
(``ops/cuda/maxplus.py``)."""

PATTERN = r"\bscan_persistent\b"


def read(tr):
    busy = sum(e.dur for e in tr.matching(PATTERN))
    if busy <= 0:
        return None
    return 100.0 * tr.floor_s / busy
