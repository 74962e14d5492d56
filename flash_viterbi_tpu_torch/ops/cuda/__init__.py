"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package never imports ``triton`` and never runs ``nvcc``;
the kernel library is built at the first launch on a CUDA tensor.
"""

from .backtrack import argmax_walk, backtrack_batched
from .beam import beam_scan
from .fold import fold_planes
from .maxplus import (maxplus_scan, maxplus_scan_deltas, maxplus_scan_emitgather,
                      maxplus_step_block)

WRAPPERS = (maxplus_scan, maxplus_scan_deltas, maxplus_scan_emitgather,
            maxplus_step_block, backtrack_batched, argmax_walk, beam_scan, fold_planes)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
