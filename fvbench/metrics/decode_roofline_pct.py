"""The floor of the completed sequences' work (``bounds.floor_s``) over the
time in which any kernel ran, in %.  Independent of which kernel does the
work, so it still bounds a gain after a kernel is replaced.  Layer: device
(the whole decode)."""

from fvbench.trace import union_s


def read(tr):
    busy = union_s(tr.kernels)
    if busy <= 0:
        return None
    return 100.0 * tr.floor_s / busy
