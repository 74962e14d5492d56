"""The floor of the completed sequences' FLASH-BS beam work
(``bounds.beam_floor_s`` at the cell's K, M, T and its decoder's beam and
segments) over the device time of the beam scan kernel,
``csrc/beam_cluster.cuh:beam_cluster_kernel`` (phase 1 and the segments),
in %.  Layer: kernels (``ops/cuda/beam.py``)."""

from fvbench import bounds, reference

PATTERN = r"\bbeam_cluster_kernel\b"


def read(tr):
    busy = sum(e.dur for e in tr.matching(PATTERN))
    if busy <= 0 or not tr.decoder or not tr.sequences:
        return None
    N = reference.segment_count(tr.T, tr.decoder["num_segments"])
    floor, _ = bounds.beam_floor_s(tr.K, tr.M, tr.T, tr.decoder["beam_width"], N, tr.card,
                                   tr.Bs)
    return 100.0 * floor * (tr.sequences / tr.Bs) / busy
