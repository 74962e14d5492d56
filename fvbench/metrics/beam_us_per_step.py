"""Device time of the beam scan kernel,
``csrc/beam_cluster.cuh:beam_cluster_kernel``, per dependent beam step of
the completed sequences, in µs: a FLASH-BS decode's steps that wait one on
another are phase 1's T−1 and the longest segment's Lmax−1 (its segments
run side by side as lanes).  What a change to the beam's select moves.
Layer: kernels (``ops/cuda/beam.py``)."""

from fvbench import reference

PATTERN = r"\bbeam_cluster_kernel\b"


def read(tr):
    busy = sum(e.dur for e in tr.matching(PATTERN))
    if busy <= 0 or not tr.decoder or not tr.sequences:
        return None
    _, lens = reference.segments(tr.T, tr.decoder["num_segments"])
    steps = (tr.T - 1) + (max(lens) - 1)
    return 1e6 * busy / (tr.sequences * steps)
