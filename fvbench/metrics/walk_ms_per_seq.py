"""Device time of the walks per completed sequence, in ms: the pointer walk
``csrc/backtrack.cu:backtrack_kernel`` and the recomputing walk
``csrc/argmax_walk.cu:walk_kernel``.  Layer: kernels
(``ops/cuda/backtrack.py``)."""

PATTERN = r"\b(backtrack_kernel|walk_kernel)\b"


def read(tr):
    walks = tr.matching(PATTERN)
    if not walks or not tr.sequences:
        return None
    return 1e3 * sum(e.dur for e in walks) / tr.sequences
