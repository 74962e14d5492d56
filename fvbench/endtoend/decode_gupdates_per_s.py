"""Trellis updates of the completed sequences, K^2 * T each at the logical
K, in 10^9 a second of the window: from its start to the first completion
at or after its length."""


def read(w):
    if not w.paths or w.seconds <= 0:
        return None
    return w.K * w.K * w.T * w.sequences / w.seconds / 1e9
