"""The 95th percentile of every request's latency in the window, in ms:
from handing the port the host's observations to holding the paths on the
host (numpy's linear percentile)."""

import numpy as np


def read(w):
    if not w.latencies:
        return None
    return float(np.percentile(np.asarray(w.latencies), 95)) * 1e3
