"""Preprocessing cache: the reference's pickle cache, framework-style.

Counterpart of ``flash_viterbi_tpu/utils/cache.py``, writing and reading
the same files.  ``Baseline.py:134-170`` pickles the preprocessed
adjacency/acoustic structures keyed by (K, T, prob, beam_width) and
reloads them on rerun.  Here the expensive precomputations are the log
tables (float64 ``log`` over K² probabilities) and the SIEVE adjacency
structures; both cache to ``.npz``/pickle files keyed the same way.

A cache file is unpickled (``cached_adjacency``) or loaded as trusted
data: point ``cache_dir`` only at files this package wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..models.hmm import HMM, LogHMM

DEFAULT_DIR = os.environ.get("FLASH_VITERBI_CACHE", ".fv_cache")


def _key(prefix: str, **params) -> str:
    parts = "_".join(f"{k}{v}" for k, v in sorted(params.items()))
    return f"{prefix}_{parts}"


def cached_log_tables(hmm: HMM, cache_dir: str = DEFAULT_DIR, device="cuda",
                      **params) -> LogHMM:
    """Log-domain tables on ``device``, loaded from cache when the key
    matches (analog of the reference's preprocessed_data_*.pkl)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key("logtables", K=hmm.K, M=hmm.M,
                                        **params) + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return LogHMM.from_numpy(z["logA"], z["logB"], z["logPi"], K=int(z["K"]),
                                     device=device)
    lh = hmm.log(device=device)
    np.savez(path, logA=lh.logA.cpu().numpy(), logB=lh.logB.cpu().numpy(),
             logPi=lh.logPi.cpu().numpy(), K=lh.K)
    return lh


def cached_adjacency(A: np.ndarray, B: np.ndarray, cache_dir: str = DEFAULT_DIR,
                     **params):
    """SIEVE adjacency structures (edge lists + acoustic dicts), pickled
    exactly like ``Baseline.py:164-170``."""
    from ..oracle.sieve_bs import build_adjacency

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key("adjacency", K=A.shape[0],
                                        M=B.shape[1], **params) + ".pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    data = build_adjacency(A, B)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data
