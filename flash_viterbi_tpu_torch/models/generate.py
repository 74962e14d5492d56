"""Seeded synthetic sparse HMMs (numpy), bit-identical per seed to
``flash_viterbi_tpu/models/generate.py``, which reproduces the reference
generator's sampling (binomial out-degree, choice without replacement,
U(0.01, 1) weights, row-normalised; B ~ U(0.1, 1) row-normalised; Pi
uniform; observations from Python's ``random.randint``).

Rows with zero sampled edges normalise to 0/0 = NaN, as the reference
keeps them; ``sanitize=True`` zeroes such rows instead.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np

from .hmm import HMM


def sparse_graph_A(K: int, seed: int = 1, prob: float = 0.2) -> np.ndarray:
    """Transition matrix of a random sparse graph."""
    rng = np.random  # the reference uses the global numpy RNG, seeded here
    rng.seed(seed)
    A = np.zeros((K, K), dtype=float)
    for state in range(K):
        edges = rng.binomial(K, p=prob, size=None)
        # choice over range(K) by its length: the same draws and values as
        # the reference's list of all states, without converting the list
        targets = rng.choice(K, size=edges, replace=False)
        ps = rng.uniform(0.01, 1, size=edges)
        A[state, targets] = ps  # distinct targets: the reference's per-edge loop
    for i in range(K):
        A[i,] = A[i,] / np.sum(A[i,])
    return A


def uniform_B(M: int, K: int, seed: int = 1) -> np.ndarray:
    """Emission matrix, U(0.1, 1) row-normalised."""
    np.random.seed(seed)
    B = np.random.uniform(0.1, 1, (K, M))
    return B / B.sum(axis=1)[:, None]


def observations(T: int, M: int, seed: int | None = None) -> np.ndarray:
    """Observation sequence from Python's ``random.randint``."""
    if seed is not None:
        _pyrandom.seed(seed)
    return np.array([_pyrandom.randint(0, M - 1) for _ in range(T)], dtype=np.int32)


def make_sparse_hmm(
    K: int, M: int, T: int, prob: float, seed: int = 1, sanitize: bool = False
) -> tuple[HMM, np.ndarray]:
    """Full generated problem: (HMM, observation sequence)."""
    _pyrandom.seed(seed)
    y = np.array([_pyrandom.randint(0, M - 1) for _ in range(T)], dtype=np.int32)
    A = sparse_graph_A(K, seed=seed, prob=prob)
    B = uniform_B(M, K, seed=seed)
    Pi = np.full(K, 1.0 / K)
    if sanitize:
        bad = ~np.isfinite(A).all(axis=1)
        A[bad] = 0.0
    return HMM(A=A, B=B, Pi=Pi), y
