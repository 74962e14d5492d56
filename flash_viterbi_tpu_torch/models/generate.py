"""Seeded synthetic sparse and DAG HMMs (numpy), bit-identical per seed to
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


def make_dag_hmm(
    K: int, M: int, T: int, seed: int = 1, sanitize: bool = False
) -> tuple[HMM, np.ndarray]:
    """DAG-structured HMM (reference data_script_dag.py:46-61), bit-identical
    per seed to ``flash_viterbi_tpu/models/generate.py``'s: edges (u, v) with
    u < v kept from a G(n, 0.9) directed graph (networkx's where it is
    installed, else the same sampling with Python's ``random``), weights
    U(0, 1) from ``random``, rows normalised with NaN -> 0."""
    _pyrandom.seed(seed)
    y = np.array([_pyrandom.randint(0, M - 1) for _ in range(T)], dtype=np.int32)
    try:
        import networkx as nx
    except ImportError:
        nx = None
    if nx is not None:
        G = nx.gnp_random_graph(K, 0.9, directed=True)
        DAG = nx.DiGraph(
            [(u, v, {"weight": _pyrandom.uniform(0, 1)}) for (u, v) in G.edges() if u < v]
        )
        A = nx.to_numpy_array(DAG)
        if A.shape[0] < K:  # isolated trailing nodes
            Ap = np.zeros((K, K))
            Ap[: A.shape[0], : A.shape[1]] = A
            A = Ap
    else:
        A = np.zeros((K, K))
        for u in range(K):
            for v in range(K):
                if u != v and _pyrandom.random() < 0.9 and u < v:
                    A[u, v] = _pyrandom.uniform(0, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        if sanitize:
            A = A / np.where(A.sum(axis=1, keepdims=True) == 0, 1.0, A.sum(axis=1, keepdims=True))
        else:
            # the reference divides by ``A.sum(axis=1)`` without keepdims
            # (data_script_dag.py:54), which broadcasts over columns and
            # overflows to 1.8e308 through nan_to_num where a row sum is 0;
            # kept for fixture compatibility (sanitize=True for a usable HMM)
            A = A / A.sum(axis=1)
    A = np.nan_to_num(A)
    B = uniform_B(M, K, seed=seed)
    Pi = np.full(K, 1.0 / K)
    return HMM(A=A, B=B, Pi=Pi), y


def make_tie_hmm(K: int, M: int, T: int, prob: float, seed: int = 11) -> tuple[HMM, np.ndarray]:
    """A problem of exact ties everywhere (a test fixture, no reference
    counterpart): uniform rows over a sparse edge pattern (each edge kept
    with probability ``prob``, every self-loop kept), a state no edge
    enters (state 5: an all -inf column of logA), one that only loops
    (state 7), uniform emissions over two symbols a state, and a uniform
    Pi.  Needs K > 7."""
    rng = np.random.RandomState(seed)
    A = (rng.uniform(size=(K, K)) < prob).astype(np.float64)
    np.fill_diagonal(A, 1.0)
    A[:, 5] = 0.0
    A[7] = 0.0
    A[7, 7] = 1.0
    A /= A.sum(axis=1, keepdims=True)
    B = np.zeros((K, M))
    for k in range(K):
        B[k, [k % M, (k + 1) % M]] = 0.5
    return HMM(A, B, np.full(K, 1.0 / K)), rng.randint(0, M, T)
