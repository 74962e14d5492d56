"""The benchmark's inputs from its seed: sparse HMMs drawn as the FLASH
Viterbi paper's generator draws them, and pools of observation sequences.

The paper's generator (Dzh-16/FLASH-Viterbi ``generate_data/data_script.py``,
frozen here as :func:`numpy_tables`) gives each state an out-degree drawn
from Binomial(K, prob), that many distinct targets drawn without
replacement, weights from U(0.01, 1), and normalises each row; B is
U(0.1, 1) row-normalised; Pi is 1/K.  :func:`tables` draws the same
distribution on the device in a few large calls: a Bernoulli(prob) mask
over every entry has a Binomial(K, prob) count a row, and given its count a
uniformly drawn set of targets, so the two draw the same rows.  A row with
no edge stays all zero (the paper's keeps 0/0 = NaN; its log is -inf
either way).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's random streams (tables,
    observations, the checked sample), from the run's ``--seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def tables(K: int, M: int, prob: float, seed: int, device) -> tuple[torch.Tensor, ...]:
    """(A (K, K), B (K, M), Pi (K,)) float32 probabilities on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 0))
    A = torch.rand((K, K), generator=g, device=device)
    keep = torch.rand((K, K), generator=g, device=device) < prob
    A.mul_(0.99).add_(0.01).mul_(keep)
    del keep
    rows = A.sum(dim=1, keepdim=True)
    A.div_(torch.where(rows > 0, rows, torch.ones_like(rows)))
    B = torch.rand((K, M), generator=g, device=device).mul_(0.9).add_(0.1)
    B.div_(B.sum(dim=1, keepdim=True))
    Pi = torch.full((K,), 1.0 / K, device=device)
    return A, B, Pi


def observations(n: int, T: int, M: int, seed: int) -> np.ndarray:
    """(n, T) int32 symbols, uniform in [0, M), on the host."""
    rng = np.random.default_rng(stream_seed(seed, 1))
    return rng.integers(0, M, size=(n, T), dtype=np.int32)


def numpy_tables(K: int, M: int, prob: float, seed: int) -> tuple[np.ndarray, ...]:
    """The paper's generator (``data_script.py:14-49``, ``:94``) as numpy,
    on a generator of its own: the distribution :func:`tables` draws."""
    rng = np.random.RandomState(seed)
    A = np.zeros((K, K))
    for state in range(K):
        edges = rng.binomial(K, p=prob)
        targets = rng.choice(K, size=edges, replace=False)
        A[state, targets] = rng.uniform(0.01, 1, size=edges)
    with np.errstate(invalid="ignore"):
        A = A / A.sum(axis=1, keepdims=True)
    B = rng.uniform(0.1, 1, (K, M))
    return A, B / B.sum(axis=1, keepdims=True), np.full(K, 1.0 / K)
