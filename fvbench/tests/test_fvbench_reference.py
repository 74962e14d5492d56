"""The plain reference against a brute-force decode, ties and absent edges
included; the float64 scores; the generator against the paper's numpy
draw."""

import itertools

import numpy as np
import pytest
import torch

from fvbench import gen, reference


def brute_best(A, B, Pi, y):
    K = A.shape[0]
    best = float("-inf")
    for p in itertools.product(range(K), repeat=len(y)):
        pt = torch.tensor([p])
        best = max(best, float(reference.path_scores(A, B, Pi, y[None], pt)[0]))
    return best


def tied_tables(K, M, seed):
    """Uniform rows over a sparse pattern and emissions over two symbols a
    state: many paths of one score, and absent edges."""
    rng = np.random.RandomState(seed)
    A = (rng.uniform(size=(K, K)) < 0.5).astype(np.float64)
    np.fill_diagonal(A, 1.0)
    A[:, 1] = 0.0  # a state no edge enters
    A /= A.sum(axis=1, keepdims=True)
    B = np.zeros((K, M))
    for k in range(K):
        B[k, [k % M, (k + 1) % M]] = 0.5
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return f(A), f(B), f(np.full(K, 1.0 / K))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tied", [False, True])
def test_reference_finds_the_best_score(seed, tied):
    K, M, T = 5, 3, 5
    A, B, Pi = tied_tables(K, M, seed) if tied else gen.tables(K, M, 0.5, seed, "cpu")
    ys = torch.as_tensor(gen.observations(3, T, M, seed)).long()
    paths = reference.viterbi(A, B, Pi, ys, lanes=2)
    scores = reference.path_scores(A, B, Pi, ys, paths)
    for i in range(3):
        assert float(scores[i]) == pytest.approx(brute_best(A, B, Pi, ys[i]), abs=1e-9)


def test_chunks_and_lanes_do_not_change_the_path(monkeypatch):
    A, B, Pi = gen.tables(40, 6, 0.3, 7, "cpu")
    ys = torch.as_tensor(gen.observations(5, 30, 6, 7)).long()
    whole = reference.viterbi(A, B, Pi, ys)
    monkeypatch.setattr(reference, "CHUNK_BYTES", 3 * 40 * 4)
    assert torch.equal(reference.viterbi(A, B, Pi, ys, lanes=2), whole)


def test_path_scores_of_impossible_paths_are_minus_inf():
    A = torch.tensor([[0.5, 0.5, 0.0], [0.0, 1.0, 0.0], [0.2, 0.3, 0.5]])
    B = torch.full((3, 2), 0.5)
    Pi = torch.full((3,), 1 / 3)
    y = torch.tensor([[0, 1, 0]] * 3)
    paths = torch.tensor([[0, 1, 1], [0, 2, 2], [0, 3, 1]])
    s = reference.path_scores(A, B, Pi, y, paths)
    assert np.isfinite(float(s[0])) and float(s[1]) == float("-inf") == float(s[2])
    assert float(s[0]) == pytest.approx(np.log(1 / 3) + 3 * np.log(0.5) + np.log(0.5))


def test_bf16_table_rounds_the_logs():
    A, B, Pi = gen.tables(64, 5, 0.3, 1, "cpu")
    fp32, _, _ = reference.log_tables(A, B, Pi)
    bf16, _, _ = reference.log_tables(A, B, Pi, torch.bfloat16)
    assert torch.equal(bf16, fp32.to(torch.bfloat16).float())
    assert not torch.equal(bf16, fp32)


def test_generator_draws_the_papers_distribution():
    K, M, prob = 600, 20, 0.112
    A, B, Pi = gen.tables(K, M, prob, 5, "cpu")
    An, Bn, _ = gen.numpy_tables(K, M, prob, 5)
    deg, deg_n = (A > 0).sum(1).double(), (An > 0).sum(1)
    sd = np.sqrt(K * prob * (1 - prob))
    assert abs(float(deg.mean()) - K * prob) < 4 * sd / np.sqrt(K)
    assert abs(float(deg.mean()) - deg_n.mean()) < 6 * sd / np.sqrt(K)
    assert abs(float(deg.std()) - deg_n.std()) < 0.15 * sd
    w = (A * (A > 0).sum(1, keepdim=True))[A > 0]  # weights over their row mean
    wn = (An * (An > 0).sum(1, keepdims=True))[An > 0]
    assert abs(float(w.mean()) - wn.mean()) < 0.01 and abs(float(w.std()) - wn.std()) < 0.02
    assert torch.allclose(A.sum(1), torch.ones(K)) and torch.allclose(B.sum(1), torch.ones(K))
    assert float(B.min()) > 0 and torch.all(Pi == 1.0 / K)


def test_observations_are_uniform_symbols():
    y = gen.observations(50, 400, 50, 2**31 + 3)
    assert y.dtype == np.int32 and y.shape == (50, 400)
    assert y.min() == 0 and y.max() == 49
    assert np.array_equal(y, gen.observations(50, 400, 50, 2**31 + 3))
