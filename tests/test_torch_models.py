"""The port's numpy/torch model layer against the JAX package's, exactly:
the generator, the log tables, padding and the table hand-over."""

import numpy as np
import pytest
import torch

from flash_viterbi_tpu.models import generate as jgen
from flash_viterbi_tpu.models import hmm as jhmm
from flash_viterbi_tpu_torch import LogHMM
from flash_viterbi_tpu_torch.models import generate as tgen
from flash_viterbi_tpu_torch.models import hmm as thmm

torch.set_num_threads(2)


@pytest.mark.parametrize("K,M,T,prob,seed", [
    (64, 12, 32, 0.3, 7),
    (100, 5, 17, 0.05, 3),  # sparse enough for empty (NaN) rows
    (257, 50, 64, 0.112, 1),
])
def test_make_sparse_hmm_bit_identical(K, M, T, prob, seed):
    jh, jy = jgen.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    th, ty = tgen.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    np.testing.assert_array_equal(jy, ty)
    assert jy.dtype == ty.dtype
    for a, b in ((jh.A, th.A), (jh.B, th.B), (jh.Pi, th.Pi)):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(jgen.observations(T, M, seed=seed + 1),
                                  tgen.observations(T, M, seed=seed + 1))


def test_log32_matches_including_nan_rows():
    p = np.array([[0.0, 0.5, np.nan], [1.0, 1e-45, 0.25]])
    a, b = jhmm._log32(p), thmm._log32(p)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert np.isneginf(b[0, 2])


@pytest.mark.parametrize("K,multiple", [(96, 128), (200, 128), (130, 8), (128, 128)])
def test_log_tables_and_padding_match(K, multiple):
    jh, _ = jgen.make_sparse_hmm(K=K, M=9, T=8, prob=0.2, seed=K)
    th, _ = tgen.make_sparse_hmm(K=K, M=9, T=8, prob=0.2, seed=K)
    jl = jh.log().padded(multiple)
    tl = th.log(device="cpu").padded(multiple)
    assert (tl.K, tl.Kp, tl.M) == (jl.K, jl.Kp, jl.M)
    for name in ("logA", "logB", "logPi"):
        got = getattr(tl, name)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == getattr(jl, name).tobytes()


def test_from_numpy_round_trips_jax_tables():
    jh, _ = jgen.make_sparse_hmm(K=72, M=6, T=8, prob=0.3, seed=2)
    jl = jh.log().padded(128)
    tl = LogHMM.from_numpy(jl.logA, jl.logB, jl.logPi, K=jl.K, device="cpu")
    assert tl.K == 72 and tl.Kp == 128
    for name in ("logA", "logB", "logPi"):
        assert getattr(tl, name).numpy().tobytes() == getattr(jl, name).tobytes()
    # registered buffers: a module move carries the tables
    assert {n for n, _ in tl.named_buffers()} == {"logA", "logB", "logPi"}


def test_from_numpy_rejects_float64():
    with pytest.raises(ValueError, match="float32"):
        LogHMM.from_numpy(np.zeros((2, 2)), np.zeros((2, 3)), np.zeros(2), K=2,
                          device="cpu")


def test_tables_default_to_the_card(monkeypatch):
    """Tables land on the card unless the CPU is asked for: without CUDA the
    default raises instead of silently building CPU tables."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    th, _ = tgen.make_sparse_hmm(K=16, M=3, T=8, prob=0.5, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.log()
    lh = th.log(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LogHMM.from_numpy(lh.logA.numpy(), lh.logB.numpy(), lh.logPi.numpy(), K=16)
    assert lh.logA.device.type == "cpu"
