"""The checkpoint slice against the JAX package, exactly: the emission-gather
scan's plain version against the Pallas kernel (interpret mode) and against
the plain pointer scan on gathered emissions; the port's checkpoint decode
against JAX's kernel path and its lax.scan form (paths, analytic memory and
the reference stdout lines); and the symbol range checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import checkpoint as jck
from flash_viterbi_tpu.ops.pallas import maxplus as pk
from flash_viterbi_tpu_torch.algorithms import checkpoint as tck
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import maxplus as tkm

torch.set_num_threads(2)


def _jax(hmm):
    """The same probability tables as the JAX package's ``HMM`` (the port's
    ``HMM.log()`` builds its tables on the card by default)."""
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith(("path:", "memory:"))]


def _eg_fixture(K: int, N: int, Tm: int, M: int, seed: int, ties: bool):
    """(logA (K,K), logBT (M,K), ys (Tm,N) int32, delta0 (N,K)) numpy."""
    rng = np.random.default_rng(seed)
    if ties:  # integer-valued: exact fp32 ties everywhere
        logA = np.round(rng.standard_normal((K, K)) * 2) / 2
        logBT = np.round(rng.standard_normal((M, K)))
        delta0 = np.round(rng.standard_normal((N, K)))
        logA[:, 3] = -np.inf  # a dead destination: pointer 0 by the tie rule
    else:
        logA = rng.standard_normal((K, K))
        logBT = rng.standard_normal((M, K))
        delta0 = rng.standard_normal((N, K))
    ys = rng.integers(0, M, (Tm, N)).astype(np.int32)
    f32 = [np.ascontiguousarray(x, dtype=np.float32) for x in (logA, logBT, delta0)]
    return f32[0], f32[1], ys, f32[2]


@pytest.mark.parametrize("Tm", [1, 17])
@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("K", [128, 256])
def test_emitgather_matches_pallas(K, N, Tm):
    logA, logBT, ys, delta0 = _eg_fixture(K, N, Tm, M=7, seed=K + N + Tm,
                                          ties=K == 128)
    want = pk.maxplus_scan_emitgather(*(jnp.asarray(x) for x in (logA, logBT, ys, delta0)),
                                      interpret=True)
    args = [torch.from_numpy(x) for x in (logA, logBT, ys, delta0)]
    got = tk.maxplus_scan_emitgather(*args)
    assert got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, p in zip(got, tkm.maxplus_scan_emitgather_plain(*args)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("K,N,Tm,ties", [(40, 3, 9, True), (130, 20, 4, False)])
def test_emitgather_plain_matches_scan_on_gathered_emissions(K, N, Tm, ties):
    logA, logBT, ys, delta0 = (torch.from_numpy(x) for x in
                               _eg_fixture(K, N, Tm, M=5, seed=K, ties=ties))
    emits = logBT[ys.to(torch.int64)]  # (Tm, N, K)
    want = tkm.maxplus_scan_plain(logA, emits, delta0)
    got = tkm.maxplus_scan_emitgather_plain(logA, logBT, ys, delta0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_emitgather_zero_steps_and_bad_args():
    logA, logBT, ys, delta0 = (torch.from_numpy(x) for x in
                               _eg_fixture(16, 2, 0, M=3, seed=0, ties=True))
    dfin, ptrs = tk.maxplus_scan_emitgather(logA, logBT, ys, delta0)
    assert torch.equal(dfin, delta0) and ptrs.shape == (0, 2, 16)
    with pytest.raises(TypeError, match="int32"):
        tk.maxplus_scan_emitgather(logA, logBT, ys.long(), delta0)
    with pytest.raises(ValueError, match="shape"):
        tk.maxplus_scan_emitgather(logA, logBT[:, :8], ys, delta0)


@pytest.mark.parametrize("bad", [-1, 3])
def test_out_of_range_symbols_raise(bad):
    logA, logBT, ys, delta0 = (torch.from_numpy(x) for x in
                               _eg_fixture(16, 2, 5, M=3, seed=1, ties=True))
    ys[2, 1] = bad
    for fn in (tk.maxplus_scan_emitgather, tkm.maxplus_scan_emitgather_plain):
        with pytest.raises(ValueError, match="outside"):
            fn(logA, logBT, ys, delta0)
    hmm, y = tfv.make_sparse_hmm(K=16, M=3, T=8, prob=0.5, seed=1)
    y = y.copy()
    y[4] = bad
    for alg in ("checkpoint", "fused", "flash"):
        with pytest.raises(ValueError, match="outside"):
            tfv.decode(hmm, y, alg, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tfv.decode_batch(hmm, np.stack([y, y]), "fused", device="cpu")


def _assert_same(j, t):
    np.testing.assert_array_equal(t.path, j.path)
    assert t.path.dtype == np.int32
    assert t.memory_bytes == j.memory_bytes
    assert _lines(t.reference_stdout()) == _lines(j.reference_stdout())


@pytest.mark.parametrize("K,T,step,pad_to,pallas", [
    (96, 37, 0, 128, (True, False)),
    (96, 1, 0, 128, (True, False)),     # T = 1: no chunk at all
    (96, 2, 0, 128, (True, False)),
    (200, 37, 5, 128, (True, False)),   # a ragged last chunk
    (101, 37, 5, 1, (False,)),          # K not a multiple of 8: no JAX kernel
    (101, 20, 0, 1, (False,)),
])
def test_checkpoint_matches_jax(K, T, step, pad_to, pallas):
    hmm, y = tfv.make_sparse_hmm(K=K, M=11, T=T, prob=0.2, seed=K + T + step)
    got = tfv.decode(hmm, y, "checkpoint", step=step, pad_to=pad_to, device="cpu",
                     warmup=False)
    for use_pallas in pallas:
        want = jfv.decode(_jax(hmm), y, "checkpoint", step=step, use_pallas=use_pallas,
                          pad_to=pad_to, warmup=False)
        _assert_same(want, got)
    assert got.extra["step"] == step
    assert all(n == 0 for n in got.extra["launches"].values())
    vanilla = tfv.decode(hmm, y, "vanilla", device="cpu", warmup=False)
    np.testing.assert_array_equal(got.path, vanilla.path)


def test_snapshot_step_and_memory_match_jax():
    for T in (1, 2, 3, 63, 64, 256, 4095, 4096, 4160, 16384, 65536, 10**6):
        assert tck.snapshot_step(T) == jck.snapshot_step(T)
    for K in (1, 96, 3965):
        for T in (1, 2, 37, 256, 16384):
            for step in (0, 1, 5, 300):
                assert tck._memory(K=K, T=T, step=step) == jck._memory(K=K, T=T, step=step)


def test_use_pallas_is_not_an_option():
    """JAX's use_pallas is recorded, as every extra keyword is, and routes
    nothing: the path is the same."""
    hmm, y = tfv.make_sparse_hmm(K=40, M=5, T=30, prob=0.3, seed=2)
    got = tfv.decode(hmm, y, "checkpoint", use_pallas=False, device="cpu", warmup=False)
    assert got.extra["use_pallas"] is False
    np.testing.assert_array_equal(
        got.path, tfv.decode(hmm, y, "checkpoint", device="cpu", warmup=False).path)
