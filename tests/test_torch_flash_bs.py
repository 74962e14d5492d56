"""The beam family against the JAX package, exactly: the port's ``flash_bs``
and ``beam`` decodes on the CPU against JAX's (with its beam kernel in
interpret mode, and on its XLA path) and against both packages' numpy
mirrors — paths (-1 segments included), analytic memory and the reference
stdout lines — plus batching, the kernel calls' inputs and the options."""

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import beam as jbeam
from flash_viterbi_tpu.algorithms import flash_bs as jflash_bs
from flash_viterbi_tpu.oracle import framework as jfw
from flash_viterbi_tpu.parallel.batch import decode_batch as jdecode_batch
from flash_viterbi_tpu_torch.algorithms import beam as tbeam
from flash_viterbi_tpu_torch.algorithms import flash_bs as tflash_bs
from flash_viterbi_tpu_torch.models.generate import observations
from flash_viterbi_tpu_torch.oracle import framework as tfw

torch.set_num_threads(2)


def _jax(hmm):
    """The same probability tables as the JAX package's ``HMM`` (the port's
    ``HMM.log()`` builds its tables on the card by default)."""
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith(("path:", "memory:"))]


def _assert_same(j, t):
    np.testing.assert_array_equal(t.path, j.path)
    assert t.path.dtype == np.int32
    assert t.memory_bytes == j.memory_bytes
    assert _lines(t.reference_stdout()) == _lines(j.reference_stdout())


def _check(hmm, y, algorithm, **static):
    """The port's CPU decode against JAX's on both routes and the mirrors;
    returns the port's result."""
    got = tfv.decode(hmm, y, algorithm, device="cpu", warmup=False, **static)
    for use_pallas in (True, False):
        _assert_same(jfv.decode(_jax(hmm), y, algorithm, use_pallas=use_pallas,
                                warmup=False, **static), got)
    mirror = {"flash_bs": (tfw.flash_bs, jfw.flash_bs), "beam": (tfw.beam, jfw.beam)}
    for fn in mirror[algorithm]:
        np.testing.assert_array_equal(got.path, fn(hmm.A, hmm.B, hmm.Pi, y, **static))
    assert all(n == 0 for n in got.extra["launches"].values())
    return got


@pytest.mark.parametrize("K,T,bw,N", [
    (96, 40, 8, 1),
    (96, 40, 8, 2),
    (96, 40, 16, 4),
    (200, 37, 8, 8),
    (96, 11, 8, 8),   # T < 2N: the segment count clamps to T // 2
    (96, 1, 8, 8),    # T = 1
])
def test_flash_bs_matches_jax(K, T, bw, N):
    hmm, y = tfv.make_sparse_hmm(K=K, M=11, T=T, prob=0.2, seed=K + T + N)
    _check(hmm, y, "flash_bs", beam_width=bw, num_segments=N)


@pytest.mark.parametrize("K,T,bw", [(96, 40, 8), (200, 37, 16), (96, 1, 8)])
def test_beam_matches_jax(K, T, bw):
    hmm, y = tfv.make_sparse_hmm(K=K, M=11, T=T, prob=0.2, seed=K + T)
    _check(hmm, y, "beam", beam_width=bw)


def test_full_beam_equals_vanilla_and_wide_beams_clamp():
    hmm, y = tfv.make_sparse_hmm(K=60, M=7, T=24, prob=0.2, seed=6)
    vanilla = tfv.decode(hmm, y, "vanilla", device="cpu", warmup=False)
    for algorithm, static in (("flash_bs", {"num_segments": 4}), ("beam", {})):
        full = tfv.decode(hmm, y, algorithm, beam_width=60, device="cpu", warmup=False,
                          **static)
        np.testing.assert_array_equal(full.path, vanilla.path)
        # beyond the padded K (128) the beam clamps to it
        wide = tfv.decode(hmm, y, algorithm, beam_width=1000, device="cpu", warmup=False,
                          **static)
        clamped = tfv.decode(hmm, y, algorithm, beam_width=128, device="cpu",
                             warmup=False, **static)
        np.testing.assert_array_equal(wide.path, clamped.path)
        want = jfv.decode(_jax(hmm), y, algorithm, beam_width=1000, use_pallas=False,
                          warmup=False, **static)
        _assert_same(want, wide)


@pytest.mark.parametrize("K,prob,bw", [(40, 0.1, 2), (64, 0.08, 1)])
def test_beam_fallout_gives_minus_one_segments(K, prob, bw):
    """A forced end state that fell out of its segment's final beam makes
    the whole segment -1, as in the reference."""
    hmm, y = tfv.make_sparse_hmm(K=K, M=6, T=24, prob=prob, seed=0)
    got = _check(hmm, y, "flash_bs", beam_width=bw, num_segments=4)
    assert (got.path == -1).any()
    assert ((got.path >= -1) & (got.path < K)).all()


def test_decode_batch_flash_bs_rows_equal_single_decodes():
    hmm, y = tfv.make_sparse_hmm(K=50, M=6, T=14, prob=0.2, seed=3)
    ys = np.stack([y] + [observations(14, 6, seed=s) for s in (4, 5)])
    static = {"beam_width": 4, "num_segments": 3}
    got = tfv.decode_batch(hmm, ys, "flash_bs", device="cpu", warmup=False, **static)
    want = jdecode_batch(_jax(hmm), ys, "flash_bs", warmup=False, use_pallas=False,
                         **static)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes == 3 * tflash_bs._memory(K=50, T=14,
                                                                          **static)
    for b in range(3):
        single = tfv.decode(hmm, ys[b], "flash_bs", device="cpu", warmup=False, **static)
        np.testing.assert_array_equal(got.path[b], single.path)


@pytest.mark.parametrize("algorithm,static,route", [
    ("flash_bs", {"num_segments": 4}, ("beam_scan", "beam_scan", "backtrack_batched")),
    ("beam", {}, ("beam_scan", "backtrack_batched")),
])
def test_beam_decoders_route_and_contiguous_kernel_inputs(algorithm, static, route,
                                                          monkeypatch):
    """Each decoder calls its kernels, and hands them only contiguous
    tensors (the CUDA wrappers refuse anything else)."""
    called = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            called.append(name)
            for a in (*args, *kw.values()):
                assert not torch.is_tensor(a) or a.is_contiguous(), name
            return fn(*args, **kw)
        return wrapped

    for mod in (tflash_bs, tbeam):
        monkeypatch.setattr(mod, "beam_scan", spy("beam_scan", mod.beam_scan))
    monkeypatch.setattr(tflash_bs, "backtrack_batched",
                        spy("backtrack_batched", tflash_bs.backtrack_batched))
    hmm, y = tfv.make_sparse_hmm(K=70, M=5, T=20, prob=0.3, seed=2)
    tfv.decode(hmm, y, algorithm, beam_width=8, device="cpu", warmup=False, **static)
    assert tuple(called) == route


def test_memory_matches_jax():
    for K in (1, 96, 3965):
        for T in (1, 2, 37, 256):
            for bw in (1, 64, 5000):
                assert tbeam._memory(K=K, T=T, beam_width=bw) == jbeam._memory(
                    K=K, T=T, beam_width=bw)
                for N in (1, 2, 8, 16):
                    assert (tflash_bs._memory(K=K, T=T, beam_width=bw, num_segments=N)
                            == jflash_bs._memory(K=K, T=T, beam_width=bw, num_segments=N))
    assert tflash_bs._memory(K=3965, T=256, beam_width=64, num_segments=8) == 12656
    assert tbeam._memory(K=3965, T=256, beam_width=64) == 133120


def test_use_pallas_is_not_an_option():
    """JAX's use_pallas is recorded, as every extra keyword is, and routes
    nothing: the path is the same."""
    hmm, y = tfv.make_sparse_hmm(K=40, M=5, T=30, prob=0.3, seed=2)
    for algorithm in ("flash_bs", "beam"):
        got = tfv.decode(hmm, y, algorithm, beam_width=8, use_pallas=False, device="cpu",
                         warmup=False)
        assert got.extra["use_pallas"] is False
        np.testing.assert_array_equal(got.path, tfv.decode(
            hmm, y, algorithm, beam_width=8, device="cpu", warmup=False).path)
