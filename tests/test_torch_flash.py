"""The slice: the port's decode() against the JAX package's, exactly —
paths, analytic memory and the reference stdout lines — for FLASH pointer
mode (JAX with its Pallas kernels in interpret mode, and without them) and
for vanilla; plus the port's oracles, device handling and import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.oracle import framework as jfw
from flash_viterbi_tpu_torch.oracle import framework as tfw
from flash_viterbi_tpu_torch.oracle import native as tnative
from flash_viterbi_tpu_torch.oracle import validate as tval

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


@pytest.mark.parametrize("K,T,N", [
    (96, 40, 1),
    (96, 40, 2),
    (96, 40, 6),
    (96, 40, 16),   # T < 2N: the segment count clamps to T // 2
    (200, 37, 6),
    (200, 64, 16),
    (200, 1, 16),   # T = 1
])
def test_flash_matches_jax(K, T, N):
    hmm, y = tfv.make_sparse_hmm(K=K, M=11, T=T, prob=0.2, seed=K + T + N)
    got = tfv.decode(hmm, y, "flash", num_segments=N, device="cpu", warmup=False)
    for use_pallas in (True, False):
        want = jfv.decode(_jax(hmm), y, "flash", num_segments=N, use_pallas=use_pallas,
                          warmup=False)
        _assert_same(want, got)
    assert got.extra["K_padded"] == ((K + 127) // 128) * 128
    assert all(n == 0 for n in got.extra["launches"].values())


def test_vanilla_matches_jax_and_oracles():
    hmm, y = tfv.make_sparse_hmm(K=150, M=13, T=48, prob=0.15, seed=4)
    got = tfv.decode(hmm, y, "vanilla", device="cpu", warmup=False)
    _assert_same(jfv.decode(_jax(hmm), y, "vanilla", warmup=False), got)
    mirror = jfw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    np.testing.assert_array_equal(got.path, mirror)
    np.testing.assert_array_equal(tfw.vanilla(hmm.A, hmm.B, hmm.Pi, y), mirror)
    np.testing.assert_array_equal(tnative.vanilla(hmm.A, hmm.B, hmm.Pi, y), mirror)
    flash = tfv.decode(hmm, y, "flash", num_segments=5, device="cpu", warmup=False)
    np.testing.assert_array_equal(flash.path, got.path)


def test_path_score_f64_and_tolerance():
    from flash_viterbi_tpu.oracle import validate as jval

    hmm, y = tfv.make_sparse_hmm(K=40, M=6, T=20, prob=0.3, seed=8)
    path = tfw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    got = tval.path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
    assert got == jval.path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
    assert np.isfinite(got)
    for s in (got, -1e9, 0.0):
        assert tval.score_tolerance_f64(20, s) == jval.score_tolerance_f64(20, s)


def test_padding_invariance_and_logHMM_input():
    hmm, y = tfv.make_sparse_hmm(K=70, M=9, T=33, prob=0.25, seed=5)
    a = tfv.decode(hmm, y, "flash", num_segments=4, device="cpu", pad_to=1)
    b = tfv.decode(hmm.log(device="cpu"), y, "flash", num_segments=4, device="cpu", pad_to=128)
    np.testing.assert_array_equal(a.path, b.path)
    assert a.extra["K_padded"] == 70 and b.extra["K_padded"] == 128


def test_unported_options_and_unknown_names_raise():
    hmm, y = tfv.make_sparse_hmm(K=16, M=3, T=8, prob=0.5, seed=1)
    with pytest.raises(ValueError, match="mode"):
        tfv.decode(hmm, y, "flash", mode="fast", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfv.decode(hmm, y, "flash", precision="bf16", device="cpu")
    with pytest.raises(KeyError):
        tfv.decode(hmm, y, "nope", device="cpu")
    with pytest.raises(ValueError):
        tfv.decode(hmm, y, "flash", device="meta")
    assert tfv.available_algorithms() == ["auto", "beam", "checkpoint", "flash", "flash_bs",
                                          "flash_long", "fused", "sieve", "sieve_bs",
                                          "sieve_bs_mp", "sieve_dag", "sieve_mp", "vanilla"]
    assert tfv.available_algorithms() == jfv.available_algorithms()


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hmm, y = tfv.make_sparse_hmm(K=16, M=3, T=8, prob=0.5, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfv.decode(hmm, y, "flash")  # device defaults to "cuda"


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, chip_smoke, flash_viterbi_tpu_torch, flash_viterbi_tpu_torch.ops.cuda, "
            "flash_viterbi_tpu_torch.parallel.batch, "
            "flash_viterbi_tpu_torch.oracle.native, "
            "flash_viterbi_tpu_torch.oracle.validate, "
            "flash_viterbi_tpu_torch.oracle.framework, "
            "flash_viterbi_tpu_torch.algorithms.beam, "
            "flash_viterbi_tpu_torch.algorithms.flash_bs, "
            "flash_viterbi_tpu_torch.ops.beam, flash_viterbi_tpu_torch.ops.cuda.beam, "
            "flash_viterbi_tpu_torch.parallel.sharded, "
            "flash_viterbi_tpu_torch.parallel.multihost, "
            "flash_viterbi_tpu_torch.parallel.commtrace, "
            "flash_viterbi_tpu_torch.bench.harness, flash_viterbi_tpu_torch.probes, "
            "flash_viterbi_tpu_torch.algorithms.auto, flash_viterbi_tpu_torch.oracle.reference, "
            "flash_viterbi_tpu_torch.utils.io, flash_viterbi_tpu_torch.ops.cuda.fold, "
            "flash_viterbi_tpu_torch.probes.alu, flash_viterbi_tpu_torch.probes.scan, "
            "flash_viterbi_tpu_torch.probes.beam, flash_viterbi_tpu_torch.probes.copy, "
            "flash_viterbi_tpu_torch.probes.__main__, flash_viterbi_tpu_torch.oracle.sieve, "
            "flash_viterbi_tpu_torch.algorithms.sieve, flash_viterbi_tpu_torch.models.generate, "
            "flash_viterbi_tpu_torch.algorithms.sieve_bs, flash_viterbi_tpu_torch.oracle.sieve_bs, "
            "flash_viterbi_tpu_torch.bench.bounds, flash_viterbi_tpu_torch.algorithms.sieve_dyn, "
            "flash_viterbi_tpu_torch.algorithms.longform; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flash_viterbi_tpu', 'triton')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
