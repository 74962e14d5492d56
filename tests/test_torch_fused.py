"""The fused decoder and batched decoding against the JAX package, exactly:
``fused`` on both of its routes, ``fused_decode_batch`` in every pointer
mode, and ``decode_batch`` (paths, analytic memory, algorithm label), with
the JAX Pallas functions in interpret mode and without them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import fused as jfused
from flash_viterbi_tpu.parallel.batch import decode_batch as jdecode_batch
from flash_viterbi_tpu_torch.algorithms import fused as tfused
from flash_viterbi_tpu_torch.models.generate import observations

torch.set_num_threads(2)


def _jax(hmm):
    """The same probability tables as the JAX package's ``HMM`` (the port's
    ``HMM.log()`` builds its tables on the card by default)."""
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith(("path:", "memory:"))]


def _batch(K: int, M: int, T: int, Bs: int, seed: int):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=0.2, seed=seed)
    ys = np.stack([y] + [observations(T, M, seed=seed + b) for b in range(1, Bs)])
    return hmm, ys


@pytest.mark.parametrize("K,T,pallas", [
    (96, 30, (True, False)),    # K <= 1024: carry history + recompute walk
    (200, 1, (True, False)),    # T = 1
    (1152, 6, (False,)),        # K > 1024: pointer scan + backtrack
])
def test_fused_matches_jax(K, T, pallas):
    hmm, y = tfv.make_sparse_hmm(K=K, M=9, T=T, prob=0.2, seed=K + T)
    got = tfv.decode(hmm, y, "fused", device="cpu", warmup=False)
    for use_pallas in pallas:
        want = jfv.decode(_jax(hmm), y, "fused", use_pallas=use_pallas, warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.path.dtype == np.int32
        assert got.memory_bytes == want.memory_bytes
        assert _lines(got.reference_stdout()) == _lines(want.reference_stdout())
    vanilla = tfv.decode(hmm, y, "vanilla", device="cpu", warmup=False)
    np.testing.assert_array_equal(got.path, vanilla.path)


@pytest.mark.parametrize("K,Bs,pointers,route", [
    (96, 0, None, ("maxplus_scan_deltas", "argmax_walk")),
    (1152, 0, None, ("maxplus_scan", "backtrack_batched")),
    (96, 3, "recompute", ("maxplus_scan_deltas", "argmax_walk")),
    (96, 3, "store", ("maxplus_scan", "backtrack_batched")),
])
def test_fused_routes_and_contiguous_kernel_inputs(K, Bs, pointers, route, monkeypatch):
    """Each route calls its two kernels, and hands them only contiguous
    tensors (the CUDA wrappers refuse anything else)."""
    called = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            called.append(name)
            for a in (*args, *kw.values()):
                assert not torch.is_tensor(a) or a.is_contiguous(), name
            return fn(*args, **kw)
        return wrapped

    for name in ("maxplus_scan", "maxplus_scan_deltas", "argmax_walk",
                 "backtrack_batched"):
        monkeypatch.setattr(tfused, name, spy(name, getattr(tfused, name)))
    if Bs:
        hmm, ys = _batch(K=K, M=5, T=6, Bs=Bs, seed=2)
        tfv.decode_batch(hmm, ys, "fused", pointers=pointers, device="cpu", warmup=False)
    else:
        hmm, y = tfv.make_sparse_hmm(K=K, M=5, T=4, prob=0.3, seed=2)
        tfv.decode(hmm, y, "fused", device="cpu", warmup=False)
    assert tuple(called) == route


@pytest.mark.parametrize("pointers", ["store", "recompute", "auto"])
@pytest.mark.parametrize("Bs", [2, 5])  # auto: store below 4 lanes, recompute above
def test_fused_decode_batch_matches_jax(Bs, pointers):
    hmm, ys = _batch(K=120, M=7, T=11, Bs=Bs, seed=Bs)
    lh = hmm.log(device="cpu").padded(128)
    tables = (lh.logA, lh.logB, lh.logPi)
    got = tfused.fused_decode_batch(*tables, torch.as_tensor(ys, dtype=torch.int64),
                                    pointers=pointers)
    assert got.dtype == torch.int32 and got.shape == ys.shape
    jt = [jnp.asarray(t.numpy()) for t in tables]
    for use_pallas in (True, False):
        want = jfused.fused_decode_batch(*jt, jnp.asarray(ys), use_pallas=use_pallas,
                                         pointers=pointers)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(Bs):
        single = tfused.fused_decode(*tables, torch.as_tensor(ys[b], dtype=torch.int64))
        assert torch.equal(got[b], single)


@pytest.mark.parametrize("algorithm,static", [
    ("fused", {}),
    ("fused", {"pointers": "store"}),
    ("checkpoint", {}),
    ("checkpoint", {"step": 4}),
])
def test_decode_batch_matches_jax(algorithm, static):
    hmm, ys = _batch(K=70, M=8, T=19, Bs=4, seed=11)
    got = tfv.decode_batch(hmm, ys, algorithm, device="cpu", warmup=False, **static)
    want = jdecode_batch(_jax(hmm), ys, algorithm, warmup=False, **static)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.path.dtype == np.int32 and got.path.shape == ys.shape
    assert got.memory_bytes == want.memory_bytes
    assert got.algorithm == want.algorithm == f"batched:{algorithm}"
    assert got.extra["batch"] == 4 and got.extra["K_padded"] == 128
    assert all(n == 0 for n in got.extra["launches"].values())
    for b in range(4):
        single = tfv.decode(hmm, ys[b], algorithm, device="cpu", warmup=False, **static)
        np.testing.assert_array_equal(got.path[b], single.path)


def test_decode_batch_other_algorithms_and_padding():
    hmm, ys = _batch(K=50, M=6, T=14, Bs=3, seed=3)
    flash = tfv.decode_batch(hmm, ys, "flash", num_segments=3, device="cpu", pad_to=1)
    want = jdecode_batch(_jax(hmm), ys, "flash", num_segments=3, pad_to=1, warmup=False)
    np.testing.assert_array_equal(flash.path, want.path)
    assert flash.memory_bytes == want.memory_bytes
    fused = tfv.decode_batch(hmm, ys, "fused", device="cpu", pad_to=1)
    np.testing.assert_array_equal(fused.path, flash.path)
    with pytest.raises(ValueError, match="Bs, T"):
        tfv.decode_batch(hmm, ys[0], "fused", device="cpu")


def test_unported_options_raise():
    hmm, ys = _batch(K=16, M=3, T=8, Bs=2, seed=1)
    with pytest.raises(TypeError, match="make_mesh"):
        tfv.decode_batch(hmm, ys, "fused", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfv.decode(hmm, ys[0], "fused", precision="bf16", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfv.decode_batch(hmm, ys, "fused", precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="pointers"):
        tfv.decode_batch(hmm, ys, "fused", pointers="both", device="cpu")
    # JAX's use_pallas is recorded only (every decoder records its extra
    # keywords) and routes nothing
    assert tfv.build("fused", use_pallas=True).static["use_pallas"] is True
    np.testing.assert_array_equal(
        tfv.decode(hmm, ys[0], "fused", use_pallas=True, device="cpu").path,
        tfv.decode(hmm, ys[0], "fused", device="cpu").path)
