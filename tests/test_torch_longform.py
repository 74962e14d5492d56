"""``flash_long`` (FLASH pointer mode in groups of steps) against the JAX
package, exactly: the port's ``flash_decode_long``, ``flash_decode_long_batch``
and ``flash_decode_long_batched`` against JAX's (its Pallas kernels in
interpret mode) and against the port's ``flash`` pointer mode, on the
fixtures of ``tests/test_longform.py`` (N in {1, 2, 4, 8}; groups that split
segments mid-way and one longer than T); one scan call a group with
contiguous kernel inputs; ``decode`` and ``decode_batch``; ``memory:``.
Tolerance 0: paths are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import longform as jlong
from flash_viterbi_tpu_torch.algorithms import longform as tlong
from flash_viterbi_tpu_torch.algorithms.flash import flash_decode
from flash_viterbi_tpu_torch.models.generate import observations

torch.set_num_threads(2)


def _tables(hmm):
    """The port's tables padded to 8 states (as ``tests/test_longform.py``
    pads JAX's), and the same arrays for the JAX package."""
    lh = hmm.log(device="cpu").padded(8)
    port = (lh.logA, lh.logB, lh.logPi)
    return port, tuple(jnp.asarray(t.numpy()) for t in port)


def _seqs(y0, T, M, n, seed):
    return np.stack([np.asarray(y0, np.int64)] + [observations(T, M, seed=seed + b)
                                                  for b in range(1, n)])


@pytest.mark.parametrize("N,group", [(4, 16), (4, 64), (2, 7), (1, 16), (8, 1000)])
def test_long_matches_jax_and_flash_pointer(N, group):
    hmm, y = tfv.make_sparse_hmm(K=96, M=10, T=64, prob=0.25, seed=11)
    port, jt = _tables(hmm)
    yd = torch.as_tensor(y, dtype=torch.int64)
    got = tlong.flash_decode_long(*port, yd, num_segments=N, group_steps=group)
    assert got.dtype == torch.int32 and got.shape == (64,)
    want = jlong.flash_decode_long(*jt, y, num_segments=N, group_steps=group)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, flash_decode(*port, yd, num_segments=N, mode="pointer"))


def test_group_boundary_invariance():
    """Splitting the scans at any group boundary is the same computation."""
    hmm, y = tfv.make_sparse_hmm(K=64, M=8, T=48, prob=0.3, seed=5)
    port, _ = _tables(hmm)
    yd = torch.as_tensor(y, dtype=torch.int64)
    paths = [tlong.flash_decode_long(*port, yd, num_segments=4, group_steps=g)
             for g in (1, 5, 12, 47, 1000)]
    for p in paths[1:]:
        assert torch.equal(paths[0], p)


def test_long_batch_matches_jax_and_flash():
    hmm, y0 = tfv.make_sparse_hmm(K=64, M=8, T=32, prob=0.3, seed=7)
    port, jt = _tables(hmm)
    ys = _seqs(y0, 32, 8, 2, seed=1)
    got = tlong.flash_decode_long_batch(*port, torch.as_tensor(ys), num_segments=4,
                                        group_steps=16)
    want = jlong.flash_decode_long_batch(*jt, ys.astype(np.int32), num_segments=4,
                                         group_steps=16)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(2):
        assert torch.equal(got[b], flash_decode(*port, torch.as_tensor(ys[b]), num_segments=4))
    one = tlong.flash_decode_long_batch(*port, torch.as_tensor(ys[:1]), num_segments=4,
                                        group_steps=16)
    assert torch.equal(one, got[:1])


@pytest.mark.parametrize("N,group", [(4, 16), (2, 13), (1, 29), (16, 5)])
def test_long_batched_matches_jax_and_per_sequence(N, group):
    """The batched pipeline (one scan a group for every sequence, carries
    kept at the groups' starts, groups re-scanned in reverse for the walk,
    every sequence's segments as lanes) against JAX's and against the
    per-sequence decode."""
    hmm, y0 = tfv.make_sparse_hmm(K=96, M=10, T=64, prob=0.25, seed=11)
    port, jt = _tables(hmm)
    ys = _seqs(y0, 64, 10, 4, seed=3)
    got = tlong.flash_decode_long_batched(*port, torch.as_tensor(ys), num_segments=N,
                                          group_steps=group)
    want = jlong.flash_decode_long_batched(*jt, ys.astype(np.int32), num_segments=N,
                                           group_steps=group)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(4):
        single = tlong.flash_decode_long(*port, torch.as_tensor(ys[b]), num_segments=N,
                                         group_steps=group)
        assert torch.equal(got[b], single), (N, group, b)


def test_phase2_sub_batches(monkeypatch):
    """Phase 2 in sub-batches of one sequence (a budget below one
    sequence's carry parts) gives the same paths."""
    hmm, y0 = tfv.make_sparse_hmm(K=96, M=10, T=64, prob=0.25, seed=11)
    port, _ = _tables(hmm)
    ys = torch.as_tensor(_seqs(y0, 64, 10, 3, seed=9))
    whole = tlong.flash_decode_long_batched(*port, ys, num_segments=4, group_steps=16)
    monkeypatch.setattr(tlong, "PHASE2_BYTES", 1)
    assert torch.equal(tlong.flash_decode_long_batched(*port, ys, num_segments=4,
                                                       group_steps=16), whole)


@pytest.mark.parametrize("batch", [False, True])
def test_one_scan_call_a_group_and_contiguous_kernel_inputs(batch, monkeypatch):
    """Each group is one scan call (phase 1 pointer scans, phase 2 carry
    scans; the batched phases A and B a carry scan each), each part walked
    once, and every kernel input is contiguous (the CUDA wrappers refuse
    anything else)."""
    called = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            called.append((name, args[1].shape[0] if name.startswith("maxplus") else None))
            for a in (*args, *kw.values()):
                assert not torch.is_tensor(a) or a.is_contiguous(), name
            return fn(*args, **kw)
        return wrapped

    for name in ("maxplus_scan", "maxplus_scan_deltas", "argmax_walk", "backtrack_batched"):
        monkeypatch.setattr(tlong, name, spy(name, getattr(tlong, name)))
    hmm, y = tfv.make_sparse_hmm(K=40, M=6, T=23, prob=0.3, seed=4)
    port, _ = _tables(hmm)
    # T=23 at N=2: phase 1 steps 1..22 in groups of 10, 10, 2; segments of
    # 12 and 11 positions, phase 2 steps 1..11 in groups of 10 and 1
    if batch:
        ys = torch.as_tensor(_seqs(y, 23, 6, 2, seed=6))
        tlong.flash_decode_long_batch(*port, ys, num_segments=2, group_steps=10)
        scans = [("maxplus_scan_deltas", n) for n in (10, 10, 2)]
        walks = [("argmax_walk", None)] * 3
        assert called[:3] == scans and called[3::2][:3] == scans[::-1]
        assert called[4:9:2] == walks
        called = called[9:]
    else:
        tlong.flash_decode_long(*port, torch.as_tensor(y, dtype=torch.int64), num_segments=2,
                                group_steps=10)
        assert called[:6] == [("maxplus_scan", 10), ("maxplus_scan", 10), ("maxplus_scan", 2)] \
            + [("backtrack_batched", None)] * 3
        called = called[6:]
    assert called == [("maxplus_scan_deltas", 10), ("maxplus_scan_deltas", 1)] \
        + [("argmax_walk", None)] * 2


def test_decode_and_decode_batch_match_jax_and_flash():
    """The registered decoder: paths of JAX's ``flash_long`` and of the port's
    ``flash`` at the same segments, the reference ``memory:`` of flash
    pointer mode, no launch on the CPU; ``decode_batch`` row by row."""
    hmm, y = tfv.make_sparse_hmm(K=96, M=10, T=48, prob=0.25, seed=11)
    jhmm = jfv.HMM(hmm.A, hmm.B, hmm.Pi)
    got = tfv.decode(hmm, y, "flash_long", num_segments=4, group_steps=20, device="cpu",
                     warmup=False)
    want = jfv.decode(jhmm, y, "flash_long", num_segments=4, group_steps=20, warmup=False)
    flash = tfv.decode(hmm, y, "flash", num_segments=4, device="cpu", warmup=False)
    np.testing.assert_array_equal(got.path, np.asarray(want.path))
    np.testing.assert_array_equal(got.path, flash.path)
    assert got.path.dtype == np.int32
    assert got.memory_bytes == want.memory_bytes == flash.memory_bytes
    assert all(n == 0 for n in got.extra["launches"].values())
    assert got.extra["group_steps"] == 20 and got.extra["num_segments"] == 4
    ys = _seqs(y, 48, 10, 3, seed=2)
    batch = tfv.decode_batch(hmm, ys, "flash_long", num_segments=4, group_steps=20,
                             device="cpu", warmup=False)
    flash_b = tfv.decode_batch(hmm, ys, "flash", num_segments=4, device="cpu", warmup=False)
    np.testing.assert_array_equal(batch.path, flash_b.path)
    assert batch.memory_bytes == 3 * got.memory_bytes


@pytest.mark.parametrize("K,T,N", [(16384, 65536, 16), (3965, 256, 4), (10, 3, 8)])
def test_memory_equals_jax_and_flash_pointer(K, T, N):
    got = tfv.build("flash_long", num_segments=N).analytic_memory(K=K, T=T)
    assert got == jfv.build("flash_long", num_segments=N).analytic_memory(K=K, T=T)
    assert got == tfv.build("flash", num_segments=N).analytic_memory(K=K, T=T)
