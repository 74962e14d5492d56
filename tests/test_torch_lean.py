"""FLASH lean mode: the port's decode against the JAX package's, exactly
(JAX with its Pallas kernels in interpret mode, and without them); the
splitting tree, the chunked phase 1, the fold and the lane budget; the
f32 FLASH mirror and the tie-flip arbiter against the JAX package's."""

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import flash as jflash
from flash_viterbi_tpu.oracle import reference as jref
from flash_viterbi_tpu.oracle import validate as jval
from flash_viterbi_tpu_torch.algorithms import flash as tflash
from flash_viterbi_tpu_torch.ops import maxplus as tmp
from flash_viterbi_tpu_torch.ops.cuda import fold as tfold
from flash_viterbi_tpu_torch.ops.cuda import maxplus as tcm
from flash_viterbi_tpu_torch.oracle import reference as tref
from flash_viterbi_tpu_torch.oracle import validate as tval

torch.set_num_threads(2)

H100_SMS = 132


def _jax(hmm):
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


@pytest.fixture(scope="module")
def chunk_problem():
    """T=70: phase 1 takes a chunk of 64 steps and one of 5."""
    return tfv.make_sparse_hmm(K=96, M=11, T=70, prob=0.2, seed=5)


@pytest.mark.parametrize("leaf", [0, 4, 64])
@pytest.mark.parametrize("N", [1, 2, 6, 16])
def test_lean_matches_jax(chunk_problem, N, leaf):
    hmm, y = chunk_problem
    got = tfv.decode(hmm, y, "flash", mode="lean", num_segments=N, lean_leaf=leaf,
                     device="cpu", warmup=False)
    for use_pallas in (True, False):
        want = jfv.decode(_jax(hmm), y, "flash", mode="lean", num_segments=N,
                          lean_leaf=leaf, use_pallas=use_pallas, warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.memory_bytes == want.memory_bytes
    assert got.extra["mode"] == "lean" and got.extra["lean_leaf"] == leaf


@pytest.mark.parametrize("segments,min_leaf", [
    ([(0, 40), (41, 69)], 0),
    ([(0, 40), (41, 69)], 4),
    ([(0, 0), (1, 2), (3, 200)], 16),
    ([(0, 255)], 64),
    ([(0, 1023), (1024, 2047)], 64),
])
def test_split_tree_leaves_matches_jax(segments, min_leaf):
    assert tflash.split_tree_leaves(segments, min_leaf) == jflash.split_tree_leaves(
        segments, min_leaf)
    assert tflash.split_tree(segments) == jflash.split_tree(segments)


@pytest.mark.parametrize("T", [40, 65, 66])  # T-1 steps: under 64, exactly 64, 65
def test_phase1_anchors_chunked_at_chunk_edges(T):
    hmm, y = tfv.make_sparse_hmm(K=72, M=9, T=T, prob=0.25, seed=T)
    lh = hmm.log(device="cpu")
    mids = tflash.flash_midpoints(0, T - 1, 5)
    emits = np.asarray(lh.logB.numpy()[:, y].T)
    jlast, janch = jflash.phase1_anchors_chunked(lh.logA.numpy(), lh.logPi.numpy(), emits, mids)
    yd = torch.as_tensor(y.astype(np.int64))
    prop = torch.as_tensor(tflash.prop_schedule(mids, T))
    last, anch = tflash.phase1_anchors_chunked(lh.logA, lh.logPi, lh.logB, yd,
                                               torch.tensor(mids), prop)
    assert int(last) == int(jlast)
    np.testing.assert_array_equal(anch.numpy(), np.asarray(janch))
    # the whole-table phase 1 of pointer mode reads the same anchors
    plast, panch = tflash.phase1_anchors(lh.logA, lh.logPi, torch.as_tensor(emits),
                                         torch.tensor(mids))
    assert int(plast) == int(last)
    np.testing.assert_array_equal(panch.numpy(), anch.numpy())


def test_init_and_forced_delta_match_jax():
    from flash_viterbi_tpu.ops import maxplus as jmp

    hmm, y = tfv.make_sparse_hmm(K=40, M=6, T=5, prob=0.3, seed=2)
    lh = hmm.log(device="cpu")
    np.testing.assert_array_equal(
        tmp.init_delta(lh.logPi, lh.logB, int(y[0])).numpy(),
        np.asarray(jmp.init_delta(lh.logPi.numpy(), lh.logB.numpy(), int(y[0]))))
    np.testing.assert_array_equal(
        tmp.forced_delta(lh.logA, lh.logB, 7, int(y[3])).numpy(),
        np.asarray(jmp.forced_delta(lh.logA.numpy(), lh.logB.numpy(), 7, int(y[3]))))


@pytest.mark.parametrize("R", [1, 4])
def test_fold_planes_plain(R):
    rng = np.random.RandomState(R)
    P, K, c = 4, 50, 9
    planes = rng.randint(0, K, (P, K)).astype(np.int32)
    rows = rng.randint(0, K, (c, R, K)).astype(np.int32)
    prop = rng.rand(c, P) < 0.6
    want = planes.copy()
    for t in range(c):
        for p in range(P):
            row = rows[t, 0 if R == 1 else p]
            want[p] = want[p][row] if prop[t, p] else row
    got = tfold.fold_planes(torch.as_tensor(planes), torch.as_tensor(rows),
                            torch.as_tensor(prop))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tfold.fold_planes(torch.as_tensor(planes), torch.as_tensor(rows[:, :1].repeat(2, 1)),
                          torch.as_tensor(prop))


def _spy(monkeypatch):
    """Record every kernel-wrapper call lean mode makes: (name, input shapes)."""
    calls = []
    for name in ("maxplus_scan", "maxplus_scan_deltas", "argmax_walk", "fold_planes",
                 "backtrack_batched"):
        real = getattr(tflash, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls.append((_name, [tuple(a.shape) for a in args if torch.is_tensor(a)]))
            return _real(*args, **kw)

        monkeypatch.setattr(tflash, name, wrapped)
    return calls


@pytest.mark.parametrize("leaf,needed,absent", [
    (64, {"maxplus_scan", "maxplus_scan_deltas", "argmax_walk", "fold_planes"},
     {"backtrack_batched"}),
    (0, {"maxplus_scan", "fold_planes"},
     {"backtrack_batched", "maxplus_scan_deltas", "argmax_walk"}),
])
def test_lean_routes_and_never_builds_the_emission_table(monkeypatch, leaf, needed, absent):
    """Every scan's emissions are a chunk or a leaf, never the (T, K) table,
    and each call's tables stay within the working-set formula."""
    hmm, y = tfv.make_sparse_hmm(K=64, M=7, T=300, prob=0.2, seed=9)
    calls = _spy(monkeypatch)
    got = tfv.decode(hmm, y, "flash", mode="lean", num_segments=4, lean_leaf=leaf,
                     device="cpu", warmup=False, pad_to=1)
    np.testing.assert_array_equal(got.path, tfv.decode(hmm, y, "vanilla", device="cpu",
                                                       warmup=False, pad_to=1).path)
    names = {n for n, _ in calls}
    assert needed <= names and not (absent & names)
    K, T = 64, 300
    ws = tflash.lean_working_set(K, T, 4, leaf)
    for name, shapes in calls:
        if name in ("maxplus_scan", "maxplus_scan_deltas"):
            steps, g, k = shapes[1]  # emits (steps, lanes, K)
            assert k == K and steps <= max(tflash.LEAN_CHUNK, leaf - 1)
            assert 2 * steps * g * K * 4 <= ws


def test_lean_splits_lanes_to_keep_the_card_scratch_within_the_formula(monkeypatch):
    """With the H100 scan plan's scratch counted, as on the card, a call
    takes fewer lanes; the path stays the same bit for bit."""
    hmm, y = tfv.make_sparse_hmm(K=200, M=9, T=256, prob=0.2, seed=4)
    want = tfv.decode(hmm, y, "flash", mode="lean", num_segments=16, device="cpu",
                      warmup=False)

    def h100_scratch(K, N, device, with_ptr):
        plan = tcm.scan_plan(K, N, H100_SMS)
        part = 2 * plan.R * plan.lanes * K * 4
        return part * (2 if with_ptr else 1) + (plan.lanes * K * 4 if plan.two_phase else 0)

    monkeypatch.setattr(tflash, "scan_scratch_bytes", h100_scratch)
    calls = _spy(monkeypatch)
    got = tfv.decode(hmm, y, "flash", mode="lean", num_segments=16, device="cpu",
                     warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    Kp, T = 256, 256
    ws = tflash.lean_working_set(Kp, T, 16)
    leaf_lanes = [shapes[1][1] for n, shapes in calls if n == "maxplus_scan_deltas"]
    assert max(leaf_lanes) < 16  # the 16 leaves no longer share one call
    for name, shapes in calls:
        if name in ("maxplus_scan", "maxplus_scan_deltas"):
            steps, g, _ = shapes[1]
            need = (2 * steps + 4) * g * Kp * 4 + h100_scratch(Kp, g, "cuda",
                                                              name == "maxplus_scan")
            assert need <= ws


def test_lean_working_set_headline_figures():
    """The working-set formula at the headline's padded K (3968)."""
    assert tflash.lean_working_set(3968, 256, 16, 64) == 8_189_952
    assert tflash.lean_working_set(3968, 256, 16, 0) == 132_626_432
    assert tflash.lean_working_set(3968, 16384, 16, 64) == 264_681_472


def test_validate_fixture_tie_flips():
    """tests/test_validate.py's seed-91031 draw: pointer and lean mode each
    equal the JAX package's and differ from each other at 2 positions; the
    port's arbiter rules pointer tie-equivalent and lean mirror-exact."""
    rng = np.random.RandomState(91031)
    K = int(rng.randint(128, 513))
    M = int(rng.randint(8, 51))
    T = int(rng.choice([128, 256, 512, 1024]))
    prob = float(rng.uniform(0.05, 0.3))
    segs = int(rng.choice([4, 6, 8]))
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=91031)
    paths = {}
    for mode in ("pointer", "lean"):
        got = tfv.decode(hmm, y, "flash", num_segments=segs, mode=mode, device="cpu",
                         warmup=False).path
        want = jfv.decode(_jax(hmm), y, "flash", num_segments=segs, mode=mode,
                          warmup=False).path
        np.testing.assert_array_equal(got, want)
        paths[mode] = got
    assert (paths["pointer"] != paths["lean"]).sum() == 2
    assert tval.arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, paths["pointer"],
                                         segs) == "tie-equivalent"
    assert tval.arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, paths["lean"],
                                         segs) == "mirror-exact"


@pytest.mark.parametrize("K,M,T,prob,seed,threads", [
    (60, 7, 90, 0.2, 3, 6),
    (130, 12, 64, 0.1, 8, 4),
])
def test_flash_mirror_matches_jax(K, M, T, prob, seed, threads):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    for numerics in ("f32", "c"):
        np.testing.assert_array_equal(
            tref.flash(hmm.A, hmm.B, hmm.Pi, y, threads=threads, numerics=numerics),
            jref.flash(hmm.A, hmm.B, hmm.Pi, y, threads=threads, numerics=numerics))
    lean = tfv.decode(hmm, y, "flash", mode="lean", num_segments=threads, device="cpu",
                      lean_leaf=0, warmup=False).path
    np.testing.assert_array_equal(
        lean, tref.flash(hmm.A, hmm.B, hmm.Pi, y, threads=threads, numerics="f32"))


def test_validate_helpers_match_jax():
    for T, s in ((256, -4000.0), (65536, -1e6), (16, 0.0)):
        assert tval.dp_divergence_tolerance_f64(T, s) == jval.dp_divergence_tolerance_f64(T, s)
    for T, n in ((256, 16), (7, 16), (1, 4), (40, 0)):
        assert tval.effective_flash_segments(T, n) == jval.effective_flash_segments(T, n)
    assert tval.FLASH_MIRROR_MAX_CELLS == jval.FLASH_MIRROR_MAX_CELLS
    assert tval.flash_mirror_cells(3965, 256) == jval.flash_mirror_cells(3965, 256)
    hmm, y = tfv.make_sparse_hmm(K=30, M=5, T=6, prob=0.3, seed=1)
    path = tfv.decode(hmm, y, "vanilla", device="cpu").path
    assert tval.arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, path, 2) is None
    assert tval.arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, path, 3,
                                         max_cells=1.0) is None
