"""The SIEVE decoders against the JAX package, exactly: the port's
``sieve_mp`` and ``sieve_bs_mp`` decodes on the CPU against JAX's (on its
XLA path, and with its scan kernel in interpret mode) and against the
copied oracles (``oracle.sieve.sieve_mp`` in fp32 numerics,
``oracle.framework.sieve_bs_mp``): paths, analytic memory, the static tree,
the median planes, batching and the kernel calls' inputs.  Tolerance 0:
the paths are integers."""

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import sieve as jsieve
from flash_viterbi_tpu.oracle import framework as jfw
from flash_viterbi_tpu.oracle import sieve as jorc
from flash_viterbi_tpu.parallel.batch import decode_batch as jdecode_batch
from flash_viterbi_tpu_torch.algorithms import sieve as tsieve
from flash_viterbi_tpu_torch.models.generate import make_tie_hmm, observations
from flash_viterbi_tpu_torch.oracle import framework as tfw
from flash_viterbi_tpu_torch.oracle import sieve as torc

torch.set_num_threads(2)

# test_tpu_algorithms.py's sieve_bs_mp fixtures and its K=512 case
BS_MP_FIXTURES = [(48, 8, 24, 0.25, 3, 8), (64, 12, 32, 0.3, 7, 16), (32, 6, 17, 0.4, 1, 4),
                  (512, 6, 16, 0.02, 5, 16)]


def _jax(hmm):
    """The same probability tables as the JAX package's ``HMM``."""
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _assert_same(j, t):
    np.testing.assert_array_equal(t.path, j.path)
    assert t.path.dtype == np.int32
    assert t.memory_bytes == j.memory_bytes


def _nonuniform_pi():
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=32, prob=0.3, seed=5)
    pi = np.random.RandomState(99).uniform(0.05, 1.0, hmm.K)
    return tfv.HMM(hmm.A, hmm.B, pi / pi.sum()), y


def _tie_problem():
    """Exact ties everywhere (``make_tie_hmm``: an all -inf column of logA,
    a state that only loops, uniform emissions over two symbols a state)."""
    return make_tie_hmm(K=24, M=3, T=21, prob=0.3, seed=11)


def _problem(name):
    if name == "small_problem":  # conftest.py's fixture
        return tfv.make_sparse_hmm(K=64, M=12, T=32, prob=0.3, seed=7)
    if name == "nonuniform_pi":
        return _nonuniform_pi()
    if name == "ties":
        return _tie_problem()
    return tfv.make_sparse_hmm(K=48, M=8, T=int(name[2:]), prob=0.3, seed=3)


def test_build_tree_and_flatten_positions_equal_jax():
    # every T up to 70, and the headline's T, an odd T and the long T
    for T in list(range(2, 71)) + [256, 257, 16384]:
        got, want = tsieve.build_tree(T), jsieve.build_tree(T)
        assert [vars(n) for n in got] == [vars(n) for n in want], T
        assert tsieve.flatten_positions(got, T) == jsieve.flatten_positions(want, T), T


@pytest.mark.parametrize("name", ["small_problem", "T=1", "T=2", "T=3", "T=17", "T=32",
                                  "T=33", "nonuniform_pi", "ties"])
def test_sieve_mp_matches_jax_and_oracle(name):
    hmm, y = _problem(name)
    for prune in (True, False):
        for pad_to in (1, 128):
            got = tfv.decode(hmm, y, "sieve_mp", pad_to=pad_to, prune=prune, device="cpu",
                             warmup=False)
            _assert_same(jfv.decode(_jax(hmm), y, "sieve_mp", pad_to=pad_to, prune=prune,
                                    use_pallas=False, warmup=False), got)
            assert all(n == 0 for n in got.extra["launches"].values())
    if len(y) > 1:  # the reference's flattening needs two output slots
        want = torc.sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
        np.testing.assert_array_equal(want, jorc.sieve_mp(hmm.A, hmm.B, hmm.Pi, y,
                                                          numerics="f32"))
        got = tfv.decode(hmm, y, "sieve_mp", pad_to=1, device="cpu", warmup=False)
        np.testing.assert_array_equal(got.path, want)


def test_sieve_mp_matches_jax_scan_kernel_in_interpret_mode():
    hmm, y = _problem("small_problem")
    got = tfv.decode(hmm, y, "sieve_mp", pad_to=128, device="cpu", warmup=False)
    _assert_same(jfv.decode(_jax(hmm), y, "sieve_mp", pad_to=128, use_pallas=True,
                            warmup=False), got)


def test_sieve_mp_oracle_c_numerics_equals_jax():
    hmm, y = _problem("T=33")
    np.testing.assert_array_equal(torc.sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="c"),
                                  jorc.sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="c"))


@pytest.mark.parametrize("K,M,T,prob,seed,bw", BS_MP_FIXTURES)
def test_sieve_bs_mp_matches_jax_and_mirror(K, M, T, prob, seed, bw):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    got = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=bw, pad_to=1, device="cpu",
                     warmup=False)
    _assert_same(jfv.decode(_jax(hmm), y, "sieve_bs_mp", beam_width=bw, pad_to=1,
                            warmup=False), got)
    for mirror in (tfw.sieve_bs_mp, jfw.sieve_bs_mp):
        np.testing.assert_array_equal(got.path, mirror(hmm.A, hmm.B, hmm.Pi, y,
                                                       beam_width=bw))
    assert all(n == 0 for n in got.extra["launches"].values())


@pytest.mark.parametrize("name", ["T=1", "T=2", "T=3", "ties"])
def test_sieve_bs_mp_edges_match_jax(name):
    hmm, y = _problem(name)
    for pad_to in (1, 128):
        got = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=4, pad_to=pad_to, device="cpu",
                         warmup=False)
        _assert_same(jfv.decode(_jax(hmm), y, "sieve_bs_mp", beam_width=4, pad_to=pad_to,
                                warmup=False), got)
    if len(y) > 1:
        np.testing.assert_array_equal(got.path, tfw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y,
                                                                beam_width=4))


def test_sieve_bs_mp_matches_jax_scan_kernel_in_interpret_mode():
    hmm, y = tfv.make_sparse_hmm(K=64, M=12, T=32, prob=0.3, seed=7)
    got = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=16, pad_to=128, device="cpu",
                     warmup=False)
    _assert_same(jfv.decode(_jax(hmm), y, "sieve_bs_mp", beam_width=16, pad_to=128,
                            use_pallas=True, warmup=False), got)


@pytest.mark.parametrize("seed_base", [600, 640])
def test_sieve_bs_mp_mirror_fuzz(seed_base):
    """After test_fuzz.py's sweep: NaN-row (zero out-degree) models and
    permuted-path ties included, the decode equals the fp32 mirror."""
    import warnings

    for seed in range(seed_base, seed_base + 25):
        rng = np.random.RandomState(seed)
        K = int(rng.randint(16, 28))
        M = int(rng.randint(3, 8))
        T = int(rng.randint(6, 24))
        prob = float(rng.uniform(0.1, 0.25))
        bw = int(rng.randint(2, 6))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # NaN rows are intentional
            hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        got = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=bw, pad_to=1, device="cpu",
                         warmup=False)
        np.testing.assert_array_equal(got.path, tfw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y,
                                                                beam_width=bw),
                                      err_msg=f"seed={seed} K={K} M={M} T={T} bw={bw}")


def test_beam_step_lane_chunks_change_no_value(monkeypatch):
    """A beam step's lanes in chunks of one lane give the same path."""
    hmm, y = tfv.make_sparse_hmm(K=40, M=5, T=37, prob=0.2, seed=4)
    lh = hmm.log(device="cpu")
    yd = torch.as_tensor(y.astype(np.int64))
    A_posF = (lh.logA > tsieve.NEG).float()
    whole = tsieve.sieve_bs_mp_decode(lh.logA, lh.logB, lh.logPi, yd, A_posF, beam_width=6)
    monkeypatch.setattr(tsieve, "BEAM_STEP_BYTES", 1)
    chunked = tsieve.sieve_bs_mp_decode(lh.logA, lh.logB, lh.logPi, yd, A_posF, beam_width=6)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    np.testing.assert_array_equal(whole.numpy(), tfw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, 6))


@pytest.mark.parametrize("length", [2, 3, 4, 9, 20])
def test_planes_from_ptrs_equal_jax(length):
    """The fold route (``fold_planes``, then one gather) gives JAX's
    ``lax.scan`` planes; at length 2 there is no row to fold."""
    import jax.numpy as jnp

    S, K = 5, 37
    ptrs = np.random.RandomState(length).randint(0, K, (length - 1, S, K)).astype(np.int32)
    px, py = tsieve._planes_from_ptrs(torch.from_numpy(ptrs), length // 2)
    jx, jy = jsieve._planes_from_ptrs(jnp.asarray(ptrs), length // 2)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert px.dtype == py.dtype == torch.int32


def test_bfs_masks_equal_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    K, S = 30, 4
    adj = (rng.uniform(size=(K, K)) < 0.1).astype(np.float32)
    front = np.eye(K, dtype=np.float32)[rng.randint(0, K, S)]
    parent = (rng.uniform(size=(S, K)) < 0.7).astype(np.float32)
    for hops in (0, 1, 3, 9):
        got = tsieve._bfs_masks(torch.from_numpy(adj).t(), torch.from_numpy(front),
                                torch.from_numpy(parent), hops)
        want = jsieve._bfs_masks(jnp.asarray(adj).T, jnp.asarray(front), jnp.asarray(parent),
                                 hops)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = tsieve._bfs_masks(torch.from_numpy(adj), torch.from_numpy(front), None, hops)
        want = jsieve._bfs_masks(jnp.asarray(adj), jnp.asarray(front),
                                 jnp.ones_like(jnp.asarray(parent)), hops)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm,static", [("sieve_mp", {}), ("sieve_mp", {"prune": False}),
                                              ("sieve_bs_mp", {"beam_width": 4})])
def test_decode_batch_rows_equal_single_decodes(algorithm, static):
    hmm, y = tfv.make_sparse_hmm(K=40, M=6, T=19, prob=0.25, seed=3)
    ys = np.stack([y] + [observations(19, 6, seed=s) for s in (4, 5)])
    got = tfv.decode_batch(hmm, ys, algorithm, device="cpu", warmup=False, **static)
    want = jdecode_batch(_jax(hmm), ys, algorithm, warmup=False, use_pallas=False, **static)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes
    for b in range(3):
        single = tfv.decode(hmm, ys[b], algorithm, device="cpu", warmup=False, **static)
        np.testing.assert_array_equal(got.path[b], single.path)


@pytest.mark.parametrize("algorithm,static,route", [
    ("sieve_mp", {}, "scan+fold"),
    ("sieve_mp", {"prune": False}, "scan+fold"),
    ("sieve_bs_mp", {"beam_width": 4}, "scan"),
])
def test_kernel_calls_take_contiguous_inputs_and_one_error_read(algorithm, static, route,
                                                                monkeypatch):
    """Every group's scan and (sieve_mp) fold get contiguous tensors, every
    scan the decode's one error word, and the decode reads it once (the
    CUDA wrappers refuse a non-contiguous tensor; the plain versions on the
    CPU would not notice)."""
    called, errs, reads = [], set(), []

    def spy(name, fn):
        def wrapped(*args, **kw):
            called.append(name)
            for a in (*args, *kw.values()):
                assert not torch.is_tensor(a) or a.is_contiguous(), name
            if "err" in kw:
                errs.add(id(kw["err"]))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tsieve, "maxplus_scan", spy("scan", tsieve.maxplus_scan))
    monkeypatch.setattr(tsieve, "fold_planes", spy("fold", tsieve.fold_planes))
    read = tsieve.raise_on_error
    monkeypatch.setattr(tsieve, "raise_on_error",
                        lambda err, what: reads.append(what) or read(err, what))
    T = 23
    hmm, y = tfv.make_sparse_hmm(K=30, M=5, T=T, prob=0.3, seed=9)
    tfv.decode(hmm, y, algorithm, device="cpu", warmup=False, **static)
    groups = len(tsieve._groups(tsieve.build_tree(T)))
    assert called.count("scan") == groups and len(errs) == 1
    assert called.count("fold") == (groups if route == "scan+fold" else 0)
    assert reads == [algorithm]


def test_memory_matches_jax():
    for K in (1, 96, 3965):
        for T in (1, 2, 37, 256):
            assert (tfv.build("sieve_mp").analytic_memory(K=K, T=T)
                    == jfv.build("sieve_mp").analytic_memory(K=K, T=T))
            for bw in (1, 64, 5000):
                assert (tfv.build("sieve_bs_mp", beam_width=bw).analytic_memory(K=K, T=T)
                        == jfv.build("sieve_bs_mp", beam_width=bw).analytic_memory(K=K, T=T))


def test_options_are_recorded():
    hmm, y = tfv.make_sparse_hmm(K=20, M=4, T=9, prob=0.3, seed=2)
    r = tfv.decode(hmm, y, "sieve_mp", use_pallas=True, device="cpu", warmup=False)
    assert r.extra["prune"] is True and r.extra["use_pallas"] is True
    r = tfv.decode(hmm, y, "sieve_bs_mp", device="cpu", warmup=False)
    assert r.extra["beam_width"] == 64
