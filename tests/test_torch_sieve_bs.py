"""SIEVE-BS (dynamic median) against the JAX package, exactly: the port's
``sieve_bs`` pairs and paths on the CPU against JAX's
``sieve_bs_decode_many`` with ``engine="device"`` (the whole tree as one
device program) and ``engine="host"`` (the level scheduler), against the
copied oracles (``oracle.sieve_bs.sieve_bs`` in float64 for a uniform Pi,
``oracle.framework.sieve_bs`` in fp32 for any Pi), and against JAX's
``decode``: odd T, T = 1 and 2, a non-uniform Pi, a DAG, a beam of 2 that
prunes every median candidate of a node (the ``(-1, -1)`` totality
sentinel), padding, batches, the b-hop counts' early exit, lane chunks and
``memory:``.  Tolerance 0: the pairs are integers."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import sieve_bs as jbs
from flash_viterbi_tpu.oracle import framework as jfw
from flash_viterbi_tpu.oracle import sieve_bs as jorc
from flash_viterbi_tpu_torch.algorithms import sieve_bs as tbs
from flash_viterbi_tpu_torch.models.generate import make_dag_hmm
from flash_viterbi_tpu_torch.oracle import framework as tfw
from flash_viterbi_tpu_torch.oracle import sieve_bs as torc

torch.set_num_threads(2)

# (K, M, T, prob, seed, beam): test_tpu_algorithms.py's sieve_bs fixtures and
# its engine-parity ones, an odd T, T = 1 and 2, the K=160 edge of the size
FIXTURES = {"k48": (48, 8, 24, 0.25, 3, 8), "k64": (64, 12, 32, 0.3, 7, 16),
            "odd_t17": (32, 6, 17, 0.4, 1, 4), "odd_t33": (48, 8, 33, 0.15, 1, 8),
            "k96": (96, 10, 48, 0.1, 2, 6), "k160": (160, 12, 64, 0.06, 5, 16),
            "t1": (40, 5, 1, 0.3, 2, 4), "t2": (40, 5, 2, 0.3, 2, 4), "t3": (40, 5, 3, 0.3, 2, 4)}
# the fixtures free of the exact fp ties on which the float64 oracle and the
# fp32 decoder legitimately part (permuted-path ties: the framework mirror's
# docstring); the others are held to the mirror alone
ORACLE_EXACT = ("k48", "k64", "odd_t17", "t1", "t2", "t3")
# a beam of 2 that prunes every median candidate of a node: the reference
# crashes (ReferenceUndefined), the decoder emits (-1, -1) and decodes on
SENTINEL = (61, 6, 24, 0.19, 1, 2)


def _pairs(p) -> list:
    return [tuple(int(v) for v in q) for q in p]


def _jax_pairs(hmm, ys, bw, engine):
    lh = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
    return [_pairs(p) for p in jbs.sieve_bs_decode_many(
        jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi), np.asarray(ys), bw,
        engine=engine)]


def _port_pairs(hmm, ys, bw, stats=None):
    lh = hmm.log(device="cpu")
    return tbs.sieve_bs_decode_many(lh.logA, lh.logB, lh.logPi, np.asarray(ys), bw, stats=stats)


def _flat(pairs, T):
    return tbs._flatten_pairs(pairs, T)


def _nonuniform_pi():
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=32, prob=0.3, seed=5)
    pi = np.random.RandomState(99).uniform(0.05, 1.0, hmm.K)
    return tfv.HMM(hmm.A, hmm.B, pi / pi.sum()), y


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pairs_match_both_jax_engines_and_the_oracles(name):
    K, M, T, prob, seed, bw = FIXTURES[name]
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    got = _port_pairs(hmm, y[None], bw)[0]
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], bw, engine)[0], engine
    assert got == _pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw))
    assert got == _pairs(jfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw))
    assert np.allclose(hmm.Pi, 1.0 / K)  # make_sparse_hmm's Pi is uniform
    if name in ORACLE_EXACT:
        assert got == _pairs(torc.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw))


@pytest.mark.parametrize("name", ["k48", "odd_t33", "t1", "t2"])
def test_decode_matches_jax_decode_at_both_paddings(name):
    K, M, T, prob, seed, bw = FIXTURES[name]
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    for pad_to in (1, 128):
        got = tfv.decode(hmm, y, "sieve_bs", beam_width=bw, pad_to=pad_to, device="cpu",
                         warmup=False)
        want = jfv.decode(jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, "sieve_bs", beam_width=bw,
                          pad_to=pad_to, warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.path.dtype == np.int32
        assert got.memory_bytes == want.memory_bytes
        assert all(n == 0 for n in got.extra["launches"].values())
        assert got.extra["beam_width"] == bw
    np.testing.assert_array_equal(
        got.path, _flat(_pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)), T))


def test_nonuniform_pi_matches_the_framework_mirror_and_jax():
    """The decoder follows the C binary (model Pi at every node): the
    framework mirror is its yardstick, the float64 oracle is not."""
    hmm, y = _nonuniform_pi()
    got = _port_pairs(hmm, y[None], 8)[0]
    assert got == _pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=8))
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], 8, engine)[0]


def test_dag_hmm_matches_jax():
    """A dense DAG drives the forward beam up to the last states, which
    cannot last the remaining steps: a beam somewhat wider than T keeps a
    median candidate that can (at T = 32 this draw needs 40; 32 is not
    enough), so the tree recurses to its leaves (T - 1 pairs, no
    sentinel)."""
    hmm, y = make_dag_hmm(K=64, M=10, T=32, seed=2, sanitize=True)
    got = _port_pairs(hmm, y[None], 40)[0]
    assert len(got) == 31 and (-1, -1) not in got
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], 40, engine)[0]
    assert got == _pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=40))


def test_dag_hmm_narrow_beam_decodes_to_the_root_sentinel():
    """The same DAG under a beam of 8: the root's beam prunes every median
    candidate, and the decode is the one (-1, -1) pair in every engine."""
    hmm, y = make_dag_hmm(K=64, M=10, T=32, seed=2, sanitize=True)
    got = _port_pairs(hmm, y[None], 8)[0]
    assert got == [(-1, -1)]
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], 8, engine)[0]
    assert got == _pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=8))


def test_beam_of_two_reaches_the_sentinel():
    K, M, T, prob, seed, bw = SENTINEL
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    with pytest.raises(torc.ReferenceUndefined):
        torc.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    with pytest.raises(jorc.ReferenceUndefined):
        jorc.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    got = _port_pairs(hmm, y[None], bw)[0]
    assert (-1, -1) in got
    assert got == _pairs(tfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw))
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], bw, engine)[0]


def test_decode_batch_equals_single_decodes():
    hmm, _ = tfv.make_sparse_hmm(K=48, M=8, T=24, prob=0.25, seed=3)
    ys = np.stack([tfv.models.generate.observations(24, 8, seed=s) for s in (1, 2, 3)])
    batch = tfv.decode_batch(hmm, ys, "sieve_bs", beam_width=8, device="cpu", warmup=False)
    assert batch.path.shape == (3, 24)
    for b in range(3):
        one = tfv.decode(hmm, ys[b], "sieve_bs", beam_width=8, device="cpu", warmup=False)
        np.testing.assert_array_equal(batch.path[b], one.path)
    assert batch.memory_bytes == 3 * one.memory_bytes
    # one level queue for the batch: the JAX host engine's shared lanes
    assert _port_pairs(hmm, ys, 8) == _jax_pairs(hmm, ys, 8, "host")


@pytest.mark.parametrize("dag", [False, True])
def test_bhop_counts_early_exit_equals_the_full_hop_count(dag):
    if dag:
        hmm, _ = make_dag_hmm(K=96, M=4, T=8, seed=3, sanitize=True)
    else:
        hmm, _ = tfv.make_sparse_hmm(K=96, M=4, T=8, prob=0.05, seed=4)
    lh = hmm.log(device="cpu")
    A_posF = (lh.logA > tbs.NEG).to(torch.float32)
    hops = 95
    anc, desc, taken = tbs._bhop_counts(A_posF, hops)
    assert max(taken) < hops  # stopped early; JAX's runs all 95 hops
    j_anc, j_desc = jbs._bhop_counts(jnp.asarray(A_posF.numpy()), hops=hops)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(j_anc))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(j_desc))
    # a hop short of saturation: no early exit, the same as JAX's
    anc2, _, taken2 = tbs._bhop_counts(A_posF, 2)
    assert taken2 == (2, 2)
    np.testing.assert_array_equal(anc2.numpy(), np.asarray(jbs._bhop_counts(
        jnp.asarray(A_posF.numpy()), hops=2)[0]))


def test_lane_chunks_change_no_pair(monkeypatch):
    """A level's lanes in chunks of one lane (the dense step and the beam
    steps) give the same pairs."""
    hmm, y = tfv.make_sparse_hmm(K=40, M=5, T=37, prob=0.2, seed=4)
    ys = np.stack([y, y[::-1].copy()])
    whole = _port_pairs(hmm, ys, 6)
    monkeypatch.setattr(tbs, "BEAM_STEP_BYTES", 1)
    monkeypatch.setattr(tbs, "DENSE_STEP_BYTES", 1)
    assert _port_pairs(hmm, ys, 6) == whole


def test_stats_count_the_tree():
    K, M, T, prob, seed, bw = FIXTURES["k64"]
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    stats = {}
    pairs = _port_pairs(hmm, y[None], bw, stats)[0]
    assert stats["nodes"] >= len(pairs) and stats["levels"] >= 2
    assert stats["forward_lanes"] <= stats["nodes"] and stats["bhop_limit"] == T - 1
    assert all(h <= T - 1 for h in stats["bhop_hops"]) and stats["host_bfs_s"] >= 0


@pytest.mark.parametrize("K,T,bw", [(3965, 256, 64), (512, 256, 64), (160, 64, 16)])
def test_memory_equals_jax(K, T, bw):
    assert tfv.build("sieve_bs", beam_width=bw).analytic_memory(K, T) == \
        jfv.build("sieve_bs", beam_width=bw).analytic_memory(K, T)


def test_copied_oracles_equal_jax():
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=24, prob=0.25, seed=3)
    for name in ("sieve_bs", "sieve_bs_mp"):
        assert getattr(torc, name)(hmm.A, hmm.B, hmm.Pi, y, 8) == \
            getattr(jorc, name)(hmm.A, hmm.B, hmm.Pi, y, 8)
    for init in (None, 3):
        got, want = (m.beam_search(hmm.A, hmm.B, hmm.Pi, y, 8, initial_state=init)
                     for m in (torc, jorc))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, b = (m.build_adjacency(hmm.A, hmm.B, lazy=False) for m in (torc, jorc))
    assert a[1] == b[1] and a[2] == b[2] and a[3] == b[3]
    np.testing.assert_array_equal(a[0], b[0])
