"""SIEVE (dynamic median) and SIEVE-DAG against the JAX package, exactly:
the port's ``sieve`` and ``sieve_dag`` pairs on the CPU against JAX's
``sieve_dynamic_decode_many`` (its device engine, the whole tree as one
program, and its host level scheduler), against the copied float64 oracles
(``oracle.sieve.sieve_dynamic`` / ``sieve_dag``, themselves held to JAX's),
and against JAX's ``decode``: the fixtures of ``tests/test_tpu_algorithms.py``,
a dense graph whose counts all tie (a serial chain of right children, each
with a forced entry state), left children that inherit a forced entry,
T = 1 (the root's median is never set) and T = 2, padding, batches, lane
chunks and ``memory:``.  Tolerance 0: the pairs are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import sieve_dyn as jsd
from flash_viterbi_tpu.oracle import sieve as jorc
from flash_viterbi_tpu_torch.algorithms import sieve_dyn as tsd
from flash_viterbi_tpu_torch.models.generate import make_dag_hmm, observations
from flash_viterbi_tpu_torch.oracle import sieve as torc

torch.set_num_threads(2)

# (K, M, T, prob, seed, b_hops): test_tpu_algorithms.py's sieve fixtures, the
# default b, T = 1 and 2, and a dense graph (2 hops reach every state, so
# every count ties at K-1 and each median falls at the first step)
SPARSE = {"k48": (48, 8, 24, 0.25, 3, 4), "k64": (64, 12, 32, 0.3, 7, 5),
          "k32": (32, 6, 17, 0.4, 1, 3), "k64_default_b": (64, 12, 32, 0.3, 7, None),
          "t1": (40, 5, 1, 0.3, 2, None), "t2": (40, 5, 2, 0.3, 2, None),
          "chain": (40, 6, 20, 0.6, 4, None)}
# (K, M, T, seed): test_tpu_algorithms.py's sieve_dag fixtures and a wider one
DAG = {"k24": (24, 8, 16, 3), "k40": (40, 6, 20, 11), "k64": (64, 10, 32, 2)}


def _pairs(p) -> list:
    return [tuple(int(v) for v in q) for q in p]


def _jax_pairs(hmm, ys, engine="device", **kw):
    lh = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
    return [_pairs(p) for p in jsd.sieve_dynamic_decode_many(
        jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi), np.asarray(ys),
        engine=engine, **kw)]


def _port_pairs(hmm, ys, pad_to=1, stats=None, **kw):
    lh = hmm.log(device="cpu").padded(pad_to)
    return tsd.sieve_dynamic_decode_many(lh.logA, lh.logB, lh.logPi, np.asarray(ys),
                                         stats=stats, **kw)


def _sparse(name):
    K, M, T, prob, seed, b = SPARSE[name]
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    return hmm, y, b


def _dag(name):
    K, M, T, seed = DAG[name]
    return make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)


@pytest.mark.parametrize("name", list(SPARSE))
def test_sieve_matches_both_jax_engines_and_the_oracles(name):
    hmm, y, b = _sparse(name)
    got = _port_pairs(hmm, y[None], b_hops=b)[0]
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], engine, b_hops=b)[0], engine
    want = _pairs(torc.sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b))
    assert want == _pairs(jorc.sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b))
    assert got == want
    assert (len(got) == 0) == (len(y) == 1)


@pytest.mark.parametrize("name", list(DAG))
def test_sieve_dag_matches_both_jax_engines_and_the_oracles(name):
    hmm, y = _dag(name)
    got = _port_pairs(hmm, y[None], dag=True)[0]
    for engine in ("device", "host"):
        assert got == _jax_pairs(hmm, y[None], engine, dag=True)[0], engine
    want = _pairs(torc.sieve_dag(hmm.A, hmm.B, hmm.Pi, y))
    assert want == _pairs(jorc.sieve_dag(hmm.A, hmm.B, hmm.Pi, y))
    assert got == want and len(got) == len(y) - 1


def test_b_hop_counts_oracle_matches_jax_and_the_decoder_counts():
    """The copied float64 b-hop counts equal JAX's, and the counts the
    decoder takes (``sieve_bs._bhop_counts`` with its early exit)."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _bhop_counts

    hmm, _, _ = _sparse("k48")
    A_pos = hmm.A > 0
    for b in (1, 2, 5):
        anc, dec = torc._b_hop_counts(A_pos, b)
        janc, jdec = jorc._b_hop_counts(A_pos, b)
        np.testing.assert_array_equal(anc, janc)
        np.testing.assert_array_equal(dec, jdec)
        t_anc, t_dec, _ = _bhop_counts(torch.as_tensor(A_pos, dtype=torch.float32), b)
        np.testing.assert_array_equal(t_anc.numpy(), anc)
        np.testing.assert_array_equal(t_dec.numpy(), dec)


def test_chain_of_forced_right_children(monkeypatch):
    """The dense graph: every count ties, every median falls at the first
    step, and the tree is a serial chain of T-1 nodes a level each, every
    node after the root a right child forced to its parent's x_b."""
    hmm, y, _ = _sparse("chain")
    seen = []
    real_forward = tsd._level_forward

    def spy(*args):
        seen.append((args[7].tolist(), args[9].tolist()))  # init, last_forced
        return real_forward(*args)

    stats = {}
    monkeypatch.setattr(tsd, "_level_forward", spy)
    got = _port_pairs(hmm, y[None], stats=stats)[0]
    assert got == _jax_pairs(hmm, y[None])[0]
    assert stats["nodes"] == stats["levels"] == stats["forward_lanes"] == len(y) - 1
    assert stats["node_steps"] == sum(range(2, len(y) + 1))
    assert seen[0] == ([-1], [-1])
    for (init, last), (x_a, x_b) in zip(seen[1:], got):
        assert init == [x_b] and last == [-1]


def test_left_children_inherit_a_forced_entry(monkeypatch):
    """A right child's left child forces its end to its x_a and inherits the
    right child's forced entry: lanes with both forced appear, and the
    pairs still equal JAX's."""
    hmm, y = _dag("k40")
    seen = []
    real_forward = tsd._level_forward

    def spy(*args):
        seen.extend(zip(args[7].tolist(), args[9].tolist()))
        return real_forward(*args)

    monkeypatch.setattr(tsd, "_level_forward", spy)
    got = _port_pairs(hmm, y[None], dag=True)[0]
    assert any(init >= 0 and last >= 0 for init, last in seen)
    assert got == _jax_pairs(hmm, y[None], dag=True)[0]


@pytest.mark.parametrize("algorithm,name", [("sieve", "k48"), ("sieve", "t1"),
                                            ("sieve", "t2"), ("sieve_dag", "k24")])
def test_decode_matches_jax_decode_at_both_paddings(algorithm, name):
    hmm, y = _dag(name) if algorithm == "sieve_dag" else _sparse(name)[:2]
    jhmm = jfv.HMM(hmm.A, hmm.B, hmm.Pi)
    paths = []
    for pad_to in (1, 128):
        got = tfv.decode(hmm, y, algorithm, pad_to=pad_to, device="cpu", warmup=False)
        want = jfv.decode(jhmm, y, algorithm, pad_to=pad_to, warmup=False)
        np.testing.assert_array_equal(got.path, np.asarray(want.path))
        assert got.path.dtype == np.int32
        assert got.memory_bytes == want.memory_bytes
        assert all(n == 0 for n in got.extra["launches"].values())
        paths.append(got.path)
    np.testing.assert_array_equal(paths[0], paths[1])
    assert (paths[0] != -1).any() == (len(y) > 1)


@pytest.mark.parametrize("algorithm", ["sieve", "sieve_dag"])
def test_decode_batch_matches_one_at_a_time_and_jax(algorithm, monkeypatch):
    """Every sequence's tree in one level queue, the levels' lanes in chunks
    of one (a byte budget below one lane's table): the paths of decoding
    each sequence alone, and JAX's batch."""
    dag = algorithm == "sieve_dag"
    hmm, y = _dag("k24") if dag else _sparse("k48")[:2]
    ys = np.stack([y] + [observations(len(y), hmm.M, seed=s) for s in (5, 6)])
    whole = tfv.decode_batch(hmm, ys, algorithm, pad_to=1, device="cpu", warmup=False)
    lh = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
    want = jsd.sieve_dynamic_decode_many(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                                         jnp.asarray(lh.logPi), ys, dag=dag)
    for b in range(len(ys)):
        single = tfv.decode(hmm, ys[b], algorithm, pad_to=1, device="cpu", warmup=False)
        np.testing.assert_array_equal(whole.path[b], single.path)
        np.testing.assert_array_equal(whole.path[b], tsd._flatten_pairs(want[b], len(y)))
    assert whole.memory_bytes == 3 * single.memory_bytes
    monkeypatch.setattr(tsd, "DENSE_STEP_BYTES", 1)
    chunked = tfv.decode_batch(hmm, ys, algorithm, pad_to=128, device="cpu", warmup=False)
    np.testing.assert_array_equal(chunked.path, whole.path)


def test_uniform_prior_is_the_float64_table():
    """The subset-uniform prior is float32(log(1/k)) from float64, JAX's
    table, which an fp32 log need not equal in the last bit."""
    logu = tsd._log_uniform(4000)
    with np.errstate(divide="ignore"):
        want = np.log(1.0 / np.maximum(np.arange(4001), 1)).astype(np.float32)
    np.testing.assert_array_equal(logu, want)
    for k in (3, 7, 3965):
        assert logu[k] == np.float32(np.log(1.0 / k))


@pytest.mark.parametrize("algorithm,static", [("sieve", {}), ("sieve", {"b_hops": 3}),
                                              ("sieve_dag", {})])
@pytest.mark.parametrize("K,T", [(3965, 256), (4096, 64), (7, 1)])
def test_memory_equals_jax(algorithm, static, K, T):
    got = tfv.build(algorithm, **static)
    assert got.analytic_memory(K=K, T=T) == jfv.build(algorithm, **static).analytic_memory(
        K=K, T=T)
    assert got.static == dict(static, **({"b_hops": None} if algorithm == "sieve"
                                         and not static else {}))
