"""Randomized checks of the port's SIEVE decoders on the CPU: the SIEVE
functions of ``tests/test_fuzz.py``, on its seeds.  ``sieve_bs``,
``sieve_bs_mp`` and ``sieve`` must give the pairs and paths of the oracles
(``oracle.framework``, ``oracle.sieve``, ``oracle.sieve_bs``) and of the
JAX package's decoders and mirrors."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.oracle import framework as jofw
from flash_viterbi_tpu_torch.oracle import framework as ofw

torch.set_num_threads(2)

DYN_SEEDS = [301, 302, 303, 304, 305, 306]


def _jax(hmm):
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _quiet_hmm(K, M, T, prob, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # NaN rows (no out-edge) are intentional
        return tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)


def _tables(hmm):
    lh = hmm.log(device="cpu")
    return lh.logA, lh.logB, lh.logPi


def _jtables(hmm):
    lh = _jax(hmm).log()
    return jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi)


@pytest.mark.parametrize("seed", DYN_SEEDS)
def test_dynamic_median_family_fuzz(seed):
    """``sieve_bs`` against the float64 oracle (or, where the reference is
    undefined, total) and JAX's decoder; ``sieve_bs_mp`` against the fp32
    mirror and JAX's decode."""
    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode as jax_bs

    from flash_viterbi_tpu_torch.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu_torch.oracle.sieve_bs import ReferenceUndefined
    from flash_viterbi_tpu_torch.oracle.sieve_bs import sieve_bs as oracle_bs

    rng = np.random.RandomState(seed)
    K = int(rng.randint(16, 96))
    M = int(rng.randint(2, 14))
    T = int(rng.randint(5, 48))
    prob = float(rng.uniform(0.15, 0.6))
    bw = int(rng.randint(2, max(3, K // 3)))
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    got = sieve_bs_decode(*_tables(hmm), np.asarray(y), beam_width=bw)
    assert got == [tuple(p) for p in jax_bs(*_jtables(hmm), np.asarray(y), beam_width=bw)]
    try:
        want = [tuple(int(v) for v in p)
                for p in oracle_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
    except ReferenceUndefined:
        # the reference crashes here (the beam pruned every median
        # candidate); the decoder must still be total
        assert len(got) >= 1 and all(len(p) == 2 for p in got)
    else:
        assert got == want, f"sieve_bs K={K} M={M} T={T} prob={prob:.2f} bw={bw}"
    wantp = ofw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    r = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=bw, pad_to=1, warmup=False, device="cpu")
    np.testing.assert_array_equal(r.path, wantp, err_msg=f"sieve_bs_mp K={K} T={T} bw={bw}")
    np.testing.assert_array_equal(
        r.path, jfv.decode(_jax(hmm), y, "sieve_bs_mp", beam_width=bw, pad_to=1,
                           warmup=False).path)


@pytest.mark.parametrize("seed", DYN_SEEDS[:3])
def test_sieve_dynamic_fuzz(seed):
    """``sieve`` (dynamic median, full state space) against its float64
    oracle and JAX's decoder: median pairs exactly."""
    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode as jax_dyn

    from flash_viterbi_tpu_torch.algorithms.sieve_dyn import sieve_dynamic_decode
    from flash_viterbi_tpu_torch.oracle.sieve import sieve_dynamic

    rng = np.random.RandomState(seed + 50)
    K = int(rng.randint(16, 80))
    M = int(rng.randint(2, 10))
    T = int(rng.randint(5, 40))
    prob = float(rng.uniform(0.2, 0.6))
    b = int(rng.randint(1, 4))
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed + 50)
    want = [tuple(int(v) for v in p) for p in sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b)]
    got = sieve_dynamic_decode(*_tables(hmm), np.asarray(y), b_hops=b)
    assert got == want, f"sieve K={K} M={M} T={T} b={b}"
    assert got == [tuple(p) for p in jax_dyn(*_jtables(hmm), np.asarray(y), b_hops=b)]


@pytest.mark.parametrize("seed_base", [600, 640])
def test_sieve_bs_mp_mirror_fuzz(seed_base):
    """``sieve_bs_mp`` bit-exact with the fp32 mirror (the port's copy and
    the JAX package's) on every fixture, NaN-row models and permuted-path
    ties included; every fifth fixture also against JAX's decode."""
    for seed in range(seed_base, seed_base + 25):
        rng = np.random.RandomState(seed)
        K = int(rng.randint(16, 28))
        M = int(rng.randint(3, 8))
        T = int(rng.randint(6, 24))
        prob = float(rng.uniform(0.1, 0.25))
        bw = int(rng.randint(2, 6))
        hmm, y = _quiet_hmm(K, M, T, prob, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = ofw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
            np.testing.assert_array_equal(
                want, jofw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw))
            r = tfv.decode(hmm, y, "sieve_bs_mp", beam_width=bw, pad_to=1, warmup=False,
                           device="cpu")
            np.testing.assert_array_equal(r.path, want,
                                          err_msg=f"seed={seed} K={K} M={M} T={T} bw={bw}")
            if seed % 5 == 0:
                np.testing.assert_array_equal(
                    r.path, jfv.decode(_jax(hmm), y, "sieve_bs_mp", beam_width=bw, pad_to=1,
                                       warmup=False).path)


def test_sieve_bs_padding_invariance():
    """The uniform prior uses the logical K: decodes at pad_to=1 and 128
    agree with each other and with the mirror at the logical K, tie-heavy
    fixtures included."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs

    for K, M, T, prob, seed in [(24, 3, 9, 0.6, 101), (100, 2, 40, 0.15, 31),
                                (17, 2, 16, 0.7, 108)]:
        hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        bw = max(2, K // 3)
        a = tfv.decode(hmm, y, "sieve_bs", beam_width=bw, pad_to=1, warmup=False, device="cpu")
        b = tfv.decode(hmm, y, "sieve_bs", beam_width=bw, pad_to=128, warmup=False,
                       device="cpu")
        np.testing.assert_array_equal(a.path, b.path, err_msg=f"K={K} seed={seed}")
        pairs = ofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        assert pairs == jofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        if pairs:
            np.testing.assert_array_equal(b.path, _flatten_pairs(pairs, T),
                                          err_msg=f"K={K} seed={seed}")


@pytest.mark.parametrize("seed_base", [700, 730])
def test_sieve_bs_mirror_fuzz(seed_base):
    """``sieve_bs`` against its fp32 mirror (the port's and the JAX
    package's): median pairs exactly on arbitrary fixtures, NaN rows and
    beam-exhausted inputs included."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import sieve_bs_decode

    for seed in range(seed_base, seed_base + 15):
        rng = np.random.RandomState(seed)
        K = int(rng.randint(16, 40))
        M = int(rng.randint(3, 8))
        T = int(rng.randint(4, 20))
        prob = float(rng.uniform(0.1, 0.3))
        bw = int(rng.randint(2, 7))
        hmm, y = _quiet_hmm(K, M, T, prob, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = sieve_bs_decode(*_tables(hmm), np.asarray(y), beam_width=bw)
            want = [tuple(int(v) for v in p)
                    for p in ofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
            assert want == [tuple(int(v) for v in p)
                            for p in jofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
        assert got == want, f"seed={seed} K={K} M={M} T={T} bw={bw}"
