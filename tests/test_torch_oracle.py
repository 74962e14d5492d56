"""The port's copies of the JAX package's last oracles against the JAX
package's own, exactly: the C programs' numpy mirrors (``vanilla``,
``checkpoint``, ``flash`` and ``flash_bs`` with its min-heap, state by state),
the beam family's f64 validators, the score-only forward scan and the native
oracle's ``available()``; ``tests/test_oracle.py``'s properties on the
port's mirrors; and ``scripts/torch_sieve_bs_witness.py`` at a cut config
against JAX's ``sieve_bs`` decode and its fp32 mirror.  Tolerance 0
throughout: paths and heap slots are compared as integers and bits, scores as
float64 bits."""

import hashlib
import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
from flash_viterbi_tpu.models.generate import make_sparse_hmm as jax_make_sparse_hmm
from flash_viterbi_tpu.ops import maxplus as jmp
from flash_viterbi_tpu.oracle import framework as jfw
from flash_viterbi_tpu.oracle import reference as jref
from flash_viterbi_tpu.oracle import validate as jval
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
from flash_viterbi_tpu_torch.ops import maxplus as tmp
from flash_viterbi_tpu_torch.oracle import native as tnative
from flash_viterbi_tpu_torch.oracle import reference as tref
from flash_viterbi_tpu_torch.oracle import validate as tval
from scripts import torch_sieve_bs_witness as witness

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)
NUMERICS = ("c", "f32")
THREADS = (1, 2, 4, 7)
# the mirrors' fixture: sparse enough that beams of 4 lose the path (-1)
K, M, T, PROB = 24, 6, 32, 0.3


def _problem(seed):
    hmm, y = jax_make_sparse_hmm(K=K, M=M, T=T, prob=PROB, seed=seed)
    return np.asarray(hmm.A), np.asarray(hmm.B), np.asarray(hmm.Pi), np.asarray(y)


def _same_path(got, want):
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("seed", SEEDS)
def test_vanilla_equals_jax(seed, numerics):
    args = _problem(seed)
    _same_path(tref.vanilla(*args, numerics=numerics), jref.vanilla(*args, numerics=numerics))


@pytest.mark.parametrize("step", (0, 3, 7))
@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("seed", SEEDS)
def test_checkpoint_equals_jax(seed, numerics, step):
    args = _problem(seed)
    _same_path(tref.checkpoint(*args, step=step, numerics=numerics),
               jref.checkpoint(*args, step=step, numerics=numerics))


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("seed", SEEDS)
def test_flash_equals_jax(seed, numerics, threads):
    args = _problem(seed)
    _same_path(tref.flash(*args, threads=threads, numerics=numerics),
               jref.flash(*args, threads=threads, numerics=numerics))


@pytest.mark.parametrize("beam", (4, 16, K))
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("seed", SEEDS)
def test_flash_bs_equals_jax(seed, numerics, threads, beam):
    args = _problem(seed)
    _same_path(tref.flash_bs(*args, beam_width=beam, threads=threads, numerics=numerics),
               jref.flash_bs(*args, beam_width=beam, threads=threads, numerics=numerics))


def test_flash_bs_fixtures_reach_the_sentinel():
    """The fixture exercises ``Find_T3_State``'s -1 (quirk (c)'s fallout)."""
    assert any((tref.flash_bs(*_problem(s), beam_width=4, threads=4) == -1).any() for s in SEEDS)


def _heap_state(h):
    return h.val.tobytes(), h.state.tolist(), h.t3.tolist(), h.count


@pytest.mark.parametrize("seed", range(6))
def test_heap_equals_jax_state_by_state(seed):
    """Random offer sequences (ties, -inf, -FLT_MAX, t3 of -1) through both
    heaps: equal slots, count, ``find_t3`` and ``leaf_argmax`` after every
    offer, at beams from 1 to 16."""
    rng = np.random.RandomState(seed)
    for B in (1, 2, 3, 5, 8, 16):
        n = B + int(rng.randint(0, 3 * B + 1))
        vals = np.round(rng.uniform(-6, 0, n) * rng.choice([1, 4], n)).astype(np.float32)
        vals[rng.rand(n) < 0.15] = -np.inf
        vals[rng.rand(n) < 0.05] = tref.NEG32
        t3 = rng.randint(-1, n, n)
        th, jh = tref._Heap(B), jref._Heap(B)
        for i in range(n):
            th.offer(vals[i], i, int(t3[i]))
            jh.offer(vals[i], i, int(t3[i]))
            assert _heap_state(th) == _heap_state(jh), (B, i)
            assert th.leaf_argmax() == jh.leaf_argmax(), (B, i)
            for s in (0, i, i + 1, int(rng.randint(0, n))):
                assert th.find_t3(s) == jh.find_t3(s), (B, i, s)
    assert tref.NEG32.tobytes() == jref.NEG32.tobytes()


@pytest.fixture(scope="module")
def beam_fixture():
    """``test_validate.py``'s K=64, seed=7 fixture and its sieve_bs path
    (2 junction breaks), decoded by the port on the CPU."""
    hmm, y = make_sparse_hmm(K=64, M=8, T=32, prob=0.2, seed=7)
    from flash_viterbi_tpu_torch import decode

    path = np.asarray(decode(hmm, y, "sieve_bs", beam_width=16, device="cpu",
                             warmup=False).path)[:32].astype(np.int64)
    return hmm, y, path


def _variant(case, hmm, y, path):
    B, p = np.asarray(hmm.B).copy(), path.copy()
    if case == "sentinel":
        p[5] = -1
    elif case == "out_of_range":
        p[3] = 64
    elif case == "zero_emission":
        B[p[4], y[4]] = 0.0
    elif case == "all_sentinels":
        p[:] = -1
    return B, p


@pytest.mark.parametrize("case", ("decoded", "sentinel", "out_of_range", "zero_emission",
                                  "all_sentinels"))
def test_beam_validators_equal_jax(beam_fixture, case):
    hmm, y, path = beam_fixture
    B, p = _variant(case, hmm, y, path)
    args = (hmm.A, B, hmm.Pi, y, p)
    if case != "out_of_range":
        got, want = tval.beam_family_score_f64(*args), jval.beam_family_score_f64(*args)
        assert np.float64(got[0]).tobytes() == np.float64(want[0]).tobytes() and got == want
        assert np.isfinite(got[0])
    label = tval.beam_path_invariants(*args)
    assert label == jval.beam_path_invariants(*args)
    if case == "decoded":
        assert label.startswith("invariants-ok:score=") and label.endswith("junction_breaks=2")
    elif case == "out_of_range":
        assert label == "invariants-VIOLATED"
    elif case == "all_sentinels":
        assert label == "invariants-ok:score=0.000,junction_breaks=0"


def test_forward_scan_noptr_equals_jax():
    rng = np.random.RandomState(3)
    Kf, Tm = 40, 12
    with np.errstate(divide="ignore"):
        logA = np.log(rng.uniform(0, 1, (Kf, Kf)) * (rng.rand(Kf, Kf) < 0.5)).astype(np.float32)
    emits = np.log(rng.uniform(0.01, 1, (Tm, Kf))).astype(np.float32)
    delta0 = np.log(rng.uniform(0.01, 1, Kf)).astype(np.float32)
    want = np.asarray(jmp.forward_scan_noptr(jnp.asarray(delta0), jnp.asarray(logA),
                                             jnp.asarray(emits)))
    got = tmp.forward_scan_noptr(torch.from_numpy(delta0), torch.from_numpy(logA),
                                 torch.from_numpy(emits)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_native_available_is_a_bool():
    assert isinstance(tnative.available(), bool)


# tests/test_oracle.py's properties, on the port's mirrors

def _brute_force(A, B, Pi, y):
    """Exhaustive max over all K^T paths, fp64 scores, lowest lexicographic
    path on ties."""
    with np.errstate(divide="ignore"):
        lA, lB, lPi = (np.log(x) for x in (A, B, Pi))
    best, best_path = -np.inf, None
    for path in itertools.product(range(A.shape[0]), repeat=len(y)):
        s = lPi[path[0]] + lB[path[0], y[0]]
        for t in range(1, len(y)):
            s += lA[path[t - 1], path[t]] + lB[path[t], y[t]]
        if s > best:
            best, best_path = s, path
    return np.array(best_path)


@pytest.mark.parametrize("seed", SEEDS)
def test_vanilla_matches_brute_force(seed):
    rng = np.random.RandomState(seed)
    A = rng.uniform(0.1, 1.0, (5, 5))
    A /= A.sum(1, keepdims=True)
    B = rng.uniform(0.1, 1.0, (5, 4))
    B /= B.sum(1, keepdims=True)
    Pi = np.full(5, 1.0 / 5)
    y = rng.randint(0, 4, 6)
    np.testing.assert_array_equal(tref.vanilla(A, B, Pi, y, numerics="c"),
                                  _brute_force(A, B, Pi, y))


@pytest.fixture(scope="module")
def small():
    hmm, y = make_sparse_hmm(K=64, M=12, T=32, prob=0.3, seed=7)
    return hmm.A, hmm.B, hmm.Pi, y


@pytest.mark.parametrize("numerics", NUMERICS)
def test_checkpoint_equals_vanilla(small, numerics):
    np.testing.assert_array_equal(tref.checkpoint(*small, numerics=numerics),
                                  tref.vanilla(*small, numerics=numerics))


def test_flash_bs_full_beam_reasonable(small):
    """B=K loses nothing; the leaf-scan final argmax (quirk (a)) may pick
    another final state, so the path's score and its bulk are compared."""
    A, B, Pi, y = small
    v = tref.vanilla(*small, numerics="c")
    f = tref.flash_bs(*small, beam_width=A.shape[0], threads=1, numerics="c")
    with np.errstate(divide="ignore"):
        lA, lB, lPi = (np.log(x) for x in (A, B, Pi))

    def ll(p):
        return lPi[p[0]] + lB[p[0], y[0]] + sum(lA[p[t - 1], p[t]] + lB[p[t], y[t]]
                                                for t in range(1, len(y)))

    assert ll(f) <= ll(v) + 1e-6
    assert (v[:-1] == f[:-1]).mean() > 0.9


@pytest.mark.parametrize("threads", (1, 4))
def test_flash_bs_runs_and_beam_grows_monotone(small, threads):
    p16 = tref.flash_bs(*small, beam_width=16, threads=threads)
    p32 = tref.flash_bs(*small, beam_width=32, threads=threads)
    assert p16.shape == p32.shape == small[3].shape


# the witness script

def test_witness_script_cut_run_equals_jax():
    """``--device cpu --K 96 --T 48``: the script's path (by its SHA-256)
    equals JAX's ``sieve_bs`` decode and JAX's fp32 mirror, its f64 figures
    equal JAX's validator on that path, and it exits 0."""
    Kc, Tc = 96, 48
    proc = subprocess.run([sys.executable, "scripts/torch_sieve_bs_witness.py", "--device", "cpu",
                           "--K", str(Kc), "--T", str(Tc)], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "cpu (the plain versions)"
    steps = {r["step"]: r for r in map(json.loads, lines[1:])}
    assert list(steps) == ["fixture", "device_decode", "device_score_f64", "fp32_mirror",
                           "c_binary", "DONE"]
    hmm, y = jax_make_sparse_hmm(**dict(witness.CONFIG, K=Kc, T=Tc))
    want = np.asarray(jfv.decode(hmm, y, algorithm="sieve_bs", beam_width=witness.BEAM_WIDTH,
                                 warmup=False).path)[:Tc]
    pairs = jfw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=witness.BEAM_WIDTH)
    flat = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])[:Tc]
    np.testing.assert_array_equal(want, flat)
    sha = hashlib.sha256(want.astype(np.int32).tobytes()).hexdigest()
    assert steps["device_decode"]["path_sha256"] == sha
    assert steps["device_decode"]["sentinels"] == int((want < 0).sum())
    score, breaks = jval.beam_family_score_f64(hmm.A, hmm.B, hmm.Pi, y, want)
    assert (steps["device_score_f64"]["score"], steps["device_score_f64"]["junction_breaks"]) \
        == (score, breaks)
    assert steps["fp32_mirror"]["bit_equal"] and steps["fp32_mirror"]["mismatches"] == 0


def test_witness_record_comparison():
    """The JAX record's own figures compare equal; a score one ulp off, a
    sentinel more or a bool for an int do not."""
    record = witness.jax_record()
    assert record["device_score_f64"]["score"] == -2198.207742012938
    steps = [dict(record[s]) for s in witness.COMPARED]
    assert witness.differences(steps, record) == []
    steps[2]["score"] = float(np.nextafter(steps[2]["score"], 0.0))
    steps[1]["sentinels"] += 1
    steps[3]["mismatches"] = False
    assert len(witness.differences(steps, record)) == 3
