"""The port's bench harness and its I/O against the JAX package's: rows and
CSV of ``run_one`` / ``sweep`` for every ported decoder and ``auto``, the
parity witness above the oracle's cells, the reference text files and the
DAG generator."""

import csv
import filecmp
import os

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.bench import harness as jh
from flash_viterbi_tpu.models import generate as jgen
from flash_viterbi_tpu.utils import io as jio
from flash_viterbi_tpu_torch.bench import harness as th
from flash_viterbi_tpu_torch.models import generate as tgen
from flash_viterbi_tpu_torch.utils import io as tio

torch.set_num_threads(2)

SMALL = dict(K=48, M=8, T=40, prob=0.2, seed=3, device="cpu")
ROWS = [("vanilla", {}, None), ("flash", {}, None), ("flash", {"mode": "lean"}, None),
        ("flash", {"mode": "lean", "lean_leaf": 0}, None), ("checkpoint", {}, None),
        ("fused", {}, None), ("flash_bs", {}, 16), ("beam", {}, 16), ("auto", {}, None),
        ("auto", {}, 16), ("auto", {"memory_budget_bytes": 1}, None), ("sieve_mp", {}, None),
        ("sieve_mp", {"prune": False}, None), ("sieve_bs_mp", {}, 16)]


def _want_parity(extra: dict):
    """A row's parity on SMALL: True against its mirror, but an unpruned
    sieve_mp row (the mirror always prunes) against the port's CPU decode."""
    return "witness:cpu:True" if extra.get("prune") is False else True


def test_csv_fields_match_jax():
    assert th.CSV_FIELDS == jh.CSV_FIELDS and len(th.CSV_FIELDS) == 14
    port = {f.name: f.default for f in th.dataclasses.fields(th.RunConfig) if f.name != "extra"}
    jax = {f.name: f.default for f in jh.dataclasses.fields(jh.RunConfig) if f.name != "extra"}
    assert port == {**jax, "device": "cuda"}  # the port adds the device only


@pytest.mark.parametrize("alg,extra,bw", ROWS)
def test_run_one_rows(alg, extra, bw):
    row = th.run_one(th.RunConfig(algorithm=alg, beam_width=bw, extra=dict(extra), **SMALL))
    want = _want_parity(extra)
    assert (row["parity"], type(row["parity"])) == (want, type(want))
    assert set(th.CSV_FIELDS) <= set(row) and len(row["times"]) == th.TIMED_DECODES
    assert row["time"] == np.median(row["times"]) and row["time"] > 0
    assert row["device"] == "cpu" and row["pallas_fallback"] == ""
    assert row["updates_per_s"] == 48 * 48 * 40 / row["time"]
    # memory at the logical K, as the JAX harness reports it
    want = jfv.build(alg, **({"num_segments": 8} if alg in ("flash", "flash_bs", "auto")
                             else {}), **({"beam_width": bw} if bw else {}), **extra)
    assert row["memory"] == want.analytic_memory(K=48, T=40, K_padded=128)


def test_sweep_writes_one_header_per_file(tmp_path):
    cfgs = [th.RunConfig(algorithm=a, beam_width=bw, extra=dict(e), **SMALL) for a, e, bw in ROWS]
    rows = th.sweep(cfgs, csv_dir=str(tmp_path), verbose=False)
    assert [r["parity"] for r in rows] == [_want_parity(e) for _, e, _ in ROWS]
    # and once more: rows append under the one header
    th.sweep(cfgs[:2], csv_dir=str(tmp_path), verbose=False)
    for name in ("vanilla", "flash", "checkpoint", "fused", "flash_bs", "beam", "auto",
                 "sieve_mp", "sieve_bs_mp"):
        with open(tmp_path / f"{name}.csv") as f:
            lines = list(csv.reader(f))
        assert lines[0] == th.CSV_FIELDS
        assert sum(line == th.CSV_FIELDS for line in lines) == 1
        assert all(len(line) == 14 for line in lines)
    with open(tmp_path / "flash.csv") as f:
        assert len(f.readlines()) == 1 + 3 + 1  # header, 3 rows, 1 appended


def test_witness_above_the_oracle_cells(monkeypatch):
    """Rows above _ORACLE_MAX_CELLS name the port's device witness: fused
    (checkpoint for a fused row)."""
    monkeypatch.setattr(th, "_ORACLE_MAX_CELLS", 0)
    got = {(a, str(e)): th.run_one(th.RunConfig(algorithm=a, extra=dict(e), **SMALL))["parity"]
           for a, e, _ in ROWS[:6] + [ROWS[8]]}
    routed = th._routed(th.RunConfig(algorithm="auto", **SMALL), tfv.build("auto"), 128)[0]
    for (alg, _), verdict in got.items():
        ran = routed if alg == "auto" else alg
        witness = "checkpoint" if ran == "fused" else "fused"
        assert verdict == f"witness:{witness}:True", (alg, verdict)


@pytest.mark.parametrize("alg,extra,bw", ROWS[-3:])
def test_sieve_rows_take_the_cpu_witness_above_the_mirror(alg, extra, bw, monkeypatch):
    """Above _MIRROR_MAX_K a SIEVE row is held to the port's CPU decode of
    the same options; a wrong path says so."""
    monkeypatch.setattr(th, "_MIRROR_MAX_K", {alg: 8})
    cfg = th.RunConfig(algorithm=alg, beam_width=bw, extra=dict(extra), **SMALL)
    assert th.run_one(cfg)["parity"] == "witness:cpu:True"
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    static = {**extra, **({"beam_width": bw} if bw else {})}
    dec = tfv.build(alg, **static)
    lh = hmm.log(device="cpu").padded(128)
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))
    path = tfv.decode(hmm, y, alg, device="cpu", **static).path.copy()
    path[7] = (path[7] + 1) % 48
    assert th._parity(cfg, hmm, y, path, dec, tables) == "witness:cpu:False"


def test_unpruned_sieve_mp_is_not_held_to_the_pruned_oracle(monkeypatch):
    """Below the mirror's K an unpruned sieve_mp row still takes the CPU
    witness (the copied oracle prunes), and a wrong path reads False."""
    from flash_viterbi_tpu_torch.oracle import sieve as osieve

    def pruned(*a, **k):
        raise AssertionError("the pruned oracle judged an unpruned row")

    monkeypatch.setattr(osieve, "sieve_mp", pruned)
    cfg = th.RunConfig(algorithm="sieve_mp", extra={"prune": False}, **SMALL)
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    dec = tfv.build("sieve_mp", prune=False)
    lh = hmm.log(device="cpu").padded(128)
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))
    path = tfv.decode(hmm, y, "sieve_mp", prune=False, device="cpu").path.copy()
    assert th._parity(cfg, hmm, y, path, dec, tables) == "witness:cpu:True"
    path[3] = (path[3] + 1) % 48
    assert th._parity(cfg, hmm, y, path, dec, tables) == "witness:cpu:False"


def test_parity_catches_a_wrong_path():
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    cfg = th.RunConfig(algorithm="fused", **SMALL)
    dec = tfv.build("fused")
    lh = hmm.log(device="cpu")
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))
    path = tfv.decode(hmm, y, "fused", device="cpu").path.copy()
    assert th._parity(cfg, hmm, y, path, dec, tables) is True
    path[5] = (path[5] + 1) % 48
    assert th._parity(cfg, hmm, y, path, dec, tables) is False


def test_unported_algorithm_raises():
    with pytest.raises(KeyError):
        th.run_one(th.RunConfig(algorithm="sieve", **SMALL))


@pytest.mark.parametrize("mirror_k,bw", [(512, 16), (512, 8), (8, 16)])
def test_sieve_bs_rows(mirror_k, bw, monkeypatch):
    """A sieve_bs row on SMALL (a uniform Pi) is held to the float64
    oracle (at B=16; at B=8 the oracle is undefined, a beam prunes every
    median candidate, and the row takes the fp32 mirror), above
    _MIRROR_MAX_K to the port's CPU decode; a wrong path says so."""
    from flash_viterbi_tpu_torch.oracle import sieve_bs as osbs

    monkeypatch.setattr(th, "_MIRROR_MAX_K", {"sieve_bs": mirror_k})
    cfg = th.RunConfig(algorithm="sieve_bs", beam_width=bw, **SMALL)
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    if bw == 8:
        with pytest.raises(osbs.ReferenceUndefined):
            osbs.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    row = th.run_one(cfg)
    want = True if mirror_k == 512 else "witness:cpu:True"
    assert (row["parity"], type(row["parity"])) == (want, type(want))
    assert row["memory"] == jfv.build("sieve_bs", beam_width=bw).analytic_memory(K=48, T=40)
    dec = tfv.build("sieve_bs", beam_width=bw)
    lh = hmm.log(device="cpu").padded(128)
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))
    path = tfv.decode(hmm, y, "sieve_bs", beam_width=bw, device="cpu").path.copy()
    path[7] = (path[7] + 1) % 48
    assert th._parity(cfg, hmm, y, path, dec, tables) in (False, "witness:cpu:False")


def test_sieve_bs_row_with_a_nonuniform_pi_takes_the_framework_mirror(monkeypatch):
    """The float64 oracle threads a uniform root Pi: a non-uniform Pi is
    held to the fp32 framework mirror instead."""
    from flash_viterbi_tpu_torch.oracle import sieve_bs as osbs

    def uniform_only(*a, **k):
        raise AssertionError("the uniform-Pi oracle judged a non-uniform Pi")

    monkeypatch.setattr(osbs, "sieve_bs", uniform_only)
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    pi = np.random.RandomState(9).uniform(0.05, 1.0, 48)
    hmm = tfv.HMM(hmm.A, hmm.B, pi / pi.sum())
    cfg = th.RunConfig(algorithm="sieve_bs", beam_width=8, **SMALL)
    dec = tfv.build("sieve_bs", beam_width=8)
    lh = hmm.log(device="cpu").padded(128)
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))
    path = tfv.decode(hmm, y, "sieve_bs", beam_width=8, device="cpu").path
    assert th._parity(cfg, hmm, y, path, dec, tables) is True


def test_save_dataset_bytes_match_jax(tmp_path):
    hmm, y = tgen.make_sparse_hmm(K=30, M=6, T=25, prob=0.3, seed=7)
    port = tio.save_dataset(str(tmp_path / "port"), hmm, y, prob=0.3)
    jax = jio.save_dataset(str(tmp_path / "jax"), jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, prob=0.3)
    assert [os.path.basename(p) for p in port.values()] == [
        os.path.basename(p) for p in jax.values()]
    for name in port:
        assert filecmp.cmp(port[name], jax[name], shallow=False), name
    for as_float32 in (False, True):
        h2, y2 = tio.load_dataset(str(tmp_path / "port"), 30, 25, 6, prob=0.3,
                                  as_float32=as_float32)
        hj, yj = jio.load_dataset(str(tmp_path / "jax"), 30, 25, 6, prob=0.3,
                                  as_float32=as_float32)
        np.testing.assert_array_equal(y2, yj)
        for a, b in ((h2.A, hj.A), (h2.B, hj.B), (h2.Pi, hj.Pi)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(y2, y)
    assert tio.prob_str(0.112) == jio.prob_str(0.112) == "0.112"
    assert tio.dataset_paths("d", 8, 9, dag=True) == jio.dataset_paths("d", 8, 9, dag=True)


def test_run_one_from_saved_dataset(tmp_path):
    hmm, y = tgen.make_sparse_hmm(K=40, M=8, T=30, prob=0.25, seed=2)
    tio.save_dataset(str(tmp_path), hmm, y, prob=0.25)
    cfg = th.RunConfig(algorithm="flash", K=40, M=8, T=30, prob=0.25, device="cpu",
                       data_path=str(tmp_path))
    assert th.run_one(cfg)["parity"] is True


@pytest.mark.parametrize("sanitize", [True, False])
def test_make_dag_hmm_matches_jax(sanitize):
    t_hmm, t_y = tgen.make_dag_hmm(K=20, M=5, T=12, seed=4, sanitize=sanitize)
    j_hmm, j_y = jgen.make_dag_hmm(K=20, M=5, T=12, seed=4, sanitize=sanitize)
    np.testing.assert_array_equal(t_y, j_y)
    for a, b in ((t_hmm.A, j_hmm.A), (t_hmm.B, j_hmm.B), (t_hmm.Pi, j_hmm.Pi)):
        np.testing.assert_array_equal(a, b)


def test_dag_rows():
    cfg = th.RunConfig(algorithm="fused", K=32, M=6, T=20, dag=True, device="cpu")
    assert th.run_one(cfg)["parity"] is True
