"""``scripts/torch_config5.py`` (config-5 at its specified scale, the port's
counterpart of ``scripts/config5_full.py``) on the CPU at small shapes: its
sequences are the JAX script's, its f64 scores equal, bit for bit, those of
JAX's ``flash_decode_long_batched`` and ``log_path_score_f64`` on the same
problem, a rerun resumes, ``--against`` holds a record bit for bit, and the
JAX package's records are never written.  Tolerance 0 throughout."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.algorithms import longform as jlong
from flash_viterbi_tpu.models.generate import make_sparse_hmm as jax_make_sparse_hmm
from flash_viterbi_tpu.oracle import validate as jval
from flash_viterbi_tpu_torch.oracle import validate as tval
from scripts import config5_full
from scripts import torch_config5 as c5

torch.set_num_threads(2)

K, T, LIMIT, BATCH = 64, 512, 8, 4
CUT = ["--device", "cpu", "--K", str(K), "--T", str(T)]


def run(argv):
    """(exit code, the lines the script logged)."""
    lines = []
    return c5.main(argv, log=lines.append), lines


def scores_of(path):
    return {b: s for b, (s, _, _) in c5.read_record(str(path), 1).items()}


def jax_scores(segments, n=LIMIT):
    """JAX's batched pipeline and f64 score on the JAX generator's tables and
    the JAX script's sequences, cut to K and T."""
    hmm, y0 = jax_make_sparse_hmm(K=K, M=c5.M, T=c5.T_SPEC, prob=c5.PROB, seed=c5.SEED)
    lh = hmm.log()
    ys = config5_full.make_ys(y0, n)[:, :T]
    tables = tuple(jnp.asarray(t) for t in (lh.logA, lh.logB, lh.logPi))
    out = []
    for b0 in range(0, n, BATCH):
        paths = jlong.flash_decode_long_batched(*tables, ys[b0:b0 + BATCH], num_segments=segments)
        out += [jval.log_path_score_f64(lh.logA, lh.logB, lh.logPi, ys[b], paths[b - b0])
                for b in range(b0, min(b0 + BATCH, n))]
    return out


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A full cut run at 1 segment: its score file and its last line."""
    out = tmp_path_factory.mktemp("c5") / "scores.jsonl"
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", str(LIMIT), "--segments", "1",
                           "--out", str(out)])
    assert rc == 0, lines
    return out, json.loads(lines[-1])


def write_record(path, scores, segments=1):
    """A record in ``config5_full.py``'s format (no path hashes)."""
    with open(path, "w") as f:
        for b0 in range(0, len(scores), BATCH):
            f.write(json.dumps({"b0": b0, "b1": b0 + BATCH, "segments": segments,
                                "batch": BATCH, "wall_s": 1.0,
                                "scores": scores[b0:b0 + BATCH]}) + "\n")


def test_make_ys_is_the_jax_scripts():
    y0 = (np.arange(c5.T_SPEC) * 7919 % c5.M).astype(np.int32)
    got, want = c5.make_ys(y0, 5), config5_full.make_ys(y0, 5)
    assert got.dtype == want.dtype and got.shape == (5, c5.T_SPEC)
    np.testing.assert_array_equal(got, want)
    # a cut run's sequences are prefixes of the full ones
    np.testing.assert_array_equal(c5.make_ys(y0[:100], 5), want[:, :100])


@pytest.mark.parametrize("segments", [1, 4])
def test_full_scores_equal_jax_bit_for_bit(segments, tmp_path):
    out = tmp_path / "scores.jsonl"
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", str(LIMIT), "--segments",
                           str(segments), "--out", str(out)])
    assert rc == 0 and "CONFIG5-FULL OK" in lines, lines
    got = {b: s for b, (s, _, _) in c5.read_record(str(out), segments).items()}
    want = jax_scores(segments)
    assert [got[b] for b in range(LIMIT)] == want
    summary = json.loads(lines[-1])
    assert summary["config"] == f"{LIMIT}xK{K}xT{T}" and summary["cut"]
    assert summary["gates"] == {"finite": True, "cross_pipeline": True,
                                "cross_segmentation": True}
    assert summary["all_finite"] and summary["against"] is None
    lines_of = [json.loads(x) for x in open(out)]
    assert [(r["b0"], r["b1"], r["segments"], r["batch"]) for r in lines_of] == [
        (0, 4, segments, 4), (4, 8, segments, 4)]
    assert all(len(r["path_sha256"]) == 4 and r["card"] == "cpu" for r in lines_of)


def test_resume_decodes_only_the_new_batch(tmp_path, monkeypatch, recorded):
    calls = []
    batched = c5.longform.flash_decode_long_batched

    def spy(logA, logB, logPi, ys, **kw):
        calls.append(ys.numpy().copy())
        return batched(logA, logB, logPi, ys, **kw)

    monkeypatch.setattr(c5.longform, "flash_decode_long_batched", spy)
    out = tmp_path / "scores.jsonl"
    argv = CUT + ["--full", str(BATCH), "--segments", "1", "--out", str(out)]
    assert run(argv + ["--limit", "4"])[0] == 0
    calls.clear()
    rc, lines = run(argv + ["--limit", "8"])
    assert rc == 0, lines
    decodes = [ys for ys in calls if ys.shape[1] == T]  # not the warm-up's
    ys = c5.make_ys(c5.Problem.make(K, T, "cpu", log=lambda s: None).y0, LIMIT)
    assert len(decodes) == 1 and np.array_equal(decodes[0], ys[4:8])
    assert json.loads(lines[-1])["decoded_batches"] == 1
    assert scores_of(out) == scores_of(recorded[0])


def test_against_an_equal_record_passes(tmp_path, recorded):
    out, _ = recorded
    scores = [scores_of(out)[b] for b in range(LIMIT)]
    write_record(tmp_path / "record.jsonl", scores)
    work = tmp_path / "scores.jsonl"
    work.write_bytes(out.read_bytes())  # resumed: every sequence recorded
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", str(LIMIT), "--segments", "1",
                           "--out", str(work), "--against", str(tmp_path / "record.jsonl")])
    assert rc == 0, lines
    summary = json.loads(lines[-1])
    assert summary["decoded_batches"] == 0
    assert summary["gates"]["against"] is True
    assert (summary["against"]["compared"], summary["against"]["equal"],
            summary["against"]["differ"]) == (LIMIT, LIMIT, [])


def test_against_a_score_one_ulp_off_fails_and_names_it(tmp_path, recorded):
    out, _ = recorded
    scores = [scores_of(out)[b] for b in range(LIMIT)]
    scores[5] = float(np.nextafter(scores[5], -np.inf))
    write_record(tmp_path / "record.jsonl", scores)
    work = tmp_path / "scores.jsonl"
    work.write_bytes(out.read_bytes())
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", str(LIMIT), "--segments", "1",
                           "--out", str(work), "--against", str(tmp_path / "record.jsonl")])
    assert rc == 2
    assert "CONFIG5-FULL VALIDATION FAILED: against: sequences [5]" in lines
    differs = [json.loads(x) for x in lines if x.startswith('{"against_differs"')]
    assert [d["against_differs"] for d in differs] == [5]
    assert differs[0]["record"] == scores[5] and differs[0]["gap"] != 0
    summary = json.loads(lines[-1])
    assert summary["gates"]["against"] is False
    assert summary["against"]["differ"] == [5] and summary["against"]["equal"] == LIMIT - 1


def test_against_a_record_at_other_segments_is_an_error(tmp_path, recorded):
    write_record(tmp_path / "record.jsonl", [-1.0] * LIMIT, segments=4)
    out = tmp_path / "scores.jsonl"
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", str(LIMIT), "--segments", "1",
                           "--out", str(out), "--against", str(tmp_path / "record.jsonl")])
    assert rc == 2 and lines[-1].startswith("error: ") and "segments=1" in lines[-1]
    assert not out.exists()  # refused before any decode


def _digests():
    return [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in c5.JAX_RECORDS]


@pytest.mark.parametrize("name", ["config5_scores.jsonl", "config5_scores_r4.jsonl"])
def test_refuses_to_write_the_jax_records(name, monkeypatch):
    before = _digests()
    rel = os.path.join("results", name)
    monkeypatch.chdir(c5.ROOT)
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", "4", "--out", rel])
    assert rc == 2 and "refusing" in lines[-1]
    prob = c5.Problem.make(K, 16, "cpu", log=lambda s: None)
    with pytest.raises(ValueError, match="refusing"):
        c5.decode_all(prob, 2, 2, 1, 4096, os.path.join(c5.ROOT, rel), log=lambda s: None)
    # a cut run is not compared with the JAX record
    rc, lines = run(CUT + ["--full", str(BATCH), "--limit", "4", "--segments", "1",
                           "--out", os.devnull, "--against", rel])
    assert rc == 2 and "no JAX record" in lines[-1]
    assert _digests() == before


def test_jax_records_hold_256_equal_scores():
    """The two JAX runs: 256 scores each at one segment, equal bit for bit
    (the witness the card's run is held to)."""
    a, b = (c5.read_record(p, 1) for p in c5.JAX_RECORDS)
    assert sorted(a) == list(range(c5.N_SEQS)) == sorted(b)
    assert all(a[s][0] == b[s][0] and np.isfinite(a[s][0]) for s in a)
    assert c5.read_record(c5.JAX_RECORDS[0], 4) == {}


def test_the_cards_recorded_run_equals_the_jax_record():
    """The committed full run on the card: 256 sequences at one segment,
    each f64 score the JAX record's bit for bit, each with its path hash;
    its log's last line has every gate holding."""
    ours = c5.read_record(c5.OUT, 1)
    jax = c5.read_record(c5.JAX_RECORDS[0], 1)
    assert sorted(ours) == list(range(c5.N_SEQS))
    assert all(ours[b][0] == jax[b][0] and len(ours[b][2]) == 64 for b in ours)
    with open(os.path.join(c5.ROOT, "results", "torch_config5_full.log")) as f:
        summary = json.loads(f.read().splitlines()[-1])
    assert summary["config"] == "256xK16384xT65536" and not summary["cut"]
    assert all(summary["gates"].values()) and summary["against"]["equal"] == c5.N_SEQS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_score_is_jax_log_path_score_f64(seed):
    """The port's score gathers in fp32 and widens only what it gathered:
    bit-equal to the JAX package's, which widens the whole tables, with
    -inf entries and NaN rows."""
    rng = np.random.default_rng(seed)
    Ks, Ts = 300, 4096
    A = (rng.standard_normal((Ks, Ks)) * 9).astype(np.float32)
    A[rng.random((Ks, Ks)) < 0.05] = -np.inf
    A[7] = np.nan
    B = rng.standard_normal((Ks, 11)).astype(np.float32)
    P = rng.standard_normal(Ks).astype(np.float32)
    y = rng.integers(0, 11, Ts)
    p = rng.integers(0, Ks, Ts)
    A_ok = np.where(np.isfinite(A), A, 0).astype(np.float32)
    for tables, path in (((A, B, P), p), ((A_ok, B, P), p), ((A_ok, B, P), p[:1])):
        want = jval.log_path_score_f64(*tables, y[:len(path)], path)
        got = tval.log_path_score_f64(*tables, y[:len(path)], path)
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), (got, want)


def test_probe_and_phase2_probe_lines():
    rc, lines = run(CUT + ["--probe", "--batches", "2,3", "--probe-T", "128",
                           "--phase2-gib", "0.0001,1", "--phase2-batches", "2"])
    assert rc == 0, lines
    probes = [json.loads(x) for x in lines if x.startswith('{"probe_batch"')]
    assert [(r["probe_batch"], r["probe_T"]) for r in probes] == [(2, 128), (3, 128)]
    assert probes[0]["s_per_seq_at_T65536"] == pytest.approx(
        probes[0]["s_per_seq"] * c5.T_SPEC / 128)
    p2 = [json.loads(x) for x in lines if x.startswith('{"phase2_batch"')]
    # a sequence's carry parts, (Lmax - 1) x 4 lanes x 64 columns x 4 bytes (~127 KiB),
    # exceed 0.0001 GiB: a sequence a sub-batch
    assert [(r["budget_gib"], r["sub_batches"]) for r in p2] == [(0.0001, 2), (1.0, 1)]
    assert lines[-1].startswith("# phase 2: the paths are equal at every budget")
    assert c5.longform.PHASE2_BYTES == 6 * 2**30  # restored


def test_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        c5.main(["--full", "4", "--K", "8", "--T", "16"])
