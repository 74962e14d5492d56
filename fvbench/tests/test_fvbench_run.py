"""Every cell end to end at a tiny size on the CPU, the result line's form,
the sample, and the whole-name module check."""

import json

import numpy as np
import pytest
import torch
from conftest import BEAM, CELLS, TINY, tiny

from fvbench import run


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS + (BEAM,))
def test_cell_prints_a_well_formed_last_line(name, traced, capsys):
    cell = run.load_cell(name, overrides=tiny(name))
    result = run.run_cell(cell, 2**31 + 977, 0.2, traced, device="cpu")
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    last = "check path_mismatch 0 limit 0" if name == BEAM else "check score_gap 0.0 limit"
    assert err.strip().splitlines()[-1].startswith(last)
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(line["metrics"]) <= names and "decode_gupdates_per_s" in line["metrics"]
        assert ("decode_p95_ms" in line["metrics"]) == (name == "paper_k3965.single_t256")
        assert line["metrics"]["decode_gupdates_per_s"]["unit"] == "Gupdates/s"


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 CUDA device" in err


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 12345678901])
def test_sample_covers_both_halves_of_a_batch(seed):
    w = run.Window(K=8, T=4, Bs=16, setup_s=0.0)
    w.paths = [(i, np.zeros((16, 4), np.int32)) for i in range(6)]
    picks = run.sample(w, 4, seed)
    lanes = [lane for _, lane, _ in picks]
    assert len(set((r, lane) for r, lane, _ in picks)) == 4
    assert min(lanes) < 8 <= max(lanes)
    assert picks == run.sample(w, 4, seed)


@pytest.mark.parametrize("R, Bs, n", [(4, 16, 64), (4, 16, 63), (4, 16, 17), (3, 1, 2),
                                      (1, 16, 3), (2, 16, 16)])
def test_sample_ends_and_is_distinct(R, Bs, n):
    w = run.Window(K=8, T=4, Bs=Bs, setup_s=0.0)
    w.paths = [(i, np.zeros((Bs, 4), np.int32)) for i in range(R)]
    picks = run.sample(w, n, 7)
    assert len(picks) == min(n, R * Bs) == len(set((r, lane) for r, lane, _ in picks))


def test_sample_takes_every_sequence_when_few():
    w = run.Window(K=8, T=4, Bs=1, setup_s=0.0)
    w.paths = [(i + 1, np.zeros((1, 4), np.int32)) for i in range(3)]
    picks = run.sample(w, 64, 3)
    assert sorted(p[2] for p in picks) == [1, 2, 3]


def test_forbidden_modules_by_whole_top_level_name():
    names = ["flash_viterbi_tpu_torch", "flash_viterbi_tpu_torch.ops", "jaxtyping", "numpy",
             "flash_viterbi_tpu", "flash_viterbi_tpu.algorithms", "jax.numpy", "jaxlib", "flax"]
    assert run.forbidden_modules(names) == sorted(
        ["flash_viterbi_tpu", "flash_viterbi_tpu.algorithms", "jax.numpy", "jaxlib", "flax"])


def test_same_seed_same_inputs():
    cfg = run.load_cell(CELLS[2], overrides=TINY)
    a = run.prepare(cfg, 2**31 + 1, "cpu")
    b = run.prepare(cfg, 2**31 + 1, "cpu")
    c = run.prepare(cfg, 2**31 + 2, "cpu")
    assert torch.equal(a.A, b.A) and np.array_equal(a.pool, b.pool)
    assert not torch.equal(a.A, c.A) and not np.array_equal(a.pool, c.pool)
