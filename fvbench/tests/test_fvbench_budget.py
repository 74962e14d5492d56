"""The cell ``config5_k16384.budget_t4096`` (``auto`` under a memory
budget) on the CPU at a small size, with the entry's ``BUDGET_BYTES``
patched so low that the small K reaches ``checkpoint``, as 32 MiB does at
K=16384, T=4096; and its reader ``reread_roofline_pct``."""

import json

import pytest
from conftest import TINY

from fvbench import bounds, run, trace
from fvbench.trace import Event

from flash_viterbi_tpu_torch.algorithms import auto, checkpoint

CELL = "config5_k16384.budget_t4096"
#: T long enough that checkpoint is leaner than fused at K=96 (128 padded)
SMALL = {**TINY, "traffic": {**TINY["traffic"], "T": 256}}


@pytest.fixture
def budgeted(monkeypatch):
    """Patch the entry's budget to checkpoint's figure at the small size,
    and count the checkpoint decodes the entry makes."""
    K, T, M = 128, SMALL["traffic"]["T"], SMALL["config"]["M"]
    budget = auto.device_peak_bytes("checkpoint", {}, K, T, M)
    assert auto.choose(K, T, budget, M=M) == ("checkpoint", {})
    real = run._load

    def load(kind, name):
        mod = real(kind, name)
        if kind == "entries" and name == "auto_budget_single":
            mod.BUDGET_BYTES = budget
        return mod

    monkeypatch.setattr(run, "_load", load)
    calls = []
    decode = checkpoint.checkpoint_decode

    def spy(*args, **kw):
        calls.append(args[3].shape)
        return decode(*args, **kw)

    monkeypatch.setattr(checkpoint, "checkpoint_decode", spy)
    return calls


def test_the_budget_is_the_entry_constant():
    mod = run._load("entries", "auto_budget_single")
    assert mod.BUDGET_BYTES == 33_554_432
    assert mod.make(None, control=True) is None  # the reference at bf16 in its place
    assert auto.choose(16384, 4096, mod.BUDGET_BYTES, M=50) == ("checkpoint", {})


def test_the_budget_cell_runs_its_own_deployment():
    """The cell's configuration is config-5's HMM under the entry's
    budget: the same tables and cuts as ``config5_k16384``, a source of
    its own, and the budget it states is the entry's."""
    with open(run.os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    spec = next(w for w in bench["workloads"] if w["name"] == CELL)
    configs = {c["name"]: c for c in bench["configs"]}
    mine, base = configs[spec["config"]], configs["config5_k16384"]
    assert spec["config"] == "config5_k16384_budget32m"
    assert mine["source"] != base["source"] and mine["reduced"] == base["reduced"]
    assert mine["file"] == f"fvbench/configs/{spec['config']}.json"
    cfg, ref = run._json("configs", spec["config"]), run._json("configs", "config5_k16384")
    for key in ("K", "M", "prob", "generator", "published", "reduced"):
        assert cfg[key] == ref[key], key
    budget = run._load("entries", "auto_budget_single").BUDGET_BYTES
    assert cfg["assumed"]["memory_budget_bytes"].startswith(f"{budget} ")
    assert run.load_cell(CELL).config["K"] == 16384


@pytest.mark.parametrize("traced", [False, True])
def test_budget_cell_runs_checkpoint_and_is_correct(budgeted, traced):
    cell = run.load_cell(CELL, overrides=SMALL)
    assert cell.traffic["entry"] == "auto_budget_single" and cell.decoder is None
    result = run.run_cell(cell, 2**31 + 977, 0.2, traced, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["score_gap"]["value"] == 0.0
    assert budgeted and all(tuple(s) == (256,) for s in budgeted)
    names = set(result["metrics"])
    if traced:
        # no device operations on the CPU, and no re-read floor at the small K
        assert "reread_roofline_pct" not in names
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    else:
        assert {"decode_gupdates_per_s", "peak_mem_mib", "setup_s"} >= names
        assert "decode_gupdates_per_s" in names and "decode_p95_ms" not in names


def test_budget_cell_lists_only_its_metrics():
    cell = run.load_cell(CELL, overrides=SMALL)
    assert [m["name"] for m in cell.end_to_end] == ["decode_gupdates_per_s", "peak_mem_mib",
                                                    "setup_s"]
    assert "reread_roofline_pct" in [m["name"] for m in cell.per_layer]
    other = run.load_cell("config5_k16384.single_t4096", overrides=TINY)
    assert "reread_roofline_pct" not in [m["name"] for m in other.per_layer]


def test_reread_floor_at_config5():
    """One T=4096 sequence at K=16384 reads the 1 GiB table's part above
    the 117.9 MB on chip 4095 times: 1.168 s at 3.35 TB/s; a table that
    fits on chip has no floor."""
    mod = run._load("metrics", "reread_roofline_pct")
    assert mod.ON_CHIP_BYTES == bounds.H100.sms * (233472 + 4 * 65536) + 50 * 2**20
    assert mod.reread_floor_s(16384, 4096) == pytest.approx(
        4095 * (2**30 - 117_850_112) / 3.35e12)
    assert mod.reread_floor_s(16384, 4096) == pytest.approx(1.1685, abs=1e-4)
    assert mod.reread_floor_s(3965, 256) == 0.0


def test_reread_reader():
    """Three requests' floors over the busy time (two kernels and a copy,
    one overlapping); nothing where no operation ran."""
    mod = run._load("metrics", "reread_roofline_pct")
    ops = [Event("scan_persistent", "kernel", 0.0, 5.0),
           Event("backtrack_kernel", "kernel", 4.0, 2.0),
           Event("Memcpy DtoH", "gpu_memcpy", 7.0, 1.0)]
    tr = trace.Trace(ops=ops, spans=[], window_s=10.0, sequences=3, floor_s=0.1, K=16384, M=50,
                     T=4096, Bs=1)
    assert mod.read(tr) == pytest.approx(100 * 3 * mod.reread_floor_s(16384, 4096) / 7.0)
    empty = trace.Trace(ops=[], spans=[], window_s=1.0, sequences=3, floor_s=0.1, K=16384,
                        M=50, T=4096)
    assert mod.read(empty) is None
