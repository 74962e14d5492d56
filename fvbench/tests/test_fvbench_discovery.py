"""A new configuration, traffic mix, entry, cell and metric are found by
name, with no edit to a file that is there."""

import json
import shutil

import pytest

from conftest import TINY

from fvbench import run


def test_new_files_are_found_by_name(tmp_path, monkeypatch, capsys):
    for kind in ("configs", "traffic", "entries", "metrics", "endtoend", "cells"):
        shutil.copytree(run.os.path.join(run.HERE, kind), tmp_path / kind)
    shutil.copy(run.os.path.join(run.HERE, "kernels.json"), tmp_path / "kernels.json")
    with open(run.os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (tmp_path / "configs" / "tiny_k40.json").write_text(json.dumps(
        {"K": 40, "M": 5, "prob": 0.3, "source": "a test"}))
    (tmp_path / "traffic" / "pair_t12.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "entry": "pair_entry", "sequences_per_request": 2,
         "T": 12, "pool": 16, "trace_requests": 2}))
    (tmp_path / "entries" / "pair_entry.py").write_text(
        "from flash_viterbi_tpu_torch.algorithms import fused\n"
        "def make(lh, control=False):\n"
        "    return lambda ys: fused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, ys)\n")
    (tmp_path / "metrics" / "window_ms.new.py").write_text(
        "def read(tr):\n    return tr.window_s * 1e3\n")
    (tmp_path / "endtoend" / "requests_done.py").write_text(
        "def read(w):\n    return float(len(w.paths))\n")
    (tmp_path / "cells" / "tiny_k40.pair_t12.json").write_text(json.dumps(
        {"sample": 2, "limits": {"failed": 0, "invalid_paths": 0, "score_gap": 0.01}}))
    bench["configs"].append({"name": "tiny_k40", "source": "a test", "file": "x", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_k40.pair_t12", "config": "tiny_k40",
                               "traffic": "pair_t12", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny_k40.pair_t12"]})
    bench["per_layer"].append({"name": "window_ms.new", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "decode_gupdates_per_s",
                               "workloads": ["tiny_k40.pair_t12"]})
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    cell = run.load_cell("tiny_k40.pair_t12", bench=bench)
    assert cell.config["K"] == 40 and cell.traffic["entry"] == "pair_entry"
    plain = run.run_cell(cell, 11, 0.1, False, device="cpu")
    assert plain["correct"] and plain["metrics"]["requests_done"]["value"] >= 1
    traced = run.run_cell(cell, 11, 0.1, True, device="cpu")
    assert traced["correct"] and traced["metrics"]["window_ms.new"]["unit"] == "ms"
    # an old cell still loads from the same folder, its files untouched
    old = run.load_cell("paper_k3965.single_t256", bench=bench, overrides=TINY)
    assert "requests_done" not in {m["name"] for m in old.end_to_end}


@pytest.mark.parametrize("kind, extra", [
    ("traffic", {"loop": "open"}),
    ("traffic", {"clients": 4}),
    ("traffic", {"rate_per_s": 200.0}),
    ("config", {"precision": "bf16"}),
    ("config", {"pad_to": 256}),
])
def test_a_key_the_harness_does_not_implement_is_refused(kind, extra):
    with pytest.raises(ValueError, match="harness"):
        run.load_cell("paper_k3965.single_t256", overrides={**TINY, kind: {**TINY.get(kind, {}),
                                                                          **extra}})
