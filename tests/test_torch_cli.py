"""The port's command line and headline script against the JAX package's:
``generate`` files byte for byte, ``decode``'s path and ``memory:``,
``bench``'s CSV header, ``compare``'s summary paths, ``scaling``'s count
fields and sweep rows, and ``bench/headline.py``'s JSON line against
``bench.py``'s keys."""

import ast
import csv
import filecmp
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from flash_viterbi_tpu import cli as jcli
from flash_viterbi_tpu_torch import cli as tcli

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEM = ["-K", "48", "-M", "8", "-T", "24", "-p", "0.3", "-s", "5"]
# analyze's fields that depend on the card's constants, not on the plan
MODELED = ("compute_s", "comm_s", "modeled_wall_s", "modeled_efficiency")


def _run(main, argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _reference(text: str):
    """(path, memory) of the reference stdout protocol."""
    m = re.fullmatch(r"time: \S+ \npath: \[([^\]]*)\]\nmemory: (\d+)\n", text)
    assert m, text
    return [int(x) for x in m.group(1).split()], int(m.group(2))


def test_generate_files_equal_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jout = _run(jcli.main, ["generate", *PROBLEM, "-o", str(jdir)])
    tout = _run(tcli.main, ["generate", *PROBLEM, "-o", str(tdir)])
    assert tout == jout.replace(str(jdir), str(tdir))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 4
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name


@pytest.mark.parametrize("alg", ["vanilla", "fused", "flash"])
def test_decode_matches_jax(alg, tmp_path):
    """Generated and loaded from the generated files: the same path and
    ``memory:`` line as the JAX command line's decode."""
    data = str(tmp_path / "data")
    _run(tcli.main, ["generate", *PROBLEM, "-o", data])
    for extra in ([], ["--data", data]):
        want = _reference(_run(jcli.main, ["decode", "-a", alg, *PROBLEM, *extra]))
        got = _reference(_run(tcli.main, ["decode", "-a", alg, *PROBLEM, *extra,
                                          "--device", "cpu"]))
        assert got == want


def test_decode_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["decode", "-a", "fused", *PROBLEM])


def test_bench_csv_matches_jax(tmp_path):
    for main, name, extra in ((jcli.main, "jax", []), (tcli.main, "port", ["--device", "cpu"])):
        _run(main, ["bench", "-a", "vanilla,fused", *PROBLEM, "--csv-dir",
                    str(tmp_path / name), *extra])
    for alg in ("vanilla", "fused"):
        rows = {}
        for name in ("jax", "port"):
            with open(tmp_path / name / f"{alg}.csv") as f:
                rows[name] = list(csv.reader(f))
        assert rows["port"][0] == rows["jax"][0]
        assert len(rows["port"]) == len(rows["jax"]) == 2
        jrow, trow = (dict(zip(rows[n][0], rows[n][1])) for n in ("jax", "port"))
        for key in ("K_STATE", "T_STATE", "obserRouteLEN", "prob", "MAX_THREADS",
                    "BeamSearchWidth", "memory", "algorithm", "parity", "pallas_fallback"):
            assert trow[key] == jrow[key], key
        assert trow["device"] == "cpu"


def _ans(text: str) -> dict:
    """Each row's path in a compare summary, and its non-timing lines."""
    paths, name, lines = {}, None, []
    for line in text.splitlines():
        if " Time: " in line:
            name = line.split(" Time: ")[0]
            lines.append(name)
        elif line.startswith("path: "):
            paths[name] = [int(x) if np.isscalar(x) else tuple(map(int, x))
                           for x in ast.literal_eval(
                               re.sub(r"np\.int64\((-?\d+)\)", r"\1", line[6:]))]
        else:
            lines.append(line)
    return {"paths": paths, "lines": lines}


def test_compare_matches_jax(tmp_path, monkeypatch):
    files = {}
    for main, name, extra in ((jcli.main, "jax", []), (tcli.main, "port", ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        _run(main, ["compare", *PROBLEM, *extra])
        (ans,) = os.listdir(tmp_path / name)
        assert ans == "ANS_K48_T24_prob0.3_beam_width48.txt"
        files[name] = _ans((tmp_path / name / ans).read_text())
    assert files["port"] == files["jax"]
    assert sorted(files["port"]["paths"]) == sorted(
        ["vanilla", "checkpoint", "fused", "flash", "flash_bs", "sieve_mp", "beam",
         "SIEVE-Mp(oracle)", "SIEVE-BS(oracle)", "SIEVE-BS-Mp(oracle)"])


def test_compare_skips_the_oracles_over_the_limit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = _run(tcli.main, ["compare", *PROBLEM, "--oracle-limit", "1e3", "--device", "cpu"])
    assert "SIEVE oracles skipped: M*K^2 = 1.84e+04" in out
    assert "(oracle)" not in (tmp_path / "ANS_K48_T24_prob0.3_beam_width48.txt").read_text()


def test_scaling_matches_jax():
    """The model's lines (count fields equal; the modeled times use each
    package's own constants) and the sweep's rows over gloo CPU ranks."""
    argv = ["scaling", "--mesh", "1,1,1;1,1,2;1,2,2", "--measure"]
    jlines = _run(jcli.main, argv).splitlines()
    tlines = _run(tcli.main, argv + ["--device", "cpu"]).splitlines()
    assert len(jlines) == len(tlines) == 6
    for j, t in zip(jlines[:3], tlines[:3]):
        j, t = json.loads(j), json.loads(t)
        assert list(t) == list(j)
        assert {k: v for k, v in t.items() if k not in MODELED} == \
            {k: v for k, v in j.items() if k not in MODELED}
    for j, t in zip(jlines[3:], tlines[3:]):
        j, t = ast.literal_eval(j), ast.literal_eval(t)
        assert t["paths_equal"] is True and list(t) == list(j)
        assert {k: v for k, v in t.items() if k not in MODELED} == \
            {k: v for k, v in j.items() if k not in MODELED}


def test_module_entry_point(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "flash_viterbi_tpu_torch", "decode", "-a",
                           "fused", *PROBLEM, "--device", "cpu"], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert _reference(proc.stdout) == _reference(_run(jcli.main, ["decode", "-a", "fused",
                                                                  *PROBLEM]))


def _bench_py_keys() -> set[str]:
    """The keys of the row ``bench.py`` prints (its ``row = {...}``)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["row"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no row dict")


def test_headline_script_smoke_cpu():
    keys = _bench_py_keys()
    assert keys == {"metric", "value", "unit", "vs_baseline", "wall_s", "config",
                    "exact_path_parity", "device"}
    proc = subprocess.run([sys.executable, "-m", "flash_viterbi_tpu_torch.bench.headline",
                           "--smoke", "--cpu"], capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert keys | {"chain_wall_s", "chain_updates_per_s"} <= set(row)
    assert row["exact_path_parity"] is True and row["device"] == "cpu"
    assert row["metric"] == "trellis_updates_per_s" and row["unit"] == "updates/s"
    assert row["value"] == 256 * 256 * 64 / row["wall_s"] > 0
    assert row["chain_updates_per_s"] == 256 * 256 * 64 / row["chain_wall_s"]
    from flash_viterbi_tpu_torch.bench import headline

    assert headline.BASELINE_UPDATES_PER_S == (3965.0**2 * 256.0) / 672.6
    assert row["vs_baseline"] == row["value"] / headline.BASELINE_UPDATES_PER_S


def test_headline_script_needs_the_card(monkeypatch):
    from flash_viterbi_tpu_torch.bench import headline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.main(["--smoke"])
