"""The port's fuzz scripts (``scripts/torch_fuzz_midscale.py``,
``torch_fuzz_engines.py``, ``torch_fuzz_sharded.py``) on the CPU: one draw
of each at its smallest regime, so the scripts cannot rot unseen, their
coverage record on the scan plans the card would take, and their import
graph, which must pull in neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flash_viterbi_tpu_torch.ops.cuda.maxplus import scan_plan
from scripts import torch_fuzz_engines as fe
from scripts import torch_fuzz_midscale as fm
from scripts import torch_fuzz_sharded as fs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_SMS = 132


@pytest.mark.parametrize("regime,seed", [("small", 50_002), ("midscale", 90_003)])
def test_midscale_script_one_round(regime, seed):
    d = fm.one_round(seed, regime, device="cpu")
    assert d.failures == [], d.failures
    assert d.ctx.startswith(f"seed={seed} K=")


def test_midscale_draws_follow_the_jax_scripts():
    """The first draws are fuzz_midscale.py's and fuzz_hunt.py's."""
    p, _ = fm.problem("midscale", 90_000)
    rng = np.random.RandomState(90_000)
    assert p == dict(K=int(rng.randint(128, 513)), M=int(rng.randint(8, 51)),
                     T=int(rng.choice([128, 256, 512, 1024])),
                     prob=float(rng.uniform(0.05, 0.3)), segs=int(rng.choice([4, 6, 8])))
    p, rng = fm.problem("small", 50_000)
    assert (p["K"], p["T"], p["bw"]) == (136, 73, 30) and int(rng.choice([1, 8, 128])) == 8
    for seed in range(70_000, 70_024):
        p, _ = fm.problem("wide", seed)
        assert 513 <= p["K"] <= 4608 and p["T"] in (64, 128, 256) and p["segs"] in (4, 8, 16)


def test_coverage_keys_tell_the_plans_apart():
    """The coverage record on the card's plans: the bf16 tile copy takes
    4-byte pairs at an even K with even first columns and 2-byte copies at
    an odd K; a two-phase plan and a several-tile plan are keyed apart."""
    even = scan_plan(1408, 1, H100_SMS, elem_bytes=2)
    odd = scan_plan(1407, 1, H100_SMS, elem_bytes=2)
    assert fm.Coverage.bf16_paths(even, 1408) == {"pairs"}
    assert fm.Coverage.bf16_paths(odd, 1407) == {"2-byte"}
    assert fm.Coverage.bf16_paths(scan_plan(1408, 1, H100_SMS), 1408) == set()
    # 16 lanes own a column a thread: a group may start at an odd column
    assert "2-byte" in fm.Coverage.bf16_paths(scan_plan(1408, 16, H100_SMS, elem_bytes=2), 1408)
    keys = {fm.Coverage.scan_key(scan_plan(K, N, H100_SMS), K)
            for K, N in ((512, 1), (4608, 1), (4608, 16), (3968, 4))}
    assert len(keys) == 4
    assert "2ph" in fm.Coverage.scan_key(scan_plan(4608, 16, H100_SMS), 4608)
    assert "+multi" in fm.Coverage.scan_key(scan_plan(3000, 16, 4), 3000)
    cov = fm.Coverage()
    cov.draw["scan"]["a"] += 2
    cov.draw["fold_G"]["G4"] += 1
    assert cov.take() == {"scan": {"a": 2}, "fold_G": {"G4": 1}}
    assert cov.take() == {}
    assert "1 distinct scan plans" in cov.summary()


def test_engines_script_one_round():
    p = fe.draws(1, 50_000)[0]  # K=96, T=64, a batch of three
    assert p["i"] == 0 and p["K"] == 96 and not p["dag"]
    r = fe.one_round(p, device="cpu")
    assert r["failures"] == [] and r["pairs"][0] >= 1


def test_engines_draws_follow_the_jax_script():
    ps = fe.draws(25, 50_000)
    rng = np.random.default_rng(50_000)
    for p in ps:
        K, T = int(rng.choice([96, 128, 160, 256, 384, 512])), int(
            rng.choice([48, 64, 96, 128, 192, 256]))
        M, prob = int(rng.integers(4, 40)), float(rng.choice([0.02, 0.05, 0.1, 0.2]))
        seed, dag, bw = int(rng.integers(0, 10_000)), bool(rng.integers(0, 3) == 0), int(
            rng.choice([2, 4, 8, 16, 32]))
        assert (p["K"], p["M"], p["prob"], p["seed"], p["dag"]) == (K, M, prob, seed, dag)
        if dag:
            assert p["T"] in (48, 64) and p["bw"] == 2 * p["T"]
        else:
            assert (p["T"], p["bw"]) == (T, bw)


def test_sharded_script_one_world(tmp_path):
    p = fs.draw(60_001, 2)
    assert int(np.prod(p["mesh"])) == 2 and p["nb"] % p["mesh"][0] == 0
    results, _, err = fs.run_world([p], 2, "cpu", str(tmp_path))
    assert err == ""
    [(_, fails, rec0)] = results
    assert fails == [] and rec0["path"] in ("pipelined", "legacy")


def test_sharded_draws_cover_every_mesh_rule():
    for world in fs.WORLDS:
        for seed in range(60_000, 60_030):
            p = fs.draw(seed, world)
            n_data, n_seq, n_state = p["mesh"]
            assert n_data * n_seq * n_state == world
            assert p["nb"] % n_data == 0 and p["segs"] % n_seq == 0
            assert (p["nb"] // n_data) % p["mb"] == 0
            assert (256 <= p["K"] <= 512 and 256 <= p["T"] <= 1024) if seed % 4 == 0 else (
                64 <= p["K"] <= 512 and 32 <= p["T"] <= 512)


def test_scripts_import_neither_jax_nor_the_jax_package():
    """The scripts' card-mode import graph, lazy imports included: one draw
    of each script's card path (on the CPU), then no JAX module loaded."""
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "from scripts import torch_fuzz_midscale as fm, torch_fuzz_engines as fe, "
            "torch_fuzz_sharded as fs\n"
            "fm.Coverage().install()\n"
            "assert fm.one_round(50_002, 'small', 'cpu').failures == []\n"
            "p = dict(fe.draws(3, 50_000)[2], T=16, i=1)\n"
            "assert fe.one_round(p, 'cpu')['failures'] == []\n"
            "from flash_viterbi_tpu_torch.parallel.sharded import make_mesh\n"
            "assert fs.rank_round(dict(fs.draw(60_001, 2), mesh=(1, 1, 1), nb=1, mb=1, "
            "segs=2), make_mesh(1, 1, 1), torch.device('cpu'))['failures'] == []\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flash_viterbi_tpu', 'triton'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
