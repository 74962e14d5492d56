"""The port's routing and chunk figures against the H100 rows they come
from, and each threshold's two sides against the JAX package.

The rows: ``results/torch_route_sweep.jsonl`` (``scripts/torch_route_sweep.py``)
and ``results/torch_auto_sweep.jsonl`` (``scripts/torch_auto_sweep.py``), on
an NVIDIA H100 80GB HBM3 at 700.00 W.  Two choices lie within each other's
spread when their medians are closer than the sum of their spreads (each
the larger of the range of its six decodes and 2% of its median).  At
every swept shape the rule's choice lies within the spread of the fastest
choice, and no figure rests on a gap below the spread: each region of the
larger working set's choice holds a swept shape where the other choice
lies outside the spread, and each figure moved one swept step toward the
smaller working set breaks the first check at some swept shape.  Lean's
figures, the memory-lean mode's, are held the other way round: no swept
value with a working set as small is faster beyond the spread.  Then the
paths on both sides of each threshold, on the CPU, against the JAX
package's (``use_pallas=True``, interpret mode), bit for bit.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import fused as jfused
from flash_viterbi_tpu_torch.algorithms import auto as tauto
from flash_viterbi_tpu_torch.algorithms import checkpoint as tck
from flash_viterbi_tpu_torch.algorithms import flash as tflash
from flash_viterbi_tpu_torch.algorithms import fused as tfused
from flash_viterbi_tpu_torch.models.generate import observations
from flash_viterbi_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(2)

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results")


def _lines(name: str) -> list[dict]:
    with open(os.path.join(RESULTS, name)) as f:
        return [json.loads(line) for line in f]


def _cells(figure: str) -> dict:
    """{shape: {choice: row}} of one figure's rows."""
    cells: dict = {}
    for row in _lines("torch_route_sweep.jsonl"):
        if row.get("figure") == figure:
            cells.setdefault(_key(row["shape"]), {})[row["choice"]] = row
    return cells


def _key(shape: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in shape.items()))


def _within(a: dict, b: dict) -> bool:
    return abs(a["ms"] - b["ms"]) <= a["spread_ms"] + b["spread_ms"]


def _fastest(rows: dict) -> dict:
    return min(rows.values(), key=lambda r: r["ms"])


def test_the_rows_are_the_cards_and_their_summaries_agree():
    """Every figure was swept on the H100, and each shape's summary line
    (the script's own reading) is what the rows give."""
    lines = _lines("torch_route_sweep.jsonl")
    assert lines[0]["card"].startswith("NVIDIA H100")
    for figure in ("fused", "batch", "snapshot", "lean", "sharded"):
        assert _cells(figure), figure
    for line in lines:
        if "summary" in line:
            rows = _cells(line["summary"])[_key(line["shape"])]
            best = _fastest(rows)
            assert line["fastest"] == best["choice"]
            assert sorted(line["within_spread"]) == sorted(
                c for c, r in rows.items() if _within(r, best))


@pytest.mark.parametrize("figure", ["fused", "batch"])
def test_pointer_route_holds_to_the_rows(figure):
    """The route ``pointer_route`` names lies within the spread of the
    faster route at every swept shape."""
    for key, rows in _cells(figure).items():
        shape = dict(key)
        pick = tfused.pointer_route(shape["K"], shape.get("Bs", 1))
        assert _within(rows[pick], _fastest(rows)), (shape, pick)


def _recompute_leads(rows: dict) -> bool:
    return (rows["recompute"]["ms"] < rows["store"]["ms"]
            and not _within(rows["recompute"], rows["store"]))


def test_pointer_route_thresholds_rest_on_the_rows():
    """Recompute, whose working set also holds the transposed logA, is
    named only where it leads store beyond the spread at some swept T: at
    every swept K of the single sequence's band and at its edges' first
    swept K inside, at two sequences just past ``PAIR_STORE_MAX_K`` and at
    ``STREAMED_MIN_K`` just past ``STREAMED_STORE_MAX_BS``; and it leads
    nowhere in a store region."""
    def leads(figure, **fixed):
        return [dict(k) for k, rows in _cells(figure).items()
                if fixed.items() <= dict(k).items() and _recompute_leads(rows)]

    lo, hi = tfused.RECOMPUTE_K
    single_ks = sorted({dict(k)["K"] for k in _cells("fused")})
    for K in single_ks:
        assert bool(leads("fused", K=K)) == (lo < K <= hi), K
    batch_ks = sorted({dict(k)["K"] for k in _cells("batch")})
    assert leads("batch", K=min(k for k in batch_ks if k > tfused.PAIR_STORE_MAX_K), Bs=2)
    assert leads("batch", K=tfused.STREAMED_MIN_K, Bs=tfused.STREAMED_STORE_MAX_BS + 1)
    for shape in leads("batch"):
        assert tfused.pointer_route(shape["K"], shape["Bs"]) == "recompute", shape


def _steps(key) -> dict:
    return {int(c.split("=")[1]): r for c, r in _cells("snapshot")[key].items()}


def test_snapshot_step_holds_to_the_rows():
    """``snapshot_step`` is a swept step within the fastest step's spread
    at every swept shape, and the least step one swept step lower (64)
    falls outside it at some shape: the figure rests on a gap above the
    spread."""
    cells = _cells("snapshot")
    for key in cells:
        T, steps = dict(key)["T"], _steps(key)
        assert _within(steps[tck.snapshot_step(T)], _fastest(steps)), dict(key)
    lower = max(s for key in cells for s in _steps(key) if s < tck.SNAPSHOT_MIN_STEP)
    broken = [dict(key) for key in cells
              if not _within(_steps(key)[max(math.isqrt(dict(key)["T"]), lower)],
                             _fastest(_steps(key)))]
    assert broken, lower


def test_snapshot_step_rule():
    """√T with ``SNAPSHOT_MIN_STEP`` below it, one chunk where T is
    shorter; a step the caller passes is the decode's."""
    for T in (1, 2, 3, 63, 128, 129, 256, 4095, 4096, 16384, 65536, 10**6):
        want = min(max(math.isqrt(T), tck.SNAPSHOT_MIN_STEP), max(T - 1, 1))
        assert tck.snapshot_step(T) == want, T
    assert tck.snapshot_step(16384) == 128 and tck.snapshot_step(65536) == 256
    assert tck.snapshot_step(1024) == tck.SNAPSHOT_MIN_STEP


# the module's values when the rows were taken, which the rows call "module"
SWEPT_MODULE = {"lean": {"chunk": 64, "lanes": 32, "leaf": 64},
                "sharded": {"chunk": 512, "group": "1GiB", "emit": "64MiB"}}


def _label(figure: str, now: dict) -> str:
    """The row label of the values ``now``: "module", or the one value
    that differs from the swept module's."""
    moved = [f"{k}={v}" for k, v in now.items() if SWEPT_MODULE[figure][k] != v]
    assert len(moved) <= 1, moved  # the rows vary one value at a time
    return moved[0] if moved else "module"


def _mib(n: int) -> str:
    return f"{n >> 30}GiB" if n >= 1 << 30 else f"{n >> 20}MiB"


def test_lean_figures_are_not_dominated_and_their_peak_is_the_formulas():
    """At every swept shape no value with a working set as small as the
    module's is faster beyond the spread (lean is the memory-lean mode:
    memory first), and the module's measured peak lies within
    ``lean_working_set``; ``LEAN_LEAF`` stays, since another leaf may flip
    a path's fp32 tie (the rows show one)."""
    label = _label("lean", {"chunk": tflash.LEAN_CHUNK, "lanes": tflash.LEAF_LANES,
                            "leaf": tflash.LEAN_LEAF})
    for key, rows in _cells("lean").items():
        mine = rows[label]
        assert mine["peak_bytes"] <= mine["working_set"], dict(key)
        for choice, row in rows.items():
            if row["working_set"] <= mine["working_set"]:
                assert row["ms"] >= mine["ms"] or _within(row, mine), (dict(key), choice)
    assert tflash.LEAN_LEAF == SWEPT_MODULE["lean"]["leaf"]
    assert any(row["path"].startswith("tie-equivalent") for rows in _cells("lean").values()
               for c, row in rows.items() if c.startswith("leaf="))


def test_sharded_figures_hold_to_the_rows():
    """The module's ``_CHUNK``, ``_GROUP_BYTES`` and ``_EMIT_BYTES`` lie
    within the fastest value's spread on every swept mesh, with the
    smallest measured peak of those within it."""
    label = _label("sharded", {"chunk": tsharded._CHUNK, "group": _mib(tsharded._GROUP_BYTES),
                               "emit": _mib(tsharded._EMIT_BYTES)})
    for key, rows in _cells("sharded").items():
        best, mine = _fastest(rows), rows[label]
        assert _within(mine, best), dict(key)
        assert mine["peak_bytes"] == min(r["peak_bytes"] for r in rows.values()
                                         if _within(r, best)), dict(key)


AUTO_LABELS = {"fused": ("fused", {}), "checkpoint": ("checkpoint", {}),
               "flash N=16": ("flash", {"num_segments": 16}),
               "flash lean": ("flash", {"mode": "lean"})}


def _auto_cells() -> dict:
    """{(Kp, T): {candidate label: row}} of ``auto``'s sweep, each row's
    spread the larger of its decodes' range and 2% of its median."""
    cells: dict = {}
    for row in _lines("torch_auto_sweep.jsonl"):
        if "candidate" in row:
            row = {**row, "spread_ms": max(row["max_ms"] - row["min_ms"], 0.02 * row["ms"])}
            cells.setdefault((row["Kp"], row["T"]), {})[row["candidate"]] = row
    return cells


def test_auto_rank_holds_to_the_rows():
    """At every cell of ``auto``'s sweep, on the grid and off it:
    ``rank``'s first candidate lies within the spread of the fastest
    swept candidate, flash pointer mode's segments within the fastest
    segment count's, and no candidate ranked after another leads it
    beyond the spread."""
    lines = _lines("torch_auto_sweep.jsonl")
    assert lines[0]["card"].startswith("NVIDIA H100")
    cells = _auto_cells()
    assert {(512, 64), (2048, 1024), (6016, 4096), (12032, 64)} <= set(cells)
    for (Kp, T), rows in cells.items():
        order = [next(lab for lab, c in AUTO_LABELS.items() if c == cand)
                 for cand in tauto.rank(Kp, T)]
        assert _within(rows[order[0]], _fastest(rows)), (Kp, T, order)
        flash = {lab: r for lab, r in rows.items() if lab.startswith("flash N=")}
        assert _within(rows[f"flash N={tauto.FLASH_SEGMENTS}"], _fastest(flash)), (Kp, T)
        for i, first in enumerate(order):
            for later in order[i + 1:]:
                assert rows[later]["ms"] >= rows[first]["ms"] or _within(
                    rows[later], rows[first]), (Kp, T, first, later)


def _spy_route(monkeypatch) -> list:
    called = []
    for name in ("maxplus_scan", "maxplus_scan_deltas", "argmax_walk", "backtrack_batched"):
        fn = getattr(tfused, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            called.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(tfused, name, wrapped)
    return called


def _took(called) -> str:
    return "recompute" if "argmax_walk" in called else "store"


@pytest.mark.parametrize("K,T", [(1024, 256), (1280, 256), (1536, 256), (2048, 256),
                                 (2176, 256)])
def test_single_route_sides_match_jax(K, T, monkeypatch):
    """Both sides of each edge of the single sequence's recompute band
    (and the JAX package's own edge, K=1024): the route the rule names,
    and JAX's path bit for bit."""
    called = _spy_route(monkeypatch)
    hmm, y = tfv.make_sparse_hmm(K=K, M=50, T=T, prob=0.112, seed=K + T)
    got = tfv.decode(hmm, y, "fused", device="cpu", warmup=False)
    assert _took(called) == tfused.pointer_route(K)
    want = jfv.decode(jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, "fused", use_pallas=True,
                      warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes


@pytest.mark.parametrize("K,T,Bs", [(256, 20, 2), (256, 20, 3), (384, 20, 2), (8192, 2, 4),
                                    (8192, 2, 5)])
def test_batch_route_sides_match_jax(K, T, Bs, monkeypatch):
    """Both sides of each store region of the batch's ``pointers="auto"``:
    the route the rule names, and JAX's paths bit for bit."""
    called = _spy_route(monkeypatch)
    hmm, y = tfv.make_sparse_hmm(K=K, M=50, T=T, prob=0.112, seed=Bs)
    ys = np.stack([y] + [observations(T, 50, seed=Bs + b) for b in range(1, Bs)])
    lh = hmm.log(device="cpu")
    got = tfused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, torch.as_tensor(ys))
    assert _took(called) == tfused.pointer_route(K, Bs)
    jt = [jnp.asarray(t.numpy()) for t in (lh.logA, lh.logB, lh.logPi)]
    want = jfused.fused_decode_batch(*jt, jnp.asarray(ys), use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
