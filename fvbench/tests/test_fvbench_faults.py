"""The check fails what it must: each fault a cell can have, planted in the
port's timed path underneath a run that skips only the look for a card, and
the control at a size a test run holds.  (The cells run on one card, so no
exchange between cards can be left out.)"""

import pytest
from conftest import BEAM, CELLS, TINY, tiny

from flash_viterbi_tpu_torch.algorithms import flash_bs, fused, longform
from fvbench import control, run

#: where each cell's entry produces its paths
PRODUCERS = {
    "paper_k3965.single_t256": (fused, "fused_decode"),
    "config5_k16384.single_t4096": (fused, "fused_decode"),
    "paper_k3965.batch16_t256": (fused, "fused_decode_batch"),
    "config5_k16384.batch16_t4096": (longform, "flash_decode_long_batched"),
    BEAM: (flash_bs, "flash_bs_decode"),
}


def altered(p):
    """One state of every path moved to the next state."""
    p = p.clone()
    mid = p.shape[-1] // 2
    p[..., mid] = (p[..., mid] + 1) % 96
    return p


def unchanged(p):
    """A step that returns its state unchanged: every path stays where it
    starts."""
    return p[..., :1].expand_as(p).contiguous()


def half_left_out(p):
    """Half the batch left out: its answers taken from the other half."""
    p = p.clone()
    half = p.shape[0] // 2
    p[half:] = p[:p.shape[0] - half]
    return p


FAULTS = {"altered": altered, "unchanged": unchanged, "half_left_out": half_left_out}


#: each cell with each fault it can have (a one-sequence request has no
#: batch to halve)
CASES = [(name, fault) for name in CELLS + (BEAM,) for fault in FAULTS
         if fault != "half_left_out" or "batch" in name]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_fault_fails_the_check(name, fault, monkeypatch):
    cell = run.load_cell(name, overrides=tiny(name))
    module, fn = PRODUCERS[name]
    sound = getattr(module, fn)
    monkeypatch.setattr(module, fn, lambda *a, **k: FAULTS[fault](sound(*a, **k)))
    result = run.run_cell(cell, 2**31 + 41, 0.1, False, device="cpu")
    assert result["correct"] is False, result["checks"]


#: sizes at which a bfloat16 table moves the best path past each cell's limit
#: on the CPU (the gap grows with K and T: at the cells' own sizes on the
#: card the control reads 0.34-0.47 at K=3965, T=256 and 4.8-6.1 at
#: K=16384, T=4096)
CONTROL_SIZES = {
    "paper_k3965.single_t256": {"config": {"K": 1024}, "traffic": {"T": 256, "pool": 16},
                                "check": {"sample": 8}},
    "config5_k16384.batch16_t4096": {"config": {"K": 1024},
                                     "traffic": {"T": 4096, "pool": 4, "sequences_per_request": 2},
                                     "check": {"sample": 2}},
}


@pytest.mark.parametrize("name", CONTROL_SIZES)
def test_the_control_fails_and_the_program_passes(name):
    recs = list(control.readings(name, [2**31 + 7], [2**31 + 7, 2**31 + 8], device="cpu",
                                 overrides=CONTROL_SIZES[name]))
    assert [r["correct"] for r in recs] == [True, False, False]


def one_outside_the_sample(p):
    """One state of one sequence moved, in a request the check does not
    sample: every completed path is scored, so its edge of probability 0
    (or its score) still shows."""
    p = p.clone()
    last = p.view(-1, p.shape[-1])[-1]
    last[1] = (last[1] + 1) % 96
    return p


@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_one_path_outside_the_sample_fails_the_check(name, monkeypatch):
    cell = run.load_cell(name, overrides={**TINY, "check": {"sample": 1}})
    module, fn = PRODUCERS[name]
    sound = getattr(module, fn)
    calls = {"n": 0}

    def once(*a, **k):
        calls["n"] += 1
        out = sound(*a, **k)
        return one_outside_the_sample(out) if calls["n"] == 4 else out

    monkeypatch.setattr(module, fn, once)
    # a fixed count of requests, not a clock: the fourth call (the third
    # request after warm-up) is always made
    result = run.run_cell(cell, 2**31 + 43, 3600.0, False, device="cpu", requests=6)
    assert result["checks"]["invalid_paths"]["value"] == 1, result["checks"]
    assert result["correct"] is False


def test_the_entry_without_a_control_of_its_own():
    lh = object()
    assert run._load("entries", "flash_long_batch").make(lh, control=True) is None
    for entry in ("auto_single", "fused_batch"):
        assert callable(run._load("entries", entry).make(lh, control=True))


def test_a_request_that_raises_is_counted_and_fails_the_check(monkeypatch):
    cell = run.load_cell(CELLS[0], overrides=TINY)
    calls = {"n": 0}
    sound = fused.fused_decode

    def sometimes(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("planted")
        return sound(*a, **k)

    monkeypatch.setattr(fused, "fused_decode", sometimes)
    result = run.run_cell(cell, 3, 0.2, False, device="cpu")
    assert result["failed"] == 1 and result["correct"] is False
