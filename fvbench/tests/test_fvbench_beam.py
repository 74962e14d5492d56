"""The FLASH-BS cell's check: the plain reference against the port's decode
and the framework's mirror, the check failing each planted fault, the
``decoder`` object read once, and the four exact cells judged as before."""

import inspect

import numpy as np
import pytest
import torch
from conftest import BEAM, CELLS, TINY, TINY_BEAM

import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu_torch.algorithms import flash as tflash
from flash_viterbi_tpu_torch.algorithms import flash_bs as tflash_bs
from flash_viterbi_tpu_torch.algorithms.base import decode, upload
from flash_viterbi_tpu_torch.models.hmm import LogHMM
from flash_viterbi_tpu_torch.ops import beam as tbeam
from flash_viterbi_tpu_torch.oracle import framework as tfw
from fvbench import control, gen, reference, run

SEED = 2**31 + 61


def port_paths(A, B, Pi, ys, beam_width, num_segments):
    """The port's ``build("flash_bs")`` on the CPU, on its padded tables, as
    the cell's entry calls it."""
    logA, logB, logPi = run.log_tables(A, B, Pi)
    pad_to = inspect.signature(decode).parameters["pad_to"].default
    _, lh = upload(LogHMM(logA, logB, logPi, A.shape[0]), torch.device("cpu"), pad_to)
    dec = tfv.build("flash_bs", beam_width=beam_width, num_segments=num_segments)
    return np.stack([dec(lh.logA, lh.logB, lh.logPi, y).numpy() for y in ys])


@pytest.mark.parametrize("K, T, bw, N, prob", [
    (64, 16, 4, 1, 0.2),
    (96, 40, 8, 2, 0.2),
    (200, 37, 8, 8, 0.2),
    (300, 64, 16, 8, 0.112),
    (128, 64, 16, 2, 0.3),
    (40, 24, 2, 4, 0.1),  # segments come back -1
])
def test_reference_equals_the_port_and_the_mirror(K, T, bw, N, prob):
    A, B, Pi = gen.tables(K, 7, prob, K + T, "cpu")
    ys = torch.as_tensor(gen.observations(4, T, 7, K + T)).long()
    got = reference.flash_bs(A, B, Pi, ys, bw, N, lanes=3).numpy()
    np.testing.assert_array_equal(got, port_paths(A, B, Pi, ys, bw, N))
    for i, y in enumerate(ys.numpy()):
        np.testing.assert_array_equal(
            got[i], tfw.flash_bs(A.double().numpy(), B.double().numpy(), Pi.double().numpy(),
                                 y, bw, N))
    if K == 40:
        assert (got == -1).any()


@pytest.mark.parametrize("T", [2, 3, 16, 37, 256, 4096])
@pytest.mark.parametrize("N", [1, 2, 3, 8, 16])
def test_segments_are_the_ports(T, N):
    starts, lens = reference.segments(T, N)
    n = reference.segment_count(T, N)
    mids = tflash.flash_midpoints(0, T - 1, n) if n > 1 else []
    want_starts, want_lens, _ = tflash.segment_layout(mids, T)
    assert (starts, lens) == (want_starts, want_lens)
    assert sum(lens) == T


def test_path_scores_with_gaps():
    A = torch.tensor([[0.5, 0.5, 0.0], [0.0, 1.0, 0.0], [0.2, 0.3, 0.5]])
    B = torch.full((3, 2), 0.5)
    Pi = torch.full((3,), 1 / 3)
    y = torch.tensor([[0, 1, 0, 1]] * 4)
    paths = torch.tensor([[0, 1, 1, 1], [-1, -1, 2, 2], [0, -1, 2, 0], [0, 1, -2, 1]])
    s = reference.path_scores(A, B, Pi, y, paths, gaps=True)
    whole = reference.path_scores(A, B, Pi, y[:1], paths[:1])
    assert float(s[0]) == float(whole[0])
    assert float(s[1]) == pytest.approx(2 * np.log(0.5) + np.log(0.5))
    assert float(s[2]) == pytest.approx(np.log(1 / 3) + 3 * np.log(0.5) + np.log(0.2))
    assert float(s[3]) == float("-inf")
    assert (reference.path_scores(A, B, Pi, y[1:3], paths[1:3]) == float("-inf")).all()


def beam_run(requests=12, seed=SEED):
    """The tiny FLASH-BS cell over a fixed number of requests, every
    completed sequence sampled."""
    over = {**TINY_BEAM, "check": {"sample": 64}}
    cell = run.load_cell(BEAM, overrides=over)
    return run.run_cell(cell, seed, 3600.0, False, device="cpu", requests=requests)


def test_a_sound_run_passes_with_dropped_segments():
    result = beam_run()
    assert result["correct"], result["checks"]
    assert result["readings"]["sampled_with_dropped_segment"] >= 1
    assert list(result)[-2:] == ["readings", "checks"]


def test_the_control_fails_and_the_program_passes():
    recs = list(control.readings(BEAM, [SEED], [SEED, SEED + 1], device="cpu",
                                 overrides=TINY_BEAM))
    assert [r["correct"] for r in recs] == [True, False, False]
    assert all(r["checks"]["path_mismatch"]["value"] > 0 for r in recs[1:])


def unstable_topk(full, B):
    """The top B with ties to the higher state: the order a sort that is
    not stable may give."""
    n = full.shape[-1]
    vals, idx = torch.sort(full.flip(-1) + 0.0, dim=-1, descending=True, stable=True)
    return vals[..., :B].contiguous(), (n - 1 - idx[..., :B]).to(torch.int32).contiguous()


def tied_tables(K, M, prob, seed, device):
    """Every edge of a row equally likely and every state emitting two
    symbols at 0.5: many beam entries tie."""
    g = torch.Generator().manual_seed(seed % 2**63)
    A = (torch.rand((K, K), generator=g) < 0.3).float()
    A.fill_diagonal_(1.0)
    A /= A.sum(dim=1, keepdim=True)
    B = torch.zeros((K, M))
    for k in range(K):
        B[k, [k % M, (k + 1) % M]] = 0.5
    return A.to(device), B.to(device), torch.full((K,), 1.0 / K, device=device)


def test_an_unstable_tie_order_fails_the_check(monkeypatch):
    monkeypatch.setattr(gen, "tables", tied_tables)
    assert beam_run()["correct"]
    monkeypatch.setattr(tbeam, "beam_topk", unstable_topk)
    monkeypatch.setattr(tflash_bs, "beam_topk", unstable_topk)
    result = beam_run()
    assert result["checks"]["path_mismatch"]["value"] > 0 and not result["correct"]


def fill_dropped_with_the_optimum(sound):
    vanilla = tfv.build("vanilla")

    def fn(logA, logB, logPi, y, **kw):
        out = sound(logA, logB, logPi, y, **kw)
        return torch.where(out == -1, vanilla(logA, logB, logPi, y).to(out.dtype), out)

    return fn


def cut_short(sound):
    """A -1 run one position shorter than its segment: segment 1's first
    position kept, the rest of it -1."""
    def fn(logA, logB, logPi, y, **kw):
        out = sound(logA, logB, logPi, y, **kw).clone()
        starts, lens = reference.segments(y.shape[0], kw["num_segments"])
        out[starts[1] + 1:starts[1] + lens[1]] = -1
        return out

    return fn


@pytest.mark.parametrize("fault, check", [(fill_dropped_with_the_optimum, "path_mismatch"),
                                          (cut_short, "invalid_paths")])
def test_a_planted_fault_fails_the_check(fault, check, monkeypatch):
    monkeypatch.setattr(tflash_bs, "flash_bs_decode", fault(tflash_bs.flash_bs_decode))
    result = beam_run()
    assert result["checks"][check]["value"] > 0 and not result["correct"], result["checks"]


def test_the_entry_reads_the_beam_from_the_decoder(monkeypatch):
    seen = []
    monkeypatch.setattr(tfv, "build", lambda name, **kw: seen.append((name, kw)))
    entry = run._load("entries", "flash_bs_single")
    dec = {"algorithm": "flash_bs", "beam_width": 64, "num_segments": 8}
    entry.make(object(), decoder=dec)
    entry.make(object(), control=True, decoder=dec)
    assert seen == [("flash_bs", {"beam_width": 64, "num_segments": 8}),
                    ("flash_bs", {"beam_width": 32, "num_segments": 8})]


def test_the_cell_states_its_decoder_once():
    cell = run.load_cell(BEAM)
    assert cell.decoder == {"algorithm": "flash_bs", "beam_width": 64, "num_segments": 8}
    assert set(cell.check["limits"]) == {"failed", "invalid_paths", "path_mismatch"}


@pytest.mark.parametrize("decoder, match", [
    ({"algorithm": "beam", "beam_width": 64}, "implements"),
    ({"algorithm": "flash_bs", "beam_width": 64}, "num_segments"),
    ({"algorithm": "flash_bs", "beam_width": 64, "num_segments": 8, "prune": 1}, "harness"),
])
def test_a_decoder_the_check_cannot_hold_is_refused(decoder, match):
    with pytest.raises(ValueError, match=match):
        run.load_cell(BEAM, overrides={**TINY, "traffic": {"decoder": decoder}})


@pytest.mark.parametrize("name", CELLS)
def test_the_exact_cells_are_judged_as_before(name):
    """No ``decoder``: the best path's float64 score gap over the sample and
    every path scored, as the check read before decoders."""
    cell = run.load_cell(name, overrides=TINY)
    assert cell.decoder is None
    s = run.prepare(cell, SEED, "cpu")
    w = run.run_window(s, cell, 3600.0, False, requests=5)
    checks, readings = run.judge(s, w, cell, SEED)
    assert readings == {} and list(checks) == ["failed", "invalid_paths", "score_gap"]
    picks = run.sample(w, int(cell.check["sample"]), SEED)
    ys = torch.from_numpy(np.stack([s.pool[pi][lane] for _, lane, pi in picks])).long()
    mine = torch.from_numpy(np.stack([w.paths[r][1][lane] for r, lane, _ in picks])).long()
    best = reference.path_scores(s.A, s.B, s.Pi, ys, reference.viterbi(s.A, s.B, s.Pi, ys))
    gap = float((best - reference.path_scores(s.A, s.B, s.Pi, ys, mine)).max())
    limits = cell.check["limits"]
    assert checks == {"failed": {"value": 0, "limit": limits["failed"]},
                      "invalid_paths": {"value": 0, "limit": limits["invalid_paths"]},
                      "score_gap": {"value": gap, "limit": limits["score_gap"]}}
