"""``algorithm="auto"``: the working-set model against the JAX package's,
the H100 order, the budget filter, memory reporting at the padded K and
exact paths under any budget; and every decoder's extra static keywords."""

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import auto as jauto
from flash_viterbi_tpu_torch.algorithms import auto as tauto
from flash_viterbi_tpu_torch.algorithms import base as tbase
from flash_viterbi_tpu_torch.oracle import framework as tfw

torch.set_num_threads(2)

KWS = [("flash", {}), ("flash", {"num_segments": 16}), ("flash_long", {}),
       ("flash", {"mode": "lean"}), ("flash", {"mode": "lean", "num_segments": 16}),
       ("flash", {"mode": "lean", "lean_leaf": 0}),
       ("flash", {"mode": "lean", "lean_leaf": 4, "num_segments": 3}),
       ("checkpoint", {}), ("checkpoint", {"step": 5}), ("fused", {}), ("vanilla", {}),
       ("flash_bs", {"beam_width": 64}), ("beam", {"beam_width": 8}), ("sieve_mp", {})]


@pytest.mark.parametrize("name,kw", KWS)
def test_device_working_set_matches_jax(name, kw):
    for K in (64, 1024, 3968, 16384):
        for T in (1, 16, 255, 256, 2048, 16384, 65536):
            assert (tauto.device_working_set(name, kw, K, T)
                    == jauto.device_working_set(name, kw, K, T)), (K, T)


def test_h100_order():
    """rank's order as measured on the H100 (scripts/torch_auto_sweep.py,
    PERF.md's "auto's order")."""
    fused, ck, lean = ("fused", {}), ("checkpoint", {}), ("flash", {"mode": "lean"})
    flash = ("flash", {"num_segments": 16})
    for K, T, want in [
        (3968, 8, [fused, ck]),
        (256, 16, [fused, ck]),
        (16384, 16, [fused, ck]),
        (3968, 256, [fused, flash, ck, lean]),
        (8192, 32, [fused, flash, ck, lean]),
        (8192, 256, [fused, flash, lean, ck]),
        (16384, 1024, [fused, flash, lean, ck]),
        (16384, 2048, [fused, flash, ck, lean]),
        (16384, 4096, [fused, flash, ck, lean]),
        (1024, 16384, [fused, ck, lean]),
        (16384, 16384, [fused, ck, lean]),
        (32768, 16384, [ck, lean]),
    ]:
        assert tauto.rank(K, T) == want, (K, T)
    assert tauto.rank(3968, 256, beam_width=32) == [
        ("flash_bs", {"beam_width": 32, "num_segments": 8})]
    assert tauto.choose(4096, 256, memory_budget_bytes=1, beam_width=64)[0] == "flash_bs"


def test_a_budget_with_many_segments_reaches_lean():
    """Lean's working set falls below fused's with many short segments, so
    where lean leads checkpoint a budget between them chooses it."""
    K, T, over = 8192, 1024, {"num_segments": 128}
    lean = tauto.device_working_set("flash", {"mode": "lean", **over}, K, T)
    assert lean < tauto.device_working_set("fused", over, K, T)
    assert tauto.choose(K, T, lean, static=over) == ("flash", {"mode": "lean", **over})
    assert tauto.choose(K, T, lean - 1, static=over)[0] == "checkpoint"


def test_budget_filter_sees_the_overrides():
    """Overrides are merged before the filter; nothing fitting takes the
    leanest candidate, never a crash."""
    ws = {n: tauto.device_working_set(n, kw, 4096, 256) for n, kw in tauto.rank(4096, 256)}
    name, kw = tauto.choose(4096, 256, memory_budget_bytes=1)
    assert tauto.device_working_set(name, kw, 4096, 256) == min(ws.values())
    name, kw = tauto.choose(4096, 256, memory_budget_bytes=1, static={"num_segments": 32})
    assert kw["num_segments"] == 32
    # checkpoint fits its own working set; with a step override its
    # snapshots no longer do, so nothing fits and the leanest is taken
    budget = tauto.device_working_set("checkpoint", {}, 4096, 256)
    assert tauto.choose(4096, 256, budget)[0] == "checkpoint"
    over = {"step": 1}
    cands = [(n, {**k, **over}) for n, k in tauto.rank(4096, 256)]
    sizes = [tauto.device_working_set(n, k, 4096, 256) for n, k in cands]
    assert min(sizes) > budget
    assert tauto.choose(4096, 256, budget, static=over) == cands[sizes.index(min(sizes))]
    assert tauto.choose(4096, 256, static=over) == cands[0]


def test_auto_memory_reporting_tracks_shape():
    """A reused auto Decoder must not report a stale choice recorded for a
    different shape."""
    d = tfv.build("auto")
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    lh = hmm.log(device="cpu")
    d(lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64)))  # chooses for (48, 40)
    name, kw = tauto.choose(1024, 65536)
    assert d.analytic_memory(K=1024, T=65536) == tfv.build(name, **kw).analytic_memory(
        K=1024, T=65536)


def test_auto_memory_uses_the_padded_k(monkeypatch):
    """decode() reports auto's memory for the choice made at the padded K."""
    seen = []
    real = tbase.Decoder.analytic_memory

    def spy(self, K, T, K_padded=None):
        seen.append((self.name, K, T, K_padded))
        return real(self, K, T, K_padded)

    monkeypatch.setattr(tbase.Decoder, "analytic_memory", spy)
    hmm, y = tfv.make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    r = tfv.decode(hmm, y, "auto", device="cpu", warmup=False)
    assert ("auto", 48, 40, 128) in seen
    name, kw = tauto.choose(128, 40)
    assert r.memory_bytes == real(tfv.build(name, **kw), 48, 40)
    # a shape whose pointer table fits the long-T budget at K but not at Kp
    T = 10000
    K = tauto.LONG_T_PTR_BUDGET // (4 * T)
    Kp = -(-(K + 1) // 128) * 128
    assert T * K * 4 <= tauto.LONG_T_PTR_BUDGET < T * Kp * 4
    auto = tfv.build("auto")
    at_k, at_kp = tauto.choose(K, T), tauto.choose(Kp, T)
    assert at_k != at_kp
    assert real(auto, K, T) == real(tfv.build(*at_k[:1], **at_k[1]), K, T)
    assert real(auto, K, T, Kp) == real(tfv.build(*at_kp[:1], **at_kp[1]), K, T)


@pytest.mark.parametrize("K,M,T,prob,seed", [
    (30, 6, 40, 0.3, 11),
    (70, 9, 120, 0.15, 12),
    (130, 5, 300, 0.1, 13),
])
def test_auto_budgeted_always_exact(K, M, T, prob, seed):
    """Whatever decoder a budget forces auto into, the nothing-fits
    leanest included, the path stays exact, and a satisfiable budget is
    respected."""
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = tfw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    rng = np.random.RandomState(seed)
    budgets = [None] + [int(10 ** rng.uniform(2, 9)) for _ in range(4)]
    for budget in budgets:
        r = tfv.decode(hmm, y, "auto", pad_to=1, device="cpu", warmup=False,
                       memory_budget_bytes=budget)
        np.testing.assert_array_equal(r.path, want, err_msg=f"budget={budget}")
        if budget is not None:
            name, kw = tauto.choose(K, T, memory_budget_bytes=budget)
            ws = tauto.device_working_set(name, kw, K, T)
            if any(tauto.device_working_set(n, k, K, T) <= budget
                   for n, k in tauto.rank(K, T)):
                assert ws <= budget, (name, kw, ws, budget)


@pytest.mark.parametrize("alg,kw", [("vanilla", {}), ("checkpoint", {}), ("fused", {}),
                                    ("flash", {}), ("flash", {"mode": "lean"}),
                                    ("flash_bs", {"beam_width": 16}),
                                    ("beam", {"beam_width": 16}), ("auto", {})])
def test_every_decoder_records_extra_static_keywords(alg, kw):
    """As in the JAX package, each decoder takes keywords it does not use
    (num_segments here) and records them in ``extra``; JAX's use_pallas is
    recorded only, and routes nothing: the path is the same."""
    hmm, y = tfv.make_sparse_hmm(K=40, M=6, T=30, prob=0.25, seed=6)
    base = tfv.decode(hmm, y, alg, device="cpu", warmup=False, **kw)
    got = tfv.decode(hmm, y, alg, num_segments=8, device="cpu", warmup=False, **kw)
    want = jfv.decode(jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, alg, num_segments=8, warmup=False,
                      **kw)
    assert got.extra["num_segments"] == want.extra["num_segments"] == 8
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes
    pallas = tfv.decode(hmm, y, alg, use_pallas=False, device="cpu", warmup=False, **kw)
    assert pallas.extra["use_pallas"] is False
    np.testing.assert_array_equal(pallas.path, base.path)
