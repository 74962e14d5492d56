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
from flash_viterbi_tpu_torch.algorithms import checkpoint as tck
from flash_viterbi_tpu_torch.algorithms import flash as tflash
from flash_viterbi_tpu_torch.oracle import framework as tfw

torch.set_num_threads(2)

KWS = [("flash", {}), ("flash", {"num_segments": 16}), ("flash_long", {}),
       ("flash", {"mode": "lean"}), ("flash", {"mode": "lean", "num_segments": 16}),
       ("flash", {"mode": "lean", "lean_leaf": 0}),
       ("flash", {"mode": "lean", "lean_leaf": 4, "num_segments": 3}),
       ("checkpoint", {}), ("checkpoint", {"step": 5}), ("fused", {}), ("vanilla", {}),
       ("flash_bs", {"beam_width": 64}), ("beam", {"beam_width": 8}), ("sieve_mp", {})]


@pytest.mark.parametrize("name,kw", KWS)
def test_device_working_set_matches_jax(name, kw, monkeypatch):
    """JAX's formulas at the port's figures: checkpoint's default step is
    the port's ``snapshot_step`` (passed to JAX explicitly), lean's chunk
    and leaf lanes the port's (patched into JAX's module)."""
    for n in ("LEAN_CHUNK", "LEAF_LANES", "LEAN_LEAF"):
        monkeypatch.setattr(jauto, n, getattr(tflash, n))
    for K in (64, 1024, 3968, 16384):
        for T in (1, 16, 255, 256, 2048, 16384, 65536):
            jkw = kw
            if name == "checkpoint" and not kw.get("step"):
                jkw = {**kw, "step": tck.snapshot_step(T)}
            assert (tauto.device_working_set(name, kw, K, T)
                    == jauto.device_working_set(name, jkw, K, T)), (K, T)


#: peak device bytes above the tables over one decode after a warm-up
#: (``tests/test_torch_auto_card.py`` on NVIDIA H100 80GB HBM3, 700 W; M=50)
H100_PEAKS = {
    (3968, 256): [12336128, 88387584, 7083520, 69352448],
    (3968, 1024): [37785600, 138484224, 7194112, 93745152],
    (3968, 4096): [134279168, 332277248, 7636480, 126397440],
    (16384, 256): [38865920, 1162752000, 1103636480, 17109504],
    (16384, 1024): [138617856, 1365146112, 1201573888, 16600576],
    (16384, 4096): [541312512, 2170529280, 18234880, 1343409664],
    (3968, 16384): [524447744, 9405952, 205101568],
}


@pytest.mark.parametrize("K,T", sorted(H100_PEAKS))
def test_device_peak_bytes_against_the_h100(K, T):
    """Each candidate's figure holds the peak the card read for it (in
    ``rank``'s order), within 1.25x of it + 2 MiB."""
    for (name, kw), got in zip(tauto.rank(K, T), H100_PEAKS[K, T], strict=True):
        fig = tauto.device_peak_bytes(name, kw, K, T, 50, 132)
        assert got <= fig <= 1.25 * got + 2 * 2**20, (name, kw, got, fig)


def test_a_32_mib_budget_takes_checkpoint_at_config5():
    """config-5's shape under 32 MiB: fused (516 MiB on the card), flash at
    16 segments (2070) and lean (1281) do not fit; checkpoint (17.4) does.
    A budget between fused's JAX figure and what the card holds for it no
    longer takes fused."""
    assert tauto.choose(16384, 4096, 33_554_432) == ("checkpoint", {})
    assert tauto.choose(16384, 4096, 33_554_432, M=50) == ("checkpoint", {})
    jax_fused = tauto.device_working_set("fused", {}, 16384, 4096)
    card = H100_PEAKS[16384, 4096][0]
    assert jax_fused < card
    for budget in (jax_fused + 2**20, (jax_fused + card) // 2, card - 1):
        assert tauto.choose(16384, 4096, budget, M=50) == ("checkpoint", {})
    assert tauto.choose(16384, 4096, 2 * card, M=50) == ("fused", {})
    # lean is never the leanest candidate at this shape
    peaks = {n + str(kw.get("mode", "")): tauto.device_peak_bytes(n, kw, 16384, 4096, 50)
             for n, kw in tauto.rank(16384, 4096)}
    assert min(peaks, key=peaks.get) == "checkpoint" and peaks["flashlean"] > peaks["fused"]


def test_memory_report_says_what_the_budget_held():
    """A budgeted ``auto``'s report gives the budget, the candidate it
    chooses and the figure held against the budget; others give none."""
    from flash_viterbi_tpu_torch.utils.profiling import memory_report

    got = memory_report(tfv.build("auto", memory_budget_bytes=33_554_432), K=16384, T=4096,
                        device="cpu", M=50)
    assert got["budget_bytes"] == 33_554_432 and got["chosen"] == ["checkpoint", {}]
    assert got["budget_figure_bytes"] == tauto.device_peak_bytes("checkpoint", {}, 16384, 4096,
                                                                 50)
    assert got["budget_figure_bytes"] <= got["budget_bytes"]
    assert "budget_bytes" not in memory_report(tfv.build("auto"), K=16384, T=4096, device="cpu")


@pytest.mark.parametrize("name,kw", KWS)
def test_device_peak_bytes_counts_at_least_jax(name, kw):
    """The card-held figure counts at least JAX's formula where the decode
    holds what that formula counts, and what the formula leaves out.  Lean's
    formula is the budget its calls are sized under (``lean_working_set``),
    and a call takes fewer lanes than fill it (the card: 195.6 MiB at
    K=3968, T=16384 against the formula's 252.2), so there the figure is
    held to what the formula leaves out: the leaves' transposed (K, K)
    table and phase 1's chunk.  A checkpoint step past T-1 makes no chunk."""
    lean = name == "flash" and kw.get("mode") == "lean"
    for K in (64, 1024, 3968, 16384):
        for T in (1, 16, 255, 256, 2048, 16384, 65536):
            got = tauto.device_peak_bytes(name, kw, K, T)
            if lean:
                chunk = 2 * min(tflash.LEAN_CHUNK, T - 1) * K * 4
                leaves = kw.get("lean_leaf", tflash.LEAN_LEAF) > 0 and T > 1
                assert got >= chunk + (K * K * 4 if leaves else 0), (K, T)
            elif name != "checkpoint" or kw.get("step", 0) < T:
                assert got >= tauto.device_working_set(name, kw, K, T), (K, T)
    if name == "fused":
        assert tauto.device_peak_bytes(name, kw, 16384, 4096, 50) >= H100_PEAKS[16384, 4096][0]


def test_h100_order():
    """rank's order as measured on the H100 (scripts/torch_auto_sweep.py,
    results/torch_auto_sweep.jsonl, PERF.md's "Routing figures")."""
    fused, ck, lean = ("fused", {}), ("checkpoint", {}), ("flash", {"mode": "lean"})
    flash = ("flash", {"num_segments": 16})
    for K, T, want in [
        (3968, 8, [fused, ck]),
        (256, 16, [fused, ck]),
        (16384, 16, [fused, ck]),
        (256, 32, [fused, ck]),
        (3968, 256, [fused, flash, ck, lean]),
        (8192, 32, [fused, ck]),
        (6016, 64, [fused, flash, ck, lean]),
        (12032, 64, [fused, flash, lean, ck]),
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
    """Lean's JAX working set falls below fused's with many short segments,
    but the decode keeps the (K, K) transposed table its leaves walk, and
    the budget is held to what the card holds (``device_peak_bytes``):
    there lean is no leaner than fused, so a budget of lean's JAX figure
    takes checkpoint, which follows lean in the order, and a budget of
    lean's own figure takes fused, which leads it."""
    K, T, over = 8192, 1024, {"num_segments": 128}
    lean = tauto.device_working_set("flash", {"mode": "lean", **over}, K, T)
    assert lean < tauto.device_working_set("fused", over, K, T)
    peak = {"lean": tauto.device_peak_bytes("flash", {"mode": "lean", **over}, K, T),
            "fused": tauto.device_peak_bytes("fused", over, K, T),
            "checkpoint": tauto.device_peak_bytes("checkpoint", over, K, T)}
    assert peak["lean"] > K * K * 4 > peak["fused"] > lean > peak["checkpoint"]
    assert tauto.choose(K, T, lean, static=over) == ("checkpoint", over)
    assert tauto.choose(K, T, peak["lean"], static=over) == ("fused", over)


def test_budget_filter_sees_the_overrides():
    """Overrides are merged before the filter; nothing fitting takes the
    leanest candidate, never a crash."""
    ws = {n: tauto.device_peak_bytes(n, kw, 4096, 256) for n, kw in tauto.rank(4096, 256)}
    name, kw = tauto.choose(4096, 256, memory_budget_bytes=1)
    assert tauto.device_peak_bytes(name, kw, 4096, 256) == min(ws.values())
    name, kw = tauto.choose(4096, 256, memory_budget_bytes=1, static={"num_segments": 32})
    assert kw["num_segments"] == 32
    # checkpoint fits its own figure; with a step override its snapshots
    # no longer do, so nothing fits and the leanest is taken
    budget = tauto.device_peak_bytes("checkpoint", {}, 4096, 256)
    assert tauto.choose(4096, 256, budget)[0] == "checkpoint"
    over = {"step": 1}
    cands = [(n, {**k, **over}) for n, k in tauto.rank(4096, 256)]
    sizes = [tauto.device_peak_bytes(n, k, 4096, 256) for n, k in cands]
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
            name, kw = tauto.choose(K, T, memory_budget_bytes=budget, M=M)
            ws = tauto.device_peak_bytes(name, kw, K, T, M)
            if any(tauto.device_peak_bytes(n, k, K, T, M) <= budget
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
