"""The port's tools against the JAX package's: re-dispatch (and
``decode(..., retries=n)``), the preprocessing cache, the phase timer and
the profiling reports' keys."""

import json
import os

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.utils import cache as jcache
from flash_viterbi_tpu.utils import failsafe as jfail
from flash_viterbi_tpu.utils import profiling as jprof
from flash_viterbi_tpu_torch.algorithms import base
from flash_viterbi_tpu_torch.utils import cache as tcache
from flash_viterbi_tpu_torch.utils import failsafe as tfail
from flash_viterbi_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

SMALL = dict(K=48, M=8, T=40, prob=0.2, seed=3)


class Flaky:
    """Raises ``exc`` on its first ``fails`` calls, then returns the call count."""

    def __init__(self, fails: int, exc=RuntimeError):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc(f"transient {self.calls}")
        return self.calls


@pytest.mark.parametrize("mod", [jfail, tfail], ids=["jax", "port"])
def test_with_redispatch_retries_runtime_errors(mod):
    fn = Flaky(2)
    assert mod.with_redispatch(fn, retries=2, backoff_s=0) == 3 and fn.calls == 3
    fn = Flaky(3)
    with pytest.raises(RuntimeError, match="transient 3"):  # the last error
        mod.with_redispatch(fn, retries=2, backoff_s=0)
    assert fn.calls == 3
    fn = Flaky(1, torch.AcceleratorError if mod is tfail else RuntimeError)
    assert mod.with_redispatch(fn, retries=1, backoff_s=0) == 2


@pytest.mark.parametrize("mod", [jfail, tfail], ids=["jax", "port"])
def test_with_redispatch_does_not_retry_other_errors(mod):
    fn = Flaky(1, ValueError)
    with pytest.raises(ValueError):
        mod.with_redispatch(fn, retries=3, backoff_s=0)
    assert fn.calls == 1
    fn = Flaky(1)
    with pytest.raises(RuntimeError):
        mod.with_redispatch(fn, retries=3, backoff_s=0, on=(KeyError,))
    assert fn.calls == 1


def test_torch_cuda_errors_are_transient():
    assert issubclass(torch.AcceleratorError, tfail.TRANSIENT)
    assert issubclass(torch.OutOfMemoryError, tfail.TRANSIENT)


@pytest.mark.parametrize("alg", ["fused", "flash"])
def test_decode_with_retries_equals_decode(alg):
    hmm, y = tfv.make_sparse_hmm(**SMALL)
    plain = tfv.decode(hmm, y, alg, device="cpu")
    retried = tfv.decode(hmm, y, alg, retries=2, device="cpu")
    np.testing.assert_array_equal(retried.path, plain.path)
    assert retried.memory_bytes == plain.memory_bytes
    jax = jfv.decode(jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, alg, retries=2, warmup=False)
    np.testing.assert_array_equal(retried.path, jax.path)


def _flaky_decoder(monkeypatch, fails: int):
    """Register ``flaky``: fused whose first ``fails`` calls raise a
    RuntimeError; returns the call log (the device of each call)."""
    calls = []

    def factory(**static):
        dec = base.build("fused")

        def fn(*tables):
            calls.append(tables[0].device.type)
            if len(calls) <= fails:
                raise RuntimeError("launch failed")
            return dec(*tables)

        return base.Decoder("flaky", fn, static, dec._memory_fn)

    monkeypatch.setitem(base._REGISTRY, "flaky", factory)
    monkeypatch.setattr(tfail.time, "sleep", lambda s: None)
    return calls


def test_decode_retries_on_the_same_device(monkeypatch):
    hmm, y = tfv.make_sparse_hmm(**SMALL)
    calls = _flaky_decoder(monkeypatch, fails=2)
    r = tfv.decode(hmm, y, "flaky", retries=2, device="cpu")
    np.testing.assert_array_equal(r.path, tfv.decode(hmm, y, "fused", device="cpu").path)
    assert calls == ["cpu"] * 4  # two failures and the warmup's success, the timed call


def test_decode_fails_fast_and_raises_the_last_error(monkeypatch):
    hmm, y = tfv.make_sparse_hmm(**SMALL)
    calls = _flaky_decoder(monkeypatch, fails=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfv.decode(hmm, y, "flaky", device="cpu")  # retries=0: no second call
    assert calls == ["cpu"]
    calls = _flaky_decoder(monkeypatch, fails=10)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfv.decode(hmm, y, "flaky", retries=2, device="cpu")
    assert calls == ["cpu"] * 3


def test_cached_log_tables_match_jax(tmp_path):
    hmm, _ = tfv.make_sparse_hmm(**SMALL)
    jhmm = jfv.HMM(hmm.A, hmm.B, hmm.Pi)
    want = jhmm.log()
    first = tcache.cached_log_tables(hmm, str(tmp_path), device="cpu", T=40, prob=0.2)
    (name,) = os.listdir(tmp_path)
    assert name == "logtables_K48_M8_T40_prob0.2.npz"
    second = tcache.cached_log_tables(hmm, str(tmp_path), device="cpu", T=40, prob=0.2)
    jax_read = jcache.cached_log_tables(jhmm, str(tmp_path), T=40, prob=0.2)
    for got in (first, second):
        assert isinstance(got, tfv.LogHMM) and got.K == 48 and got.logA.device.type == "cpu"
        for field in ("logA", "logB", "logPi"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(want, field))
            np.testing.assert_array_equal(getattr(jax_read, field), getattr(want, field))
    # a file the JAX package wrote reads back the same
    jdir = tmp_path / "jax"
    jcache.cached_log_tables(jhmm, str(jdir), T=40)
    again = tcache.cached_log_tables(hmm, str(jdir), device="cpu", T=40)
    np.testing.assert_array_equal(again.logA.numpy(), want.logA)


def test_cached_log_tables_default_to_the_card(tmp_path, monkeypatch):
    hmm, _ = tfv.make_sparse_hmm(**SMALL)
    tcache.cached_log_tables(hmm, str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcache.cached_log_tables(hmm, str(tmp_path))


def _adjacency_view(adj):
    pi, out, inn, acoustic = adj
    return (np.asarray(pi), out, inn,
            [(np.asarray(a.logb), np.asarray(a.pos)) for a in acoustic])


def test_cached_adjacency_matches_jax(tmp_path):
    hmm, _ = tfv.make_sparse_hmm(**SMALL)
    want = _adjacency_view(jcache.cached_adjacency(hmm.A, hmm.B, str(tmp_path / "jax"),
                                                   T=40))
    first = tcache.cached_adjacency(hmm.A, hmm.B, str(tmp_path), T=40)
    assert sorted(os.listdir(tmp_path)) == ["adjacency_K48_M8_T40.pkl", "jax"]
    second = tcache.cached_adjacency(hmm.A, hmm.B, str(tmp_path), T=40)
    assert type(second[3][0]).__module__ == "flash_viterbi_tpu_torch.oracle.sieve_bs"
    for got in (first, second):
        got = _adjacency_view(got)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[2] == want[2]
        for (gb, gp), (wb, wp) in zip(got[3], want[3]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gp, wp)


def test_phase_timer_matches_jax():
    phases = {"phase1": 0.5, "segments": 0.25, "backtrack": 0.25}
    reports = []
    for mod in (jprof, tprof):
        timer = mod.PhaseTimer()
        for name in phases:
            with timer.phase(name):
                pass
        timer.phases.update(phases)
        reports.append((timer.report(), timer.report(K=4, T=8), timer.json(K=4, T=8)))
    assert reports[1] == reports[0]
    assert reports[1][1]["trellis_updates_per_s"] == 4 * 4 * 8 / 1.0
    assert list(reports[1][0]["phases"]) == list(phases)


def test_profile_flash_keys_on_the_cpu():
    hmm, y = tfv.make_sparse_hmm(**SMALL)
    rep = tprof.profile_flash(hmm, y, num_segments=4, reps=1, device="cpu")
    assert set(rep) == {"phase1_s", "phase2_and_backtrack_s", "total_s",
                        "trellis_updates_per_s", "num_segments"}
    assert rep["num_segments"] == 4 and rep["phase1_s"] > 0 and rep["total_s"] > 0
    assert rep["trellis_updates_per_s"] == 48 * 48 * 40 / rep["total_s"]


def test_memory_report_keys_match_jax_on_the_cpu():
    want = jprof.memory_report(jfv.build("fused"), K=48, T=40)
    got = tprof.memory_report(tfv.build("fused"), K=48, T=40, device="cpu")
    assert got == {"analytic_bytes": want["analytic_bytes"], "live_array_bytes": 0}
    assert set(got) == set(want)
    assert tprof.memory_report(device="cpu") == {"live_array_bytes": 0}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    hmm, y = tfv.make_sparse_hmm(**SMALL)
    with tprof.device_trace(str(tmp_path / "trace")):
        tfv.decode(hmm, y, "fused", device="cpu", warmup=False)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert events
    # the port's own spans are in the same file, on the same clock
    spans = {e["name"] for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("fvt.")}
    assert {"fvt.decode.fused", "fvt.emissions", "fvt.kernel.maxplus_scan",
            "fvt.kernel.backtrack_batched", "fvt.sync"} <= spans
