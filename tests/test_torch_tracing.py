"""The port's own spans (``utils/profiling.py``): off, a span is one shared
null context; under a ``torch.profiler`` session the decode paths record
their ``fvt.*`` ranges, nested on the calling thread, and the spans show
``auto.choose``'s and ``fused.pointer_route``'s decisions and each time the
host waits on the device; paths are the same with tracing on and off."""

import contextlib
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu_torch.algorithms import auto as tauto
from flash_viterbi_tpu_torch.algorithms import fused as tfused
from flash_viterbi_tpu_torch.algorithms import longform as tlong
from flash_viterbi_tpu_torch.algorithms import sieve_bs as tsbs
from flash_viterbi_tpu_torch.algorithms import sieve_dyn as tsd
from flash_viterbi_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


def _tables(K, M=6, T=12, seed=1, Bs=None):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=0.3, seed=seed)
    lh = hmm.log(device="cpu").padded(128)
    if Bs is None:
        return lh, torch.as_tensor(y)
    g = torch.Generator().manual_seed(seed)
    return lh, torch.randint(0, M, (Bs, T), generator=g)


def _spans(fn, tmp_path):
    """(result of ``fn()``, the ``fvt.*`` spans of a CPU profiler session
    over it as (name, start, end), by start, outer before inner)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e["name"]).startswith("fvt.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The name of the innermost span that holds span ``i``, or None."""
    name, a, b = spans[i]
    holders = [s for j, s in enumerate(spans) if j != i and s[1] <= a and b <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


def _parents(spans):
    return {(s[0], _parent(spans, i)) for i, s in enumerate(spans)}


def test_off_a_span_is_one_shared_null_context(monkeypatch):
    """With no profiler session a span is the same null context every time,
    and a decode makes no ``record_function`` object."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tprof.span("fvt.a") is tprof.span("fvt.b")
    assert isinstance(tprof.span("fvt.a"), contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    lh, y = _tables(100)
    tfv.build("auto")(lh.logA, lh.logB, lh.logPi, y)
    tfused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, torch.stack([y, y.flip(0)]),
                              pointers="recompute")


def test_auto_records_its_spans_nested(tmp_path):
    lh, y = _tables(100)
    dec = tfv.build("auto")
    _, spans = _spans(lambda: dec(lh.logA, lh.logB, lh.logPi, y), tmp_path)
    assert spans[0][0] == "fvt.decode.auto"
    assert _parents(spans) == {
        ("fvt.decode.auto", None),
        ("fvt.auto.choose", "fvt.decode.auto"),
        ("fvt.auto.fused", "fvt.decode.auto"),
        ("fvt.decode.fused", "fvt.auto.fused"),
        ("fvt.emissions", "fvt.decode.fused"),
        ("fvt.kernel.maxplus_scan", "fvt.decode.fused"),
        ("fvt.kernel.backtrack_batched", "fvt.decode.fused"),
        ("fvt.sync", "fvt.decode.fused"),
    }
    names = [s[0] for s in spans]
    assert names.index("fvt.auto.choose") < names.index("fvt.decode.fused")
    assert names[-1] == "fvt.sync"


def test_recomputing_batch_records_the_transposition(tmp_path):
    lh, ys = _tables(100, Bs=5)
    _, spans = _spans(lambda: tfused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, ys,
                                                        pointers="recompute"), tmp_path)
    assert _parents(spans) == {
        ("fvt.decode.fused", None),
        ("fvt.emissions", "fvt.decode.fused"),
        ("fvt.kernel.maxplus_scan_deltas", "fvt.decode.fused"),
        ("fvt.transpose", "fvt.decode.fused"),
        ("fvt.kernel.argmax_walk", "fvt.decode.fused"),
        ("fvt.sync", "fvt.decode.fused"),
    }


@pytest.mark.parametrize("N, phases", [
    (1, ["fvt.flash_long.phase_a", "fvt.flash_long.phase_b"]),
    (4, ["fvt.flash_long.phase_a", "fvt.flash_long.phase_b", "fvt.flash_long.phase_2"]),
])
def test_flash_long_batched_records_its_phases_in_order(N, phases, tmp_path):
    lh, ys = _tables(100, T=40, Bs=3)
    _, spans = _spans(lambda: tlong.flash_decode_long_batched(
        lh.logA, lh.logB, lh.logPi, ys, num_segments=N, group_steps=16), tmp_path)
    got = [s for s in spans if s[0].startswith("fvt.flash_long.")]
    assert [s[0] for s in got] == phases
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    rel = _parents(spans)
    assert {p for p in phases} <= {n for n, parent in rel if parent == "fvt.decode.flash_long"}
    # the scans' emission rows are gathered in the phases, a group a span
    assert ("fvt.emissions", "fvt.flash_long.phase_a") in rel
    assert ("fvt.emissions", "fvt.flash_long.phase_b") in rel
    assert ("fvt.kernel.argmax_walk", "fvt.flash_long.phase_b") in rel
    assert ("fvt.sync", "fvt.decode.flash_long") in rel


@pytest.mark.parametrize("N", [1, 4])
def test_flash_long_single_records_phases_1_and_2(N, tmp_path):
    lh, y = _tables(100, T=40)
    _, spans = _spans(lambda: tlong.flash_decode_long(lh.logA, lh.logB, lh.logPi, y,
                                                      num_segments=N, group_steps=16), tmp_path)
    got = [s[0] for s in spans if s[0].startswith("fvt.flash_long.")]
    assert got == ["fvt.flash_long.phase_1"] + (["fvt.flash_long.phase_2"] if N > 1 else [])
    assert ("fvt.transpose" in [s[0] for s in spans]) == (N > 1)


def _names(spans):
    """How many of each span name."""
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("K, budget", [(100, None), (1300, None), (100, 1)])
def test_auto_counts_its_decision(K, budget, tmp_path):
    """Each call ``auto`` sends on is a ``fvt.auto.<decoder>`` span, the
    decoder ``choose`` named, inside the call's ``fvt.decode.auto``."""
    lh, y = _tables(K, T=8)
    dec = tfv.build("auto", memory_budget_bytes=budget)

    def twice():
        for _ in range(2):
            dec(lh.logA, lh.logB, lh.logPi, y)

    _, spans = _spans(twice, tmp_path)
    name, _ = tauto.choose(lh.Kp, int(y.shape[0]), budget)
    got = _names(spans)
    sent = {n: c for n, c in got.items() if n.startswith("fvt.auto.") and n != "fvt.auto.choose"}
    assert got["fvt.decode.auto"] == 2 and got["fvt.auto.choose"] == 2
    assert sent == {f"fvt.auto.{name}": 2}
    assert (f"fvt.auto.{name}", "fvt.decode.auto") in _parents(spans)
    if name == "fused":
        scan = {"store": "fvt.kernel.maxplus_scan",
                "recompute": "fvt.kernel.maxplus_scan_deltas"}[tfused.pointer_route(lh.Kp)]
        assert got[scan] == 2 and got["fvt.sync"] == 2
        assert got.get("fvt.transpose", 0) == (2 if scan.endswith("deltas") else 0)


@pytest.mark.parametrize("Bs, pointers", [(2, "auto"), (5, "auto"), (1, "auto"),
                                          (3, "store"), (3, "recompute")])
def test_fused_counts_its_route_and_one_sync_a_call(Bs, pointers, tmp_path):
    """The route a batch takes shows as its scan's span, and the host
    waits on the device once a call."""
    lh, ys = _tables(100, Bs=Bs)
    _, spans = _spans(lambda: tfused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, ys,
                                                        pointers=pointers), tmp_path)
    route = tfused.pointer_route(lh.Kp, Bs) if pointers == "auto" else pointers
    walk = {"store": {"fvt.kernel.maxplus_scan": 1, "fvt.kernel.backtrack_batched": 1},
            "recompute": {"fvt.kernel.maxplus_scan_deltas": 1, "fvt.transpose": 1,
                          "fvt.kernel.argmax_walk": 1}}[route]
    assert _names(spans) == {"fvt.decode.fused": 1, "fvt.emissions": 1, "fvt.sync": 1, **walk}


def test_device_rows_leave_out_the_spans_device_rows():
    """A range that launched device work has a CUDA row of its own (its
    length on the device): ``device_rows`` keeps the kernels only."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, device_type, device_us, annotation):
        return SimpleNamespace(key=key, device_type=device_type, count=1,
                               self_device_time_total=device_us, is_user_annotation=annotation)

    kernel = row("scan_persistent", cuda, 3500.0, False)
    rows = [kernel, row("fvt.decode.fused", cuda, 3600.0, True),
            row("fvt.decode.fused", cpu, 0.0, True), row("aten::empty", cpu, 0.0, False),
            row("cudaLaunchKernel", cuda, 0.0, False)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert tprof.device_rows(prof) == [kernel]


def test_flash_long_keeps_its_transposed_table(tmp_path):
    """``flash_long``'s decoder makes the walk's transposed table once for
    the tables it is called on again; the default makes it each call."""
    lh, ys = _tables(100, T=40, Bs=2)
    batch_fn = tfv.build("flash_long", num_segments=1).batch_fn

    def calls():
        for _ in range(3):
            batch_fn(lh.logA, lh.logB, lh.logPi, ys)
        tlong.flash_decode_long_batched(lh.logA, lh.logB, lh.logPi, ys, num_segments=1)

    _, spans = _spans(calls, tmp_path)
    got = _names(spans)
    assert got["fvt.transpose"] == 2
    assert got["fvt.sync"] == got["fvt.decode.flash_long"] == 4


@pytest.mark.parametrize("decoder", ["sieve_bs", "sieve", "sieve_dag"])
def test_sieve_read_backs_are_syncs(decoder, tmp_path):
    """The SIEVE decoders read their levels (and their searches' progress)
    back to the host: each read is a ``fvt.sync``, at least one a level."""
    lh, y = _tables(24, M=4, T=12, seed=3)
    stats: dict = {}
    if decoder == "sieve_bs":
        def run():
            return tsbs.sieve_bs_decode(lh.logA, lh.logB, lh.logPi, y, beam_width=4, stats=stats)
    else:
        def run():
            return tsd.sieve_dynamic_decode(lh.logA, lh.logB, lh.logPi, y,
                                            dag=decoder == "sieve_dag", stats=stats)
    off = run()
    on, spans = _spans(run, tmp_path)
    assert on == off
    syncs = [s for s in spans if s[0] == "fvt.sync"]
    assert len(syncs) >= stats["levels"] >= 1
    assert {p for n, p in _parents(spans) if n == "fvt.sync"} == {None}


def _paths(case):
    lh, ys = _tables(100, T=40, Bs=4)
    tables = (lh.logA, lh.logB, lh.logPi)
    if case == "auto":
        return tfv.build("auto")(*tables, ys[0])
    if case in ("store", "recompute"):
        return tfused.fused_decode_batch(*tables, ys, pointers=case)
    return tlong.flash_decode_long_batched(*tables, ys, num_segments=int(case[-1]),
                                           group_steps=16)


@pytest.mark.parametrize("case", ["auto", "store", "recompute", "flash_long1", "flash_long4"])
def test_paths_are_the_same_traced_and_not(case, tmp_path):
    off = _paths(case)
    on, spans = _spans(lambda: _paths(case), tmp_path)
    assert spans and torch.equal(on, off) and on.dtype == off.dtype


def _x(name, cat, ts, dur, corr=None):
    """A complete Chrome trace event (times in µs)."""
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            **({"args": {"correlation": corr}} if corr is not None else {})}


def _made_up_session():
    """One request in a made-up session: ``auto`` sends on to ``fused``; the
    emission gather (a PyTorch kernel) is launched at 26 µs, the port's scan
    at 45 µs, one copy at 125 µs outside every port span."""
    return [
        _x("fvbench.call", "user_annotation", 0, 100),
        _x("fvt.decode.auto", "user_annotation", 10, 80),
        _x("fvt.auto.choose", "user_annotation", 12, 8),
        _x("fvt.auto.fused", "user_annotation", 21, 68),
        _x("fvt.decode.fused", "user_annotation", 22, 66),
        _x("fvt.emissions", "user_annotation", 24, 6),
        _x("fvt.kernel.maxplus_scan", "user_annotation", 34, 16),
        _x("fvt.sync", "user_annotation", 82, 5),
        _x("fvbench.copy_out", "user_annotation", 124, 12),
        _x("cudaLaunchKernel", "cuda_runtime", 26, 2, corr=1),
        _x("cudaLaunchCooperativeKernel", "cuda_runtime", 45, 3, corr=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 125, 1, corr=3),
        _x("index_elementwise_kernel", "kernel", 31, 2, corr=1),
        _x("void scan_persistent<1, true>(ScanArgs)", "kernel", 52, 28, corr=2),
        _x("Memcpy DtoH", "gpu_memcpy", 130, 1, corr=3),
        _x("fvt.decode.fused", "gpu_user_annotation", 31, 49),
    ]


def test_trace_spans_reads_a_made_up_session():
    """The span reader's figures, worked by hand: idle in the port span
    [10, 90] µs is [10, 31], [33, 52] before the scan starts and [80, 90]
    after; each idle piece goes to the innermost span open over it."""
    from scripts import torch_trace_spans as tts

    got = tts.read(tts.load(_made_up_session()), sequences=1, port_rx=tts.port_pattern())
    approx = lambda v: pytest.approx(v, abs=1e-9)  # noqa: E731
    assert got["requests"] == 1 and got["ops"] == 3 and got["ops_without_launch"] == 0
    assert got["busy_ms"] == approx(0.031)
    assert got["host_prelaunch_ms"] == approx(0.040)
    assert got["call_gap_ms"] == approx(0.010)
    assert got["idle_in_port_ms"] == approx(0.050)
    # [33, 52]; the midpoint of [80, 130] lies after the call's end
    assert got["idle_in_call_ms"] == approx(0.019)
    assert got["port_gaps_ms"] == {
        "fvt.kernel.maxplus_scan": approx(0.016), "fvt.auto.choose": approx(0.008),
        "fvt.emissions": approx(0.006), "fvt.decode.fused": approx(0.009),
        "fvt.sync": approx(0.005), "fvt.decode.auto (own)": approx(0.004),
        "fvt.auto.fused": approx(0.002)}
    assert got["device_ms_per_seq"] == {
        "fvt.decode.auto": approx(0.030), "fvt.auto.fused": approx(0.030),
        "fvt.decode.fused": approx(0.030), "fvt.kernel.maxplus_scan": approx(0.028),
        "fvt.emissions": approx(0.002)}
    assert got["spans_per_request"]["fvt.auto.fused"] == 1.0
    assert got["syncs_per_seq"] == 1.0


def test_trace_spans_reads_saved_traces_again(tmp_path, capsys):
    """``--read DIR`` reads ``<tag>.json.gz`` beside ``<tag>.meta.json``."""
    import gzip

    from scripts import torch_trace_spans as tts

    tag = tmp_path / "paper_k3965.single_t256.7"
    with gzip.open(f"{tag}.json.gz", "wt") as f:
        json.dump({"traceEvents": _made_up_session()}, f)
    meta = {"cell": "paper_k3965.single_t256", "seed": 7, "sequences": 2, "window_s": 1e-4,
            "launches": {"maxplus_scan": 1, "backtrack_batched": 0}}
    (tmp_path / "paper_k3965.single_t256.7.meta.json").write_text(json.dumps(meta))
    assert tts.main(["--read", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["tag"] == "paper_k3965.single_t256.7" and line["seed"] == 7
    assert line["syncs_per_seq"] == 0.5
    assert line["host_prelaunch_ms"] == pytest.approx(0.040)
    assert line["lost_records"] == []
    # a backtrack launched that the session did not record
    meta["launches"]["backtrack_batched"] = 1
    (tmp_path / "paper_k3965.single_t256.7.meta.json").write_text(json.dumps(meta))
    tts.main(["--read", str(tmp_path)])
    lost = json.loads(capsys.readouterr().out.strip())["lost_records"]
    assert lost and "backtrack_kernel" in lost[0]
