"""The traced run's readers on a made-up session: busy time, the metrics,
the lost-records check and the breakdown."""

import json

import pytest

from fvbench import bounds, run, trace
from fvbench.trace import Event

SCAN = "void scan_persistent<1, true, (Emit)0, 31u, float>(float const*, float*)"
WALK = "void backtrack_kernel<4>(int const*, int const*, int*)"


def made_up() -> trace.Trace:
    ops = [Event(SCAN, "kernel", 0.0, 4e-3), Event("Memcpy HtoD", "gpu_memcpy", 4e-3, 1e-4),
           Event(WALK, "kernel", 5e-3, 1e-3), Event("void at::elementwise", "kernel", 5.5e-3, 1e-3),
           Event(SCAN, "kernel", 8e-3, 4e-3), Event(WALK, "kernel", 12e-3, 1e-3)]
    spans = [Event("fvbench.call", "user_annotation", 0.0, 4.05e-3),
             Event("fvbench.copy_out", "user_annotation", 4.1e-3, 2e-3),
             Event("fvbench.host", "user_annotation", 6.5e-3, 1.5e-3)]
    return trace.Trace(ops=ops, spans=spans, window_s=20e-3, sequences=2, floor_s=2e-3)


def test_busy_is_the_union_of_device_operations():
    assert made_up().busy_s == pytest.approx(4e-3 + 1e-4 + 1.5e-3 + 5e-3)


@pytest.mark.parametrize("name, expected", [
    ("kernels_per_seq", 5 / 2),
    ("scan_roofline_pct", 100 * 2e-3 / 8e-3),
    ("walk_ms_per_seq", 1e3 * 2e-3 / 2),
    ("decode_roofline_pct", 100 * 2e-3 / (4e-3 + 1.5e-3 + 5e-3)),
    ("device_idle_pct", 100 * (1 - (4e-3 + 1e-4 + 1.5e-3 + 5e-3) / 20e-3)),
])
def test_metric_readers(name, expected):
    assert run._load("metrics", name).read(made_up()) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["kernels_per_seq", "scan_roofline_pct", "walk_ms_per_seq",
                                  "decode_roofline_pct", "device_idle_pct"])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    empty = trace.Trace(ops=[], spans=[], window_s=1.0, sequences=3, floor_s=1e-3)
    assert run._load("metrics", name).read(empty) is None


BEAM_KERNEL = "void beam_cluster_kernel<64, 16>(float const*, float const*, int*)"
FLASH_BS = {"algorithm": "flash_bs", "beam_width": 64, "num_segments": 8}


def beam_trace(decoder=FLASH_BS) -> trace.Trace:
    """Two FLASH-BS sequences at paper_k3965.beam64_t256's shape: two beam
    scans each (6.4 and 0.9 ms) and a walk."""
    ops = []
    for t0 in (0.0, 10e-3):
        ops += [Event(BEAM_KERNEL, "kernel", t0, 6.4e-3),
                Event(BEAM_KERNEL, "kernel", t0 + 6.5e-3, 0.9e-3),
                Event(WALK, "kernel", t0 + 7.5e-3, 0.02e-3)]
    return trace.Trace(ops=ops, spans=[], window_s=20e-3, sequences=2, floor_s=0.5e-3,
                       K=3965, M=50, T=256, decoder=decoder, card=bounds.H100)


def test_beam_readers():
    busy = 2 * 7.3e-3
    floor, _ = bounds.beam_floor_s(3965, 50, 256, 64, 8)
    roof = run._load("metrics", "beam_roofline_pct").read(beam_trace())
    assert roof == pytest.approx(100 * 2 * floor / busy) and 0 < roof < 1
    # 255 phase-1 steps and the longest segment's 32 (lengths 31-33)
    step = run._load("metrics", "beam_us_per_step").read(beam_trace())
    assert step == pytest.approx(1e6 * busy / (2 * 287))


@pytest.mark.parametrize("name", ["beam_roofline_pct", "beam_us_per_step"])
def test_a_beam_reader_without_a_beam_returns_nothing(name):
    assert run._load("metrics", name).read(made_up()) is None
    assert run._load("metrics", name).read(beam_trace(decoder=None)) is None


def test_lost_records():
    kernels = run._json("", "kernels")
    tr = made_up()
    assert trace.lost_records(tr.ops, {"maxplus_scan": 2, "backtrack_batched": 2}, kernels) == []
    lost = trace.lost_records(tr.ops, {"maxplus_scan": 3, "backtrack_batched": 2}, kernels)
    assert lost and "scan_persistent" in lost[0]
    assert trace.lost_records([], {"argmax_walk": 1}, kernels)


def test_breakdown_names_the_gaps_by_span():
    b = trace.breakdown(made_up())
    assert b["device_ops"][0] == [SCAN[:120], pytest.approx(8e-3)]
    gaps = dict(b["idle_gaps"])
    assert gaps["fvbench.copy_out"] == pytest.approx(5e-3 - 4.1e-3)
    assert gaps["fvbench.host"] == pytest.approx(8e-3 - 6.5e-3)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_read_chrome(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": SCAN, "ts": 10.0, "dur": 5.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "fvbench.call", "ts": 9, "dur": 7},
              {"ph": "X", "cat": "user_annotation", "name": "fvbench.call", "ts": 9, "dur": 7},
              {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 9, "dur": 7},
              {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 1.0, "dur": 1.0},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ops, spans = trace.read_chrome(str(path))
    assert [e.cat for e in ops] == ["gpu_memset", "kernel"]
    assert ops[1].start == pytest.approx(10e-6) and ops[1].dur == pytest.approx(5e-6)
    assert [s.name for s in spans] == ["fvbench.call"]
