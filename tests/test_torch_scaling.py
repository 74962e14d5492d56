"""The port's scaling model against the JAX package's, field for field
under equal constants, on its own H100 constants, and its parity sweep
over gloo CPU ranks against JAX's virtual mesh."""

import numpy as np
import pytest

from flash_viterbi_tpu.parallel import scaling as jsc
from flash_viterbi_tpu_torch.parallel import scaling as tsc

CONFIG5 = dict(K=16384, T=65536, batch=256)
CONFIG5_SHAPES = [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 8), (4, 4, 4), (8, 2, 1), (4, 2, 2)]
# (the JAX package's tests' cases) mesh shape, keywords of analyze
CASES = ([(shape, CONFIG5) for shape in CONFIG5_SHAPES]
         + [((1, 4, 1), dict(K=1024, T=4096, batch=1)),
            ((1, 1, 1), dict(K=1024, T=4096, batch=1)),
            ((2, 2, 2), dict(K=64, T=64, batch=8, num_segments=8)),
            ((1, 4, 2), dict(K=64, T=64, batch=8, microbatch=2, num_segments=8)),
            ((2, 1, 4), dict(K=64, T=64, batch=8, num_segments=4)),
            ((1, 2, 1), dict(K=3965, T=256, batch=16, microbatch=4))])
RATES = dict(chip_updates_per_s=2.5e11, ici_bytes_per_s=7.0e10)
# the fused decode on the headline tables, NVIDIA H100 80GB HBM3, 700.00 W
# (PERF.md section 5): (K, T, seconds)
H100_FUSED = [(3965, 256, 3.812e-3), (3965, 16384, 228.059e-3)]


@pytest.mark.parametrize("shape,kw", CASES)
def test_analyze_equals_jax_under_equal_constants(shape, kw):
    assert tsc.analyze(shape, **kw, **RATES).as_dict() == jsc.analyze(shape, **kw,
                                                                       **RATES).as_dict()


@pytest.mark.parametrize("shape,kw", CASES)
def test_work_report_equals_jax(shape, kw):
    """Every counter equal; the modeled efficiency is each package's own
    constants' (the port's: its analyze at its defaults)."""
    got, want = tsc.work_report(shape, **kw), jsc.work_report(shape, **kw)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "modeled_efficiency"} == \
        {k: v for k, v in want.items() if k != "modeled_efficiency"}
    assert got["modeled_efficiency"] == tsc.analyze(shape, **kw).modeled_efficiency


@pytest.mark.parametrize("shape,kw,match", [
    ((3, 1, 1), dict(K=64, T=64, batch=8), "data axis"),
    ((2, 1, 1), dict(K=64, T=64, batch=8, microbatch=3), "microbatch 3"),
])
def test_analyze_refuses_what_cannot_run(shape, kw, match):
    for mod in (jsc, tsc):
        with pytest.raises(ValueError, match=match):
            mod.analyze(shape, **kw)


def test_constants_are_the_cards():
    """The H100's rate and NVLink's published figure, not the TPU's."""
    assert tsc.CHIP_UPDATES_PER_S == 1.13e12 != jsc.CHIP_UPDATES_PER_S
    assert tsc.NVLINK_BYTES_PER_S == 4.5e11 != jsc.ICI_BYTES_PER_S
    assert tsc.analyze((1, 1, 2), **CONFIG5).comm_s == pytest.approx(
        tsc.analyze((1, 1, 2), **CONFIG5).ici_bytes_per_device / 4.5e11)


@pytest.mark.parametrize("shape", CONFIG5_SHAPES)
def test_config5_target_on_the_cards_constants(shape):
    r = tsc.analyze(shape, **CONFIG5)
    assert r.modeled_efficiency >= 0.8, r.modeled_efficiency
    assert r.ici_bytes_per_device > 0 and r.ptr_bytes_per_device > 0


def test_single_sequence_stays_honest():
    assert tsc.analyze((1, 4, 1), K=1024, T=4096, batch=1).modeled_efficiency < 0.6


@pytest.mark.parametrize("K,T,wall", H100_FUSED)
def test_single_chip_wall_model_calibrated_to_the_h100(K, T, wall):
    m = tsc.single_chip_wall_model(K, T)
    assert abs(m - wall) / wall < 0.25, (K, T, m, wall)


def test_common_segments_rule():
    assert tsc.common_segments([(1, 1, 1), (2, 2, 2), (1, 2, 4)], 32) == 8
    assert tsc.common_segments([(1, 3, 1), (1, 2, 1)], 64) == 6
    with pytest.raises(ValueError, match="too short"):
        tsc.common_segments([(1, 4, 1), (1, 3, 1)], 16)


def test_measure_virtual_equals_jax():
    """Each mesh as gloo CPU ranks against JAX's virtual mesh: equal paths
    on every shape, equal counters."""
    shapes = [(1, 1, 1), (2, 2, 2), (1, 2, 4)]
    got = tsc.measure_virtual(shapes, K=48, T=32, batch=4, device="cpu")
    want = jsc.measure_virtual(shapes, K=48, T=32, batch=4)
    assert [r["paths_equal"] for r in got] == [True] * 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k != "modeled_efficiency"} == \
            {k: v for k, v in w.items() if k != "modeled_efficiency"}
        assert np.isfinite(g["modeled_efficiency"]) and g["updates_per_device"] > 0
