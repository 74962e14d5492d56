"""The floor's arithmetic at the four cells' shapes."""

import pytest

from fvbench import bounds


@pytest.mark.parametrize("K, T, Bs, floor_s", [
    (3965, 256, 1, 0.2397e-3),    # paper_k3965.single_t256
    (16384, 4096, 16, 1.0515),    # config5_k16384.batch16_t4096
    (3965, 256, 16, 3.835e-3),    # paper_k3965.batch16_t256
    (16384, 4096, 1, 65.72e-3),   # config5_k16384.single_t4096
])
def test_floor_at_the_cells(K, T, Bs, floor_s):
    got, by = bounds.floor_s(K, 50, T, Bs)
    assert by == "operations"
    assert got == pytest.approx(floor_s, rel=1e-3)


def test_floor_by_bytes_where_there_is_little_work():
    got, by = bounds.floor_s(4096, 50, 2, 1)
    assert by == "bytes"
    assert got == pytest.approx((4 * (4096 * 4096 + 4096 * 50 + 4096) + 16) / 3.35e12)


def test_cells_rate_is_half_the_fma_peak():
    assert bounds.H100.cells_per_s == pytest.approx(64 * 132 * 1.98e9)
    assert 2 * bounds.H100.cells_per_s / 1e12 == pytest.approx(33.45, rel=1e-3)
