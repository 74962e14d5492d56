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


def test_beam_floor_at_the_flash_bs_cell():
    """paper_k3965.beam64_t256: 255 + 248 steps of 64 x 3965 cells (7.63 us)
    under logA's 3965 rows read once (19.0 us)."""
    assert bounds.beam_steps(256, 8) == 503
    got, by = bounds.beam_floor_s(3965, 50, 256, 64, 8)
    assert by == "bytes"
    assert got == pytest.approx((4 * (3965 * 3965 + 3965 * 50 + 3965) + 8 * 256) / 3.35e12)
    cells = 503 * 64 * 3965 / bounds.H100.cells_per_s
    assert cells == pytest.approx(7.63e-6, rel=1e-3)


def test_beam_floor_counts_only_the_rows_a_beam_reaches():
    """Two steps of a beam of 4 reach 8 rows of 4096; a beam wider than K
    is K."""
    got, by = bounds.beam_floor_s(4096, 50, 2, 4, 1)
    assert by == "bytes"
    assert got == pytest.approx((4 * (8 * 4096 + 4096 * 50 + 4096) + 16) / 3.35e12)
    assert bounds.beam_floor_s(64, 5, 300, 1000, 4) == bounds.beam_floor_s(64, 5, 300, 64, 4)
