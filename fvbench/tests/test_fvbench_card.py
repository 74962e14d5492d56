"""On the card, at a cell's own size: the control fails the check on three
seeds, and the program passes it on three (``python -m pytest
fvbench/tests -m card`` on a machine with an NVIDIA GPU; ~4 min)."""

import pytest

from fvbench import control


@pytest.mark.card
@pytest.mark.parametrize("name", ["paper_k3965.single_t256", "paper_k3965.batch16_t256",
                                  "config5_k16384.single_t4096", "paper_k3965.beam64_t256"])
def test_control_fails_at_the_cells_size(card, name):
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    recs = list(control.readings(name, seeds, seeds, device=card))
    assert [r["correct"] for r in recs] == [True] * 3 + [False] * 3
