"""The benchmark's own tests: ``python -m pytest fvbench/tests -q`` from the
repository's root.  Tests marked ``card`` need an NVIDIA GPU and skip
without one; the others run on the CPU with the port's plain versions."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("paper_k3965.single_t256", "config5_k16384.batch16_t4096",
         "paper_k3965.batch16_t256", "config5_k16384.single_t4096")

#: the cell that states a ``decoder`` (FLASH-BS): judged against its own
#: decode, not the optimum
BEAM = "paper_k3965.beam64_t256"

#: a size every cell runs at on the CPU in a few seconds
TINY = {"config": {"K": 96, "M": 7, "prob": 0.2},
        "traffic": {"T": 24, "pool": 64, "trace_requests": 3},
        "check": {"sample": 4}}
#: the same for the FLASH-BS cell, with a beam narrow enough to prune at
#: K=96 and a segment that comes back -1 at the seeds the tests use
TINY_BEAM = {**TINY, "traffic": {**TINY["traffic"], "decoder": {
    "algorithm": "flash_bs", "beam_width": 4, "num_segments": 4}}}


def tiny(name: str) -> dict:
    """The tiny overrides of the cell ``name``."""
    return TINY_BEAM if name == BEAM else TINY


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check at a cell's own size runs on the card")
    return torch.device("cuda", 0)
