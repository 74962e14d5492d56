"""``auto``'s budget figure (``auto.device_peak_bytes``) held to what each
candidate's decode allocates on the card: for every candidate ``rank``
gives at K in {3968, 16384} x T in {256, 1024, 4096} and at K=3968,
T=16384, the peak ``torch.cuda.max_memory_allocated`` reads over one decode
after a warm-up, less the tables, is at most the figure, and the figure at
most 1.25 x that peak + 2 MiB.

These need an NVIDIA GPU and skip without one.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_auto_card.py``
(``--noconftest``: the tests' conftest imports JAX, which that machine has
not; this file imports the port alone), ~2 min on an H100;
``python3 -m tests.test_torch_auto_card`` prints the table of peaks, one
JSON line a candidate."""

import json
import sys

import pytest
import torch

from flash_viterbi_tpu_torch import build
from flash_viterbi_tpu_torch.algorithms import auto
from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

pytestmark = pytest.mark.cuda

M = 50
GRID = [(3968, 256), (3968, 1024), (3968, 4096), (16384, 256), (16384, 1024),
        (16384, 4096), (3968, 16384)]
MIB = 2**20


def tables(K: int, dev):
    """Padded-size float32 log tables drawn on the card (values do not move
    what a decode allocates)."""
    g = torch.Generator(device=dev).manual_seed(K)
    logA = torch.rand((K, K), generator=g, device=dev).log_()
    logB = torch.rand((K, M), generator=g, device=dev).log_()
    logPi = torch.full((K,), -float(torch.log(torch.tensor(float(K)))), device=dev)
    return logA, logB, logPi


def peak_rows(K: int, T: int, dev):
    """One dict a candidate of ``rank(K, T)``: its measured peak above the
    tables and the figure, in bytes."""
    torch.cuda.empty_cache()
    tabs = tables(K, dev)
    g = torch.Generator().manual_seed(T)
    y_host = torch.randint(0, M, (T,), generator=g)
    sms = sm_count(dev)
    rows = []
    for name, kw in auto.rank(K, T):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        dec = build(name, **kw)
        dec(*tabs, y_host.to(dev))  # warm-up: what the decoder keeps is made here
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = dec(*tabs, y_host.to(dev))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out, dec
        rows.append({"K": K, "T": T, "name": name, "kw": kw, "measured": peak,
                     "figure": auto.device_peak_bytes(name, kw, K, T, M, sms),
                     "jax_working_set": auto.device_working_set(name, kw, K, T)})
    del tabs
    torch.cuda.empty_cache()
    return rows


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the figure is held to the card's allocator")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("K,T", GRID)
def test_budget_figure_holds_on_the_card(card, K, T):
    for r in peak_rows(K, T, card):
        assert r["measured"] <= r["figure"] <= 1.25 * r["measured"] + 2 * MIB, r


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(dev), file=sys.stderr)
    for K, T in GRID:
        for r in peak_rows(K, T, dev):
            r.update(measured_mib=r["measured"] / MIB, figure_mib=r["figure"] / MIB,
                     ok=r["measured"] <= r["figure"] <= 1.25 * r["measured"] + 2 * MIB)
            print(json.dumps(r), flush=True)
