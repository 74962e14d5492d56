"""The deltas scan's ring route on the card: the kernel bit for bit against
its plain version (the final carry and the history) at the route's shapes
(16, 8 and 4 lanes; the carry in one pass and in passes), under ring plans
forced at small K, on an unaligned table, and a shared error word already
set.

These need an NVIDIA GPU and skip without one.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_scan_ring.py``
(``--noconftest``: the tests' conftest imports JAX, which that machine has
not; this file imports the port alone).  ~2 min on an H100."""

import pytest
import torch

from flash_viterbi_tpu_torch.ops import cuda as k
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ring route is a CUDA kernel")
    return torch.device("cuda", 0)


def _halves(g, *shape, device):
    return torch.round(torch.randn(shape, generator=g, device=device) * 2) / 2


@pytest.fixture(scope="module")
def table(card):
    """The (K, K) table of a K, drawn on the card once: halves (ties
    everywhere), source row K // 3 and destination column K // 5 all -inf."""
    tables = {}

    def get(K):
        if K not in tables:
            tables.clear()
            torch.cuda.empty_cache()
            g = torch.Generator(device=card).manual_seed(K)
            logA = _halves(g, K, K, device=card)
            logA[K // 3] = float("-inf")
            logA[:, K // 5] = float("-inf")
            tables[K] = logA
        return tables[K]

    return get


def _inputs(K, N, Tm, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return _halves(g, Tm, N, K, device=device), _halves(g, N, K, device=device)


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), f"max abs err {(a - b).abs().nan_to_num(0).max().item()}"


@pytest.mark.parametrize("K", [14464, 16384, 16383])
@pytest.mark.parametrize("N", [9, 16])
@pytest.mark.parametrize("Tm", [1, 2, 33])
def test_ring_route_equals_plain(card, table, K, N, Tm):
    assert km.scan_plan(K, N, km.sm_count(card), deltas=True).ring_rows > 0
    logA = table(K)
    emits, delta0 = _inputs(K, N, Tm, card, seed=K + N + Tm)
    before = k.launch_counts()["maxplus_scan_deltas"]
    got = k.maxplus_scan_deltas(logA, emits, delta0)
    assert k.launch_counts()["maxplus_scan_deltas"] == before + 1
    _same(got, km.maxplus_scan_deltas_plain(logA, emits, delta0))


@pytest.mark.parametrize("K,N,Tm", [(28544, 8, 2), (32768, 16, 2), (55936, 4, 2)])
def test_ring_route_at_8_and_4_lanes_and_in_carry_passes(card, table, K, N, Tm):
    """The route's 8- and 4-lane instances, and 16 lanes where a range's
    carry comes in passes, at shapes the route takes."""
    plan = km.scan_plan(K, N, km.sm_count(card), deltas=True)
    assert plan.ring_rows > 0 and plan.carry_rows < plan.rows_streamed
    logA = table(K)
    emits, delta0 = _inputs(K, N, Tm, card, seed=K + N)
    _same(k.maxplus_scan_deltas(logA, emits, delta0),
          km.maxplus_scan_deltas_plain(logA, emits, delta0))


def _in_passes(K, N, sms):
    """The ring plan of (K, N) under the least shared memory that still
    takes it: the carry in passes of a few stages."""
    for extra in range(0, 1 << 17, 256):
        p = km.ring_plan(K, N, sms, smem_bytes=km.STATIC_SMEM + km.RING_MIN_BYTES + extra)
        if p is not None:
            return p
    raise AssertionError(f"no ring plan for K={K}, N={N}")


@pytest.mark.parametrize("K,N", [(3000, 16), (3001, 9), (2999, 3)])
@pytest.mark.parametrize("passes", [False, True])
def test_forced_ring_plans_at_small_k(card, table, K, N, passes):
    """Ring plans handed to the wrapper off the route (every lane count,
    ragged K, one pass or many)."""
    sms = km.sm_count(card)
    plan = _in_passes(K, N, sms) if passes else km.ring_plan(K, N, sms)
    assert (plan.carry_rows < plan.rows_streamed) == passes
    logA = table(K)
    emits, delta0 = _inputs(K, N, 5, card, seed=K * N)
    _same(k.maxplus_scan_deltas(logA, emits, delta0, plan=plan),
          km.maxplus_scan_deltas_plain(logA, emits, delta0))


def test_ring_route_on_an_unaligned_table(card, table):
    """A view of logA 4 bytes past a 16-byte boundary: every row's slice
    lands 1 to 3 floats into its ring slot."""
    K, N, Tm = 16384, 16, 3
    base = torch.empty(K * K + 1, device=card)
    logA = base[1:].view(K, K)
    logA.copy_(table(K))
    assert logA.data_ptr() % 16 == 4
    emits, delta0 = _inputs(K, N, Tm, card, seed=7)
    _same(k.maxplus_scan_deltas(logA, emits, delta0),
          km.maxplus_scan_deltas_plain(logA, emits, delta0))


def test_a_shared_error_word_already_set_stops_the_ring_at_its_first_barrier(card, table):
    """The scan writes the history's first row (before its first barrier)
    and nothing after it; the caller reading the word raises."""
    K, N, Tm = 16384, 16, 4
    logA = table(K)
    emits, delta0 = _inputs(K, N, Tm, card, seed=11)
    plan = km.scan_plan(K, N, km.sm_count(card), deltas=True)
    err = km.error_word(card)
    err.fill_(1)
    hist = torch.full((Tm, N, K), float("nan"), device=card)
    km.launch_scan("fvt_maxplus_scan", k.maxplus_scan_deltas,
                   {"logA": logA, "emits": emits}, delta0, hist, plan, err)
    torch.cuda.synchronize()
    assert torch.equal(hist[0], delta0)
    assert bool(hist[1:].isnan().all())
    with pytest.raises(RuntimeError, match="timed out"):
        km.raise_on_error(err, "decode")
    # through the wrapper, as a decode shares its word
    k.maxplus_scan_deltas(logA, emits, delta0, err=err)
    with pytest.raises(RuntimeError, match="timed out"):
        km.raise_on_error(err, "decode")
