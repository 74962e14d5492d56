"""The step block's tiling (``step_plan``) and its combine order.

The plan must put every (lane, source row, column) of a step in exactly
one warp's slice of one tile, spread the tiles over the SMs, and keep a
thread's columns and a cluster within the kernel's limits; a test-side
emulation of the kernel's decomposition (each warp's slice folded in
ascending order with a strict '>', the warps' partials combined in shared
memory, the R tiles of a column group combined lexicographically in any
order of arrival) must equal the plain version and JAX's Pallas kernel
(interpret mode) bit for bit on tie fixtures."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas.maxplus import maxplus_step_block as jstep
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
from tests.test_torch_step_block import SHAPES, _fixture

torch.set_num_threads(2)

SMS = 132  # an H100's SMs
INT_MAX = np.iinfo(np.int32).max


def _cover_once(edges_list, n: int) -> None:
    """Every index in [0, n) lies in exactly one [lo, hi) of ``edges_list``."""
    count = np.zeros(n, dtype=np.int64)
    for lo, hi in edges_list:
        assert 0 <= lo <= hi <= n
        count[lo:hi] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("sms", [1, 8, SMS])
@pytest.mark.parametrize("N", [1, 3, 16, 20, 64])
def test_plan_covers_every_lane_row_and_column_once(N, sms):
    for Ks, Kd in itertools.product([1, 7, 1000, 3968, 16384],
                                    [1, 5, 250, 992, 1984, 3968, 4096]):
        p = km.step_plan(N, Ks, Kd, sms)
        assert p.lanes == min(16, 1 << (N - 1).bit_length())
        assert p.cols == (4 if p.lanes <= 4 else 2 if p.lanes == 8 else 1)
        assert (p.groups - 1) * p.lanes < N <= p.groups * p.lanes
        _cover_once([(g * p.lanes, min(N, (g + 1) * p.lanes)) for g in range(p.groups)], N)
        # source rows: R ranges, each split into the warps' slices
        assert 1 <= p.R <= km.STEP_CLUSTER_MAX and len(p.row_edges) == p.R + 1
        assert p.row_edges[0] == 0 and p.row_edges[-1] == Ks
        assert (np.diff(p.row_edges) > 0).all()  # no empty tile
        slices = []
        for r in range(p.R):
            e = p.warp_edges(r)
            assert len(e) == km.STEP_WARPS + 1
            assert (e[0], e[-1]) == (p.row_edges[r], p.row_edges[r + 1])
            slices += list(zip(e[:-1], e[1:]))
        _cover_once(slices, Ks)
        # columns: C groups of whole units, each within one warp's reach
        cols = np.array(p.col_edges)
        assert len(cols) == p.C + 1 and cols[0] == 0 and cols[-1] == Kd
        assert (np.diff(cols) > 0).all()
        assert all(c % p.cols == 0 for c in cols[:-1])
        assert np.diff(cols).max() <= km.STEP_UNITS * p.cols
        _cover_once(list(zip(cols[:-1], cols[1:])), Kd)
        assert p.blocks == p.R * p.C * p.groups
        assert p.combine == ("cluster" if p.R > 1 else "none")
        assert list(p.c_args()) == [p.lanes, p.R, p.C, p.groups]
        # a warp keeps STEP_MIN_ROWS rows where Ks allows more than one range
        assert p.R == 1 or Ks // p.R >= km.STEP_WARPS * km.STEP_MIN_ROWS


@pytest.mark.parametrize("N,Ks,Kd", [(16, 3968, 992), (1, 3968, 3968), (1, 16384, 4096),
                                     (1, 3968, 1984), (16, 3968, 1984), (8, 3968, 1984)])
def test_plan_spreads_the_shard_steps_over_the_sms(N, Ks, Kd):
    """The sharded decode's shapes: at least 124 of 132 SMs busy, none
    with more tiles than another by two, where the parent kernel ran
    (16, 3968, 992) as 31 blocks."""
    p = km.step_plan(N, Ks, Kd, SMS)
    assert 124 <= p.blocks
    per_sm = -(-p.blocks // SMS)
    assert p.blocks > (per_sm - 1) * SMS  # no SM holds two more than another
    if (N, Ks, Kd) == (16, 3968, 992):
        assert p.blocks > 31 and p.R > 1 and p.combine == "cluster"


def test_plan_takes_a_forced_range_count_and_refuses_others():
    p = km.step_plan(16, 3968, 992, SMS, R=16)
    assert p.R == 16 and p.row_edges[-1] == 3968 and p.blocks == 16 * 31
    assert km.step_plan(16, 3968, 992, SMS, R=1).combine == "none"
    for R in (0, 17):
        with pytest.raises(ValueError, match="R must lie"):
            km.step_plan(16, 3968, 992, SMS, R=R)
    with pytest.raises(ValueError, match="R must lie"):
        km.step_plan(1, 3, 8, SMS, R=4)  # more ranges than rows
    with pytest.raises(ValueError, match=">= 1"):
        km.step_plan(1, 0, 8, SMS)


def _better(v, a, bv, ba):
    """argmax.cuh's fvt_better, elementwise."""
    return (v > bv) | ((v == bv) & (a < ba))


def _pick(v, a, bv, ba):
    take = _better(v, a, bv, ba)
    return np.where(take, v, bv), np.where(take, a, ba)


def _tile_partials(d, logA, plan, r, c0, c1):
    """Tile (r, c0:c1) of one lane group as the kernel forms it: each warp's
    slice walked in ascending order with a strict '>' from (-inf, its first
    row), or the identity (-inf, INT_MAX) when empty; then the warps'
    partials combined in warp order."""
    shape = (d.shape[0], c1 - c0)
    out = None
    edges = plan.warp_edges(r)
    for s0, s1 in zip(edges[:-1], edges[1:]):
        best = np.full(shape, -np.inf, dtype=np.float32)
        arg = np.full(shape, s0 if s1 > s0 else INT_MAX, dtype=np.int32)
        for k in range(s0, s1):
            v = d[:, k, None] + logA[k, c0:c1]
            take = v > best
            best, arg = np.where(take, v, best), np.where(take, np.int32(k), arg)
        out = (best, arg) if out is None else _pick(best, arg, *out)
    return out


def _orders(R: int, seed: int):
    """Every order of R arrivals for R <= 4; else the identity, its reverse
    and six random orders."""
    if R <= 4:
        return list(itertools.permutations(range(R)))
    rng = np.random.default_rng(seed)
    return [tuple(range(R)), tuple(reversed(range(R)))] + [tuple(rng.permutation(R))
                                                          for _ in range(6)]


def _emulate(delta, logA, plan, seed: int = 0):
    """The kernel's decomposition in numpy, its cross-tile combine taken in
    every order of :func:`_orders`; every order must give one result,
    which is returned as (val, ptr)."""
    N, Kd = delta.shape[0], logA.shape[1]
    val = np.empty((N, Kd), dtype=np.float32)
    ptr = np.empty((N, Kd), dtype=np.int32)
    for g in range(plan.groups):
        lanes = slice(g * plan.lanes, min(N, (g + 1) * plan.lanes))
        for c in range(plan.C):
            c0, c1 = plan.col_edges[c], plan.col_edges[c + 1]
            parts = [_tile_partials(delta[lanes], logA, plan, r, c0, c1) for r in range(plan.R)]
            results = []
            for order in _orders(plan.R, seed + c):
                bv = np.full(parts[0][0].shape, -np.inf, dtype=np.float32)
                ba = np.full(parts[0][1].shape, INT_MAX, dtype=np.int32)
                for q in order:
                    bv, ba = _pick(*parts[q], bv, ba)
                results.append((bv, ba))
            for bv, ba in results[1:]:
                np.testing.assert_array_equal(bv, results[0][0])
                np.testing.assert_array_equal(ba, results[0][1])
            val[lanes, c0:c1], ptr[lanes, c0:c1] = results[0]
    return val, ptr


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("N,Ks,Kd", SHAPES)
def test_emulated_split_equals_plain_and_pallas(N, Ks, Kd, integer):
    """At the shapes JAX's tiling takes, on test_torch_step_block's tie
    fixtures (a repeated source row, an all -inf row and column, -inf
    carries), the plan for 132 SMs (several ranges a column group, so a
    cluster combine) gives the plain version's and Pallas's outputs."""
    delta, logA = _fixture(N, Ks, Kd, integer)
    plan = km.step_plan(N, Ks, Kd, SMS)
    assert plan.R > 1
    val, ptr = _emulate(delta, logA, plan, seed=N)
    want = km.maxplus_step_block_plain(torch.as_tensor(delta), torch.as_tensor(logA))
    jval, jptr = jstep(jnp.asarray(delta), jnp.asarray(logA), interpret=True)
    for got, w, j in ((val, want[0], jval), (ptr, want[1], jptr)):
        assert got.dtype == w.numpy().dtype
        np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(got, np.asarray(j))
    assert (ptr[:, 5] == 0).all()  # the dead column resolves to source 0


@pytest.mark.parametrize("N,Ks,Kd,R", [(20, 1000, 250, None), (20, 1000, 250, 3), (5, 7, 5, None),
                                       (1, 1, 1, None), (3, 33, 9, 2), (17, 300, 21, 16),
                                       (2, 40, 6, 4)])
def test_emulated_split_equals_plain_on_ragged_shapes(N, Ks, Kd, R):
    """Shapes the Pallas tiling refuses: Kd % 4 != 0, two lane groups, a
    source dimension shorter than a tile's warps (empty slices), more
    ranges than the default; values in halves, so ties everywhere."""
    rng = np.random.default_rng(N * Ks + Kd)
    delta = (np.round(rng.standard_normal((N, Ks)) * 2) / 2).astype(np.float32)
    logA = (np.round(rng.standard_normal((Ks, Kd)) * 2) / 2).astype(np.float32)
    if Ks > 3:
        logA[Ks // 2] = -np.inf
        delta[:, 1] = -np.inf
    logA[:, Kd // 2] = -np.inf
    plan = km.step_plan(N, Ks, Kd, SMS, R=R)
    val, ptr = _emulate(delta, logA, plan, seed=Kd)
    want = km.maxplus_step_block_plain(torch.as_tensor(delta), torch.as_tensor(logA))
    np.testing.assert_array_equal(val, want[0].numpy())
    np.testing.assert_array_equal(ptr, want[1].numpy())
