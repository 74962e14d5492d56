"""The persistent scan's tiling (``scan_plan``) and its combine order.

The plan must cover every (source, column) cell of logA once and fit a
block's shared memory; a test-side emulation of the kernel's decomposition
(tiles walked with a strict '>', partials combined lexicographically in the
kernel's team order, the emission added after the max) must equal the plain
versions and the JAX Pallas scans (interpret mode) bit for bit on tie
fixtures; and the CUDA branches, spied on the CPU, must hand the kernel the
plan, its scratch and contiguous inputs, count one launch a call and raise
when a grid barrier timed out, at once or, with an error word shared by a
decode's scans, where the decode reads it."""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas import maxplus as pk
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import beam as kbeam
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
from flash_viterbi_tpu_torch.ops.cuda.common import SMEM_LIMIT

torch.set_num_threads(2)

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("N", [1, 16, 20, 64])
@pytest.mark.parametrize("K", [1, 7, 64, 1000, 3965, 3968, 16384, 70000])
def test_plan_tiles_cover_logA_once_and_fit_a_block(K, N):
    p = km.scan_plan(K, N, SMS)
    rows, cols = np.array(p.row_edges), np.array(p.col_edges)
    # edges rise from 0 to K, so every cell lies in exactly one tile
    assert rows[0] == 0 and rows[-1] == K and (np.diff(rows) > 0).all()
    assert cols[0] == 0 and cols[-1] == K and (np.diff(cols) > 0).all()
    assert len(rows) == p.R + 1 and len(cols) == p.C + 1
    assert all(c % p.cols == 0 for c in cols[:-1])  # a thread's columns stay in one group
    assert p.blocks <= SMS and p.blocks == min(p.tiles, SMS)
    # a block walks several tiles only where one range spans every row
    assert p.tiles == p.blocks or (p.R == 1 and p.C > SMS and p.rows_smem == 0)
    assert np.diff(cols).max() <= km.THREADS * p.cols  # every column has its thread
    kr_max = int(np.diff(rows).max())
    assert p.rows_smem + p.rows_streamed == kr_max and p.rows_smem >= 0
    assert 1 <= p.carry_rows <= kr_max
    assert p.smem == -(-p.carry_rows * p.lanes // 4) * 16 + p.rows_smem * p.stride * 4
    assert p.smem + km.STATIC_SMEM <= SMEM_LIMIT
    assert p.stride >= np.diff(cols).max() and p.stride % p.cols == 0
    assert p.lanes == min(16, 1 << (N - 1).bit_length())
    assert p.team in (1, 2, 4, 8, 16, 32)
    if K == 3968:
        assert p.blocks > 124  # more SMs busy than the one-step kernel's 124 blocks
    if 3965 <= K <= 16384 and N == 1:
        assert p.blocks >= 126 and p.rows_smem > 0
    if K == 70000 and N > 1:  # 137 column groups at 16 lanes
        assert p.tiles == 137 and p.blocks == SMS


def test_plan_walks_several_tiles_a_block_past_the_sms():
    """More column groups than SMs: one range of every row, each block
    walking groups b, b + blocks, ...; all rows streamed; the combine
    chosen by the caller where asked."""
    p = km.scan_plan(km.THREADS + 1, 16, 1)  # 2 column groups on 1 SM
    assert (p.R, p.C, p.blocks, p.rows_smem) == (1, 2, 1, 0)
    assert p.rows_streamed == km.THREADS + 1
    p = km.scan_plan(km.THREADS * 4 + 1, 16, 4)
    assert (p.R, p.C, p.blocks, p.rows_smem, p.tiles) == (1, 5, 4, 0, 5)
    for two_phase in (False, True):
        q = km.scan_plan(3968, 16, SMS, two_phase=two_phase)
        assert q.two_phase == two_phase
        assert q._replace(team=0, two_phase=None) == km.scan_plan(3968, 16, SMS)._replace(
            team=0, two_phase=None)
    with pytest.raises(ValueError, match=">= 1"):
        km.scan_plan(0, 1, SMS)


def _better(v, a, bv, ba):
    """argmax.cuh's fvt_better, elementwise."""
    return (v > bv) | ((v == bv) & (a < ba))


def _combine(part_v, part_i, team):
    """The R partials (R, n, K) of every carry entry combined in the
    kernel's order: member m of a team folds ranges m, m + team, ... in
    ascending order, then the members meet in an xor tree of shuffles."""
    R = part_v.shape[0]
    acc = []
    for m in range(team):
        bv = torch.full(part_v.shape[1:], -np.inf)
        ba = torch.full(part_v.shape[1:], np.iinfo(np.int32).max, dtype=torch.int32)
        for rr in range(m, R, team):
            take = _better(part_v[rr], part_i[rr], bv, ba)
            bv, ba = torch.where(take, part_v[rr], bv), torch.where(take, part_i[rr], ba)
        acc.append((bv, ba))
    s = team >> 1
    while s:
        nxt = []
        for m in range(team):
            (bv, ba), (ov, oa) = acc[m], acc[m ^ s]
            take = _better(ov, oa, bv, ba)
            nxt.append((torch.where(take, ov, bv), torch.where(take, oa, ba)))
        acc, s = nxt, s >> 1
    return acc[0]


def _emulate(logA, delta0, emit_at, Tm, plan, with_ptr):
    """The persistent kernel's decomposition in torch: per lane group and
    step, every tile's partial (max, argmax) by a strict '>' walk over its
    source rows in ascending order, the partials combined on read, the
    emission added after the max.  Returns (dfin, ptrs) or (dfin, deltas)."""
    N, K = delta0.shape
    dfin = torch.empty_like(delta0)
    hist = torch.empty((Tm, N, K), dtype=torch.int32 if with_ptr else torch.float32)
    for g0 in range(0, N, plan.lanes):
        lanes = list(range(g0, min(N, g0 + plan.lanes)))
        d = delta0[lanes]
        for t in range(Tm):
            if not with_ptr:
                hist[t, lanes] = d
            part_v = torch.empty((plan.R, len(lanes), K))
            part_i = torch.empty((plan.R, len(lanes), K), dtype=torch.int32)
            for r in range(plan.R):
                r0, r1 = plan.row_edges[r], plan.row_edges[r + 1]
                for c in range(plan.C):
                    c0, c1 = plan.col_edges[c], plan.col_edges[c + 1]
                    best = torch.full((len(lanes), c1 - c0), -np.inf)
                    arg = torch.full((len(lanes), c1 - c0), r0, dtype=torch.int32)
                    for k in range(r0, r1):
                        v = d[:, k, None] + logA[k, c0:c1]
                        take = v > best
                        best = torch.where(take, v, best)
                        arg = torch.where(take, torch.tensor(k, dtype=torch.int32), arg)
                    part_v[r, :, c0:c1], part_i[r, :, c0:c1] = best, arg
            val, idx = _combine(part_v, part_i, plan.team)
            d = val + emit_at(t, lanes)
            if with_ptr:
                hist[t, lanes] = idx
        dfin[lanes] = d
    return dfin, hist


def _ties(K, N, Tm, M, seed):
    """Integer-valued tables (exact fp32 ties everywhere) with an all -inf
    source row 9 and destination column 5, a source row 17 equal to row 3,
    and two -inf carry entries."""
    rng = np.random.default_rng(seed)
    logA = np.round(rng.standard_normal((K, K)) * 2) / 2
    logA[17] = logA[3]
    logA[9] = -np.inf
    logA[:, 5] = -np.inf
    emits = np.round(rng.standard_normal((Tm, N, K)))
    delta0 = np.round(rng.standard_normal((N, K)))
    delta0[:, 11:13] = -np.inf
    logBT = np.round(rng.standard_normal((M, K)))
    ys = rng.integers(0, M, (Tm, N)).astype(np.int32)
    f32 = [np.ascontiguousarray(x, dtype=np.float32) for x in (logA, emits, delta0, logBT)]
    return (*f32, ys)


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("N,sms", [(1, 64), (3, 64), (20, 64), (20, 4), (1, 1)])
@pytest.mark.parametrize("kind", ["scan", "deltas", "emitgather"])
def test_emulated_decomposition_equals_plain_and_pallas(kind, N, sms, two_phase, monkeypatch):
    """At K=128 the real plan has one tile; a smaller block (16 threads)
    and tiles of a few rows on 64 SMs give the same decomposition ragged
    tiles in both dimensions, several ranges a column and (at one lane)
    teams of several threads, for both ways of combining.  On 4 SMs (20
    lanes) and on 1 there are more column groups than SMs: one range, each
    block walking several tiles."""
    monkeypatch.setattr(km, "THREADS", 16)
    monkeypatch.setattr(km, "MIN_TILE_ROWS", 3)
    K, Tm, M = 128, 4, 7
    plan = km.scan_plan(K, N, sms, two_phase=two_phase)
    assert plan.two_phase == two_phase
    if sms == 64:
        assert plan.R > 1 and plan.C > 1 and (N > 1 or plan.team > 1)
    else:
        assert plan.R == 1 and plan.tiles > plan.blocks == sms and plan.rows_smem == 0
    logA, emits, delta0, logBT, ys = _ties(K, N, Tm, M, seed=N)
    tA, te, td, tB, ty = (torch.from_numpy(x) for x in (logA, emits, delta0, logBT, ys))
    if kind == "emitgather":
        want = km.maxplus_scan_emitgather_plain(tA, tB, ty, td)
        jax_out = pk.maxplus_scan_emitgather(*(jnp.asarray(x) for x in (logA, logBT, ys, delta0)),
                                             interpret=True)
        got = _emulate(tA, td, lambda t, lanes: tB[ty[t, lanes].long()], Tm, plan, True)
    else:
        plain = km.maxplus_scan_plain if kind == "scan" else km.maxplus_scan_deltas_plain
        jfn = pk.maxplus_scan if kind == "scan" else pk.maxplus_scan_deltas
        want = plain(tA, te, td)
        jax_out = jfn(*(jnp.asarray(x) for x in (logA, emits, delta0)), interpret=True)
        got = _emulate(tA, td, lambda t, lanes: te[t, lanes], Tm, plan, kind == "scan")
    for g, w, j in zip(got, want, jax_out):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    if kind != "deltas":  # the dead column resolves to source 0
        assert (got[1][:, :, 5] == 0).all()


def _spy(monkeypatch, timeout: bool = False):
    """Fake the CUDA branch: every device check answers CUDA, the card has
    SMS SMs, and the launch records its arguments and counts; with
    ``timeout`` it sets the error word it was given, as a timed-out
    barrier does."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        if timeout:
            ctypes.c_int.from_address(args[-5]).value = 1
        counter.launches += 1

    monkeypatch.setattr(km, "on_cuda", lambda *t: True)
    monkeypatch.setattr(km, "launch", fake_launch)
    monkeypatch.setattr(km, "sm_count", lambda dev: SMS)
    tk.reset_launches()
    return calls


def test_cuda_branches_pass_plan_scratch_and_count_one_launch_a_call(monkeypatch):
    calls = _spy(monkeypatch)
    logA, emits, delta0, logBT, ys = (torch.from_numpy(x) for x in _ties(64, 20, 3, 5, seed=1))
    with pytest.raises(ValueError, match="contiguous"):
        km.maxplus_scan(logA.t(), emits, delta0)
    with pytest.raises(ValueError, match="contiguous"):
        km.maxplus_scan_deltas(logA, emits.transpose(0, 1).contiguous().transpose(0, 1), delta0)
    with pytest.raises(ValueError, match="contiguous"):
        km.maxplus_scan_emitgather(logA, logBT, ys.t().contiguous().t(), delta0)
    assert calls == []
    km.maxplus_scan(logA, emits, delta0)
    km.maxplus_scan_deltas(logA, emits, delta0)
    km.maxplus_scan_emitgather(logA, logBT, ys, delta0)
    assert [c[0] for c in calls] == ["fvt_maxplus_scan", "fvt_maxplus_scan",
                                     "fvt_maxplus_scan_eg"]
    plan = km.scan_plan(64, 20, SMS)
    for fn_name, args in calls:
        c_plan = args[-4]
        assert list(c_plan) == [plan.lanes, plan.R, plan.C, plan.blocks, plan.rows_smem,
                                plan.stride, plan.carry_rows, plan.team, int(plan.two_phase),
                                plan.smem, plan.ring_rows]
        assert args[-5] == args[-6] + 4 * km.SYNC_ERR  # the call's own error word
        assert args[-3:] == (3, 20, 64)
        assert all(isinstance(a, int) for a in args[-9:-4] if a is not None)
    ptr_args, deltas_args = calls[0][1], calls[1][1]
    assert ptr_args[4] is not None and ptr_args[5] is None  # ptrs, no deltas
    assert deltas_args[4] is None and deltas_args[5] is not None
    assert ptr_args[7] is not None and deltas_args[7] is None  # part_i with pointers only
    # 20 lanes are two groups of 16 inside one launch
    assert tk.launch_counts()["maxplus_scan"] == 1
    assert tk.launch_counts()["maxplus_scan_deltas"] == 1
    assert tk.launch_counts()["maxplus_scan_emitgather"] == 1
    # no launch for zero steps
    dfin, ptrs = km.maxplus_scan(logA, emits[:0], delta0)
    assert len(calls) == 3 and dfin is delta0 and ptrs.shape == (0, 20, 64)


def test_a_timed_out_barrier_raises(monkeypatch):
    _spy(monkeypatch, timeout=True)
    logA, emits, delta0, _, _ = (torch.from_numpy(x) for x in _ties(64, 2, 3, 5, seed=2))
    with pytest.raises(RuntimeError, match="timed out"):
        km.maxplus_scan(logA, emits, delta0)
    assert tk.launch_counts()["maxplus_scan"] == 1


def test_a_shared_error_word_is_read_by_its_caller(monkeypatch):
    """With ``err=`` the kernel gets the caller's word and the wrapper
    reads nothing: a timeout shows where the caller reads the word."""
    calls = _spy(monkeypatch, timeout=True)
    logA, emits, delta0, logBT, ys = (torch.from_numpy(x) for x in _ties(64, 2, 3, 5, seed=2))
    err = km.error_word("cpu")
    km.maxplus_scan(logA, emits, delta0, err=err)
    km.maxplus_scan_deltas(logA, emits, delta0, err=err)
    km.maxplus_scan_emitgather(logA, logBT, ys, delta0, err=err)
    assert [args[-5] for _, args in calls] == [err.data_ptr()] * 3
    with pytest.raises(RuntimeError, match="decode: a grid barrier"):
        km.raise_on_error(err, "decode")
    km.raise_on_error(km.error_word("cpu"), "decode")  # a clean word passes
    with pytest.raises(TypeError, match="err must be"):
        km.maxplus_scan(logA, emits, delta0, err=err.float())
    assert len(calls) == 3


def test_cuda_branches_take_the_callers_plan(monkeypatch):
    """``plan=`` reaches the kernel as given; a plan of another shape is
    refused before the launch."""
    calls = _spy(monkeypatch)
    logA, emits, delta0, _, _ = (torch.from_numpy(x) for x in _ties(64, 20, 3, 5, seed=3))
    plan = km.scan_plan(64, 20, 1, two_phase=True)
    km.maxplus_scan_deltas(logA, emits, delta0, plan=plan)
    assert list(calls[0][1][-4]) == list(plan.c_args())
    for other in (km.scan_plan(65, 20, 1), km.scan_plan(64, 1, 1)):
        with pytest.raises(ValueError, match="the plan is for"):
            km.maxplus_scan(logA, emits, delta0, plan=other)
    assert len(calls) == 1


@pytest.mark.parametrize("algorithm", ["flash", "checkpoint"])
def test_a_decode_reads_its_scans_error_word_once(algorithm, monkeypatch):
    """flash's two scans and checkpoint's two a chunk share one error
    word, read once at the end of the decode, not once a scan; the path
    is the plain decode's."""
    import importlib

    from flash_viterbi_tpu_torch.algorithms import base
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    mod = importlib.import_module(f"flash_viterbi_tpu_torch.algorithms.{algorithm}")
    hmm, y = make_sparse_hmm(K=24, M=5, T=40, prob=0.3, seed=4)
    lh = hmm.log(device="cpu")
    dec = base.build(algorithm, **({"num_segments": 4} if algorithm == "flash" else {}))
    want = dec(lh.logA, lh.logB, lh.logPi, torch.as_tensor(y))
    plain = {("fvt_maxplus_scan", True): km.maxplus_scan_plain,
             ("fvt_maxplus_scan", False): km.maxplus_scan_deltas_plain,
             ("fvt_maxplus_scan_eg", True): km.maxplus_scan_emitgather_plain}
    words, reads = [], []

    def spy_scan(fn_name, counter, inputs, delta0, Tm, with_ptr, plan, err):
        words.append(err)
        return plain[fn_name, with_ptr](*inputs.values(), delta0)

    monkeypatch.setattr(km, "on_cuda", lambda *t: True)
    monkeypatch.setattr(km, "_scan_cuda", spy_scan)
    monkeypatch.setattr(mod, "raise_on_error", lambda err, what: reads.append(err))
    got = dec(lh.logA, lh.logB, lh.logPi, torch.as_tensor(y))
    assert len(words) >= 2 and words[0] is not None
    assert all(w is words[0] for w in words)
    assert len(reads) == 1 and reads[0] is words[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("Kp,scratch", [(1000, False), (17000, True)])
def test_beam_scan_takes_a_scratch_above_a_blocks_memory(Kp, scratch, monkeypatch):
    """Where a CTA's keys, slots and copy of the beam do not fit its shared
    memory (the full beam at Kp=17000) the beam wrapper hands the kernel a
    scratch of one region a (lane, CTA) instead of raising."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append(args)
        counter.launches += 1

    B = Kp if scratch else 64
    monkeypatch.setattr(kbeam, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kbeam, "launch", fake_launch)
    monkeypatch.setattr(kbeam, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(kbeam, "_clusters", lambda index, plan: SMS // plan.C)
    monkeypatch.setattr(kbeam, "_card_plan", lambda index, sms, Kp, B, N, P: kbeam.beam_plan(
        Kp, B, N, sms, P))
    logA = torch.zeros((Kp, 1))
    logA = logA.expand(Kp, Kp)  # no (Kp, Kp) allocation: the fake never reads it
    monkeypatch.setattr(kbeam, "expect_contiguous", lambda **t: None)
    kbeam.beam_scan(logA, torch.zeros((2, 3, Kp)), torch.zeros((3, B)),
                    torch.zeros((3, B), dtype=torch.int32))
    (args,) = calls
    plan = kbeam.beam_plan(Kp, B, 3, SMS)
    assert (args[9] is not None) == scratch == (not plan.state_smem)
    need = plan.state_words * 4
    assert (need + plan.rg * plan.cw * 4 > SMEM_LIMIT - kbeam.STATIC_SMEM) == scratch


# ---- the deltas scan's ring route ----

# The resident route's plans of the benchmark's cells that bypass the ring,
# field for field as they were before it: (K, N): lanes, cols, R, C, blocks,
# stride, rows_smem, rows_streamed, carry_rows, team, two_phase, smem
CELL_PLANS = {
    (3968, 1): (1, 4, 66, 2, 132, 1984, 29, 32, 61, 8, False, 230400),
    (3968, 16): (16, 1, 16, 8, 128, 496, 108, 140, 248, 1, True, 230144),
    (16384, 1): (1, 4, 16, 8, 128, 2048, 27, 997, 1024, 4, True, 225280),
}


@pytest.mark.parametrize("K,N", list(CELL_PLANS))
@pytest.mark.parametrize("deltas", [False, True])
def test_cells_off_the_route_keep_their_plans(K, N, deltas):
    """Cells 1, 3 and 4 (the N=1 pointer scans, the 16-lane deltas scan at
    K=3968) keep the resident route's plan, whichever scan asks."""
    p = km.scan_plan(K, N, SMS, deltas=deltas)
    assert (p.lanes, p.cols, p.R, p.C, p.blocks, p.stride, p.rows_smem, p.rows_streamed,
            p.carry_rows, p.team, p.two_phase, p.smem) == CELL_PLANS[K, N]
    assert p.row_edges == tuple(r * K // p.R for r in range(p.R + 1))
    units = -(-K // p.cols)
    assert p.col_edges == tuple(min(K, (c * units // p.C) * p.cols) for c in range(p.C + 1))
    assert p.elem_bytes == 4 and p.ring_rows == 0


@pytest.mark.parametrize("lanes,K,on", [(16, 14336, False), (16, 14464, True),
                                         (8, 28416, False), (8, 28544, True),
                                         (4, 55808, False), (4, 55936, True),
                                         (2, 65536, False), (1, 65536, False)])
def test_ring_route_at_its_edges(lanes, K, on):
    """The deltas scan takes the ring where the resident plan keeps no tile
    row in shared memory and every block has one tile, at 4, 8 and 16
    lanes; off the route the deltas plan is the resident one."""
    resident = km.scan_plan(K, lanes, SMS)
    p = km.scan_plan(K, lanes, SMS, deltas=True)
    assert km.ring_route(resident) == on
    assert (p.ring_rows > 0) == on
    assert resident.ring_rows == 0
    if not on:
        assert p == resident


def test_bf16_pointer_and_forced_combines_stay_off_the_route():
    """At K=16384 x 16 lanes the bf16 table, the pointer scan and an
    on-read combine keep the resident plan; a forced two-phase one does
    not change the ring."""
    resident = km.scan_plan(16384, 16, SMS)
    assert km.scan_plan(16384, 16, SMS, elem_bytes=2, deltas=True).ring_rows == 0
    assert km.scan_plan(16384, 16, SMS, elem_bytes=2, deltas=True) == km.scan_plan(
        16384, 16, SMS, elem_bytes=2)
    assert resident.ring_rows == 0 and resident.rows_smem == 0
    assert km.scan_plan(16384, 16, SMS, two_phase=False, deltas=True).ring_rows == 0
    assert km.scan_plan(16384, 16, SMS, two_phase=True, deltas=True) == km.scan_plan(
        16384, 16, SMS, deltas=True)
    # the shared memory of a block too small for a ring: the resident plan
    small = km.STATIC_SMEM + 64 * 1024
    assert km.scan_plan(16384, 16, SMS, smem_bytes=small, deltas=True) == km.scan_plan(
        16384, 16, SMS, smem_bytes=small)


def _span_bytes(addr: int, width: int) -> tuple[int, int]:
    """ring_span's copy of a slice of ``width`` floats at byte ``addr``:
    (the copy's bytes, the slice's first float within it)."""
    a, e = addr & ~15, (addr + 4 * width + 15) & ~15
    return e - a, (addr - a) // 4


RING_SHAPES = [(16, K) for K in (14341, 14464, 16383, 16384, 32768, 67584)] + [
    (8, K) for K in (28544, 65536, 135168)] + [(4, K) for K in (55936, 131072, 270336)]


@pytest.mark.parametrize("lanes,K", RING_SHAPES)
def test_ring_plan_fits_and_keeps_64_kib_in_flight(lanes, K):
    """The ring plan: one tile a block over every cell once, columns in
    whole quads a block's threads own, the carry and the ring within a
    block's shared memory, at least RING_MIN_BYTES of table a block in
    flight, the carry in passes of whole stages where it is tall."""
    p = km.scan_plan(K, lanes, SMS, deltas=True)
    assert p.ring_rows > 0 and p.two_phase and p.rows_smem == 0
    assert p.tiles == p.blocks <= SMS
    rows, cols = np.array(p.row_edges), np.array(p.col_edges)
    assert rows[0] == 0 and rows[-1] == K and (np.diff(rows) > 0).all()
    assert cols[0] == 0 and cols[-1] == K and (np.diff(cols) > 0).all()
    assert all(c % 4 == 0 for c in cols[:-1])
    width = int(np.diff(cols).max())
    assert width <= km.THREADS * p.cols and p.cols == (4 if lanes == 4 else 2)
    assert p.stride % 4 == 0 and p.stride >= width + 6
    assert p.ring_rows % km.RING_STAGE_ROWS == 0
    assert p.ring_rows <= km.RING_STAGE_ROWS * km.RING_STAGES_MAX
    assert p.ring_rows * width * 4 >= km.RING_MIN_BYTES
    kr_max = int(np.diff(rows).max())
    assert p.rows_streamed == kr_max
    assert p.carry_rows == kr_max or p.carry_rows % km.RING_STAGE_ROWS == 0
    carry = -(-p.carry_rows * p.lanes // 4) * 16
    assert p.smem == carry + p.ring_rows * p.stride * 4
    assert p.smem + km.STATIC_SMEM <= SMEM_LIMIT
    assert p.team == km.combine_team(-(-lanes * K // p.blocks), p.R)
    assert km.streamed_bytes(p) == K * K * 4
    if K == 16384:  # R=8 x C=16, the carry in one pass; partials within 16 MiB
        assert (p.R, p.C, p.carry_rows, p.ring_rows) == (8, 16, 2048, 24)
        assert 2 * p.R * p.lanes * K * 4 <= 16 * 2**20
    # every row's copy fits its slot, wherever logA's base lies
    for base in (0, 4, 8, 12):
        for r in range(p.R):
            for k in (p.row_edges[r], p.row_edges[r + 1] - 1):
                for c0, c1 in zip(p.col_edges, p.col_edges[1:]):
                    nbytes, off = _span_bytes(base + 4 * (k * K + c0), c1 - c0)
                    assert nbytes % 16 == 0 and nbytes <= 4 * p.stride
                    # the last thread's columns (CPT from lc) stay in the slot
                    last = -(-(c1 - c0) // p.cols) * p.cols
                    assert off + last <= p.stride
                    if base == 0 and K % 4 == 0:
                        assert off == 0 and nbytes == 4 * (c1 - c0)


def _ring_orders(kr: int, carry_rows: int, stages: int, steps: int):
    """The ring's stage sequence as the producer fills it (chunks of
    RING_STAGE_ROWS rows from each step's first row) and as the folding
    threads take it (each carry pass's rows in chunks): (slot, parity,
    first row, rows) each."""
    sr = km.RING_STAGE_ROWS

    def walk(chunks):
        out, s, ph = [], 0, 0
        for lr, n in chunks:
            out.append((s, ph, lr, n))
            s, ph = (0, ph ^ 1) if s + 1 == stages else (s + 1, ph)
        return out

    fill = [(lr, min(sr, kr - lr)) for _ in range(steps) for lr in range(0, kr, sr)]
    take = [(lr, min(sr, p1 - lr)) for _ in range(steps)
            for p0 in range(0, kr, carry_rows) for p1 in [min(kr, p0 + carry_rows)]
            for lr in range(p0, p1, sr)]
    return walk(fill), walk(take)


@pytest.mark.parametrize("lanes,K", RING_SHAPES)
def test_ring_stages_are_filled_and_folded_in_one_order(lanes, K):
    """Producer and folding threads agree on every stage's slot, parity and
    rows (so a carry pass never splits a stage), and each row of a tile
    folds once a step, in ascending order."""
    p = km.scan_plan(K, lanes, SMS, deltas=True)
    stages = p.ring_rows // km.RING_STAGE_ROWS
    for r in {0, p.R - 1}:
        kr = p.row_edges[r + 1] - p.row_edges[r]
        fill, take = _ring_orders(kr, p.carry_rows, stages, steps=2)
        assert fill == take
        rows = [lr + i for _, _, lr, n in take[:len(take) // 2] for i in range(n)]
        assert rows == list(range(kr))


def test_ring_emulated_decomposition_equals_plain(monkeypatch):
    """The ring plan's tiling (quads of columns, 2 a thread at 16 lanes,
    the carry in passes) run through the kernel's decomposition equals the
    plain deltas scan bit for bit, on a small card (16 threads a block, a
    few rows a tile) whose shared memory forces the passes."""
    monkeypatch.setattr(km, "THREADS", 16)
    monkeypatch.setattr(km, "MIN_TILE_ROWS", 3)
    monkeypatch.setattr(km, "RING_MIN_BYTES", 512)
    K, N, Tm = 131, 20, 4
    plan = km.ring_plan(K, N, 64, smem_bytes=km.STATIC_SMEM + 1700)
    assert plan is not None and plan.carry_rows < plan.rows_streamed and plan.C > 1
    logA, emits, delta0, _, _ = (torch.from_numpy(x) for x in _ties(K, N, Tm, 5, seed=8))
    got = _emulate(logA, delta0, lambda t, lanes: emits[t, lanes], Tm, plan, False)
    want = km.maxplus_scan_deltas_plain(logA, emits, delta0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _big_spy(monkeypatch, K):
    """The CUDA branch faked as in _spy, for a (K, K) table that is never
    allocated (an expanded row: the fake launch reads nothing), with the
    ``fvt.*`` spans the wrapper opens recorded."""
    calls = _spy(monkeypatch)
    spans = []

    def record(name):
        spans.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(km, "span", record)
    monkeypatch.setattr(km, "expect_contiguous", lambda **t: None)
    return calls, spans


@pytest.mark.parametrize("K,N,kind,ring", [(16384, 16, "deltas", True),
                                           (16384, 9, "deltas", True),
                                           (16384, 16, "scan", False),
                                           (16384, 16, "deltas_bf16", False),
                                           (3968, 16, "deltas", False),
                                           (16384, 1, "deltas", False)])
def test_the_wrapper_opens_the_ring_span_only_on_the_route(K, N, kind, ring, monkeypatch):
    """The deltas wrapper hands the kernel the ring plan and opens
    ``fvt.scan.ring`` around its launch exactly where the route is taken."""
    calls, spans = _big_spy(monkeypatch, K)
    dtype = torch.bfloat16 if kind.endswith("bf16") else torch.float32
    logA = torch.zeros((K, 1), dtype=dtype).expand(K, K)
    emits, delta0 = torch.zeros((1, N, K)), torch.zeros((N, K))
    fn = km.maxplus_scan if kind == "scan" else km.maxplus_scan_deltas
    fn(logA, emits, delta0)
    (_, args), = calls
    plan = km.scan_plan(K, N, SMS, elem_bytes=2 if dtype == torch.bfloat16 else 4,
                        deltas=kind != "scan")
    assert list(args[-4]) == list(plan.c_args())
    assert (plan.ring_rows > 0) == ring
    assert ("fvt.scan.ring" in spans) == ring


def test_a_ring_plan_is_refused_but_by_the_fp32_deltas_scan(monkeypatch):
    """A ring plan handed to the pointer scan or to the bf16 deltas scan is
    refused before any launch; the fp32 deltas scan takes it."""
    K, N = 16384, 16
    calls, spans = _big_spy(monkeypatch, K)
    plan = km.ring_plan(K, N, SMS)
    logA = torch.zeros((K, 1)).expand(K, K)
    emits, delta0 = torch.zeros((1, N, K)), torch.zeros((N, K))
    with pytest.raises(ValueError, match="ring plan"):
        km.maxplus_scan(logA, emits, delta0, plan=plan)
    with pytest.raises(ValueError, match="4-byte table values"):
        km.maxplus_scan_deltas(logA.to(torch.bfloat16), emits, delta0, plan=plan)
    assert calls == [] and spans == []
    km.maxplus_scan_deltas(logA, emits, delta0, plan=plan)
    assert list(calls[0][1][-4]) == list(plan.c_args())
    assert spans == ["fvt.scan.ring", "fvt.sync"]  # the call reads its own error word
