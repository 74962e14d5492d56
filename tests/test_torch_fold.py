"""The pointer-row fold's split over a thread-block cluster (``fold_plan``)
and its grouped algorithm.

The plan must give every row to exactly one CTA in order, fill the SMs
without passing them and keep the maps in shared memory exactly where they
fit; a test-side mirror of the kernel's order (each CTA's rows folded into
an index map from the identity, the maps joined pairwise in the kernel's
rounds, the result applied to the planes) must equal the plain fold, the
JAX package's ``lax.scan`` folds (``flash_viterbi_tpu/algorithms/flash.py``
:185-190 with one row a step, :396-401 with a row a plane) and a numpy
sequential fold with the card's -1 rule bit for bit; and the CUDA branch,
spied on the CPU, must hand the kernel the plan, its scratch and
contiguous inputs and count one launch a call."""

import ctypes
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import fold as kf

torch.set_num_threads(2)

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("c", [1, 3, 7, 64, 128, 1000])
@pytest.mark.parametrize("P", [1, 2, 15, 118, 200])
def test_plan_tiles_the_rows_and_fills_the_card(P, c):
    for R, K, sms in itertools.product(sorted({1, P}), (1, 37, 3968, 28928, 28929, 30000,
                                                         58112, 60000), (16, SMS)):
        p = kf.fold_plan(P, c, R, K, sms)
        edges = np.array(p.row_edges)
        assert 1 <= p.G <= kf.CLUSTER_MAX and len(edges) == p.G + 1
        # edges rise from 0 to c: every row lies in exactly one CTA, in order
        assert edges[0] == 0 and edges[-1] == c and (np.diff(edges) > 0).all()
        if P < sms:
            assert P * p.G <= sms
        if p.G > 1:
            assert np.diff(edges).min() >= kf.MIN_ROWS and P * p.G <= sms
        # the maps leave shared memory exactly where their 2 K ints do not fit
        assert p.maps_smem == (2 * K * 4 <= kf.FOLD_SMEM)
        assert 0 <= p.ring <= min(kf.RING_MAX, np.diff(edges).max())
        assert p.ring == 0 or K % 4 == 0
        assert p.smem == (2 * K * 4 if p.maps_smem else 0) + p.ring * 4 * K
        assert p.smem <= kf.FOLD_SMEM
        if p.maps_smem and K % 4 == 0 and K <= 3968:
            assert p.ring == min(kf.RING_MAX, np.diff(edges).max())


def test_plan_picks_the_cluster_of_each_decode_shape():
    # lean phase 1's chunk: 15 anchor planes, 64 rows of one pointer row a step
    assert kf.fold_plan(15, 64, 1, 3968, SMS).G == 8
    # the round shape: 118 t2 planes, a row each, fill the card alone
    assert kf.fold_plan(118, 64, 118, 3968, SMS).G == 1
    # sieve_mp's top level: one plane of ~128 rows
    top = kf.fold_plan(1, 128, 1, 3968, SMS)
    assert top.G == 16 and top.row_edges == tuple(range(0, 129, 8))
    assert kf.fold_plan(1, 7, 1, 3968, SMS).G == 1  # too few rows to split
    assert kf.fold_plan(1, 8, 1, 3968, SMS).G == 2
    # residency: 16-CTA clusters fit 7 at once, 8-CTA ones 15
    active = {16: 7, 8: 15, 4: 30, 2: 66}
    assert kf.fold_plan(7, 64, 1, 3968, SMS, active=active).G == 16
    assert kf.fold_plan(8, 64, 1, 3968, SMS, active=active).G == 8
    assert kf.fold_plan(16, 64, 1, 3968, SMS, active=active).G == 4
    assert kf.fold_plan(15, 64, 1, 3968, SMS, active={8: 14, 4: 30}).G == 4
    assert kf.fold_plan(15, 64, 1, 3968, SMS, G=2).G == 2
    with pytest.raises(ValueError, match="cluster of 17"):
        kf.fold_plan(1, 64, 1, 3968, SMS, G=17)
    with pytest.raises(ValueError, match="cluster of 4 CTAs for 3 rows"):
        kf.fold_plan(1, 3, 1, 3968, SMS, G=4)
    with pytest.raises(ValueError, match="R = 1 or P"):
        kf.fold_plan(4, 8, 2, 3968, SMS)
    # the scratch fixture: K=30000 keeps its maps in global memory, one row in the ring
    big = kf.fold_plan(3, 5, 1, 30000, SMS)
    assert not big.maps_smem and big.ring == 1 and big.smem == 120000
    assert kf.fold_plan(3, 5, 1, 30001, SMS).ring == 0  # rows not 16-byte multiples


def _fold_numpy(planes, rows, prop):
    """The fold one row at a time with the card's rule: a pointer outside
    [0, K) gives -1."""
    out = planes.copy()
    K = planes.shape[1]
    for t in range(rows.shape[0]):
        for p in range(planes.shape[0]):
            row = rows[t, 0 if rows.shape[1] == 1 else p]
            if prop[t, p]:
                ok = (row >= 0) & (row < K)
                out[p] = np.where(ok, out[p][np.where(ok, row, 0)], -1)
            else:
                out[p] = row
    return out


def _fold_grouped(planes, rows, prop, edges):
    """The kernel's order in torch: CTA g folds rows [edges[g], edges[g+1])
    into (V, reset) from the identity; the maps join pairwise, CTA g taking
    in CTA g + s for s = 1, 2, 4, ...; CTA 0's map is applied."""
    P, K = planes.shape
    R = rows.shape[1]

    def gather(V, idx):  # V[idx] per plane, -1 where idx is outside [0, K)
        ok = (idx >= 0) & (idx < K)
        return torch.where(ok, V.gather(1, torch.where(ok, idx, 0).long()), -1)

    maps = []
    for g in range(len(edges) - 1):
        V, reset = torch.arange(K, dtype=torch.int32).expand(P, K), torch.zeros(P, dtype=bool)
        for t in range(edges[g], edges[g + 1]):
            row = rows[t].expand(P, K) if R == 1 else rows[t]
            V = torch.where(prop[t][:, None], gather(V, row), row)
            reset |= ~prop[t]
        maps.append((V, reset))
    G, s = len(maps), 1
    while s < G:
        for g in range(0, G - s, 2 * s):
            (A, ra), (B, rb) = maps[g], maps[g + s]
            maps[g] = (torch.where(rb[:, None], B, gather(A, B)), ra | rb)
        s *= 2
    V, reset = maps[0]
    return torch.where(reset[:, None], V, gather(planes, V))


def _fold_jax(planes, rows, prop):
    """The JAX package's folds as ``lax.scan``s: flash.py:185-190 (one row a
    step for every plane) and :396-401 (a row a plane, its schedule the
    record flags)."""
    planes, rows, prop = jnp.asarray(planes), jnp.asarray(rows), jnp.asarray(prop)
    if rows.shape[1] == 1:
        def fold(pl, x):
            row, pr = x
            moved = jnp.take_along_axis(pl, row[None, :], axis=1)
            return jnp.where(pr[:, None], moved, row[None, :]), None

        out, _ = jax.lax.scan(fold, planes, (rows[:, 0, :], prop))
    else:
        def fold(t2c, x):
            row, r = x
            moved = jnp.take_along_axis(t2c, row, axis=1)
            return jnp.where(r[:, None], row, moved), None

        out, _ = jax.lax.scan(fold, planes, (rows, ~prop))
    return np.asarray(out)


def _fixture(P, c, R, K, seed, schedule="random"):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, K, (P, K)).astype(np.int32)
    rows = rng.integers(0, K, (c, R, K)).astype(np.int32)
    prop = {"random": rng.random((c, P)) < 0.7, "propagate": np.ones((c, P), bool),
            "record": np.zeros((c, P), bool)}[schedule]
    return planes, rows, prop


def _check(planes, rows, prop, G):
    P, K = planes.shape
    c, R, _ = rows.shape
    plan = kf.fold_plan(P, c, R, K, SMS, G=G)
    got = _fold_grouped(*(torch.from_numpy(x) for x in (planes, rows, prop)), plan.row_edges)
    want = _fold_numpy(planes, rows, prop)
    np.testing.assert_array_equal(got.numpy(), want)
    if ((rows >= 0) & (rows < K)).all():
        plain = kf.fold_planes(*(torch.from_numpy(x) for x in (planes, rows, prop)))
        np.testing.assert_array_equal(plain.numpy(), want)
        np.testing.assert_array_equal(_fold_jax(planes, rows, prop), want)


@pytest.mark.parametrize("R", ["1", "P"])
@pytest.mark.parametrize("G", list(range(1, 17)))
def test_grouped_fold_equals_plain_jax_and_numpy(G, R):
    P, c, K = 3, 37, 29
    _check(*_fixture(P, c, 1 if R == "1" else P, K, seed=G), G)


@pytest.mark.parametrize("G", [2, 4, 5, 8, 16])
def test_resets_on_before_and_after_group_boundaries(G):
    """A plane whose only record sits on a group's first row, on the row
    before it, after it, in the last row, and a plane never recording: a
    reset in group g makes the earlier groups and the input plane irrelevant."""
    P, c, K = 6, 32, 23
    planes, rows, _ = _fixture(P, c, 1, K, seed=40 + G)
    edges = kf.fold_plan(P, c, 1, K, SMS, G=G).row_edges
    b = edges[G // 2]
    prop = np.ones((c, P), bool)
    for p, t in enumerate((b, b - 1, b + 1, c - 1, 0)):
        prop[t, p] = False
    _check(planes, rows, prop, G)
    prop[:, 1] = np.arange(c) % 5 != 0  # a record every 5 rows across every boundary
    _check(planes, rows, prop, G)


@pytest.mark.parametrize("schedule", ["propagate", "record"])
@pytest.mark.parametrize("G", [1, 3, 8, 16])
def test_all_propagate_and_all_record(schedule, G):
    for R in (1, 4):
        _check(*_fixture(4, 16, R, 31, seed=G, schedule=schedule), G)


@pytest.mark.parametrize("R", [1, 3])
def test_one_row(R):
    for schedule in ("random", "propagate", "record"):
        _check(*_fixture(3, 1, R, 17, seed=R, schedule=schedule), 1)


@pytest.mark.parametrize("G", [1, 2, 7, 16])
def test_out_of_range_pointers_give_minus_one(G):
    """Pointers -1, -7, K and K + 5 planted in the rows: -1 where a plane
    follows them, their values where it records them, and -1 carried
    through later rows and joins (held against the numpy fold only: the
    plain version raises on them)."""
    P, c, K = 5, 24, 19
    planes, rows, prop = _fixture(P, c, 1, K, seed=70 + G)
    rng = np.random.default_rng(G)
    for t in range(c):
        rows[t, 0, rng.integers(0, K, 3)] = rng.choice([-1, -7, K, K + 5], 3)
    prop[c // 3, 0] = False
    _check(planes, rows, prop, G)
    with pytest.raises((IndexError, RuntimeError)):
        kf.fold_planes(*(torch.from_numpy(x) for x in (planes, rows, prop)))


def _spy(monkeypatch, clusters: int = 15, timeout: bool = False):
    """Fake the CUDA branch: every device check answers CUDA, the card has
    SMS SMs and keeps ``clusters`` clusters resident; the launch records its
    arguments and counts, and with ``timeout`` sets the error word."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        if timeout:
            ctypes.c_int.from_address(args[5]).value = 1
        counter.launches += 1

    monkeypatch.setattr(kf, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kf, "launch", fake_launch)
    monkeypatch.setattr(kf, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(kf, "_clusters", lambda index, G, maps_smem, smem: clusters)
    monkeypatch.setattr(kf, "_card_plan", lambda index, sms, P, c, R, K: kf.fold_plan(
        P, c, R, K, sms, active={g: clusters for g in (16, 8, 4, 2)}))
    tk.reset_launches()
    return calls


def test_cuda_branch_passes_plan_scratch_and_counts_one_launch_a_call(monkeypatch):
    calls = _spy(monkeypatch)
    planes, rows, prop = (torch.from_numpy(x) for x in _fixture(15, 64, 1, 3968, seed=1))
    with pytest.raises(ValueError, match="contiguous"):
        kf.fold_planes(planes.t().contiguous().t(), rows, prop)
    with pytest.raises(ValueError, match="contiguous"):
        kf.fold_planes(planes, rows, prop.t().contiguous().t())
    assert calls == []
    kf.fold_planes(planes, rows, prop)
    (fn_name, args), = calls
    assert fn_name == "fvt_fold_planes"
    plan = kf.fold_plan(15, 64, 1, 3968, SMS)
    assert plan.G == 8 and plan.maps_smem and plan.ring == kf.RING_MAX
    assert list(args[6]) == list(plan.c_args())
    assert args[4] is None  # the maps in shared memory: no scratch
    assert args[5] is not None  # the call's own error word
    assert args[:3] == (planes.data_ptr(), rows.data_ptr(), prop.data_ptr())
    assert args[-4:] == (64, 1, 15, 3968)
    assert tk.launch_counts()["fold_planes"] == 1
    # a forced plan reaches the kernel as given; one for other rows is refused
    mine = kf.fold_plan(15, 64, 1, 3968, SMS, G=16)
    kf.fold_planes(planes, rows, prop, plan=mine)
    assert list(calls[1][1][6]) == list(mine.c_args()) and calls[1][1][6][0] == 16
    with pytest.raises(ValueError, match="the plan is for"):
        kf.fold_planes(planes, rows, prop, plan=kf.fold_plan(15, 32, 1, 3968, SMS))
    # a shared error word is passed through and not read
    err = torch.zeros(1, dtype=torch.int32)
    kf.fold_planes(planes, rows, prop, err=err)
    assert calls[2][1][5] == err.data_ptr()
    # no launch for zero rows or zero planes
    kf.fold_planes(planes, rows[:0], prop[:0])
    kf.fold_planes(planes[:0], rows, prop[:, :0])
    assert len(calls) == 3 and tk.launch_counts()["fold_planes"] == 3


def test_cuda_branch_allocates_the_scratch_only_where_the_plan_asks(monkeypatch):
    calls = _spy(monkeypatch)
    K = 30000
    planes, rows, prop = (torch.from_numpy(x) for x in _fixture(3, 5, 1, K, seed=2))
    kf.fold_planes(planes, rows, prop)
    plan = kf.fold_plan(3, 5, 1, K, SMS)
    assert not plan.maps_smem and calls[0][1][4] is not None
    assert list(calls[0][1][6]) == list(plan.c_args())
    # a plan squeezed out of shared memory at K=3968 takes the scratch too
    planes, rows, prop = (torch.from_numpy(x) for x in _fixture(2, 16, 2, 3968, seed=3))
    squeezed = kf.fold_plan(2, 16, 2, 3968, SMS, smem_bytes=16000, G=4)
    assert not squeezed.maps_smem and squeezed.ring == 1
    kf.fold_planes(planes, rows, prop, plan=squeezed)
    assert calls[1][1][4] is not None and list(calls[1][1][6]) == list(squeezed.c_args())
    kf.fold_planes(planes, rows, prop)
    assert calls[2][1][4] is None
    assert tk.launch_counts()["fold_planes"] == 3


def test_cuda_branch_raises_on_a_timeout_and_an_unschedulable_cluster(monkeypatch):
    planes, rows, prop = (torch.from_numpy(x) for x in _fixture(2, 16, 1, 64, seed=4))
    _spy(monkeypatch, timeout=True)
    with pytest.raises(RuntimeError, match="fold_planes: a grid barrier or a copy barrier"):
        kf.fold_planes(planes, rows, prop)
    assert tk.launch_counts()["fold_planes"] == 1
    calls = _spy(monkeypatch, clusters=0)
    with pytest.raises(RuntimeError, match="cannot keep one cluster"):
        kf.fold_planes(planes, rows, prop)
    assert calls == []
