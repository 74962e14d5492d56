"""The beam scan's split over a thread-block cluster (``beam_plan``) and its
cluster-wide select.

The plan must give every column to exactly one CTA and fit a CTA's shared
memory; a test-side emulation of the kernel's order (per-CTA column ranges
folded in chunks, 8-bit radix passes over the CTAs' histograms, the prefix
over lower ranks and over columns on ties, the leader's rank sort of the B
winners) must equal the plain beam scan and the JAX Pallas ``beam_scan`` /
``beam_scan_planes`` (interpret mode) bit for bit on tie fixtures; and the
CUDA branch, spied on the CPU, must hand the kernel the plan, its scratch
and contiguous inputs, count one launch a call and raise on a timed-out
wait or a cluster the card cannot keep resident."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas import beam as pk
from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
from flash_viterbi_tpu_torch.ops import beam as tb
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import beam as kb
from flash_viterbi_tpu_torch.ops.cuda.common import SMEM_LIMIT

torch.set_num_threads(2)

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("N", [1, 8, 20])
@pytest.mark.parametrize("Bk", ["1", "64", "Kp"])
@pytest.mark.parametrize("Kp", [1, 7, 64, 1000, 3968, 17024, 70000])
def test_plan_covers_every_column_once_and_fits_a_cta(Kp, Bk, N):
    B = {"1": 1, "64": min(64, Kp), "Kp": Kp}[Bk]
    for P in (0, 7):
        p = kb.beam_plan(Kp, B, N, SMS, P)
        edges = np.array(p.col_edges)
        assert len(edges) == p.C + 1 and 1 <= p.C <= kb.cluster_cap(Kp)
        # edges rise from 0 to Kp: every column lies in exactly one CTA
        assert edges[0] == 0 and edges[-1] == Kp and (np.diff(edges) > 0).all()
        assert all(e % 4 == 0 for e in edges[:-1])  # bulk copies start 16-byte aligned
        assert np.diff(edges).max() <= p.width and p.width % 4 == 0
        assert p.cw % 4 == 0 and p.cw <= kb.THREADS * kb.JMAX and p.cw <= p.width
        assert 1 <= p.rg <= kb.ROWS_A_GROUP and 1 <= p.g <= kb.GROUPS_MAX
        assert p.state_words >= 2 * p.width + 7 * B + 2 * P * B and p.state_words % 4 == 0
        assert p.smem == p.g * p.rg * p.cw * 4 + (p.state_words * 4 if p.state_smem else 0)
        assert p.smem + kb.STATIC_SMEM <= SMEM_LIMIT
        assert p.lda == -(-Kp // 4) * 4
        if Kp == 3968 and B == 64:  # the headline: one cluster of 16, all in shared memory
            assert p.C == (16 if N <= SMS // 16 else 8 if N <= SMS // 8 else 4)
            assert p.state_smem and (p.g * p.rg >= B or p.C < 16)
        if Kp == 17024 and B == 64:  # the select in shared memory, the rows in a ring
            assert p.state_smem and p.g * p.rg < B
            assert p.C == 16 or N > 1
    if B == Kp and Kp >= 17024:
        assert not kb.beam_plan(Kp, B, N, SMS).state_smem  # thousands of beam entries


def test_plan_takes_the_largest_cluster_whose_lanes_are_all_resident():
    assert kb.beam_plan(3968, 64, 1, SMS).C == 16
    assert kb.beam_plan(3968, 64, 8, SMS, active={16: 7, 8: 16}).C == 8
    assert kb.beam_plan(3968, 64, 8, SMS, active={16: 8, 8: 16}).C == 16
    assert kb.beam_plan(3968, 64, 64, SMS, active={16: 7, 8: 16, 4: 33, 2: 66}).C == 2
    assert kb.beam_plan(3968, 64, 200, SMS, active={16: 7, 8: 16, 4: 33, 2: 66}).C == 1
    assert kb.beam_plan(1000, 64, 1, SMS).C == 4  # 1000 // MIN_COLS = 7: a power of two
    assert kb.beam_plan(64, 8, 1, SMS).C == 1
    assert kb.beam_plan(3968, 64, 1, SMS, C=2).C == 2
    with pytest.raises(ValueError, match="cluster of 17"):
        kb.beam_plan(3968, 64, 1, SMS, C=17)
    with pytest.raises(ValueError, match="B <= Kp"):
        kb.beam_plan(64, 65, 1, SMS)
    wide = kb.beam_plan(70000, 64, 1, SMS)  # 4376 columns a CTA: chunks of 2048
    assert wide.cw == kb.THREADS * kb.JMAX and -(-wide.width // wide.cw) == 3


def _orderable(v: np.ndarray) -> np.ndarray:
    """The kernel's key: float32 bits mapped so that unsigned order is value order."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _from_orderable(o: np.ndarray) -> np.ndarray:
    u = np.where(o & 0x80000000, o & 0x7fffffff, ~o).astype(np.uint32)
    return u.view(np.float32)


def _select(keys: np.ndarray, edges, B: int) -> np.ndarray:
    """The kernel's cluster select on one lane's (Kp,) keys: the B winning
    columns in the positions the kernel writes them to."""
    C = len(edges) - 1
    need, prefix, shift, whole = B, 0, 32, False
    above_before, eq_before = np.zeros(C, np.int64), np.zeros(C, np.int64)
    for p in range(4):
        shift -= 8
        hists = []
        for r in range(C):  # each CTA's histogram of its keys under the prefix
            k = keys[edges[r]:edges[r + 1]]
            if p:
                k = k[(k >> np.uint32(shift + 8)) == prefix]
            hists.append(np.bincount((k >> np.uint32(shift)) & 255, minlength=256))
        hists = np.array(hists, np.int64)
        H = hists.sum(0)
        S = np.cumsum(H[::-1])[::-1]  # suffix sums, highest bin first
        (d,) = np.nonzero((S >= need) & (S - H < need))[0]
        lower = np.cumsum(hists, 0) - hists  # each CTA's sums over the lower ranks
        above_before += lower[:, d + 1:].sum(1)
        eq_before = lower[:, d]
        need -= int(S[d] - H[d])
        prefix = (prefix << 8) | int(d)
        whole = need == H[d]
        if whole:
            break
    at = np.full(B, -1)
    for r in range(C):
        k = keys[edges[r]:edges[r + 1]] >> np.uint32(shift)
        a, e = k > prefix, k == prefix
        room = np.iinfo(np.int64).max if whole else max(0, need - int(eq_before[r]))
        base = above_before[r] + (eq_before[r] if whole else min(need, eq_before[r]))
        xa, xe = np.cumsum(a) - a, np.cumsum(e) - e  # exclusive, in column order
        taken = a | (e & (xe < room))
        pos = base + xa + np.minimum(xe, room)
        assert (at[pos[taken]] == -1).all()
        at[pos[taken]] = edges[r] + np.nonzero(taken)[0]
    assert (at >= 0).all()
    return at


def _emulate(logA, emits, vals0, states0, valid, prop, plan):
    """The kernel in numpy, lane by lane in its order: each CTA folds its
    columns chunk by chunk, beam slots ascending with a strict '>', adds the
    emission after the max; the cluster select; the leader's rank sort of
    the winners by (key descending, index ascending) and its planes."""
    Tm, N, Kp = emits.shape
    B = vals0.shape[1]
    P = 0 if prop is None else prop.shape[1]
    hist = np.empty((Tm, N, B), np.int32)
    slots = np.empty((Tm, N, B), np.int32)
    planes_out = np.full((N, P, B), -1, np.int32)
    edges = plan.col_edges
    for n in range(N):
        vals, states = vals0[n].copy(), states0[n].astype(np.int64)
        planes = np.full((P, B), -1, np.int64)
        for t in range(Tm):
            if valid is not None and not valid[t, n]:
                hist[t, n], slots[t, n] = states, np.arange(B)
                continue
            best = np.full(Kp, -np.inf, np.float32)
            sl = np.zeros(Kp, np.int64)
            for r in range(plan.C):
                for c0 in range(edges[r], edges[r + 1], plan.cw):
                    cols = slice(c0, min(edges[r + 1], c0 + plan.cw))
                    for b in range(B):
                        c = vals[b] + logA[states[b], cols]
                        take = c > best[cols]
                        best[cols] = np.where(take, c, best[cols])
                        sl[cols] = np.where(take, b, sl[cols])
            keys = _orderable((best + emits[t, n]) + np.float32(0))
            won = _select(keys, edges, B)
            won = won[np.lexsort((won, ~keys[won]))]  # key descending, index ascending
            bs = sl[won]
            hist[t, n], slots[t, n] = won, bs
            if P:
                planes = np.where(prop[t][:, None], planes[:, bs], states[bs][None, :])
            vals, states = _from_orderable(keys[won]), won
        planes_out[n] = planes
    return hist, slots, planes_out


def _ties(K, N, Tm, B, P, seed, density=0.02):
    """Integer-valued tables (exact fp32 ties everywhere) made sparse, start
    rows with few finite scores (the early beams hold fewer than B), a
    ragged valid mask and a P-plane schedule."""
    rng = np.random.default_rng(seed)
    logA = np.where(rng.random((K, K)) < density,
                    np.round(rng.standard_normal((K, K)) * 2) / 2, -np.inf) + 0.0
    emits = np.round(rng.standard_normal((Tm, N, K))) + 0.0
    start = np.where(rng.random((N, K)) < 0.01, np.round(rng.standard_normal((N, K))),
                     -np.inf) + 0.0
    vals0, states0 = tb.beam_topk(torch.from_numpy(start.astype(np.float32)), B)
    valid = rng.random((Tm, N)) < 0.8
    valid[0, 0] = True
    prop = prop_schedule(flash_midpoints(0, Tm, P + 1), Tm + 1) if P else None
    return (logA.astype(np.float32), emits.astype(np.float32), vals0.numpy(),
            states0.numpy(), valid, prop)


def _check(fixture, plan, masked=True):
    logA, emits, vals0, states0, valid, prop = fixture
    v = valid if masked else None
    got = _emulate(logA, emits, vals0, states0, v, prop, plan)
    want = tb.beam_scan_plain(*(torch.from_numpy(x) for x in (logA, emits, vals0, states0)),
                              None if v is None else torch.from_numpy(v),
                              None if prop is None else torch.from_numpy(prop))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return got


@pytest.mark.parametrize("C", [1, 4, 16])
def test_emulated_select_equals_plain_and_pallas(C):
    """K=1000, B=128, P=3 on a sparse tie fixture, three ragged lanes: the
    emulation equals the plain beam scan; lane 0 unmasked also equals the
    Pallas beam_scan_planes in interpret mode."""
    K, N, Tm, B, P = 1000, 3, 4, 128, 3
    fixture = _ties(K, N, Tm, B, P, seed=C)
    plan = kb.beam_plan(K, B, N, SMS, P, C=C)
    _check(fixture, plan)
    hist, slots, planes = _check(fixture, plan, masked=False)
    logA, emits, vals0, states0, _, prop = fixture
    want = pk.beam_scan_planes(jnp.asarray(logA), jnp.asarray(emits[:, 0]),
                               jnp.asarray(vals0[0]), jnp.asarray(states0[0]),
                               jnp.asarray(prop.astype(np.int32)), interpret=True)
    for g, w in zip((hist[:, 0], slots[:, 0], planes[0]), want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("K,B,C,cw", [
    (1000, 1, 16, None),   # B=1: one winner, the earliest passes end the select
    (200, 200, 4, None),   # the full beam: every column a winner
    (200, 200, 16, None),
    (1000, 64, 2, 128),    # chunks of 128 columns: four a CTA
])
def test_emulated_select_at_beam_extremes(K, B, C, cw):
    fixture = _ties(K, 2, 5, B, 2, seed=K + B + C, density=0.05)
    plan = kb.beam_plan(K, B, 2, SMS, 2, C=C)
    if cw:
        plan = plan._replace(cw=cw)
    _check(fixture, plan)


def test_emulated_select_on_dense_ties_and_negative_zero():
    """A row of ties, -inf and -0.0 (which ranks equal to +0.0) through an
    all-zero table: the emulation and the plain scan take the same top B at
    B = 1, 128 and K on clusters of 1, 4 and 16."""
    K = 1000
    row = np.random.default_rng(11).choice(
        np.array([1.0, 0.5, 0.0, -0.0, -2.0, -np.inf], np.float32), K)
    for B in (1, 128, K):
        args = (np.zeros((K, K), np.float32), row[None, None, :],
                np.zeros((1, B), np.float32), np.zeros((1, B), np.int32), None, None)
        for C in (1, 4, 16):
            _check(args, kb.beam_plan(K, B, 1, SMS, C=C), masked=False)


def _spy(monkeypatch, clusters: int = 8, timeout: bool = False):
    """Fake the CUDA branch: every device check answers CUDA, the card has
    SMS SMs and keeps ``clusters`` clusters resident; the launch records its
    arguments and counts, and with ``timeout`` sets the error word."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        if timeout:
            ctypes.c_int.from_address(args[10]).value = 1
        counter.launches += 1

    monkeypatch.setattr(kb, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kb, "launch", fake_launch)
    monkeypatch.setattr(kb, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(kb, "_clusters", lambda index, plan: clusters)
    monkeypatch.setattr(kb, "_card_plan", lambda index, sms, Kp, B, N, P: kb.beam_plan(
        Kp, B, N, sms, P, active={c: clusters for c in (16, 8, 4, 2)}))
    tk.reset_launches()
    return calls


def test_cuda_branch_passes_plan_scratch_and_counts_one_launch_a_call(monkeypatch):
    calls = _spy(monkeypatch)
    logA, emits, vals0, states0, valid, prop = (
        x if x is None else torch.from_numpy(x) for x in _ties(1000, 3, 4, 64, 2, seed=1))
    with pytest.raises(ValueError, match="contiguous"):
        kb.beam_scan(logA.t(), emits, vals0, states0)
    with pytest.raises(ValueError, match="contiguous"):
        kb.beam_scan(logA, emits.transpose(0, 1).contiguous().transpose(0, 1), vals0, states0)
    assert calls == []
    kb.beam_scan(logA, emits, vals0, states0, valid, prop)
    (fn_name, args), = calls
    assert fn_name == "fvt_beam_scan"
    plan = kb.beam_plan(1000, 64, 3, SMS, 2, active={c: 8 for c in (16, 8, 4, 2)})
    assert plan.C == 4 and plan.state_smem  # 1000 columns: at most 7 CTAs
    assert list(args[11]) == list(plan.c_args())
    assert args[9] is None  # the state in shared memory: no scratch
    assert args[10] is not None  # the call's own error word
    assert args[-5:] == (4, 3, 1000, 64, 2)
    assert args[0] == logA.data_ptr()  # Kp % 4 == 0: the table as it is
    assert tk.launch_counts()["beam_scan"] == 1
    # no launch for zero steps
    hist, slots, planes = kb.beam_scan(logA, emits[:0], vals0, states0)
    assert len(calls) == 1 and hist.shape == (0, 3, 64) and (planes.shape == (3, 0, 64))


def test_cuda_branch_scratch_padding_and_plans(monkeypatch):
    """The full beam at Kp=17000 keeps its state in a global scratch of one
    region a (lane, CTA); an odd Kp gets a logA padded to a multiple of 4
    columns; a caller's plan reaches the kernel as given and one of another
    shape is refused."""
    calls = _spy(monkeypatch)
    Kp = 17000
    logA = torch.zeros((Kp, 1)).expand(Kp, Kp)  # no (Kp, Kp) allocation
    monkeypatch.setattr(kb, "expect_contiguous", lambda **t: None)
    kb.beam_scan(logA, torch.zeros((2, 1, Kp)), torch.zeros((1, Kp)),
                 torch.zeros((1, Kp), dtype=torch.int32))
    plan = kb.beam_plan(Kp, Kp, 1, SMS, active={c: 8 for c in (16, 8, 4, 2)})
    assert not plan.state_smem and calls[0][1][9] is not None
    assert list(calls[0][1][11]) == list(plan.c_args())
    K = 1001
    fixture = [torch.from_numpy(x) for x in _ties(K, 1, 2, 8, 0, seed=2)[:4]]
    kb.beam_scan(*fixture)
    assert calls[1][1][0] != fixture[0].data_ptr()  # a padded copy, lda = 1004
    assert list(calls[1][1][11])[-1] == 1004
    mine = kb.beam_plan(K, 8, 1, SMS, C=2)
    kb.beam_scan(*fixture, plan=mine)
    assert list(calls[2][1][11]) == list(mine.c_args())
    with pytest.raises(ValueError, match="the plan is for"):
        kb.beam_scan(*fixture, plan=kb.beam_plan(1000, 8, 1, SMS))
    assert len(calls) == 3


def test_cuda_branch_raises_on_a_timeout_and_an_unschedulable_cluster(monkeypatch):
    fixture = [torch.from_numpy(x) for x in _ties(200, 1, 2, 8, 0, seed=3)[:4]]
    _spy(monkeypatch, timeout=True)
    with pytest.raises(RuntimeError, match="beam_scan: a grid barrier or a copy barrier"):
        kb.beam_scan(*fixture)
    assert tk.launch_counts()["beam_scan"] == 1
    calls = _spy(monkeypatch, clusters=0)
    with pytest.raises(RuntimeError, match="cannot keep one cluster"):
        kb.beam_scan(*fixture, plan=kb.beam_plan(200, 8, 1, SMS, C=16))
    assert calls == []
