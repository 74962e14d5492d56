"""The pointer walk's plan and its three phases, on the CPU.

The port's ``backtrack_batched_plain`` against the JAX package's
``backtrack_pallas_batched`` (interpret mode) on tables whose lane paths
meet entries below -1, of K and above, and out-of-range last states; the
invariants of ``backtrack_plan``; and a torch emulation of the kernel's
phases A-C (``csrc/backtrack.cu``) under forced plans, held to the plain
version and to JAX, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas import backtrack as pb
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import backtrack as tkb

torch.set_num_threads(2)

H100_SMS = 132


def _jax(ptrs, last):
    return np.asarray(pb.backtrack_pallas_batched(jnp.asarray(ptrs), jnp.asarray(last),
                                                  interpret=True))


def _plain(ptrs, last):
    return tkb.backtrack_batched_plain(torch.from_numpy(ptrs), torch.from_numpy(last)).numpy()


def _planted(Tm, N, K, seed, last_out=True):
    """Random pointers in [0, K) with -5, -1, K and K+3 planted on the lane
    paths (each lane's walk meets one), and, with ``last_out``, lanes that
    end in K+7 and in -2 beside lanes that end in range."""
    rng = np.random.default_rng(seed)
    ptrs = rng.integers(0, K, (Tm, N, K)).astype(np.int32)
    last = rng.integers(0, K, N).astype(np.int32)
    plants = (-5, -1, K, K + 3)
    for n in range(N):
        s, t_hit = int(last[n]), int(rng.integers(0, Tm))
        for t in range(Tm - 1, t_hit, -1):  # follow the walk down to row t_hit
            s = int(ptrs[t, n, s])
        ptrs[t_hit, n, s] = plants[n % len(plants)]
    if last_out and N >= 3:
        last[1], last[2] = K + 7, -2
    return ptrs, last


# (a) the negative-pointer rule: the JAX package's, not the table's entry

def test_negative_pointer_reads_as_minus_one_as_the_tpu_kernel_does():
    """The repro: Tm=12, N=3, K=256, a -5 on lane 0's path at t=6 and K+3
    on lane 1's; JAX's interpret-mode kernel writes -1 at t=6, and so must
    the plain version (it wrote -5)."""
    Tm, N, K = 12, 3, 256
    rng = np.random.default_rng(0)
    ptrs = rng.integers(0, K, (Tm, N, K)).astype(np.int32)
    last = np.array([3, 17, 200], np.int32)

    def state_at(n, t):
        s = int(last[n])
        for u in range(Tm - 1, t, -1):
            s = int(ptrs[u, n, s])
        return s

    ptrs[6, 0, state_at(0, 6)] = -5
    ptrs[4, 1, state_at(1, 4)] = K + 3
    want = _jax(ptrs, last)
    got = _plain(ptrs, last)
    np.testing.assert_array_equal(got, want)
    assert got[0, 6] == -1 and (got[0, :6] == -1).all()
    assert got[1, 4] == K + 3 and (got[1, :4] == -1).all()
    assert (got[2] >= 0).all()


@pytest.mark.parametrize("Tm,N,K,seed", [(9, 4, 128, 1), (30, 5, 64, 2), (17, 3, 256, 3)])
def test_planted_out_of_range_entries_match_jax(Tm, N, K, seed):
    ptrs, last = _planted(Tm, N, K, seed)
    want = _jax(ptrs, last)
    np.testing.assert_array_equal(_plain(ptrs, last), want)
    assert (want[1, :Tm] == -1).all() and (want[2, :Tm] == -1).all()


# (b) the plan's invariants

SHAPES = [(255, 1, 3968), (16383, 1, 3968), (15, 1, 3968), (16, 1, 3968), (256, 1, 3968),
          (255, 1, 64), (255, 16, 3968), (255, 64, 3968), (4096, 1, 16384), (1, 1, 64),
          (2, 1, 64), (100, 3, 1001), (64, 1, 29056), (64, 1, 40000), (65535, 1, 16384),
          (31, 64, 4096)]


@pytest.mark.parametrize("Tm,N,K", SHAPES)
def test_plan_invariants(Tm, N, K):
    plan = tkb.backtrack_plan(Tm, N, K, H100_SMS)
    if plan.serial:
        assert plan.L == Tm and plan.blocks == -(-N // tkb.SERIAL_THREADS)
        assert plan.scratch_words(N, K) == 0 and plan.E == 1
        return
    G, L = plan.G, plan.L
    edges = [min(c * L, Tm) for c in range(G + 1)]
    assert edges[0] == 0 and edges[-1] == Tm and G >= 2
    assert all(b - a == L for a, b in zip(edges[:-2], edges[1:-1]))  # full chunks
    assert 1 <= edges[-1] - edges[-2] <= L                             # a ragged tail
    assert Tm >= tkb.SERIAL_ROWS and N * K <= tkb.SERIAL_ENTRIES
    assert G * N * plan.S <= H100_SMS and plan.blocks == G * N * plan.S  # one wave
    # G near sqrt(2 T'), or as many as the wave holds
    assert G <= round((2 * Tm) ** 0.5)
    assert G >= 0.8 * (2 * Tm) ** 0.5 or G * N * plan.S * 2 > H100_SMS
    slice_max = -(-K // plan.S)
    assert plan.E in (1, 2, 4, 8, 16) and plan.E * tkb.THREADS >= slice_max
    assert plan.E == 1 or (plan.E // 2) * tkb.THREADS < slice_max  # the least instance
    assert plan.scratch_words(N, K) == N * G * K + N * (G + 1)
    assert 4 * plan.scratch_words(N, K) <= 4 * N * Tm * K  # never above the table


@pytest.mark.parametrize("Tm", [1, 2, 3, 4, tkb.SERIAL_ROWS - 1])
def test_short_walks_are_serial(Tm):
    for N, K in ((1, 3968), (16, 3968), (1, 64)):
        assert tkb.backtrack_plan(Tm, N, K, H100_SMS).serial


def test_forced_plans_the_kernel_cannot_run_are_refused():
    assert tkb.backtrack_plan(255, 1, 3968, H100_SMS, L=255).serial
    assert tkb.backtrack_plan(255, 1, 1001, H100_SMS, L=16, S=8).E == 1  # any K
    for L, S, K in ((4, 1, 40000), (4, 1, 16384), (4, 2, 64 * 1024), (4, 65, 64)):
        with pytest.raises(ValueError, match="no chunked plan"):
            tkb.backtrack_plan(255, 1, K, H100_SMS, L=L, S=S)
    assert tkb.backtrack_plan(255, 1, 16384, H100_SMS, L=4, S=2).E == tkb.E_MAX


def test_plan_prefers_chunks_where_the_model_says_and_never_models_slower():
    """The rule's choices at the main path's shapes, as the card's sweep
    (results/torch_backtrack_sweep.jsonl) found them fastest: chunks for
    one lane from SERIAL_ROWS rows on and up to 8 lanes at K=3968; the
    serial walk for short walks, the store batches of 16 and 64 lanes, and
    wherever the wave holds fewer than 2 chunks of every lane."""
    plans = {shape: tkb.backtrack_plan(*shape, H100_SMS) for shape in SHAPES}
    assert [shape for shape, p in plans.items() if p.serial] == [
        (15, 1, 3968), (16, 1, 3968), (255, 16, 3968), (255, 64, 3968), (1, 1, 64),
        (2, 1, 64), (64, 1, 40000), (31, 64, 4096)]
    assert tuple(plans[255, 1, 3968])[:3] == (22, 12, 4)    # G ~ sqrt(2 T'), 4 slices
    assert tuple(plans[16383, 1, 3968])[:3] == (132, 125, 1)  # the wave caps G
    assert tuple(plans[4096, 1, 16384])[:3] == (66, 63, 2)  # E_MAX forces 2 slices
    assert not tkb.backtrack_plan(255, 8, 3968, H100_SMS).serial
    assert tkb.backtrack_plan(tkb.SERIAL_ROWS, 1, 3968, H100_SMS).G == 8
    assert tkb.backtrack_plan(255, 1, 3968, 1).serial  # no wave of 2 chunks


# (c) the three phases, emulated in torch

def emulate(ptrs: torch.Tensor, last: torch.Tensor, plan) -> torch.Tensor:
    """csrc/backtrack.cu's phases under ``plan``, item by item as the CTAs
    take them: A folds each (chunk, lane, slice) from the identity, the
    chunk's rows latest first; B walks the boundaries; C the rows."""
    Tm, N, K = ptrs.shape
    out = torch.full((N, Tm + 1), -99, dtype=torch.int32)

    def step(row, s):  # s: int64 tensor of states
        ok = (s >= 0) & (s < K)
        return torch.where(ok, row[s.clamp(0, K - 1)].to(torch.int64).clamp_min(-1), -1)

    def walk(n, s, t0, t1):
        for t in range(t1 - 1, t0 - 1, -1):
            s = step(ptrs[t, n], s)
            out[n, t] = int(s)

    if plan.serial:
        for n in range(N):
            out[n, Tm] = last[n]
            walk(n, torch.tensor(int(last[n])), 0, Tm)
        return out
    G, L, S = plan.G, plan.L, plan.S
    maps = torch.full((N, G, K), -99, dtype=torch.int64)
    for b in range(plan.blocks):                  # phase A
        for it in range(b, G * N * S, plan.blocks):
            s, n, c = it % S, (it // S) % N, it // (S * N)
            lo, hi = s * K // S, (s + 1) * K // S
            v = torch.arange(lo, hi)
            for t in range(min((c + 1) * L, Tm) - 1, c * L - 1, -1):
                v = step(ptrs[t, n], v)
            maps[n, c, lo:hi] = v
    assert (maps != -99).all()
    bounds = torch.empty((N, G + 1), dtype=torch.int64)
    for n in range(N):                            # phase B
        s = int(last[n])
        bounds[n, G] = s
        for c in range(G - 1, -1, -1):
            s = int(maps[n, c, s]) if 0 <= s < K else -1
            bounds[n, c] = s
    for n in range(N):                            # phase C
        for c in range(G):
            if c == G - 1:
                out[n, Tm] = last[n]
            walk(n, bounds[n, c + 1], c * L, min((c + 1) * L, Tm))
    assert (out != -99).all()
    return out


@pytest.mark.parametrize("Tm,N,K,L,S", [
    (13, 1, 64, 1, 1),      # L=1: a chunk a row
    (13, 4, 64, 1, 2),
    (13, 4, 128, 12, 1),    # G=2, a one-row tail
    (13, 1, 128, 13, 1),    # L=T': the serial walk
    (21, 4, 128, 5, 4),     # a ragged tail of 1 row, 4 slices
    (21, 1, 64, 8, 2),      # a tail of 5 rows
    (40, 4, 64, 7, 16),     # slices of 4 entries
    (33, 1, 130, 4, 1),     # K not a multiple of anything
])
def test_emulated_phases_match_plain_and_jax(Tm, N, K, L, S):
    ptrs, last = _planted(Tm, N, K, seed=Tm * 10 + N + L, last_out=N >= 3)
    plan = tkb.backtrack_plan(Tm, N, K, H100_SMS, L=L, S=S)
    assert plan.serial == (L >= Tm)
    want = _jax(ptrs, last)
    got = emulate(torch.from_numpy(ptrs), torch.from_numpy(last), plan).numpy()
    np.testing.assert_array_equal(got, _plain(ptrs, last))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blocks", [1, 3])
def test_emulated_phases_on_few_ctas(blocks):
    """A grid smaller than the items: each CTA folds several in turn."""
    Tm, N, K = 26, 4, 64
    ptrs, last = _planted(Tm, N, K, seed=7)
    plan = tkb.backtrack_plan(Tm, N, K, blocks, L=5, S=2)
    assert plan.blocks == blocks
    got = emulate(torch.from_numpy(ptrs), torch.from_numpy(last), plan).numpy()
    np.testing.assert_array_equal(got, _jax(ptrs, last))


# the CUDA branch, spied on the CPU

def test_cuda_branch_launches_once_with_the_plan_and_its_scratch(monkeypatch):
    """One launch a call and no host read (the kernel waits on nothing):
    a chunked plan passes its scratch and the stream's ticket word, a
    serial plan neither; the plan's ints reach the C entry; a plan of
    another shape and non-contiguous ptrs are refused."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        counter.launches += 1

    monkeypatch.setattr(tkb, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tkb, "launch", fake_launch)
    monkeypatch.setattr(tkb, "sm_count", lambda dev: H100_SMS)
    ticket = torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(tkb, "_ticket", lambda dev: ticket)
    Tm, N, K = 255, 2, 128
    ptrs = torch.zeros((Tm, N, K), dtype=torch.int32)
    last = torch.zeros(N, dtype=torch.int32)
    tk.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        tk.backtrack_batched(ptrs.transpose(0, 1).contiguous().transpose(0, 1), last)
    plan = tkb.backtrack_plan(Tm, N, K, H100_SMS, L=16, S=2)
    tk.backtrack_batched(ptrs, last, plan=plan)
    tk.backtrack_batched(ptrs, last, plan=tkb.serial_plan(Tm, N))
    tk.backtrack_batched(ptrs, last)
    with pytest.raises(ValueError, match="does not fit"):
        tk.backtrack_batched(ptrs[:100], last, plan=plan)
    (_, a1), (_, a2), (_, a3) = calls
    assert all(c[0] == "fvt_backtrack" for c in calls)
    assert a1[0] == ptrs.data_ptr() and a1[3] is not None and a1[4] == ticket.data_ptr()
    assert a2[3:5] == (None, None)
    assert list(a1[5]) == list(plan.c_args()) and a1[-3:] == (Tm, N, K)
    assert list(a2[5])[:2] == [1, Tm]
    assert list(a3[5]) == list(tkb.backtrack_plan(Tm, N, K, H100_SMS).c_args())
    assert tk.launch_counts()["backtrack_batched"] == 3


# the global-memory latency chase, a probe of its own

def test_chase_rows_plain_walks_as_the_tpu_kernel():
    """``probes/copy.py:probe_chase_rows``, the serial walk the card's
    dependent-load latency is measured with: its plain version (and its
    CPU branch) equal JAX's kernel, out-of-range entries included, and it
    counts launches of its own, not ``backtrack_batched``'s."""
    from flash_viterbi_tpu_torch.probes import copy as pc

    ptrs, last = _planted(19, 4, 64, seed=11)
    want = _jax(ptrs, last)
    got = pc.probe_chase_rows_plain(torch.from_numpy(ptrs), torch.from_numpy(last))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    tk.reset_launches()
    pc.probe_chase_rows.launches = 0
    got = pc.probe_chase_rows(torch.from_numpy(ptrs), torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tk.launch_counts()["backtrack_batched"] == 0 and pc.probe_chase_rows.launches == 0
    with pytest.raises(TypeError):
        pc.probe_chase_rows(torch.from_numpy(ptrs), torch.from_numpy(last).long())
