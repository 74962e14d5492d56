"""The probes (``flash_viterbi_tpu_torch.probes``): each plain version held
bit for bit against the JAX probe kernel of ``scripts/`` in Pallas
interpret mode, on inputs made from the same numpy seeds; the copy
probes beside ``beam_dma_probe``'s own checks; ``marginal_time`` on a CPU
chain; and each wrapper's CUDA branch, spied on the CPU."""

import functools
import importlib.util
import itertools
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_viterbi_tpu_torch import probes
from flash_viterbi_tpu_torch.bench import bounds
from flash_viterbi_tpu_torch.bench.harness import marginal_time
from flash_viterbi_tpu_torch.ops.cuda import beam as kbeam
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
from flash_viterbi_tpu_torch.probes import alu, beam, copy, scan
from flash_viterbi_tpu_torch.probes.__main__ import main as probes_main

torch.set_num_threads(2)

SMS = 132  # an H100's SMs
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


@functools.lru_cache(maxsize=None)
def _script(name: str):
    """Import ``scripts/<name>.py`` (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(16, 128), (7, 131)])
@pytest.mark.parametrize("rounds", [0, 1, 4])
def test_alu_matches_vpu_kernel(rounds, shape):
    """On the probe's block and on an odd element count, whose last pair of
    the resident grid is one element."""
    vp = _script("vpu_probe")
    x = alu.inputs(*shape, device="cpu")
    want = pl.pallas_call(functools.partial(vp._vpu_kernel, R=rounds),
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)(jnp.asarray(x.numpy()))
    got = alu.probe_alu(x, rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert alu.operations(x.numel(), rounds) == 2 * alu.cells(x.numel(), rounds) + 7 * x.numel()


@pytest.mark.parametrize("blocks_per_sm,sms", [(1, 1), (3, 2), (8, 5)])
def test_alu_resident_grid_takes_every_element_once(blocks_per_sm, sms):
    """The kernel's walk (``thread_elements``) over the resident grid: every
    element once, two a pair but an odd count's last pair, the grid
    striding where the elements outnumber its threads twice over."""
    for n in (1, 2, 3, 63, 64, 65, 2 * alu.THREADS * blocks_per_sm * sms + 1, 9001):
        plan = alu.alu_plan(n, blocks_per_sm, sms)
        assert plan.blocks == blocks_per_sm * sms and plan.half == (n + 1) // 2
        got = [e for b in range(plan.blocks) for t in range(alu.THREADS)
               for e in alu.thread_elements(plan, n, b, t)]
        assert sorted(got) == list(range(n))
        one = [t for b in range(plan.blocks) for t in range(alu.THREADS)
               if len(alu.thread_elements(plan, n, b, t)) % 2]
        assert len(one) == n % 2
    with pytest.raises(ValueError, match="n, blocks_per_sm"):
        alu.alu_plan(0, blocks_per_sm, sms)


def test_bounds_count_the_issue_rate_and_logA_beyond_the_chip():
    """An add or a max issues at 128 a clock an SM, half the published 67
    TFLOP/s (an FMA counted as two): probe_alu at R=64 is bound at 4.01 us
    of cells, 4.07 with its scalings and sums.  A logA larger than what the
    card holds on chip is read again every step less that: at phaseA ~9.2
    ms by bytes; the headline's 63 MB logA fits and counts once."""
    h100 = bounds.H100
    assert 2 * h100.ops_per_s == pytest.approx(67e12, rel=0.002)
    assert h100.on_chip_bytes == pytest.approx(116e6, rel=0.02)
    n = alu.ROWS * alu.COLS
    assert alu.cells(n, alu.R) / (h100.ops_per_s / 2) * 1e6 == pytest.approx(4.012, abs=1e-3)
    ms, by = bounds.bound(2 * n * 4, alu.operations(n, alu.R))
    assert by == "operations" and ms * 1e3 == pytest.approx(4.067, abs=1e-3)
    K, N, Tm = scan.SHAPES["phaseA"]
    moved, ops = scan.work(K, N, Tm, True)
    ms, by = bounds.bound(moved, ops)
    assert by == "bytes" and ms == pytest.approx(9.19, abs=0.01)
    assert bounds.bound(0, ops)[0] == pytest.approx(8.217, abs=1e-3)
    assert moved > Tm * (K * K * 4 - h100.on_chip_bytes)
    assert bounds.table_bytes(3968 * 3968 * 4, 255) == 3968 * 3968 * 4
    assert bounds.table_bytes(K * K * 4, 1) == K * K * 4
    assert bounds.card("cpu") == h100


def _ablation_pallas(vp, logA, emits, delta0, write_hist, BK=128, BI=128):
    """``vpu_probe.ablation``'s pallas_call at these inputs, interpreted."""
    K = logA.shape[0]
    Tm, N, _ = emits.shape
    kernel = functools.partial(vp._abl_kernel, N=N, BK=BK, BI=BI, write_hist=write_hist,
                               transpose=True)
    return pl.pallas_call(
        kernel, grid=(Tm, K // BI, K // BK),
        in_specs=[pl.BlockSpec((N, K), lambda t, it, kt: (0, 0)),
                  pl.BlockSpec((BK, BI), lambda t, it, kt: (kt, it)),
                  pl.BlockSpec((1, N, BI), lambda t, it, kt: (t, 0, it))],
        out_specs=[pl.BlockSpec((N, BI), lambda t, it, kt: (0, it)),
                   pl.BlockSpec((1, N, BI), lambda t, it, kt: (t, 0, it))],
        out_shape=[jax.ShapeDtypeStruct((N, K), jnp.float32),
                   jax.ShapeDtypeStruct((Tm, N, K), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((2, N, K), jnp.float32), pltpu.VMEM((N, BI), jnp.float32)],
        interpret=True,
    )(jnp.asarray(delta0), jnp.asarray(logA), jnp.asarray(emits))


@functools.lru_cache(maxsize=None)
def _ablation_want(write_hist: bool):
    logA, emits, delta0 = scan.inputs(256, 2, 3, device="cpu")
    return tuple(np.asarray(a) for a in _ablation_pallas(
        _script("vpu_probe"), logA.numpy(), emits.numpy(), delta0.numpy(), write_hist))


@pytest.mark.parametrize("variant", scan.EXACT)
@pytest.mark.parametrize("write_hist", [True, False])
def test_scan_ablation_matches_abl_kernel(write_hist, variant):
    """The variants that compute the scan against ``_abl_kernel`` with and
    without its history: dfin always, the history wherever both write it."""
    jdfin, jhist = _ablation_want(write_hist)
    dfin, deltas = scan.probe_scan_ablation(*scan.inputs(256, 2, 3, device="cpu"), variant)
    np.testing.assert_array_equal(dfin.numpy(), jdfin)
    assert (deltas is None) == (variant == "no-hist")
    if write_hist and deltas is not None:
        np.testing.assert_array_equal(deltas.numpy(), jhist)


@pytest.mark.parametrize("variant", [v for v in scan.VARIANTS if v not in scan.EXACT])
def test_scan_ablation_attribution_variants_have_no_plain_version(variant):
    args = scan.inputs(64, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="cost attribution"):
        scan.probe_scan_ablation(*args, variant)
    with pytest.raises(ValueError, match="cost attribution"):
        scan.probe_scan_ablation_plain(*args, variant)


def test_scan_ablation_plans_are_the_production_plans():
    """Each variant runs under the production plan of 1 lane or 16 a
    group; all-streamed under that plan with no row in shared memory and
    the same carry passes; the split reads a step's parts."""
    for K, N in ((3968, 1), (3968, 16), (4096, 64), (16384, 16), (300, 5)):
        full = scan.ablation_plan(K, N, SMS)
        assert full == km.scan_plan(K, N if N in (1, 16, 64) else 16, SMS)
        streamed = scan.ablation_plan(K, N, SMS, "all-streamed")
        assert streamed.rows_smem == 0 and streamed.carry_rows == full.carry_rows
        assert streamed.smem == full.smem - full.rows_smem * full.stride * 4
        assert km.streamed_bytes(streamed) == K * K * 4 >= km.streamed_bytes(full)
    sp = scan.split({"full": 10.0, "no-hist": 9.0, "all-streamed": 12.0, "no-stream": 6.0,
                     "no-fold": 7.0, "no-combine": 8.0, "barrier-only": 1.0}, 5, 2, 100)
    assert sp == {"fixed_step_s": 0.2, "combine_step_s": 0.4, "stream_step_s": 0.8,
                  "stream_bytes_per_s": 250.0, "fold_step_s": 0.6, "hist_step_s": 0.2}


def test_scan_inputs_share_one_logA_draw_per_K():
    cache = {}
    a = scan.inputs(64, 2, 3, device="cpu", cache=cache)
    b = scan.inputs(64, 4, 2, device="cpu", cache=cache)
    fresh = scan.inputs(64, 4, 2, device="cpu")
    assert b[0] is a[0]
    for x, y in zip(b, fresh):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown variant"):
        scan.probe_scan_ablation(*a, "KC256")


def _beam_pallas(kern, logA, emits, vals0, states0):
    """``beam_profile.run_variant``'s pallas_call (both scripts use one
    layout) at these inputs, interpreted: codes (T', 1, B)."""
    Tm, _, K = emits.shape
    B = vals0.shape[1]
    S = K // 128
    return pl.pallas_call(
        kern, grid=(Tm,),
        in_specs=[pl.BlockSpec((1, B), lambda t: (0, 0), memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, B), lambda t: (0, 0), memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, S, 128), lambda t: (t, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 1, B), lambda t: (t, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Tm, 1, B), jnp.int32),
        scratch_shapes=[pltpu.SMEM((1, B), jnp.float32), pltpu.SMEM((1, B), jnp.int32),
                        pltpu.VMEM((B, S, 128), jnp.float32), pltpu.SemaphoreType.DMA((B,))],
        interpret=True,
    )(jnp.asarray(vals0.numpy()), jnp.asarray(states0.numpy()),
      jnp.asarray(emits.numpy().reshape(Tm, S, 128)), jnp.asarray(logA.numpy().reshape(K, S, 128)))


def _beam_inputs(integer: bool):
    """The probes' inputs at B=4, K=256, T'=3; ``integer`` rounds logA
    and the emissions to halves (exact ties in the fold and the select)."""
    args = beam.inputs(4, 256, 3, device="cpu")
    if integer:
        logA, emits, vals0, states0 = args
        args = (torch.round(logA * 2) / 2 + 0.0, torch.round(emits * 2) / 2 + 0.0,
                torch.round(vals0) + 0.0, states0)
    return args


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("source", ["beam_profile", "prod", "packed", "blockm"])
def test_beam_plain_matches_profile_kernels(source, integer):
    args = _beam_inputs(integer)
    B, K, Tm = args[2].shape[1], args[0].shape[0], args[1].shape[0]
    if source == "beam_profile":
        kern = _script("beam_profile").make_kernel(B, K, Tm, True, True, True)
    else:
        kern = _script("beam_profile2").make_kernel(B, K, source)
    want = np.asarray(_beam_pallas(kern, *args))
    np.testing.assert_array_equal(beam.probe_beam_plain(*args).numpy(), want)
    for variant in beam.PARTS:
        if variant in beam.EXACT:
            np.testing.assert_array_equal(beam.probe_beam_parts(*args, variant).numpy(), want)
    for variant in beam.SELECTS:
        if variant in beam.EXACT:
            np.testing.assert_array_equal(beam.probe_beam_select(*args, variant).numpy(), want)


def test_beam_attribution_variants_have_no_plain_version():
    args = _beam_inputs(False)
    for variant in ("no-pick", "no-fold", "no-dma", "dma-only", "empty"):
        with pytest.raises(ValueError, match="cost attribution"):
            beam.probe_beam_parts(*args, variant)
    with pytest.raises(ValueError, match="cost attribution"):
        beam.probe_beam_select(*args, "onereduce")
    with pytest.raises(ValueError, match="unknown variant"):
        beam.probe_beam_select(*args, "radix")
    assert set(beam.PARTS) | set(beam.SELECTS) == set(beam.VARIANTS) | {"sort"}


@pytest.mark.parametrize("name", ["p1", "p3", "p4"])
def test_copy_probes_beside_beam_dma_probe(name):
    bdp = _script("beam_dma_probe")
    with pltpu.force_tpu_interpret_mode():
        assert getattr(bdp, name)() == "bit-ok"
    if name == "p4":
        got = copy.probe_copy_p4(bdp.Tm, 8, device="cpu")
        want = np.arange(bdp.Tm)[:, None, None] + np.ones((1, 1, 8), int)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    x = copy.fixture(bdp.Tm, bdp.S, device="cpu")
    np.testing.assert_array_equal(
        x.numpy(), np.arange(bdp.Tm * bdp.S * 128, dtype=np.float32).reshape(bdp.Tm, bdp.S, 128))
    got = copy.probe_copy_p1(x) if name == "p1" else copy.probe_copy_p3(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


def test_p5_plain_is_the_numpy_winner_with_its_forced_tie():
    v, c = copy.p5_fixture(device="cpu")
    outv, outc = copy.probe_copy_p5(v, c)
    best = min(zip(-v.numpy().ravel(), c.numpy().ravel()))  # beam_dma_probe.py:162
    assert tuple(outv.shape) == tuple(outc.shape) == (1, 128)
    assert (outv.numpy() == -best[0]).all() and (outc.numpy() == best[1]).all()
    assert best[1] == 5 * 256 + 3 and v[1, 7] == v[0, 5]  # the tie went to the lower code


@pytest.mark.parametrize("shape", list(copy.P4_CLUSTER_SHAPES))
def test_p4_cluster_plain_at_every_shape(shape):
    """Every CTA reads every result of every step, result j of step t being
    t * W + j: one value per step and slot, so that no read of a wrong CTA,
    slot or parity buffer can agree with it; at C = 1 and one result, the
    old p4's output (t + 1) with its CTA axis."""
    Tm, W, C = copy.P4_CLUSTER_SHAPES[shape]
    for pub in copy.PUBS:
        got = copy.probe_copy_p4_cluster(Tm, W, C, pub, device="cpu")
        assert got.shape == (Tm, C, W) and got.dtype == torch.int32
        want = np.arange(Tm)[:, None, None] * W + np.arange(W)[None, None, :] + 1
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(want, (Tm, C, W)))
        assert len(np.unique(got.numpy()[:, 0])) == Tm * W
    assert torch.equal(copy.probe_copy_p4_cluster(Tm, 1, 1, device="cpu"),
                       copy.probe_copy_p4(Tm, 1, device="cpu"))


@pytest.mark.parametrize("shape", list(copy.P5_CLUSTER_SHAPES))
def test_p5_cluster_plain_is_the_numpy_winner(shape):
    n, C = copy.P5_CLUSTER_SHAPES[shape]
    v, c = copy.p5_row(n, device="cpu")
    assert v[5] == v[n // 2 + 7] == v.max()  # the forced tie
    outv, outc = copy.probe_copy_p5_cluster(v, c, C)
    best = min(zip(-v.numpy(), c.numpy()))  # beam_dma_probe.py:162
    assert tuple(outv.shape) == tuple(outc.shape) == (1, copy.P5_WIDTH)
    assert (outv.numpy() == -best[0]).all() and (outc.numpy() == best[1]).all()
    assert best[1] == 5 * 256 + 3
    if n == copy.S * 128:  # the TPU fixture: the old p5's answer
        v2, c2 = copy.p5_fixture(device="cpu")
        old = copy.probe_copy_p5(v2, c2)
        new = copy.probe_copy_p5_cluster(v2.reshape(-1), c2.reshape(-1), C)
        assert torch.equal(old[0], new[0]) and torch.equal(old[1], new[1])


@pytest.mark.parametrize("shape", list(copy.P5_CLUSTER_SHAPES))
def test_p5_cluster_plain_wins_in_the_last_shard(shape):
    """The late tie: the winner in the last CTA's shard, its tied partner of
    a larger code in a lower CTA's, so the CTAs' winners must meet and
    keep the tie rule across them."""
    n, C = copy.P5_CLUSTER_SHAPES[shape]
    v, c = copy.p5_row(n, device="cpu", late=True)
    assert v[n - 3] == v[n // 3] == v.max() and c[n // 3] > c[n - 3]
    shard = [(r * n // C, (r + 1) * n // C) for r in range(C)]  # the kernel's shards
    win = next(r for r, (lo, hi) in enumerate(shard) if lo <= n - 3 < hi)
    partner = next(r for r, (lo, hi) in enumerate(shard) if lo <= n // 3 < hi)
    assert win == C - 1 and (C == 1 or partner < win)
    outv, outc = copy.probe_copy_p5_cluster(v, c, C)
    best = min(zip(-v.numpy(), c.numpy()))
    assert (outv.numpy() == -best[0]).all() and (outc.numpy() == best[1]).all()
    assert best[1] == 2 * 256 + 3


def test_cluster_shapes_fit_the_kernels():
    """Every shape: C a power of two up to 16, W a multiple of C, at most 256
    results a CTA (one a thread) and 1024 in all; the beam shape's C is
    beam_plan's cluster at Kp = 3968, one lane."""
    for Tm, W, C in copy.P4_CLUSTER_SHAPES.values():
        copy.check_cluster(W, C)
        assert W // C <= copy.P4C_MAX_OWN and W % C == 0 and C & (C - 1) == 0
    for n, C in copy.P5_CLUSTER_SHAPES.values():
        copy.check_cluster(C, C)
    assert copy.P4_CLUSTER_SHAPES["beam_c16"][2] == kbeam.beam_plan(3968, 64, 1, SMS).C == 16
    assert copy.P4_CLUSTER_SHAPES["beam_c16"][1] == 16 * 32
    for W, C in ((8, 3), (8, 32), (12, 8), (2048, 16), (4, 8)):
        with pytest.raises(ValueError):
            copy.check_cluster(W, C)
    with pytest.raises(ValueError, match="publish"):
        copy.probe_copy_p4_cluster(4, 8, 1, "ring", device="cpu")
    with pytest.raises(ValueError, match="cluster"):
        copy.probe_copy_p5_cluster(*copy.p5_row(64, device="cpu"), 3)


@pytest.mark.parametrize("mode", copy.CHASES)
def test_chase_plain_versions(mode):
    """The chase table is one cycle through every entry; each chase's plain
    version follows its definition."""
    table = copy.chase_table(64, device="cpu", seed=3)
    t = table.numpy()
    x, seen = 0, set()
    for _ in range(64):
        seen.add(x)
        x = int(t[x])
    assert x == 0 and seen == set(range(64))
    got = copy.probe_chase(table, 100, mode, torch.zeros(2, dtype=torch.int64))
    if mode in ("smem", "dsmem"):
        x = 0
        for _ in range(100):
            x = int(t[x])
        assert got == x
        assert copy.probe_chase(table, 64, mode, None) == 0
        assert copy.probe_chase(table, 3, mode, None) == int(t[t[t[0]]])
    elif mode == "shfl":
        lanes = np.arange(32)
        for _ in range(100):
            lanes = np.array([lanes[(lanes[l] + 1) % 32] for l in range(32)])
        assert got == lanes[0]
    else:
        vals = t.view(np.float32)
        order = sorted(range(100), key=lambda h: (-vals[h % 64], h))
        assert got == order[0]
    with pytest.raises(ValueError, match="power-of-two"):
        copy.probe_chase(copy.chase_table(48, device="cpu"), 4, mode, None)
    with pytest.raises(ValueError, match="unknown chase"):
        copy.probe_chase(table, 4, "global", None)


def test_chain_floors():
    """p4: Tm round trips through the memory it publishes by; p5: the larger
    of its compare, shuffle and peer chain and its bytes."""
    lat = {"smem": 30e-9, "dsmem": 200e-9, "shfl": 25e-9, "better": 10e-9}
    assert bounds.p4_floor_s(255, 1, lat) == 255 * 30e-9
    assert bounds.p4_floor_s(255, 16, lat) == 255 * 200e-9
    assert bounds.p5_floor_s(256, 1, lat) == 1 * 10e-9 + 10 * 25e-9
    assert bounds.p5_floor_s(3968, 1, lat) == pytest.approx(16 * 10e-9 + 10 * 25e-9)
    assert bounds.p5_floor_s(3968, 16, lat) == pytest.approx(1 * 10e-9 + 10 * 25e-9 + 200e-9)
    # compares far quicker than a byte's share of the memory rate: the bytes bound it
    fast = {**lat, "better": 1e-12}
    assert bounds.p5_floor_s(10**9, 16, fast) == 8e9 / bounds.HBM_BYTES_PER_S
    assert bounds.P5_SHUFFLE_ROUNDS == 2 * 5  # log2(32) within a warp, then across 8 warps


def test_copy_rows_checks():
    with pytest.raises(ValueError, match="16 bytes"):
        copy.probe_copy_p1(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="exceed"):
        copy.probe_copy_p3(torch.zeros((2, 16384)))
    with pytest.raises(TypeError, match="float32"):
        copy.probe_copy_p1(torch.zeros((4, 8), dtype=torch.float64))


@pytest.mark.parametrize("B", [1, copy.P3_B])
def test_copy_plan_takes_each_step_once_in_a_ring_that_fits(B):
    """Every step to exactly one CTA, a contiguous run each; at least two
    stages wherever two fit beside the barriers (one otherwise), never more
    than shared memory holds; a row too large for a block is refused as
    ``_check_rows`` refuses it."""
    for Tm, n, sms in itertools.product([1, 2, 4, 255, 1000], [4, 256, 3968, 16384, 29056],
                                        [1, 8, SMS]):
        stage = B * n * 4
        if stage > kbeam.SMEM_LIMIT:
            with pytest.raises(ValueError, match="exceed"):
                copy.copy_plan(Tm, n, B, sms)
            with pytest.raises(ValueError, match="exceed"):
                copy.probe_copy_p3(torch.zeros((2, n)))  # only p3's four rows exceed
            continue
        p = copy.copy_plan(Tm, n, B, sms)
        assert p.ctas == min(Tm, sms) and len(p.step_edges) == p.ctas + 1
        assert p.step_edges[0] == 0 and p.step_edges[-1] == Tm
        assert (np.diff(p.step_edges) > 0).all()  # each step once, no idle CTA
        assert 1 <= p.stages <= copy.STAGES_MAX
        two_fit = 2 * stage + copy.STATIC_SMEM <= kbeam.SMEM_LIMIT
        assert (p.stages >= 2) == two_fit
        assert p.stages == 1 or p.stages * stage + copy.STATIC_SMEM <= kbeam.SMEM_LIMIT
        assert list(p.c_args()) == [p.ctas, p.stages]
    forced = copy.copy_plan(255, 3968, B, SMS, ctas=1)
    assert forced.step_edges == (0, 255) and forced.stages == (14 if B == 1 else 3)
    with pytest.raises(ValueError, match="ctas must lie"):
        copy.copy_plan(4, 256, B, SMS, ctas=5)


def test_copy_rows_cuda_branch_passes_its_plan_and_a_shared_word(monkeypatch):
    """The C entry gets the card's plan (or the caller's) and a word of its
    own, which the call reads, or the caller's ``err=``, which it leaves to
    the caller; a plan of another shape is refused before the launch."""
    calls = _fake_launches(monkeypatch, (copy,))
    rows = copy.beam_rows(255, 3968, device="cpu")
    copy.probe_copy_p1(rows)
    copy.probe_copy_p3(rows, plan=copy.copy_plan(255, 3968, copy.P3_B, SMS, ctas=4))
    assert [list(a[2]) for _, a in calls] == [[SMS, 2], [4, 3]]
    err = torch.zeros(1, dtype=torch.int32)
    err[0] = 1  # a word another call set: this call must not read it
    copy.probe_copy_p1(rows, err=err)
    assert calls[2][1][-1] == err.data_ptr()
    with pytest.raises(RuntimeError, match="timed out"):
        copy.raise_on(err, "probe_copy_p1")
    with pytest.raises(ValueError, match="the plan is for"):
        copy.probe_copy_p1(rows, plan=copy.copy_plan(254, 3968, 1, SMS))
    assert len(calls) == 3 and probes.launch_counts()["probe_copy_p1"] == 2


def test_marginal_time_on_a_cpu_chain():
    def chain(k):
        def f():
            for _ in range(k):
                time.sleep(0.02)
            return torch.zeros(1)
        return f

    per = marginal_time(chain, 1, 3)
    assert 0.015 <= per <= 0.1


def _fake_launches(monkeypatch, modules):
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        counter.launches += 1

    for mod in modules:
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    for mod in (alu, beam, copy, km):  # km: the scan ablation launches through launch_scan
        monkeypatch.setattr(mod, "launch", fake_launch)
    for mod in (copy, scan, alu):
        monkeypatch.setattr(mod, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(alu, "_blocks_per_sm", lambda: 8)
    monkeypatch.setattr(beam, "plan", lambda Kp, Bw, device: kbeam.beam_plan(Kp, Bw, 1, SMS))
    monkeypatch.setattr(kbeam, "_clusters", lambda index, plan: 1)
    probes.reset_launches()
    return calls


def test_cuda_branches_launch_and_refuse_non_contiguous_inputs(monkeypatch):
    """With the device check answering "CUDA", every probe wrapper launches
    its C entry point once (counted) on contiguous inputs, and refuses
    non-contiguous ones before launching."""
    calls = _fake_launches(monkeypatch, (alu, scan, beam, copy))
    x = alu.inputs(16, 128, device="cpu")
    sargs = scan.inputs(64, 2, 3, device="cpu")
    bargs = beam.inputs(4, 256, 3, device="cpu")
    rows = copy.fixture(device="cpu")
    v, c = copy.p5_fixture(device="cpu")
    for fn, args in ((alu.probe_alu, (x.t(),)), (scan.probe_scan_ablation, (sargs[0].t(), *sargs[1:])),
                     (beam.probe_beam_parts, (bargs[0].t(), *bargs[1:])),
                     (copy.probe_copy_p1, (rows.transpose(1, 2),)),
                     (copy.probe_copy_p5, (v.t(), c.t()))):
        with pytest.raises(ValueError, match="contiguous"):
            fn(*args)
    assert calls == []
    alu.probe_alu(x, 4)
    scan.probe_scan_ablation(*sargs, "no-fold")
    beam.probe_beam_parts(*bargs, "no-dma")
    beam.probe_beam_select(*bargs, "blockm")
    beam.probe_beam_select(*bargs, "sort")
    copy.probe_copy_p1(rows)
    copy.probe_copy_p3(rows)
    copy.probe_copy_p4(device="cpu")
    copy.probe_copy_p5(v, c)
    with pytest.raises(ValueError, match="contiguous"):
        copy.probe_copy_p5_cluster(v.t(), c.t(), 2)
    clocks = torch.zeros(2, dtype=torch.int64)
    copy.probe_copy_p4_cluster(255, 512, 16, "sync", device="cpu", clocks=clocks)
    copy.probe_copy_p5_cluster(v, c, 16, clocks=clocks)
    names = [name for name, _ in calls]
    assert names == ["fvt_probe_alu", "fvt_maxplus_scan_deltas_ablation", "fvt_probe_beam",
                     "fvt_probe_beam", "fvt_probe_beam", "fvt_probe_copy_rows",
                     "fvt_probe_copy_rows", "fvt_probe_copy_p4", "fvt_probe_copy_p5",
                     "fvt_probe_copy_p4_cluster", "fvt_probe_copy_p5_cluster"]
    assert calls[9][1][1:4] == (255, 512, 16) and calls[9][1][4] == copy.PUBS.index("sync")
    assert calls[9][1][5] == clocks.data_ptr()
    assert calls[10][1][2] == v.numel() and calls[10][1][5:8] == (copy.P5_WIDTH, 16,
                                                                  clocks.data_ptr())
    assert calls[0][1][2:] == (x.numel(), x.numel() // 2, 4, 8 * SMS, None)
    a = calls[1][1]
    assert a[4] is None and a[5] is not None and a[7] is None  # deltas, no pointers
    assert a[-4:] == (3, 2, 64, scan.VARIANTS.index("no-fold"))
    assert list(a[-5]) == list(km.scan_plan(64, 16, SMS).c_args())  # 2 lanes in a group of 16
    assert [a[-1] for _, a in calls[2:5]] == [beam.VARIANTS.index("no-dma"),
                                             beam.VARIANTS.index("blockm"), 0]
    assert calls[5][1][-4:-1] == (4, 256, 1) and calls[6][1][-4:-1] == (4, 256, copy.P3_B)
    assert probes.launch_counts() == {"probe_alu": 1, "probe_scan_ablation": 1,
                                      "probe_beam_parts": 1, "probe_beam_select": 2,
                                      "probe_copy_p1": 1, "probe_copy_p3": 1,
                                      "probe_copy_p4": 1, "probe_copy_p5": 1,
                                      "probe_copy_p4_cluster": 1, "probe_copy_p5_cluster": 1}


def test_beam_probe_refuses_a_select_too_large_for_a_block(monkeypatch):
    """The probe keeps each CTA's keys and beam in shared memory: a plan that
    puts them in the global scratch is refused before any launch."""
    calls = _fake_launches(monkeypatch, (beam,))
    monkeypatch.setattr(beam, "plan", lambda Kp, Bw, device: kbeam.beam_plan(
        Kp, Bw, 1, SMS, smem_bytes=1000))
    with pytest.raises(ValueError, match=str(kbeam.SMEM_LIMIT)):
        beam.probe_beam_parts(*beam.inputs(4, 256, 3, device="cpu"))
    assert calls == []


def test_beam_probe_kernel_table_matches_variants_and_production_is_one_instance():
    """csrc/probe_beam.cu's variant table names the variants of
    probes/beam.py:VARIANTS in their order, each an instance of the shared
    cluster kernel, "full" the production one; csrc/beam_scan.cu
    instantiates that one alone."""
    csrc = os.path.join(os.path.dirname(SCRIPTS), "flash_viterbi_tpu_torch", "csrc")
    with open(os.path.join(csrc, "probe_beam.cu")) as f:
        table = re.findall(r'\{"([a-z-]+)", beam_cluster_kernel<(\w+), (\w+), (SEL_\w+)>\}',
                           f.read())
    assert tuple(name for name, *_ in table) == beam.VARIANTS
    kinds = {name: tuple(args) for name, *args in table}
    assert kinds["full"] == ("true", "true", "SEL_RADIX")
    assert len(set(kinds.values())) == len(kinds)
    exact = {name for name, (read, fold, sel) in kinds.items()
             if read == fold == "true" and sel in ("SEL_RADIX", "SEL_PICK", "SEL_NOSMEM",
                                                   "SEL_BLOCKM")}
    assert exact | {"sort"} == set(beam.EXACT)
    with open(os.path.join(csrc, "beam_scan.cu")) as f:
        assert re.findall(r"beam_cluster_kernel<([^>]*)>", f.read()) == [
            "true, true, SEL_RADIX"]


def test_scan_ablation_table_matches_variants_and_production_passes_all_parts():
    """csrc/maxplus_scan.cu's ablation table names probes/scan.py:VARIANTS
    in their order, each with the parts of a step it keeps, "full" and
    "all-streamed" (a plan, not a template) the production P_ALL; the
    variants that keep every part the scan's result needs are EXACT; every
    production launch of scan_persistent passes P_ALL."""
    path = os.path.join(os.path.dirname(SCRIPTS), "flash_viterbi_tpu_torch", "csrc",
                        "maxplus_scan.cu")
    with open(path) as f:
        src = f.read()
    table = re.findall(r'\{"([a-z-]+)", (P_ALL(?: & ~P_[A-Z]+)?|0)\}', src)
    assert tuple(name for name, _ in table) == scan.VARIANTS
    parts = dict(table)
    assert parts["full"] == parts["all-streamed"] == "P_ALL"
    assert parts["barrier-only"] == "0"
    cut = {name: p.split("~")[-1] for name, p in parts.items() if "~" in p}
    assert cut == {"no-hist": "P_HIST", "no-stream": "P_STREAM", "no-fold": "P_FOLD",
                   "no-combine": "P_COMBINE"}
    assert {name for name, p in parts.items() if p in ("P_ALL", "P_ALL & ~P_HIST")} == set(
        scan.EXACT)
    launches = re.findall(r"launch_persistent<([^>]*)>\(", src)
    assert sorted(launches) == ["LG, WITH_PTR, EMIT, P_ALL, TA, RING",
                                "LG, false, EMIT_ROWS, ABLATION[V].parts"]
    # fvt_maxplus_scan, fvt_maxplus_scan_bf16 (its table type from logA's),
    # fvt_maxplus_scan_eg
    assert re.findall(r"run_scan<(\w+), (\w+)>\(", src) == [
        ("true", "EMIT_ROWS"), ("false", "EMIT_ROWS"), ("true", "EMIT_ROWS"),
        ("false", "EMIT_ROWS"), ("true", "EMIT_GATHER")]
    assert "scan_step" not in src and "for_each_step" not in src


@pytest.mark.parametrize("name", list(probes.PROBES))
def test_probe_runs_hand_their_kernels_contiguous_inputs(name, monkeypatch):
    """Each probe's run, at a small size on the CPU, calls its wrappers on
    contiguous tensors (their CUDA branches refuse anything else; the
    plain versions would not notice) and records every variant."""
    called = []

    def spy(mod, attr):
        fn = getattr(mod, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            called.append(attr)
            for a in args:
                assert not torch.is_tensor(a) or a.is_contiguous(), attr
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, attr, wrapped)

    small = {"alu": dict(rows=16, cols=128, rounds=2, rate_rounds=4),
             "scan": dict(shapes={"tiny": (128, 3, 2)}),
             "beam_profile": dict(Bw=4, Kp=256, Tm=3),
             "beam_profile2": dict(Bw=4, Kp=256, Tm=3),
             "copy": dict(beam_tm=3, beam_k=128)}[name]
    for mod, attrs in ((alu, ["probe_alu"]), (scan, ["probe_scan_ablation"]),
                       (beam, ["probe_beam_parts", "probe_beam_select"]),
                       (copy, ["probe_copy_p1", "probe_copy_p3", "probe_copy_p5"])):
        for attr in attrs:
            spy(mod, attr)
    runner = {"alu": alu.run, "scan": scan.run, "beam_profile": beam.run_parts,
              "beam_profile2": beam.run_select, "copy": copy.run}[name]
    records = runner(device="cpu", **small)
    assert called
    timed = [r for r in records if "skipped" not in r]
    assert timed and all(r["device"] == "cpu" and r["per_call_s"] > 0 and r["bytes"] > 0
                         for r in timed)
    if name == "scan":
        assert len(timed) == len(scan.EXACT) and {r["variant"] for r in records} >= set(scan.NO_RUN)


def test_main_prints_one_json_line_a_variant(capsys):
    probes_main(["copy", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in lines] == ["p1", "p1_beam_rows", "p3", "p3_beam_rows", "p4",
                                             "p5"] + [c[0] for c in copy.cluster_cases("cpu")]
    assert [r["variant"] for r in lines[6:]] == [
        "p4c_fixture_mbarrier", "p4c_fixture_sync", "p4c_warp_mbarrier", "p4c_warp_sync",
        "p4c_beam_c16_mbarrier", "p4c_beam_c16_sync", "p4c_beam_c8_mbarrier", "p4c_beam_c8_sync",
        "p4c_barrier_c16_mbarrier", "p4c_barrier_c16_sync", "p5c_fixture", "p5c_carry_row_c1",
        "p5c_carry_row_c16"]
    assert all(r["back_to_back_s"] > 0 and "cycles" not in r for r in lines[6:])
    with pytest.raises(ValueError, match="unknown probes"):
        probes.run(["vpu"], device="cpu")
