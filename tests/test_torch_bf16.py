"""``precision="bf16"``: the port's fused, flash (pointer and lean), auto and
batched fused decodes against the JAX package's bf16 decodes, bit for bit
(JAX with its Pallas kernels in interpret mode, and without them); each
equal to the port's fp32 decode of the table rounded to bfloat16, one
fixture differing from the fp32 decode of the exact table; the decodes'
quality against the optimum; the plain scans and walk on a bf16 table; the
wrappers' dtype checks, their bf16 kernel instances (a faked CUDA branch)
and the bf16 scan plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms import fused as jfused
from flash_viterbi_tpu.parallel.batch import decode_batch as jdecode_batch
from flash_viterbi_tpu_torch.algorithms import flash as tflash
from flash_viterbi_tpu_torch.algorithms import fused as tfused
from flash_viterbi_tpu_torch.models.generate import observations
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops import maxplus as tmp
from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
from flash_viterbi_tpu_torch.ops.cuda.common import SMEM_LIMIT
from flash_viterbi_tpu_torch.oracle import validate as tval

torch.set_num_threads(2)

SMS = 132  # an H100's SMs
# a fixture whose bf16 path differs from its fp32 path (in 3 positions)
DIFFERS = dict(K=130, M=7, T=64, prob=0.2, seed=2)


def _jax(hmm):
    """The same probability tables as the JAX package's ``HMM``."""
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


def _rounded(hmm, pad_to: int = 128):
    """The port's padded CPU tables with logA rounded to bf16 and widened
    back to fp32: the table the bf16 decodes decode exactly."""
    lh = hmm.log(device="cpu").padded(pad_to)
    return lh.logA.to(torch.bfloat16).float(), lh.logB, lh.logPi


def _y(y):
    return torch.as_tensor(np.asarray(y, dtype=np.int64))


@pytest.fixture(scope="module")
def differs():
    return tfv.make_sparse_hmm(**DIFFERS)


@pytest.mark.parametrize("K,M,T,seed,pallas", [
    (96, 9, 30, 1, (True, False)),     # K <= 1024: bf16 takes the pointer route too
    (200, 9, 1, 2, (True, False)),     # T = 1
    (130, 7, 64, 2, (True, False)),    # the fixture where bf16 differs from fp32
    (1152, 9, 6, 3, (False,)),         # K > 1024
])
def test_fused_bf16_matches_jax_and_the_rounded_table(K, M, T, seed, pallas):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=0.2, seed=seed)
    got = tfv.decode(hmm, y, "fused", precision="bf16", device="cpu", warmup=False)
    for use_pallas in pallas:
        want = jfv.decode(_jax(hmm), y, "fused", precision="bf16", use_pallas=use_pallas,
                          warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.memory_bytes == want.memory_bytes
    assert got.path.dtype == np.int32 and got.extra["precision"] == "bf16"
    exact = tfused.fused_decode(*_rounded(hmm), _y(y))
    np.testing.assert_array_equal(got.path, exact.numpy()[:T])


def test_bf16_differs_from_fp32_on_one_fixture(differs):
    """The mode is on: the rounded table reroutes the path."""
    hmm, y = differs
    bf16 = tfv.decode(hmm, y, "fused", precision="bf16", device="cpu", warmup=False)
    fp32 = tfv.decode(hmm, y, "fused", device="cpu", warmup=False)
    assert int((bf16.path != fp32.path).sum()) == 3
    assert bf16.memory_bytes == fp32.memory_bytes


@pytest.mark.parametrize("pointers", ["store", "recompute", "auto"])
def test_decode_batch_fused_bf16_matches_jax(differs, pointers, monkeypatch):
    hmm, y = differs
    ys = np.stack([y] + [observations(DIFFERS["T"], DIFFERS["M"], seed=s) for s in (3, 4, 5)])
    called = []
    for name in ("maxplus_scan", "maxplus_scan_deltas"):
        fn = getattr(tfused, name)
        monkeypatch.setattr(tfused, name,
                            lambda *a, _f=fn, _n=name, **kw: called.append(_n) or _f(*a, **kw))
    got = tfv.decode_batch(hmm, ys, "fused", pointers=pointers, precision="bf16",
                           device="cpu", warmup=False)
    # Bs = 4: auto takes recompute in fp32, store in bf16, as in JAX
    assert called == ["maxplus_scan_deltas" if pointers == "recompute" else "maxplus_scan"]
    want = jdecode_batch(_jax(hmm), ys, "fused", pointers=pointers, precision="bf16",
                         warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes
    lh = hmm.log(device="cpu").padded(128)
    jt = [jnp.asarray(t.numpy()) for t in (lh.logA, lh.logB, lh.logPi)]
    interp = jfused.fused_decode_batch(*jt, jnp.asarray(ys), use_pallas=True,
                                       pointers=pointers, precision="bf16")
    np.testing.assert_array_equal(got.path, np.asarray(interp))
    exact = tfused.fused_decode_batch(*_rounded(hmm), _y(ys), pointers=pointers)
    np.testing.assert_array_equal(got.path, exact.numpy())
    for b in range(len(ys)):
        single = tfv.decode(hmm, ys[b], "fused", precision="bf16", device="cpu", warmup=False)
        np.testing.assert_array_equal(got.path[b], single.path)


@pytest.mark.parametrize("N", [1, 4, 8])
def test_flash_pointer_bf16_matches_jax(differs, N):
    hmm, y = differs
    got = tfv.decode(hmm, y, "flash", num_segments=N, precision="bf16", device="cpu",
                     warmup=False)
    for use_pallas in (True, False):
        want = jfv.decode(_jax(hmm), y, "flash", num_segments=N, precision="bf16",
                          use_pallas=use_pallas, warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.memory_bytes == want.memory_bytes
    exact = tflash.flash_decode(*_rounded(hmm), _y(y), num_segments=N)
    np.testing.assert_array_equal(got.path, exact.numpy())


@pytest.mark.parametrize("leaf,T,N", [
    (tflash.LEAN_LEAF, 160, 2),  # segments of 80: a round, then leaves
    (0, 64, 4),                  # rounds only
])
def test_flash_lean_bf16_matches_jax(leaf, T, N):
    hmm, y = tfv.make_sparse_hmm(**dict(DIFFERS, T=T))
    got = tfv.decode(hmm, y, "flash", mode="lean", num_segments=N, lean_leaf=leaf,
                     precision="bf16", device="cpu", warmup=False)
    for use_pallas in (True, False):
        want = jfv.decode(_jax(hmm), y, "flash", mode="lean", num_segments=N, lean_leaf=leaf,
                          precision="bf16", use_pallas=use_pallas, warmup=False)
        np.testing.assert_array_equal(got.path, want.path)
        assert got.memory_bytes == want.memory_bytes
    exact = tflash.flash_decode(*_rounded(hmm), _y(y), num_segments=N, mode="lean",
                                lean_leaf=leaf)
    np.testing.assert_array_equal(got.path, exact.numpy())


def test_auto_bf16_reaches_fused_bf16(differs):
    """auto merges the caller's precision into its candidate: at this shape
    both packages choose fused, and run it in bf16."""
    hmm, y = differs
    got = tfv.decode(hmm, y, "auto", precision="bf16", device="cpu", warmup=False)
    want = jfv.decode(_jax(hmm), y, "auto", precision="bf16", warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes == want.memory_bytes
    assert got.extra["precision"] == "bf16"
    fused = tfv.decode(hmm, y, "fused", precision="bf16", device="cpu", warmup=False)
    np.testing.assert_array_equal(got.path, fused.path)
    assert (got.path != tfv.decode(hmm, y, "auto", device="cpu", warmup=False).path).any()


@pytest.mark.parametrize("algorithm,static", [
    ("fused", {}),
    ("flash", {"num_segments": 4}),
    ("flash", {"mode": "lean", "num_segments": 4}),
])
def test_bf16_quality_against_the_optimum(differs, algorithm, static):
    """JAX's quality bound on the approximate mode
    (tests/test_scaling_precision.py): by the exact tables' f64 score, the
    bf16 path is never better than the fp32 optimum, and within 5% of it."""
    hmm, y = differs
    exact = tfv.decode(hmm, y, algorithm, device="cpu", warmup=False, pad_to=1, **static)
    approx = tfv.decode(hmm, y, algorithm, precision="bf16", device="cpu", warmup=False,
                        pad_to=1, **static)
    le, la = (tval.path_score_f64(hmm.A, hmm.B, hmm.Pi, y, p) for p in (exact.path,
                                                                         approx.path))
    assert la <= le + 1e-6
    assert la >= le - 0.05 * abs(le)


def _tie_tables(K: int, N: int, Tm: int, seed: int):
    """A dense-tie bf16 logA (a handful of values, an all -inf row and
    column), integer emissions and carries."""
    rng = np.random.default_rng(seed)
    logA = rng.choice(np.float32([-3.0, -1.5, -0.75, 0.0]), (K, K))
    logA[K // 3] = -np.inf
    logA[:, K // 5] = -np.inf
    emits = np.round(rng.standard_normal((Tm, N, K))).astype(np.float32)
    delta0 = np.round(rng.standard_normal((N, K))).astype(np.float32)
    return (torch.from_numpy(logA).to(torch.bfloat16), torch.from_numpy(emits),
            torch.from_numpy(delta0))


@pytest.mark.parametrize("K,N", [(37, 3), (64, 1)])
def test_plain_versions_on_bf16_equal_fp32_on_the_upcast_table(K, N):
    logA, emits, delta0 = _tie_tables(K, N, 6, seed=K)
    up = logA.float()
    for plain in (km.maxplus_scan_plain, km.maxplus_scan_deltas_plain):
        got, want = plain(logA, emits, delta0), plain(up, emits, delta0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[0].dtype == torch.float32
    # CPU tensors: every wrapper runs its plain version
    for wrapper, plain in ((km.maxplus_scan, km.maxplus_scan_plain),
                           (km.maxplus_scan_bf16, km.maxplus_scan_plain),
                           (km.maxplus_scan_deltas, km.maxplus_scan_deltas_plain),
                           (km.maxplus_scan_deltas_bf16, km.maxplus_scan_deltas_plain)):
        got, want = wrapper(logA, emits, delta0), plain(up, emits, delta0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    dfin, deltas = km.maxplus_scan_deltas_plain(up, emits, delta0)
    last = tmp.first_argmax(dfin, 1)[1]
    valid = torch.from_numpy(np.random.default_rng(K).random((6, N)) < 0.7)
    logAT = logA.t().contiguous()
    want = kb.argmax_walk_plain(deltas, logAT.float(), last, valid)
    assert torch.equal(kb.argmax_walk_plain(deltas, logAT, last, valid), want)
    assert torch.equal(kb.argmax_walk(deltas, logAT, last, valid), want)
    assert torch.equal(kb.argmax_walk_bf16(deltas, logAT, last, valid), want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_reject_other_tables_and_bf16_emissions(dtype):
    logA, emits, delta0 = _tie_tables(16, 2, 3, seed=1)
    for fn in (km.maxplus_scan, km.maxplus_scan_deltas, km.maxplus_scan_bf16,
               km.maxplus_scan_deltas_bf16):
        with pytest.raises(TypeError, match="logA must be"):
            fn(logA.to(dtype), emits, delta0)
        with pytest.raises(TypeError, match="emits must be"):
            fn(logA, emits.to(torch.bfloat16), delta0)
        with pytest.raises(TypeError, match="delta0 must be"):
            fn(logA, emits, delta0.to(torch.bfloat16))
    for fn in (km.maxplus_scan_bf16, km.maxplus_scan_deltas_bf16):
        with pytest.raises(TypeError, match="logA must be"):
            fn(logA.float(), emits, delta0)
    logBT, ys = emits[0], torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="logA must be"):  # the gather scan stays fp32
        km.maxplus_scan_emitgather(logA, logBT, ys, delta0)
    _, deltas = km.maxplus_scan_deltas(logA, emits, delta0)
    last = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="logAT must be"):
        kb.argmax_walk(deltas, logA.to(dtype), last)
    with pytest.raises(TypeError, match="logAT must be"):
        kb.argmax_walk_bf16(deltas, logA.float(), last)
    with pytest.raises(TypeError, match="deltas must be"):
        kb.argmax_walk(deltas.to(torch.bfloat16), logA, last)


def _spy(monkeypatch):
    """Fake the CUDA branches of the scans and the walk: every device check
    answers CUDA, the card has SMS SMs, and a launch records its entry
    point and arguments and counts on its wrapper."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        counter.launches += 1

    for mod in (km, kb):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "launch", fake_launch)
    monkeypatch.setattr(km, "sm_count", lambda dev: SMS)
    tk.reset_launches()
    return calls


def test_bf16_tables_launch_the_bf16_instances(monkeypatch):
    """On CUDA a bf16 table goes to the bf16 entry points under their own
    counters, with a plan made for 2-byte values; a plan for fp32 values is
    refused before the launch."""
    calls = _spy(monkeypatch)
    logA, emits, delta0 = _tie_tables(64, 20, 3, seed=2)
    km.maxplus_scan(logA, emits, delta0)
    km.maxplus_scan_deltas(logA, emits, delta0)
    km.maxplus_scan_bf16(logA, emits, delta0)
    km.maxplus_scan(logA.float(), emits, delta0)
    assert [c[0] for c in calls] == ["fvt_maxplus_scan_bf16"] * 3 + ["fvt_maxplus_scan"]
    plan = km.scan_plan(64, 20, SMS, elem_bytes=2)
    for _, args in calls[:3]:
        assert list(args[-4]) == list(plan.c_args())
    assert list(calls[3][1][-4]) == list(km.scan_plan(64, 20, SMS).c_args())
    counts = tk.launch_counts()
    assert (counts["maxplus_scan_bf16"], counts["maxplus_scan_deltas_bf16"],
            counts["maxplus_scan"], counts["maxplus_scan_deltas"]) == (2, 1, 1, 0)
    with pytest.raises(ValueError, match="2-byte ones"):
        km.maxplus_scan(logA, emits, delta0, plan=km.scan_plan(64, 20, SMS))
    with pytest.raises(ValueError, match="4-byte ones"):
        km.maxplus_scan(logA.float(), emits, delta0, plan=plan)
    _, deltas = km.maxplus_scan_deltas_plain(logA, emits, delta0)
    last = torch.zeros(20, dtype=torch.int32)
    err = km.error_word("cpu")
    kb.argmax_walk(deltas, logA.t().contiguous(), last, err=err)
    kb.argmax_walk(deltas, logA.t().contiguous().float(), last, err=err)
    assert [c[0] for c in calls[-2:]] == ["fvt_argmax_walk_bf16", "fvt_argmax_walk"]
    counts = tk.launch_counts()
    assert counts["argmax_walk_bf16"] == 1 and counts["argmax_walk"] == 1


@pytest.mark.parametrize("N", [1, 16, 20])
@pytest.mark.parametrize("K", [7, 64, 1000, 3965, 3968, 16384, 70000])
def test_bf16_plan_holds_twice_the_rows(K, N):
    """A plan for 2-byte values tiles logA as the fp32 plan does and keeps
    as many tile rows in shared memory as fit at 2 bytes a value: about
    twice the fp32 plan's, with an even stride."""
    p4, p2 = km.scan_plan(K, N, SMS), km.scan_plan(K, N, SMS, elem_bytes=2)
    same = ("lanes", "cols", "R", "C", "blocks", "row_edges", "col_edges", "carry_rows",
            "team", "two_phase")
    assert all(getattr(p4, f) == getattr(p2, f) for f in same)
    assert p2.elem_bytes == 2 and p2.stride % 2 == 0 and p2.stride - p4.stride in (0, 1)
    carry = -(-p2.carry_rows * p2.lanes // 4) * 16
    assert p2.smem == carry + p2.rows_smem * p2.stride * 2
    assert p2.smem + km.STATIC_SMEM <= SMEM_LIMIT
    kr_max = p2.rows_smem + p2.rows_streamed
    room = SMEM_LIMIT - km.STATIC_SMEM - carry
    if p2.tiles == p2.blocks:
        assert p2.rows_smem == min(kr_max, room // (p2.stride * 2)) >= p4.rows_smem
        assert p2.rows_smem >= min(kr_max, 2 * p4.rows_smem - 1)
    assert km.streamed_bytes(p2) <= km.streamed_bytes(p4) // 2
    if (K, N) == (3968, 1):  # the headline's phase 1: 58 of a tile's 61 rows on chip
        assert (p4.rows_smem, p2.rows_smem, kr_max) == (29, 58, 61)


def test_scan_plan_refuses_other_element_sizes():
    with pytest.raises(ValueError, match="elem_bytes"):
        km.scan_plan(64, 1, SMS, elem_bytes=8)


def test_flash_keeps_the_cast_and_the_transpose(differs, monkeypatch):
    """The flash decoder rounds a table once and transposes it once while
    the table is unchanged, and again after it changes in place."""
    casts = []
    real = tmp.table_at
    monkeypatch.setattr(tmp, "table_at", lambda a, p: casts.append(p) or real(a, p))
    hmm, y = differs
    lh = hmm.log(device="cpu").padded(128)
    dec = tfv.build("flash", num_segments=4, precision="bf16")
    first = dec(lh.logA, lh.logB, lh.logPi, _y(y))
    assert torch.equal(dec(lh.logA, lh.logB, lh.logPi, _y(y)), first)
    assert casts == ["bf16"]
    cache = tflash._Transposed()
    table = cache.cast(lh.logA, "bf16")
    assert table.dtype == torch.bfloat16 and cache.cast(lh.logA, "bf16") is table
    assert cache(table) is cache(table) and torch.equal(cache(table), table.t())
    lh.logA.add_(0.0)  # a new version: made again
    assert cache.cast(lh.logA, "bf16") is not table
    assert cache.cast(lh.logA, "fp32") is lh.logA


def test_precision_is_checked_and_recorded():
    hmm, y = tfv.make_sparse_hmm(K=16, M=3, T=8, prob=0.5, seed=1)
    for algorithm in ("fused", "flash"):
        with pytest.raises(ValueError, match="precision"):
            tfv.decode(hmm, y, algorithm, precision="fp16", device="cpu")
        assert tfv.build(algorithm, precision="bf16").static["precision"] == "bf16"
    with pytest.raises(ValueError, match="precision"):
        tmp.table_at(torch.zeros((2, 2)), "int8")


def test_sharded_batch_ignores_precision_as_jax_does(differs):
    """The sharded decode takes no precision (in JAX too): it decodes fp32."""
    hmm, y = differs
    ys = np.stack([y, observations(DIFFERS["T"], DIFFERS["M"], seed=3)])
    mesh = tfv.make_mesh(1, 1, 1)
    got = tfv.decode_batch(hmm, ys, mesh=mesh, num_segments=4, precision="bf16",
                           device="cpu", warmup=False)
    fp32 = tfv.decode_batch(hmm, ys, mesh=mesh, num_segments=4, device="cpu", warmup=False)
    np.testing.assert_array_equal(got.path, fp32.path)
