"""The probes (``flash_viterbi_tpu_torch.probes``): each plain version held
bit for bit against the JAX probe kernel of ``scripts/`` in Pallas
interpret mode, on inputs made from the same numpy seeds; the copy
probes beside ``beam_dma_probe``'s own checks; ``marginal_time`` on a CPU
chain; and each wrapper's CUDA branch, spied on the CPU."""

import functools
import importlib.util
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_viterbi_tpu_torch import probes
from flash_viterbi_tpu_torch.bench.harness import marginal_time
from flash_viterbi_tpu_torch.ops.cuda import beam as kbeam
from flash_viterbi_tpu_torch.probes import alu, beam, copy, scan
from flash_viterbi_tpu_torch.probes.__main__ import main as probes_main

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


@functools.lru_cache(maxsize=None)
def _script(name: str):
    """Import ``scripts/<name>.py`` (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rounds", [0, 1, 4])
def test_alu_matches_vpu_kernel(rounds):
    vp = _script("vpu_probe")
    x = alu.inputs(16, 128, device="cpu")
    want = pl.pallas_call(functools.partial(vp._vpu_kernel, R=rounds),
                          out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
                          interpret=True)(jnp.asarray(x.numpy()))
    got = alu.probe_alu(x, rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert alu.operations(x.numel(), rounds) == 2 * alu.cells(x.numel(), rounds) + 7 * x.numel()


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


@pytest.mark.parametrize("write_hist", [True, False])
def test_scan_ablation_matches_abl_kernel(write_hist):
    vp = _script("vpu_probe")
    logA, emits, delta0 = scan.inputs(256, 2, 3, device="cpu")
    jdfin, jhist = _ablation_pallas(vp, logA.numpy(), emits.numpy(), delta0.numpy(), write_hist)
    for kc in scan.KCS:
        dfin, deltas = scan.probe_scan_ablation(logA, emits, delta0, write_hist, kc)
        np.testing.assert_array_equal(dfin.numpy(), np.asarray(jdfin))
        if write_hist:
            np.testing.assert_array_equal(deltas.numpy(), np.asarray(jhist))
        else:
            assert deltas is None


def test_scan_inputs_share_one_logA_draw_per_K():
    cache = {}
    a = scan.inputs(64, 2, 3, device="cpu", cache=cache)
    b = scan.inputs(64, 4, 2, device="cpu", cache=cache)
    fresh = scan.inputs(64, 4, 2, device="cpu")
    assert b[0] is a[0]
    for x, y in zip(b, fresh):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="kc"):
        scan.probe_scan_ablation(*a, kc=1024)


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


def test_copy_rows_checks():
    with pytest.raises(ValueError, match="16 bytes"):
        copy.probe_copy_p1(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="exceed"):
        copy.probe_copy_p3(torch.zeros((2, 16384)))
    with pytest.raises(TypeError, match="float32"):
        copy.probe_copy_p1(torch.zeros((4, 8), dtype=torch.float64))


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
        monkeypatch.setattr(mod, "launch", fake_launch)
    monkeypatch.setattr(beam.build, "kernels", lambda: type(
        "Lib", (), {"fvt_probe_beam_smem": staticmethod(lambda K, B: 0)})())
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
    scan.probe_scan_ablation(*sargs, write_hist=False, kc=512)
    beam.probe_beam_parts(*bargs, "no-dma")
    beam.probe_beam_select(*bargs, "blockm")
    beam.probe_beam_select(*bargs, "sort")
    copy.probe_copy_p1(rows)
    copy.probe_copy_p3(rows)
    copy.probe_copy_p4(device="cpu")
    copy.probe_copy_p5(v, c)
    names = [name for name, _ in calls]
    assert names == ["fvt_probe_alu", "fvt_maxplus_scan_deltas_ablation", "fvt_probe_beam",
                     "fvt_probe_beam", "fvt_probe_beam", "fvt_probe_copy_rows",
                     "fvt_probe_copy_rows", "fvt_probe_copy_p4", "fvt_probe_copy_p5"]
    assert calls[0][1][-2:] == (x.numel(), 4)
    assert calls[1][1][4] is None and calls[1][1][-5:] == (3, 2, 64, 0, 512)
    assert [a[-1] for _, a in calls[2:5]] == [beam.VARIANTS.index("no-dma"),
                                             beam.VARIANTS.index("blockm"), 0]
    assert calls[5][1][-4:-1] == (4, 256, 1) and calls[6][1][-4:-1] == (4, 256, copy.P3_B)
    assert probes.launch_counts() == {"probe_alu": 1, "probe_scan_ablation": 1,
                                      "probe_beam_parts": 1, "probe_beam_select": 2,
                                      "probe_copy_p1": 1, "probe_copy_p3": 1,
                                      "probe_copy_p4": 1, "probe_copy_p5": 1}


def test_beam_probe_refuses_a_select_too_large_for_a_block(monkeypatch):
    _fake_launches(monkeypatch, (beam,))
    monkeypatch.setattr(beam.build, "kernels", lambda: type(
        "Lib", (), {"fvt_probe_beam_smem": staticmethod(lambda K, B: kbeam.SMEM_LIMIT + 1)})())
    with pytest.raises(ValueError, match=str(kbeam.SMEM_LIMIT)):
        beam.probe_beam_parts(*beam.inputs(4, 256, 3, device="cpu"))


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
             "scan": dict(shapes={"tiny": (128, 3, 2)}, kcs=(128, 512)),
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
        assert len(timed) == 4 and {r["variant"] for r in records} >= set(scan.NO_RUN)


def test_main_prints_one_json_line_a_variant(capsys):
    probes_main(["copy", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in lines] == ["p1", "p1_beam_rows", "p3", "p3_beam_rows", "p4",
                                             "p5"]
    with pytest.raises(ValueError, match="unknown probes"):
        probes.run(["vpu"], device="cpu")
