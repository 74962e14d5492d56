"""The port's max-plus primitives and scan plain versions against the JAX
package's (Pallas functions in interpret mode), exactly: carries, pointers
and carry histories, on random, tie and padded fixtures, at N in
{1, 3, 16}, on the TPU kernels' resident and tiled routes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.models.generate import make_sparse_hmm
from flash_viterbi_tpu.ops import maxplus as jmp
from flash_viterbi_tpu.ops.pallas import maxplus as pk
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops import maxplus as tmp_
from flash_viterbi_tpu_torch.ops.cuda import maxplus as tkm

torch.set_num_threads(2)


def _fixture(kind: str, K: int, N: int, Tm: int, seed: int):
    """(logA (K,K), emits (Tm,N,K), delta0 (N,K)) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        logA = rng.standard_normal((K, K))
        emits = rng.standard_normal((Tm, N, K))
        delta0 = rng.standard_normal((N, K))
    elif kind == "ties":  # integer-valued: exact fp32 ties everywhere
        logA = np.round(rng.standard_normal((K, K)) * 2) / 2
        emits = np.round(rng.standard_normal((Tm, N, K)))
        delta0 = np.round(rng.standard_normal((N, K)))
    else:  # "padded": a real model padded with dead (-inf) states
        hmm, y = make_sparse_hmm(K=K - 28, M=7, T=Tm + 1, prob=0.2, seed=seed)
        lh = hmm.log().padded(K)
        logA = lh.logA
        starts = rng.integers(0, lh.K, N)
        ys = rng.integers(0, lh.M, (Tm + 1, N))
        emits = np.transpose(lh.logB[:, ys], (1, 2, 0))[1:]  # (Tm, N, K)
        delta0 = logA[starts] + lh.logB[:, ys[0]].T
        delta0[0] = lh.logPi + lh.logB[:, ys[0, 0]]
    return tuple(np.ascontiguousarray(x, dtype=np.float32)
                 for x in (logA, emits, delta0))


def _jax_scans(logA, emits, delta0, tiled: bool, monkeypatch):
    args = [jnp.asarray(x) for x in (logA, emits, delta0)]
    if tiled:
        # shrink the VMEM budget: no resident route, (128, 128) tiles at K=256
        monkeypatch.setattr(pk, "_VMEM_BUDGET", 2 * 128 * 128 * 4)
        assert pk._pick_tiles(logA.shape[0]) == (128, 128)
        scan = pk.maxplus_scan.__wrapped__
        scan_deltas = pk.maxplus_scan_deltas.__wrapped__
    else:
        scan, scan_deltas = pk.maxplus_scan, pk.maxplus_scan_deltas
    dfin, ptrs = scan(*args, interpret=True)
    dfin2, deltas = scan_deltas(*args, interpret=True)
    return [np.asarray(x) for x in (dfin, ptrs, dfin2, deltas)]


@pytest.mark.parametrize("route", ["resident", "tiled"])
@pytest.mark.parametrize("N", [1, 3, 16])
@pytest.mark.parametrize("kind", ["random", "ties", "padded"])
def test_scan_plain_matches_pallas(kind, N, route, monkeypatch):
    logA, emits, delta0 = _fixture(kind, 256, N, 5, seed=N)
    want = _jax_scans(logA, emits, delta0, route == "tiled", monkeypatch)
    args = [torch.from_numpy(x) for x in (logA, emits, delta0)]
    dfin, ptrs = tkm.maxplus_scan_plain(*args)
    dfin2, deltas = tkm.maxplus_scan_deltas_plain(*args)
    assert ptrs.dtype == torch.int32 and deltas.dtype == torch.float32
    for got, exp in zip((dfin, ptrs, dfin2, deltas), want):
        np.testing.assert_array_equal(got.numpy(), exp)


def test_scan_zero_steps_returns_carry():
    logA, emits, delta0 = _fixture("random", 16, 2, 0, seed=0)
    args = [torch.from_numpy(x) for x in (logA, emits, delta0)]
    for fn in (tk.maxplus_scan, tk.maxplus_scan_deltas):
        dfin, hist = fn(*args)
        assert torch.equal(dfin, args[2]) and hist.shape == (0, 2, 16)


def test_wrappers_dispatch_cpu_to_plain_without_launching():
    logA, emits, delta0 = _fixture("ties", 40, 3, 4, seed=2)
    args = [torch.from_numpy(x) for x in (logA, emits, delta0)]
    before = tk.launch_counts()
    for fn, plain in ((tk.maxplus_scan, tkm.maxplus_scan_plain),
                      (tk.maxplus_scan_deltas, tkm.maxplus_scan_deltas_plain)):
        for g, w in zip(fn(*args), plain(*args)):
            assert torch.equal(g, w)
    assert tk.launch_counts() == before


def test_wrappers_reject_other_devices_and_bad_args():
    logA, emits, delta0 = (torch.zeros(s, device="meta")
                           for s in ((8, 8), (2, 1, 8), (1, 8)))
    with pytest.raises(ValueError, match="device"):
        tk.maxplus_scan(logA, emits, delta0)
    cpu = [torch.zeros(s) for s in ((8, 8), (2, 1, 8), (1, 8))]
    with pytest.raises(ValueError, match="shape"):
        tk.maxplus_scan(cpu[0], cpu[1], torch.zeros(2, 8))
    with pytest.raises(TypeError, match="float32"):
        tk.maxplus_scan_deltas(cpu[0].double(), cpu[1], cpu[2])
    with pytest.raises(ValueError, match="devices"):
        tk.maxplus_scan(cpu[0], cpu[1], delta0)


def _tie_step_inputs(K=96, seed=3):
    rng = np.random.default_rng(seed)
    logA = (np.round(rng.standard_normal((K, K)) * 2) / 2).astype(np.float32)
    logA[:, 5] = -np.inf  # a dead destination: argmax 0 by the tie rule
    delta = np.round(rng.standard_normal(K)).astype(np.float32)
    emits = np.round(rng.standard_normal((7, K))).astype(np.float32)
    return logA, delta, emits


def test_primitives_match_jax():
    logA, delta, emits = _tie_step_inputs()
    jA, jd, je = jnp.asarray(logA), jnp.asarray(delta), jnp.asarray(emits)
    tA, td, te = (torch.from_numpy(x) for x in (logA, delta, emits))

    jv, jp = jmp.maxplus_step(jd, jA, je[0])
    tv, tp = tmp_.maxplus_step(td, tA, te[0])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.int32 and int(tp[5]) == 0
    np.testing.assert_array_equal(
        tmp_.maxplus_step_noptr(td, tA, te[0]).numpy(),
        np.asarray(jmp.maxplus_step_noptr(jd, jA, je[0])))

    jdf, jptrs = jmp.forward_scan(jd, jA, je)
    tdf, tptrs = tmp_.forward_scan(td, tA, te)
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    np.testing.assert_array_equal(tptrs.numpy(), np.asarray(jptrs))

    jlast = jmp.argmax_final(jdf)
    tlast = tmp_.argmax_final(tdf)
    assert int(tlast) == int(jlast) and tlast.dtype == torch.int32
    jpath = jmp.backtrack(jptrs, jlast)
    tpath = tmp_.backtrack(tptrs, tlast)
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))

    # integer-valued tables keep every fp32 sum exact in any order
    logB = np.round(logA[:, :11]).astype(np.float32)
    logPi = np.round(delta).astype(np.float32)
    y = np.arange(8) % 11
    path = np.array(jpath)
    want = jmp.path_score(jnp.asarray(logA), jnp.asarray(logB), jnp.asarray(logPi),
                          jnp.asarray(y), jnp.asarray(path))
    got = tmp_.path_score(tA, torch.from_numpy(logB), torch.from_numpy(logPi),
                          torch.from_numpy(y), torch.from_numpy(path))
    assert float(got) == float(want)


def test_first_argmax_all_neg_inf_is_zero_and_ties_lowest():
    x = torch.tensor([[-np.inf, 1.0, 3.0], [-np.inf, 3.0, 3.0]], dtype=torch.float32)
    val, idx = tmp_.first_argmax(x, 0)
    assert idx.tolist() == [0, 1, 0] and val.tolist() == [-np.inf, 3.0, 3.0]
    assert tmp_.first_argmax(x, 1)[1].tolist() == [2, 1]
