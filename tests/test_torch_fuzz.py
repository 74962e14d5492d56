"""Randomized cross-algorithm checks of the port on the CPU: the counterpart
of ``tests/test_fuzz.py``, on its cases and seeds (its SIEVE functions are
in ``tests/test_torch_fuzz_sieve.py``).  Every exact decoder of the port
must give the same path as the oracle (``oracle.framework``) and as the JAX
package (its Pallas kernels in interpret mode, as its own tests run them);
the sharded cases run in gloo worlds of the port's ranks
(``tests/torch_sharded_worker.py``'s ``FUZZ_CASES``)."""

import os

import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.oracle import framework as jofw
from flash_viterbi_tpu_torch.oracle import framework as ofw
from flash_viterbi_tpu_torch.parallel import multihost
from tests.torch_sharded_worker import FUZZ_CASES, world_size

torch.set_num_threads(2)

CASES = [
    # (K, M, T, prob, seed)
    (24, 3, 9, 0.6, 101),
    (40, 7, 21, 0.35, 102),
    (56, 11, 40, 0.2, 103),
    (72, 5, 13, 0.45, 104),
    (96, 16, 57, 0.15, 105),
    (33, 4, 26, 0.5, 106),   # K not a multiple of 8
    (128, 9, 31, 0.1, 107),
    (17, 2, 64, 0.7, 108),
]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sharded_worker.py")


def _jax(hmm):
    return jfv.HMM(hmm.A, hmm.B, hmm.Pi)


@pytest.mark.parametrize("K,M,T,prob,seed", CASES)
def test_exact_algorithms_agree(K, M, T, prob, seed):
    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    np.testing.assert_array_equal(want, jofw.vanilla(hmm.A, hmm.B, hmm.Pi, y))
    # the JAX package's Pallas fused path (interpret mode) on the same problem
    np.testing.assert_array_equal(
        jfv.decode(_jax(hmm), y, "fused", use_pallas=True, pad_to=1, warmup=False).path, want)
    for alg, kw in [
        ("vanilla", {}),
        ("checkpoint", {}),
        ("fused", {}),
        ("flash", {"num_segments": 5}),
        ("flash", {"num_segments": 5, "mode": "lean"}),
        ("flash", {"num_segments": 5, "mode": "lean", "lean_leaf": 0}),
        ("flash", {"num_segments": 3, "mode": "lean", "lean_leaf": 4}),
        ("flash_bs", {"beam_width": K, "num_segments": 5}),
        ("beam", {"beam_width": K}),
        ("flash_long", {"num_segments": 5, "group_steps": 8}),
    ]:
        r = tfv.decode(hmm, y, alg, pad_to=1, warmup=False, device="cpu", **kw)
        np.testing.assert_array_equal(r.path, want, err_msg=f"{alg} {kw} K={K} T={T}")


@pytest.fixture(scope="module")
def fuzz_worlds(tmp_path_factory):
    """Each world size's output directory, its ranks spawned on first use
    (only the fuzz cases)."""
    dirs = {}

    def get(n: int):
        if n not in dirs:
            d = tmp_path_factory.mktemp(f"fuzzworld{n}")
            multihost.launch_workers(WORKER, n, d, timeout=240.0,
                                     env={"FVT_WORKER_CASES": "fuzz"})
            dirs[n] = d
        return dirs[n]

    return get


@pytest.mark.parametrize("name", sorted(FUZZ_CASES))
def test_sharded_agrees_with_single_chip_fuzz(name, fuzz_worlds):
    """Random problems through the public mesh path (``decode_batch``) on
    every rank are bit-identical to per-sequence single-device flash decodes
    of the port and to the JAX package's mesh decode."""
    from flash_viterbi_tpu.parallel.sharded import make_mesh

    from tests.torch_sharded_worker import problem

    case = FUZZ_CASES[name]
    n = world_size(case)
    out = fuzz_worlds(n)
    hmm, _, ys = problem(case)
    segs = case["opts"]["num_segments"]
    want = np.stack([tfv.decode(hmm, row, "flash", num_segments=segs, mode="pointer",
                                warmup=False, device="cpu").path for row in ys])
    jax = jfv.decode_batch(_jax(hmm), ys, mesh=make_mesh(*case["shape"]), num_segments=segs,
                           warmup=False)
    np.testing.assert_array_equal(jax.path, want)
    for r in range(n):
        got = np.load(os.path.join(out, f"{name}.rank{r}.npy"))
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("K,M,T,prob,seed", CASES)
def test_auto_budgeted_always_exact(K, M, T, prob, seed):
    """Whatever decoder a memory budget forces auto into, the nothing-fits
    fallback included, the path stays exact, and the chosen candidate's
    working set respects a budget that some candidate meets."""
    from flash_viterbi_tpu_torch.algorithms.auto import choose, device_working_set

    hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    rng = np.random.RandomState(seed)
    budgets = [None] + [int(10 ** rng.uniform(2, 9)) for _ in range(4)]
    for budget in budgets:
        r = tfv.decode(hmm, y, "auto", pad_to=1, warmup=False, device="cpu",
                       memory_budget_bytes=budget)
        np.testing.assert_array_equal(r.path, want, err_msg=f"budget={budget} K={K} T={T}")
        if budget is not None:
            name, kw = choose(K, T, memory_budget_bytes=budget)
            ws = device_working_set(name, kw, K, T)
            fits_any = any(device_working_set(n, k, K, T) <= budget
                           for n, k in [("flash", {"num_segments": 8}),
                                        ("flash", {"mode": "lean"}),
                                        ("checkpoint", {}), ("fused", {})])
            if fits_any:
                assert ws <= budget, (name, kw, ws, budget)
    np.testing.assert_array_equal(
        jfv.decode(_jax(hmm), y, "auto", pad_to=1, warmup=False).path, want)
