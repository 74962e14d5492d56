"""The beam scan's plain version against the JAX package, exactly: against
the Pallas ``beam_scan`` / ``beam_scan_planes`` (interpret mode) on sparse
and integer-valued tie fixtures, with and without anchor planes, at the
padded and an unpadded K; lanes against single-lane calls; the valid mask;
and ``beam_topk`` against ``jax.lax.top_k``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas import beam as pk
from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
from flash_viterbi_tpu_torch.ops import beam as tb
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.oracle import framework as tfw

torch.set_num_threads(2)

NEG = np.float32(-np.inf)


def _fixture(kind: str, K: int, Tm: int, B: int, seed: int):
    """(logA (K,K), emits (Tm,K), vals0 (B,), states0 (B,) int32) numpy.

    "sparse": about 4% of the edges exist and the start row has 3 finite
    scores, so beams hold fewer finite scores than B.  "ties": integer
    and half-integer values, exact fp32 ties everywhere, a dead
    destination column and some -inf edges.  No -0.0: the tables' logs
    never produce one."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        logA = np.where(rng.random((K, K)) < 0.04, rng.standard_normal((K, K)), NEG)
        emits = np.where(rng.random((Tm, K)) < 0.9, rng.standard_normal((Tm, K)), NEG)
        full0 = np.full(K, NEG)
        full0[rng.choice(K, 3, replace=False)] = rng.standard_normal(3)
    else:
        logA = np.round(rng.standard_normal((K, K)) * 2) / 2 + 0.0
        logA[rng.random((K, K)) < 0.1] = NEG
        logA[:, 3] = NEG
        emits = np.round(rng.standard_normal((Tm, K))) + 0.0
        full0 = np.round(rng.standard_normal(K)) + 0.0
    logA, emits, full0 = (np.ascontiguousarray(x, dtype=np.float32)
                          for x in (logA, emits, full0))
    vals0, states0 = tfw.topk(full0, B)
    return logA, emits, vals0, states0.astype(np.int32)


def _prop(Tm: int, P: int) -> np.ndarray:
    """(Tm, P) bool schedule of P anchors over Tm+1 positions."""
    return prop_schedule(flash_midpoints(0, Tm, P + 1), Tm + 1)


@pytest.mark.parametrize("K,B,Tm,P,kind", [
    (128, 8, 17, 0, "ties"),
    (128, 16, 17, 3, "sparse"),
    (200, 1, 17, 1, "sparse"),    # K not a multiple of 128: JAX pads to 256
    (200, 16, 1, 3, "ties"),
    (200, 8, 17, 3, "ties"),
    (128, 16, 1, 0, "sparse"),
    (128, 1, 0, 1, "sparse"),     # zero steps: planes stay -1
    (200, 8, 0, 0, "ties"),
])
def test_beam_scan_plain_matches_pallas(K, B, Tm, P, kind):
    logA, emits, vals0, states0 = _fixture(kind, K, Tm, B, seed=K + B + Tm + P)
    prop = _prop(Tm, P)
    ja = [jnp.asarray(x) for x in (logA, emits, vals0, states0)]
    if P:
        want = pk.beam_scan_planes(*ja, jnp.asarray(prop.astype(np.int32)), interpret=True)
    else:
        want = pk.beam_scan(*ja, interpret=True) + (np.full((0, B), -1, np.int32),)
    args = (torch.from_numpy(logA), torch.from_numpy(emits)[:, None, :],
            torch.from_numpy(vals0)[None], torch.from_numpy(states0)[None])
    tprop = torch.from_numpy(prop) if P else None
    got = tk.beam_scan(*args, prop=tprop)
    for g, w in zip((got[0][:, 0], got[1][:, 0], got[2][0]), want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, p in zip(got, tb.beam_scan_plain(*args, prop=tprop)):
        assert torch.equal(g, p)


def test_lanes_equal_single_lane_calls_and_masked_rows():
    K, B, Tm, P, N = 64, 8, 12, 2, 3
    fx = [_fixture("ties" if n % 2 else "sparse", K, Tm, B, seed=40 + n) for n in range(N)]
    logA = torch.from_numpy(fx[0][0])
    emits = torch.from_numpy(np.stack([f[1] for f in fx], axis=1))  # (Tm, N, K)
    vals0 = torch.from_numpy(np.stack([f[2] for f in fx]))
    states0 = torch.from_numpy(np.stack([f[3] for f in fx]))
    prop = torch.from_numpy(_prop(Tm, P))
    valid = torch.from_numpy(np.random.default_rng(9).random((Tm, N)) < 0.7)
    valid[0, 1] = False
    for mask in (None, valid):
        hist, slots, planes = tk.beam_scan(logA, emits, vals0, states0, valid=mask, prop=prop)
        for n in range(N):
            one = tk.beam_scan(logA, emits[:, n:n + 1].contiguous(), vals0[n:n + 1],
                               states0[n:n + 1],
                               valid=None if mask is None else mask[:, n:n + 1], prop=prop)
            assert torch.equal(hist[:, n], one[0][:, 0])
            assert torch.equal(slots[:, n], one[1][:, 0])
            assert torch.equal(planes[n], one[2][0])
    iota = torch.arange(B, dtype=torch.int32)
    for t in range(Tm):
        for n in range(N):
            if not valid[t, n]:
                before = states0[n] if t == 0 else hist[t - 1, n]
                assert torch.equal(hist[t, n], before)
                assert torch.equal(slots[t, n], iota)
    # a lane masked from its first row on keeps its start beam
    assert torch.equal(hist[0, 1], states0[1])


def test_beam_topk_matches_lax_top_k():
    rng = np.random.default_rng(3)
    rows = rng.choice(np.array([1.0, 0.5, -2.0, NEG], np.float32), size=(4, 50))
    rows[1] = NEG                   # all -inf: indices in order
    rows[2, :] = 0.5                # all tied
    rows[3, 40:] = NEG
    for B in (1, 7, 50):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows), B)
        got_v, got_i = tb.beam_topk(torch.from_numpy(rows), B)
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        for r in range(4):
            np.testing.assert_array_equal(got_i[r].numpy(), tfw.topk(rows[r], B)[1])


def test_beam_scan_rejects_bad_arguments():
    logA, emits, vals0, states0 = (torch.from_numpy(x) for x in
                                   _fixture("ties", 16, 4, 4, seed=1))
    args = (logA, emits[:, None], vals0[None], states0[None])
    with pytest.raises(TypeError, match="int32"):
        tk.beam_scan(*args[:3], args[3].long())
    with pytest.raises(ValueError, match="B <= Kp"):
        tk.beam_scan(logA, emits[:, None], torch.zeros((1, 17)),
                     torch.zeros((1, 17), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        tk.beam_scan(*args, valid=torch.ones((4, 2), dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        tk.beam_scan(*args, prop=torch.ones((4, 2), dtype=torch.int32))
