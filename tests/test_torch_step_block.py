"""``maxplus_step_block``, the state-sharded trellis step: the port's plain
version against JAX's Pallas kernel in interpret mode, bit for bit, with
exact ties and dead (all -inf) rows and columns; and the CUDA branch's
argument checks and the sharded decode's kernel inputs, spied on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas.maxplus import maxplus_step_block as jstep
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
from flash_viterbi_tpu_torch.parallel import sharded

torch.set_num_threads(2)

SHAPES = [(4, 512, 256), (1, 256, 256), (3, 384, 128)]


def _fixture(N: int, Ks: int, Kd: int, integer: bool):
    """delta (N, Ks), logA_block (Ks, Kd) float32.  Source row 17 repeats
    row 3 in both (exact ties between two rows); ``integer`` rounds every
    value to halves (ties everywhere).  Column 5 and source row 9 are all
    -inf, so are delta's entries 11 and 12."""
    rng = np.random.RandomState(N + Ks + Kd)
    logA = rng.randn(Ks, Kd)
    delta = rng.randn(N, Ks)
    if integer:
        logA, delta = np.round(logA * 2) / 2, np.round(delta * 2) / 2
    logA[17] = logA[3]
    delta[:, 17] = delta[:, 3]
    logA[:, 5] = -np.inf
    logA[9] = -np.inf
    delta[:, 11:13] = -np.inf
    return delta.astype(np.float32), logA.astype(np.float32)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("N,Ks,Kd", SHAPES)
def test_step_block_matches_jax(N, Ks, Kd, integer):
    delta, logA = _fixture(N, Ks, Kd, integer)
    val, ptr = km.maxplus_step_block(torch.as_tensor(delta), torch.as_tensor(logA))
    jval, jptr = jstep(jnp.asarray(delta), jnp.asarray(logA), interpret=True)
    assert val.dtype == torch.float32 and ptr.dtype == torch.int32
    assert tuple(val.shape) == tuple(ptr.shape) == (N, Kd)
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr))
    scores = delta[:, :, None] + logA[None]
    np.testing.assert_array_equal(ptr.numpy(), scores.argmax(axis=1))
    assert (ptr[:, 5] == 0).all() and torch.isneginf(val[:, 5]).all()


def test_cuda_branch_checks_and_launches(monkeypatch):
    """With the device check answering "CUDA", the wrapper refuses
    non-contiguous inputs, wrong dtypes and wrong shapes, and launches the
    C entry point with (N, Ks, Kd), counting the launch."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args[-3:]))
        counter.launches += 1

    monkeypatch.setattr(km, "on_cuda", lambda *t: True)
    monkeypatch.setattr(km, "launch", fake_launch)
    monkeypatch.setattr(km, "sm_count", lambda dev: 132)
    monkeypatch.setattr(km.maxplus_step_block, "launches", 0)
    delta, logA = (torch.as_tensor(a) for a in _fixture(3, 384, 128, False))
    with pytest.raises(ValueError, match="contiguous"):
        km.maxplus_step_block(delta.t().contiguous().t(), logA)
    with pytest.raises(ValueError, match="contiguous"):
        km.maxplus_step_block(delta, torch.as_tensor(_fixture(3, 384, 256, False)[1])[:, ::2])
    with pytest.raises(TypeError, match="float32"):
        km.maxplus_step_block(delta.double(), logA)
    with pytest.raises(ValueError, match="shape"):
        km.maxplus_step_block(delta, logA[:200])
    with pytest.raises(ValueError, match="empty"):
        km.maxplus_step_block(delta[:0], logA)
    assert calls == []
    val, ptr = km.maxplus_step_block(delta, logA)
    assert calls == [("fvt_maxplus_step_block", (3, 384, 128))]
    assert km.maxplus_step_block.launches == 1
    assert tuple(val.shape) == tuple(ptr.shape) == (3, 128)
    assert "maxplus_step_block" in tk.launch_counts()
    assert km.step_block_supported(1000, 250)  # the Pallas tiling refuses this


@pytest.mark.parametrize("opts", [
    dict(num_segments=4, use_kernel=False),
    dict(num_segments=4, microbatch=2, use_kernel=True),
    dict(num_segments=4, pipeline=False),
])
def test_sharded_hands_the_kernels_contiguous_inputs(opts, monkeypatch):
    """Every kernel wrapper the sharded decode calls gets contiguous
    tensors (the CUDA branches refuse anything else; the CPU plain versions
    would not notice), and every form calls the step block."""
    called = []

    def spy(name, fn):
        def wrapped(*args):
            called.append(name)
            for a in args:
                assert not torch.is_tensor(a) or a.is_contiguous(), name
            return fn(*args)
        return wrapped

    for name in ("maxplus_step_block", "maxplus_scan", "maxplus_scan_deltas",
                 "backtrack_batched", "argmax_walk"):
        monkeypatch.setattr(sharded, name, spy(name, getattr(sharded, name)))
    hmm, y = make_sparse_hmm(K=64, M=12, T=32, prob=0.3, seed=7)
    lh = hmm.log(device="cpu")
    sharded.flash_decode_sharded(sharded.make_mesh(), lh.logA, lh.logB, lh.logPi,
                                 np.stack([y] * 4), **opts)
    assert "maxplus_step_block" in called
    if opts.get("use_kernel"):
        assert {"maxplus_scan", "maxplus_scan_deltas", "backtrack_batched",
                "argmax_walk"} <= set(called)


def test_one_launch_a_call_with_the_plan_at_the_c_entry(monkeypatch):
    """N=20 lanes (two lane groups) make one launch, not one a group; the C
    entry gets ``step_plan``'s ints for the card, or the caller's plan; a
    plan of another shape is refused before any launch."""
    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        counter.launches += 1

    monkeypatch.setattr(km, "on_cuda", lambda *t: True)
    monkeypatch.setattr(km, "launch", fake_launch)
    monkeypatch.setattr(km, "sm_count", lambda dev: 132)
    monkeypatch.setattr(km.maxplus_step_block, "launches", 0)
    delta, logA = (torch.as_tensor(a) for a in _fixture(20, 1000, 250, True))
    km.maxplus_step_block(delta, logA)
    assert km.maxplus_step_block.launches == 1
    plan = km.step_plan(20, 1000, 250, 132)
    ((name, args),) = calls
    assert name == "fvt_maxplus_step_block" and args[-3:] == (20, 1000, 250)
    assert list(args[4]) == [plan.lanes, plan.R, plan.C, plan.groups] == [16, 16, 8, 2]
    forced = km.step_plan(20, 1000, 250, 132, R=3)
    km.maxplus_step_block(delta, logA, plan=forced)
    assert list(calls[1][1][4]) == [16, 3, 8, 2]
    with pytest.raises(ValueError, match="the plan is for"):
        km.maxplus_step_block(delta, logA, plan=km.step_plan(16, 1000, 250, 132))
    with pytest.raises(ValueError, match="the plan is for"):
        km.maxplus_step_block(delta, logA, plan=km.step_plan(20, 1000, 256, 132))
    assert km.maxplus_step_block.launches == 2
