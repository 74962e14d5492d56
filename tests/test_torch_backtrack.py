"""The port's backward-walk plain versions against the JAX package's
Pallas functions (interpret mode), exactly: the pointer backtrack over
several chunks with a ragged tail, and the recompute-argmax walk on each of
the TPU kernel's routes, with and without the valid mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_viterbi_tpu.ops.pallas import backtrack as pb
from flash_viterbi_tpu_torch.ops import cuda as tk
from flash_viterbi_tpu_torch.ops.cuda import backtrack as tkb

torch.set_num_threads(2)


@pytest.mark.parametrize("chunk_bytes", [None, 1])  # 1: chunks of 8 rows
@pytest.mark.parametrize("N,Tm", [(1, 13), (4, 21)])
def test_backtrack_plain_matches_pallas(N, Tm, chunk_bytes, monkeypatch):
    K = 128
    rng = np.random.default_rng(N * 100 + Tm)
    ptrs = rng.integers(0, K, (Tm, N, K)).astype(np.int32)
    last = rng.integers(0, K, N).astype(np.int32)
    if chunk_bytes is not None:
        monkeypatch.setattr(pb, "_CHUNK_BYTES", chunk_bytes)
        assert pb._pick_chunk(Tm, N, K) == 8
    want = pb.backtrack_pallas_batched(jnp.asarray(ptrs), jnp.asarray(last),
                                       interpret=True)
    got = tkb.backtrack_batched_plain(torch.from_numpy(ptrs), torch.from_numpy(last))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wrapped = tk.backtrack_batched(torch.from_numpy(ptrs), torch.from_numpy(last))
    assert torch.equal(wrapped, got)


def test_backtrack_out_of_range_last():
    """The plain version writes -1 past an out-of-range state, as the TPU
    kernel does; the CPU wrapper refuses such a state outright."""
    K, N, Tm = 128, 2, 9
    rng = np.random.default_rng(0)
    ptrs = rng.integers(0, K, (Tm, N, K)).astype(np.int32)
    last = np.array([3, K + 5], np.int32)
    want = pb.backtrack_pallas_batched(jnp.asarray(ptrs), jnp.asarray(last),
                                       interpret=True)
    got = tkb.backtrack_batched_plain(torch.from_numpy(ptrs), torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1, :Tm] == -1).all()
    with pytest.raises(ValueError, match="outside"):
        tk.backtrack_batched(torch.from_numpy(ptrs), torch.from_numpy(last))
    with pytest.raises(ValueError, match="outside"):
        tk.argmax_walk(torch.zeros((Tm, N, K)), torch.zeros((K, K)),
                       torch.from_numpy(last))


def _walk_inputs(kind, Tm, N, K, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        deltas = np.round(rng.standard_normal((Tm, N, K)))
        logAT = np.round(rng.standard_normal((K, K)) * 2) / 2
        logAT[:, 7] = -np.inf
        logAT[9] = -np.inf  # a dead state's column: every candidate is -inf
    else:
        deltas = rng.standard_normal((Tm, N, K))
        logAT = rng.standard_normal((K, K))
    last = rng.integers(0, K, N).astype(np.int32)
    last[0] = 9 if K > 9 else 0
    valid = rng.random((Tm, N)) < 0.7
    return deltas.astype(np.float32), logAT.astype(np.float32), last, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route,Tm,N,K,kind", [
    ("resident_small", 13, 3, 256, "ties"),   # 1 chunk of 8 + a 5-row tail
    ("resident_small", 8, 6, 128, "random"),
    ("resident_mm", 11, 17, 128, "ties"),     # N > 16: one-hot matmul route
    ("dma", 11, 2, 2048, "random"),           # K > 1024: per-row DMA route
    ("tail_only", 5, 4, 128, "ties"),         # T' < 8: the XLA tail alone
    ("tail_only", 6, 3, 1001, "ties"),        # K % 4 != 0: the CUDA walk's scalar tail
    ("resident_mm", 9, 64, 128, "random"),    # 64 lanes: 64 blocks on the card
])
def test_argmax_walk_plain_matches_pallas(route, Tm, N, K, kind, masked):
    deltas, logAT, last, valid = _walk_inputs(kind, Tm, N, K, seed=Tm * N)
    v = valid if masked else None
    want = pb.argmax_walk_pallas(
        jnp.asarray(deltas), jnp.asarray(logAT), jnp.asarray(last),
        valid=None if v is None else jnp.asarray(v), interpret=True)
    args = (torch.from_numpy(deltas), torch.from_numpy(logAT), torch.from_numpy(last),
            None if v is None else torch.from_numpy(v))
    got = tkb.argmax_walk_plain(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tk.argmax_walk(*args), got)


def test_walks_with_zero_rows_return_last():
    last = torch.tensor([2, 0], dtype=torch.int32)
    out = tk.argmax_walk(torch.zeros((0, 2, 4)), torch.zeros((4, 4)), last)
    assert out.tolist() == [[2], [0]]
    out = tk.backtrack_batched(torch.zeros((0, 2, 4), dtype=torch.int32), last)
    assert out.tolist() == [[2], [0]]


def test_argmax_walk_cuda_branch_passes_its_error_word(monkeypatch):
    """Spied on the CPU: one launch a call on contiguous inputs with the
    call's own error word, read at once (a timed-out wait raises); with a
    caller's word the wrapper leaves the read to the caller."""
    import ctypes

    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    calls = []

    def fake_launch(fn_name, counter, device, *args):
        calls.append((fn_name, args))
        ctypes.c_int.from_address(args[5]).value = 1  # a timed-out wait
        counter.launches += 1

    monkeypatch.setattr(tkb, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tkb, "launch", fake_launch)
    deltas, logAT, last, valid = (torch.from_numpy(x) for x in
                                  _walk_inputs("ties", 5, 3, 1001, seed=4))
    tk.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        tk.argmax_walk(deltas, logAT.t(), last)
    with pytest.raises(RuntimeError, match="argmax_walk: a grid barrier or a copy barrier"):
        tk.argmax_walk(deltas, logAT, last, valid)
    err = km.error_word("cpu")
    tk.argmax_walk(deltas, logAT, last, err=err)
    assert [c[0] for c in calls] == ["fvt_argmax_walk"] * 2
    (_, a1), (_, a2) = calls
    assert a1[0] == deltas.data_ptr() and a1[1] == logAT.data_ptr()
    assert a1[3] is not None and a2[3] is None  # the valid mask, when given
    assert a2[5] == err.data_ptr() and int(err[0]) == 1
    assert a1[-3:] == a2[-3:] == (5, 3, 1001)
    assert tk.launch_counts()["argmax_walk"] == 2
