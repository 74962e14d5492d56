"""Run-time collective counter of the sharded decode.

Counterpart of ``flash_viterbi_tpu/parallel/commtrace.py``.  JAX walks the
jaxpr of its ``shard_map`` program; PyTorch runs eagerly, so the port
counts at run time instead.  Inside :func:`counting`, the collective
helpers of ``parallel.sharded`` record, per kind, the bytes this rank
receives and the number of issues, under JAX's convention:

* ``all_gather`` over an axis of size n: operand bytes x (n - 1) (each
  rank already holds its own shard);
* ``ppermute``: operand bytes (one buffer in per hop);
* ``psum`` (all_reduce): operand bytes x ceil(log2 n).

A collective over an axis of size 1 is neither issued nor counted, as in
JAX's program.  The final gather over ``data`` that hands every rank the
whole batch (JAX's ``out_specs`` assembles the global array outside the
traced program) is counted under its own kind, ``data_gather``, so the
three JAX kinds stay comparable.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_stats: dict | None = None


def record(kind: str, operand_bytes: int, n: int) -> None:
    """Count one collective of ``kind`` over an axis of size ``n`` > 1."""
    if _stats is None:
        return
    if kind == "psum":
        received = operand_bytes * math.ceil(math.log2(n))
    elif kind == "ppermute":
        received = operand_bytes
    else:  # all_gather, data_gather
        received = operand_bytes * (n - 1)
    entry = _stats.setdefault(kind, {"bytes": 0.0, "count": 0})
    entry["bytes"] += received
    entry["count"] += 1


@contextlib.contextmanager
def counting():
    """Collect ``{kind: {"bytes": float, "count": int}}`` for the block."""
    global _stats
    outer, _stats = _stats, {}
    try:
        yield _stats
    finally:
        _stats = outer


def trace_sharded_decode(mesh, K: int, T: int, batch: int, num_segments: int,
                         microbatch: int = 1, M: int = 8, seed: int = 7,
                         device="cuda") -> dict:
    """Run one pipelined sharded decode on ``mesh``, with the tables on
    ``device``, and return this rank's collective stats (every rank of the
    mesh must call it)."""
    from ..models.generate import make_sparse_hmm
    from .sharded import flash_decode_sharded

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=0.3, seed=seed)
    lh = hmm.log(device=device)
    ys = torch.as_tensor(np.stack([y] * batch))
    with counting() as stats:
        flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys,
                             num_segments=num_segments, microbatch=microbatch,
                             pipeline=True)
    return {k: dict(v) for k, v in stats.items()}
