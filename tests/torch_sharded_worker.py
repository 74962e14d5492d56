"""One rank of the port's sharded-decode worlds (tests/test_torch_sharded.py).

    python tests/torch_sharded_worker.py <init_method> <rank> <world> <outdir>

Joins a gloo world of ``<world>`` ranks (none for a world of 1), runs
every case of ``CASES`` (with ``FVT_WORKER_CASES=fuzz`` in the environment,
of ``FUZZ_CASES``: ``tests/test_torch_fuzz.py``'s, through the public
``decode_batch``) whose mesh has that many ranks, and writes each
case's (Bs, T) paths as ``<case>.rank<r>.npy`` (commtrace cases: the
rank's collective stats as ``<case>.rank<r>.json``) into ``<outdir>``,
then ``ok_<rank>``.  Imports only the port, never JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

PROBLEMS = {"small": dict(K=64, M=12, T=32, prob=0.3, seed=7),
            "medium": dict(K=128, M=20, T=64, prob=0.2, seed=3)}


def _name(kind: str, shape, **kw) -> str:
    tags = "".join(f"-{k}{v}" for k, v in kw.items())
    return f"{kind}-{'x'.join(map(str, shape))}{tags}"


def _cases() -> dict[str, dict]:
    """Every mesh shape of tests/test_sharded.py and tests/test_commtrace.py,
    plus the legacy path; ``opts`` go to ``flash_decode_sharded``."""
    c = {}
    for shape, segs in [((2, 2, 2), 4), ((1, 2, 4), 8), ((4, 2, 1), 2),
                        ((1, 1, 8), 4), ((1, 8, 1), 8), ((1, 1, 1), 4)]:
        c[_name("auto", shape, s=segs)] = dict(shape=shape, opts=dict(num_segments=segs))
    for shape, segs, mb in [((1, 1, 1), 8, 1), ((1, 2, 1), 8, 1), ((1, 4, 1), 8, 2),
                            ((2, 2, 2), 8, 1), ((1, 2, 4), 8, 1), ((1, 8, 1), 8, 1),
                            ((1, 1, 8), 4, 4), ((1, 2, 2), 4, 2)]:
        c[_name("pipelined", shape, s=segs, mb=mb)] = dict(
            shape=shape, opts=dict(num_segments=segs, microbatch=mb, pipeline=True))
    for shape in [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2)]:
        c[_name("kernel", shape)] = dict(shape=shape, opts=dict(
            num_segments=4, microbatch=2, pipeline=True, use_kernel=True))
    for pipeline in (True, "auto"):
        c[_name("distinct", (2, 2, 2), pipeline=pipeline)] = dict(
            shape=(2, 2, 2), problem="medium", batch="distinct",
            opts=dict(num_segments=4, pipeline=pipeline))
    for shape in [(1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 4, 2)]:
        c[_name("legacy", shape)] = dict(shape=shape, opts=dict(num_segments=4,
                                                                pipeline=False))
    # 6 segments over 2 blocks of 16 steps do not divide: "auto" goes legacy
    c[_name("legacy", (1, 2, 1), s=6)] = dict(shape=(1, 2, 1), opts=dict(num_segments=6))
    for shape, batch, segs, mb in [((2, 2, 2), 8, 8, 1), ((1, 4, 2), 8, 8, 2),
                                   ((2, 1, 4), 8, 4, 1)]:
        c[_name("commtrace", shape, s=segs, mb=mb)] = dict(
            shape=shape, trace=dict(K=64, T=64, batch=batch, num_segments=segs,
                                    microbatch=mb))
    return c


CASES = _cases()

# tests/test_fuzz.py's SHARD_CASES: (K, M, T, prob, seed, mesh shape, segments)
SHARD_CASES = [(33, 4, 26, 0.5, 206, (2, 2, 2), 4),
               (56, 11, 40, 0.2, 203, (1, 2, 2), 6),
               (72, 5, 23, 0.45, 204, (2, 2, 1), 4)]
FUZZ_CASES = {_name("fuzz", shape, s=segs, seed=seed): dict(
    shape=shape, fuzz=(K, M, T, prob, seed), opts=dict(num_segments=segs))
    for K, M, T, prob, seed, shape, segs in SHARD_CASES}


def problem(case: dict):
    """(HMM, y, ys): the case's problem and its (4, T) int32 batch (a fuzz
    case's: its sequence and one more, as tests/test_fuzz.py draws them)."""
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    if "fuzz" in case:
        K, M, T, prob, seed = case["fuzz"]
        hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        rng = np.random.RandomState(seed)
        return hmm, y, np.stack([np.asarray(y, np.int32),
                                 rng.randint(0, M, size=T).astype(np.int32)])
    hmm, y = make_sparse_hmm(**PROBLEMS[case.get("problem", "small")])
    if case.get("batch", "repeat") == "repeat":
        return hmm, y, np.stack([y] * 4).astype(np.int32)
    rng = np.random.RandomState(0)
    ys = np.stack([y, rng.randint(0, hmm.M, size=len(y)), y[::-1], (y + 1) % hmm.M])
    return hmm, y, ys.astype(np.int32)


def world_size(case: dict) -> int:
    return int(np.prod(case["shape"]))


def main() -> None:
    init_method, rank, world, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch

    torch.set_num_threads(1)
    from flash_viterbi_tpu_torch.parallel import commtrace, multihost, sharded
    from flash_viterbi_tpu_torch.parallel.batch import decode_batch

    multihost.initialize(init_method, world, rank, backend="gloo")
    meshes = {}
    cases = FUZZ_CASES if os.environ.get("FVT_WORKER_CASES") == "fuzz" else CASES
    for name, case in cases.items():
        if world_size(case) != world:
            continue
        shape = case["shape"]
        if shape not in meshes:
            # the world of 2 names its axis groups' backend, the others inherit it
            meshes[shape] = sharded.make_mesh(*shape, backend="gloo" if world == 2 else None)
        mesh = meshes[shape]
        stem = os.path.join(outdir, f"{name}.rank{rank}")
        if "trace" in case:
            stats = commtrace.trace_sharded_decode(mesh, device="cpu", **case["trace"])
            with open(stem + ".json", "w") as f:
                json.dump(stats, f)
            continue
        hmm, _, ys = problem(case)
        if "fuzz" in case:  # the public mesh path, which pads K to 128
            paths = decode_batch(hmm, ys, mesh=mesh, device="cpu", warmup=False,
                                 **case["opts"]).path
        else:
            lh = hmm.log(device="cpu")
            paths = sharded.flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys,
                                                 **case["opts"]).numpy()
        np.save(stem + ".npy", paths)
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


if __name__ == "__main__":
    main()
