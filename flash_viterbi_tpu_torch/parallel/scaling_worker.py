"""One rank of ``scaling.measure_virtual``'s worlds.

    python flash_viterbi_tpu_torch/parallel/scaling_worker.py <init_method> <rank> <world> <outdir>

``multihost.launch_workers`` starts it once a rank, with the job as JSON
in ``FVT_SCALING_JOB`` (mesh shape, problem, batch, segment count,
device).  The rank joins a gloo world (none for a world of 1), makes the
seeded problem, runs ``flash_decode_sharded`` on the job's device (the
card: ``cuda:0`` for every rank) and writes its (batch, T) paths as
``paths.rank<r>.npy`` into ``<outdir>``, then ``ok_<rank>``.
"""

from __future__ import annotations

import json
import os
import sys

if __name__ == "__main__":
    # run by path: drop this package directory from the import path, so its
    # modules are imported only under their package names
    sys.path.pop(0)

import numpy as np


def main(init_method: str, rank: str, world: str, outdir: str) -> None:
    import torch

    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
    from flash_viterbi_tpu_torch.parallel import multihost, scaling, sharded

    job = json.loads(os.environ[scaling.JOB_ENV])
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = torch.device("cuda", 0) if job["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(init_method, world, rank, backend="gloo")
    mesh = sharded.make_mesh(*job["shape"])
    hmm, y = make_sparse_hmm(K=job["K"], M=job["M"], T=job["T"], prob=job["prob"],
                             seed=job["seed"])
    lh = hmm.log(device=device)
    ys = np.stack([np.asarray(y, np.int32)] * job["batch"])
    paths = sharded.flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys,
                                         num_segments=job["segments"])
    np.save(os.path.join(outdir, f"paths.rank{rank}.npy"), paths.cpu().numpy())
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


if __name__ == "__main__":
    main(*sys.argv[1:])
