"""Multi-process runtime: ``torch.distributed`` init, a local launcher, and
node-aware meshes.

Counterpart of ``flash_viterbi_tpu/parallel/multihost.py``, with JAX's
"process" read as "node" (one host): in PyTorch every rank is a process.
The mesh layout contract is JAX's:

* ``state``: two K-vector all_gathers per trellis step; must never cross
  a node boundary.
* ``seq``: one (mb, K) carry hop per pipeline block plus the final path
  sum; tolerates the inter-node network, prefers the node's links.
* ``data``: no traffic until the final gather; the axis that should span
  nodes.

Ranks are numbered node by node (``LOCAL_WORLD_SIZE`` ranks a node, the
``torchrun`` convention) and meshes are data-major, so every (seq, state)
plane stays on one node whenever ``n_seq * n_state`` divides the ranks of
a node; :func:`make_global_mesh` checks it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> bool:
    """Join the ``torch.distributed`` world; returns True if multi-process.

    A no-op (False) for a single process, so callers can use it
    unconditionally.  Arguments left out are read from the environment
    (``WORLD_SIZE``, ``RANK`` and ``env://``, as ``torchrun`` sets them).
    ``backend`` defaults to NCCL where CUDA is available (one GPU a rank),
    else gloo.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return False
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ["RANK"])
        dist.init_process_group(
            backend or ("nccl" if torch.cuda.is_available() else "gloo"),
            init_method=init_method or "env://", world_size=world_size, rank=rank)
    return True


def shutdown() -> None:
    """Leave the world: a barrier, then destroy the process group, so no
    rank exits while its peers' collectives or gloo's threads still run."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def launch_workers(worker: str, n: int, outdir, timeout: float = 240.0,
                   env: dict | None = None) -> list[str]:
    """Run ``n`` copies of the ``worker`` script as the ranks of one world.

    Each gets argv ``init_method rank n outdir``, where ``init_method`` is a
    ``file://`` store in ``outdir`` (no ports to race for), and the
    environment plus ``env``, with the checkout on ``PYTHONPATH`` and gloo
    on the loopback interface.  Every worker must exit 0 and write
    ``ok_<rank>`` into ``outdir``; otherwise this raises with that
    worker's output tail.  A failed worker, or the ``timeout``, kills the
    rest.  Returns each worker's output (also kept in
    ``outdir/worker_<rank>.log``).
    """
    outdir = os.path.abspath(str(outdir))
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(outdir, "store")
    if os.path.exists(store):
        os.remove(store)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = repo + os.pathsep + child_env.get("PYTHONPATH", "")
    child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    child_env.update(env or {})
    logs = [os.path.join(outdir, f"worker_{r}.log") for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, worker, "file://" + store, str(r), str(n), outdir],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))

    def tail(r: int, nbytes: int = 3000) -> str:
        with open(logs[r], errors="replace") as f:
            return f.read()[-nbytes:]

    deadline = time.monotonic() + timeout
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"workers timed out after {timeout} s; worker 0:\n{tail(0)}")
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is not None:
        raise RuntimeError(f"worker {failed} failed ({procs[failed].returncode}):\n"
                           f"{tail(failed)}")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"worker {r} failed ({p.returncode}):\n{tail(r)}")
        if not os.path.exists(os.path.join(outdir, f"ok_{r}")):
            raise RuntimeError(f"worker {r} wrote no ok-file:\n{tail(r, 2000)}")
    return [tail(r, 1 << 30) for r in range(n)]


def make_global_mesh(n_data: int | None = None, n_seq: int = 1, n_state: int = 1,
                     allow_dcn_state: bool = False) -> Mesh:
    """(data, seq, state) mesh over every rank of the world, data-major.

    ``n_data`` defaults to the world size over ``n_seq * n_state``.  With
    more than one node, every (seq, state) plane must lie on one node
    (:func:`check_plane_locality`) unless ``allow_dcn_state``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    inner = n_seq * n_state
    if n_data is None:
        if world % inner:
            raise ValueError(f"{world} ranks not divisible by seq*state={inner}")
        n_data = world // inner
    if n_data * inner != world:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_state} != {world} ranks")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = np.arange(world).reshape(n_data, n_seq, n_state) // per_node
    if nodes.max() > 0:
        check_plane_locality(nodes, allow_dcn_state=allow_dcn_state)
    return make_mesh(n_data, n_seq, n_state)


def check_plane_locality(node_of, allow_dcn_state: bool = False) -> None:
    """Raise unless every (seq, state) plane of a (data, seq, state) array
    of node indices lies on one node (the module docstring's layout
    contract).  A pure function of the array, so the CPU tier can test the
    refusal without a process group."""
    if allow_dcn_state:
        return
    node_of = np.asarray(node_of)
    for d in range(node_of.shape[0]):
        nodes = sorted({int(x) for x in node_of[d].ravel()})
        if len(nodes) > 1:
            raise ValueError(
                f"(seq, state) plane {d} spans nodes {nodes}: per-step state "
                "collectives would cross the inter-node network (DCN).  Shrink "
                "seq*state to the ranks of one node or pass allow_dcn_state=True.")


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """Rows of the global (Bs, T) batch this rank decodes: its slice of the
    data axis."""
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the data axis "
            f"{n} (pad the batch); remainder rows would be silently dropped")
    per = global_batch // n
    d = mesh.coords[0]
    return slice(d * per, (d + 1) * per)
