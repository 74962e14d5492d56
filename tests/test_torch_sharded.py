"""The port's sharded decode (``parallel/sharded.py``) against the JAX
package's, exactly, on every mesh shape of ``tests/test_sharded.py`` and
``tests/test_commtrace.py``.

Worlds of 1, 2, 4 and 8 gloo ranks are spawned once each (module-scoped,
through the port's ``launch_workers``, a ``file://`` store and
``tests/torch_sharded_worker.py``, which imports only the port); every
rank's paths are then held, tolerance 0, against JAX's
``flash_decode_sharded`` on the 8-device virtual CPU mesh and against
``flash_decode(mode="pointer")``, and every rank's collective counts
against JAX's jaxpr trace."""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.algorithms.flash import flash_decode
from flash_viterbi_tpu.parallel import commtrace as jcommtrace
from flash_viterbi_tpu.parallel import sharded as jsharded
from flash_viterbi_tpu.parallel.batch import decode_batch as jdecode_batch
from flash_viterbi_tpu_torch.parallel import multihost, sharded
from tests.torch_sharded_worker import CASES, problem, world_size

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sharded_worker.py")
WORLD_TIMEOUT_S = 240.0
PATH_CASES = sorted(n for n, c in CASES.items() if "trace" not in c)
TRACE_CASES = sorted(n for n, c in CASES.items() if "trace" in c)


@pytest.fixture(scope="module")
def world_dirs(tmp_path_factory):
    """Each world size's output directory, its ranks spawned on first use."""
    dirs = {}

    def get(n: int):
        if n not in dirs:
            d = tmp_path_factory.mktemp(f"world{n}")
            multihost.launch_workers(WORKER, n, d, timeout=WORLD_TIMEOUT_S)
            dirs[n] = d
        return dirs[n]

    return get


def _jax_tables(hmm):
    lh = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
    return jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi)


@functools.lru_cache(maxsize=None)
def _pointer_paths(problem_name: str, batch: str, segs: int) -> np.ndarray:
    """JAX's single-device ``flash_decode(mode="pointer")`` of every row of
    a case's batch, each distinct row decoded once."""
    hmm, _, ys = problem({"problem": problem_name, "batch": batch})
    tables = _jax_tables(hmm)
    done = {}
    for row in ys:
        if row.tobytes() not in done:
            done[row.tobytes()] = np.asarray(flash_decode(
                *tables, jnp.asarray(row), num_segments=segs, mode="pointer"))
    return np.stack([done[row.tobytes()] for row in ys])


@pytest.mark.parametrize("name", PATH_CASES)
def test_sharded_paths_match_jax(name, world_dirs):
    case = CASES[name]
    n = world_size(case)
    out = world_dirs(n)
    hmm, _, ys = problem(case)
    want = np.asarray(jsharded.flash_decode_sharded(
        jsharded.make_mesh(*case["shape"]), *_jax_tables(hmm), jnp.asarray(ys),
        **case["opts"]))
    np.testing.assert_array_equal(want, _pointer_paths(
        case.get("problem", "small"), case.get("batch", "repeat"),
        case["opts"]["num_segments"]))
    for r in range(n):
        got = np.load(os.path.join(out, f"{name}.rank{r}.npy"))
        assert got.dtype == np.int32 and got.shape == ys.shape
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", TRACE_CASES)
def test_commtrace_matches_jax(name, world_dirs):
    """Bytes received and issue counts per collective kind, on every rank."""
    case = CASES[name]
    out = world_dirs(world_size(case))
    want = jcommtrace.trace_sharded_decode(jsharded.make_mesh(*case["shape"]),
                                           **case["trace"])
    n_data = case["shape"][0]
    tr = case["trace"]
    for r in range(world_size(case)):
        with open(os.path.join(out, f"{name}.rank{r}.json")) as f:
            got = json.load(f)
        data = got.pop("data_gather", None)
        assert got == want, f"rank {r}"
        assert data == (None if n_data == 1 else {
            "bytes": (n_data - 1) * tr["batch"] // n_data * tr["T"] * 4, "count": 1})


def test_mesh_shape_for_matches_jax():
    for n in range(1, 13):
        assert sharded.mesh_shape_for(n) == jsharded.mesh_shape_for(n)


def test_check_plane_locality_refusal():
    """A (seq, state) plane spanning two nodes is refused unless allowed;
    a data-major layout of 2 nodes x 4 ranks keeps each plane on a node."""
    spans = np.arange(8).reshape(1, 2, 4) // 4
    with pytest.raises(ValueError, match="spans nodes"):
        multihost.check_plane_locality(spans)
    multihost.check_plane_locality(spans, allow_dcn_state=True)
    multihost.check_plane_locality(np.arange(8).reshape(2, 2, 2) // 4)


@pytest.mark.parametrize("segs", [4, None])
def test_decode_batch_mesh_matches_jax(segs):
    hmm, _, ys = problem({"problem": "medium", "batch": "distinct"})
    got = tfv.decode_batch(hmm, ys, mesh=tfv.make_mesh(1, 1, 1), num_segments=segs,
                           device="cpu", warmup=False)
    want = jdecode_batch(jfv.HMM(hmm.A, hmm.B, hmm.Pi), ys, mesh=jsharded.make_mesh(1, 1, 1),
                         num_segments=segs, warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.path.dtype == np.int32
    assert got.memory_bytes == want.memory_bytes == len(ys) * tfv.build(
        "flash", num_segments=segs or 8).analytic_memory(K=hmm.K, T=ys.shape[1])
    assert got.algorithm == want.algorithm == "batched:flash"
    assert got.extra["mesh"] == want.extra["mesh"] == {"data": 1, "seq": 1, "state": 1}
    assert all(v == 0 for v in got.extra["launches"].values())


def test_sharded_argument_checks():
    hmm, y = tfv.make_sparse_hmm(K=16, M=3, T=30, prob=0.5, seed=1)
    lh = hmm.log(device="cpu")
    ys = np.stack([y] * 4)
    mesh = sharded.make_mesh()
    with pytest.raises(TypeError, match="make_mesh"):
        tfv.decode_batch(hmm, ys, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        sharded.flash_decode_sharded(object(), lh.logA, lh.logB, lh.logPi, ys)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        sharded.make_mesh(1, 2, 1)
    with pytest.raises(ValueError, match="equal segments"):  # 30 steps, 4 segments
        sharded.flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys,
                                     num_segments=4, pipeline=True)
    with pytest.raises(ValueError, match="microbatch 3"):
        sharded.flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys,
                                     num_segments=2, microbatch=3)
    with pytest.raises(ValueError, match="logA"):
        sharded.flash_decode_sharded(mesh, lh.logA[:, :8], lh.logB, lh.logPi, ys)


def test_local_batch_slice():
    assert multihost.local_batch_slice(8, sharded.Mesh((2, 1, 1))) == slice(0, 4)
    with pytest.raises(ValueError, match="divisible"):
        multihost.local_batch_slice(7, sharded.Mesh((2, 1, 1)))
    assert multihost.initialize(world_size=1) is False


def test_launch_workers_reports_failures(tmp_path):
    """A failing worker raises with its output tail and stops the others;
    a worker that writes no ok-file raises; the timeout kills every worker."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "rank, out = int(sys.argv[2]), sys.argv[4]\n"
        "mode = os.environ['MODE']\n"
        "if mode == 'fail' and rank == 1:\n"
        "    print('rank one gives up'); sys.exit(3)\n"
        "if mode == 'fail' or mode == 'hang':\n"
        "    time.sleep(60)\n"
        "if mode == 'ok' or rank == 0:\n"
        "    open(os.path.join(out, f'ok_{rank}'), 'w').write('ok')\n")
    assert len(multihost.launch_workers(str(script), 2, tmp_path / "ok",
                                        env={"MODE": "ok"})) == 2
    with pytest.raises(RuntimeError, match="worker 1 failed \\(3\\)[^$]*rank one gives up"):
        multihost.launch_workers(str(script), 2, tmp_path / "fail", timeout=30,
                                 env={"MODE": "fail"})
    with pytest.raises(RuntimeError, match="worker 1 wrote no ok-file"):
        multihost.launch_workers(str(script), 2, tmp_path / "nook", env={"MODE": "nook"})
    with pytest.raises(RuntimeError, match="timed out"):
        multihost.launch_workers(str(script), 2, tmp_path / "hang", timeout=1,
                                 env={"MODE": "hang"})
