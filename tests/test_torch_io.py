"""The port's model files (``utils/io.py``) through its native loader and
writer (``runtime/native.py``, ``csrc/fastio.c``) against the numpy reader
and writer and against the JAX package's ``utils/io.py``, byte for byte and
value for value, on the reference's sparse and DAG file names."""

import filecmp
import os
import shutil

import numpy as np
import pytest

import flash_viterbi_tpu as jfv
import flash_viterbi_tpu_torch as tfv
from flash_viterbi_tpu.runtime import native as jnative
from flash_viterbi_tpu.utils import io as jio
from flash_viterbi_tpu_torch.models import generate as tgen
from flash_viterbi_tpu_torch.runtime import native
from flash_viterbi_tpu_torch.utils import io as tio

HAS_CC = shutil.which(os.environ.get("CC", "cc")) is not None

# (kind, problem): the reference's sparse-graph name (prob0.112) and its DAG name
PROBLEMS = [("sparse", dict(K=37, M=7, T=29, prob=0.112, seed=3)),
            ("dag", dict(K=24, M=5, T=17, seed=4))]


def _problem(kind, p):
    if kind == "dag":
        return tgen.make_dag_hmm(**p), dict(dag=True)
    return tfv.make_sparse_hmm(**p), dict(prob=p["prob"])


@pytest.mark.parametrize("kind,p", PROBLEMS, ids=[k for k, _ in PROBLEMS])
def test_native_load_equals_the_numpy_reader(kind, p, tmp_path, monkeypatch):
    (hmm, y), tag = _problem(kind, p)
    paths = tio.save_dataset(str(tmp_path), hmm, y, **tag)
    want = os.path.basename(jio.dataset_paths("d", p["K"], p["T"], **tag)["A"])
    assert os.path.basename(paths["A"]) == want
    K, T, M = p["K"], p["T"], p["M"]
    for as_float32 in (False, True):
        got, gy = tio.load_dataset(str(tmp_path), K, T, M, as_float32=as_float32, **tag)
        with monkeypatch.context() as m:
            m.setattr(native, "get_lib", lambda: None)
            ref, ry = tio.load_dataset(str(tmp_path), K, T, M, as_float32=as_float32, **tag)
        jax, jy = jio.load_dataset(str(tmp_path), K, T, M, as_float32=as_float32, **tag)
        for a, b, c in ((got.A, ref.A, jax.A), (got.B, ref.B, jax.B), (got.Pi, ref.Pi, jax.Pi)):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert gy.dtype == ry.dtype == np.int32
        np.testing.assert_array_equal(gy, ry)
        np.testing.assert_array_equal(gy, jy)
    np.testing.assert_array_equal(gy, y)


@pytest.mark.parametrize("kind,p", PROBLEMS, ids=[k for k, _ in PROBLEMS])
@pytest.mark.parametrize("port_native", [True, False], ids=["native", "numpy"])
def test_save_dataset_writes_jax_bytes(kind, p, port_native, tmp_path, monkeypatch):
    """Each writer against the JAX package's same writer: a NaN row (a
    state with no out-edge) is "-nan" from C's printf, "nan" from numpy."""
    (hmm, y), tag = _problem(kind, p)
    if not port_native:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "save_floats_native", lambda *a, **kw: False)
    port = tio.save_dataset(str(tmp_path / "port"), hmm, y, **tag)
    jax = jio.save_dataset(str(tmp_path / "jax"), jfv.HMM(hmm.A, hmm.B, hmm.Pi), y, **tag)
    assert [os.path.basename(q) for q in port.values()] == [
        os.path.basename(q) for q in jax.values()]
    for name in port:
        assert filecmp.cmp(port[name], jax[name], shallow=False), name


@pytest.mark.skipif(not HAS_CC, reason="no C compiler: utils.io reads and writes with numpy")
def test_native_path_is_taken_where_cc_exists(tmp_path, monkeypatch):
    assert native.get_lib() is not None
    assert os.path.exists(native.LIBRARY)
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            calls.append((fn.__name__, out is not None and out is not False))
            return out
        return wrapped

    for name in ("load_floats_native", "load_ints_native", "save_floats_native"):
        monkeypatch.setattr(native, name, spy(getattr(native, name)))
    monkeypatch.setattr(np, "savetxt", spy(np.savetxt))
    hmm, y = tfv.make_sparse_hmm(K=12, M=3, T=9, prob=0.5, seed=2)
    tio.save_dataset(str(tmp_path), hmm, y, prob=0.5)
    tio.load_dataset(str(tmp_path), 12, 9, 3, prob=0.5)
    # A and B by the library, Pi and ob by numpy (as the JAX package does);
    # A, B, Pi and ob read back by the library
    assert calls == [("save_floats_native", True), ("save_floats_native", True),
                     ("savetxt", False), ("savetxt", False),
                     ("load_floats_native", True), ("load_floats_native", True),
                     ("load_floats_native", True), ("load_ints_native", True)]


@pytest.mark.skipif(not HAS_CC, reason="no C compiler: utils.io reads and writes with numpy")
def test_native_writer_matches_savetxt(tmp_path):
    """Matrices as ``np.savetxt``'s ``%.16f`` rows, a vector as its one line."""
    rng = np.random.default_rng(5)
    for name, data, kw in (("m", rng.random((7, 5)), {}), ("v", rng.random(9), {"newline": " "}),
                           ("neg", -rng.random((3, 4)) * 1e6, {})):
        assert native.save_floats_native(str(tmp_path / f"{name}.c"), data)
        np.savetxt(tmp_path / f"{name}.np", data, fmt="%.16f", **kw)
        assert filecmp.cmp(tmp_path / f"{name}.c", tmp_path / f"{name}.np", shallow=False), name


def test_overflowed_tokens_and_short_files_read_alike(tmp_path, monkeypatch):
    """The reference DAG generator writes overflowed 1.8e308 tokens; both
    readers take them as inf, both stop at the file's end, and both raise
    OSError on a missing file."""
    path = tmp_path / "x.txt"
    path.write_text("0.5000000000000000 1.8e308 -0.25\n3 ")
    native_vals = tio._load_text_floats(str(path), 8)
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        numpy_vals = tio._load_text_floats(str(path), 8)
        with pytest.raises(OSError):
            tio._load_text_floats(str(tmp_path / "missing.txt"), 1)
    np.testing.assert_array_equal(numpy_vals, [0.5, np.inf, -0.25, 3.0])
    np.testing.assert_array_equal(native_vals, numpy_vals)
    with pytest.raises(OSError):
        tio._load_text_floats(str(tmp_path / "missing.txt"), 1)
