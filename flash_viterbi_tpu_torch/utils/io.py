"""Model I/O: the reference's text file format and file names.

File names (reference ``README.md:107-114``, ``data_script.py:98-101``)::

    {data_path}/{A,B,Pi,ob}_K{K}_T{T}_prob{p}.txt      (sparse-graph HMMs)
    {data_path}/{A,B,Pi,ob}_K{K}_T{T}_DAG.txt          (DAG HMMs)

where ``T`` in the file name is the observation sequence length, not the
alphabet size M.  Files are whitespace-separated text: ``A`` and ``B`` a
matrix row a line (``%.16f``), ``Pi`` and ``ob`` one line each.
Probabilities load as float64; ``as_float32=True`` quantizes them as the C
loaders store them.  Copied from ``flash_viterbi_tpu/utils/io.py`` with its
numpy reader and writer (the JAX package's optional native parser writes
the same bytes).
"""

from __future__ import annotations

import os

import numpy as np

from ..models.hmm import HMM


def prob_str(prob: float, decimals: int | None = None) -> str:
    """Format ``prob`` the way the reference's run.py patches it
    (``src/run.py:39-47``): the number of decimals of the Python literal."""
    if decimals is None:
        s = repr(float(prob))
        decimals = len(s.split(".")[1]) if "." in s else 0
    return f"{prob:.{decimals}f}"


def dataset_paths(data_path: str, K: int, T: int, prob: float | None = None,
                  dag: bool = False, prob_decimals: int | None = None) -> dict:
    tag = "DAG" if dag else f"prob{prob_str(prob, prob_decimals)}"
    return {
        name: os.path.join(data_path, f"{name}_K{K}_T{T}_{tag}.txt")
        for name in ("A", "B", "Pi", "ob")
    }


def save_dataset(data_path: str, hmm: HMM, y: np.ndarray, T: int | None = None,
                 prob: float | None = None, dag: bool = False,
                 prob_decimals: int | None = None) -> dict:
    """Write the four text files as the reference generator does
    (``data_script.py:98-101``: ``%.16f`` matrices, ``%d`` observations,
    one-line Pi and ob with a trailing separator); returns their paths."""
    os.makedirs(data_path, exist_ok=True)
    T = int(len(y) if T is None else T)
    paths = dataset_paths(data_path, hmm.K, T, prob, dag, prob_decimals)
    np.savetxt(paths["A"], hmm.A, fmt="%.16f")
    np.savetxt(paths["B"], hmm.B, fmt="%.16f")
    np.savetxt(paths["Pi"], hmm.Pi, fmt="%.16f", newline=" ")
    np.savetxt(paths["ob"], np.asarray(y, dtype=np.int64), fmt="%d", newline=" ")
    return paths


def _load_text_floats(path: str, count: int) -> np.ndarray:
    # split-parse: np.fromfile(sep=" ") stops at the reference DAG
    # generator's overflowed 1.8e308 tokens (data_script_dag.py:54)
    with open(path) as f:
        toks = f.read().split()
    return np.array(toks[:count], dtype=np.float64)


def load_dataset(data_path: str, K: int, T: int, M: int,
                 prob: float | None = None, dag: bool = False,
                 prob_decimals: int | None = None,
                 as_float32: bool = False) -> tuple[HMM, np.ndarray]:
    """Load ``(HMM, observations)`` from the reference text format."""
    paths = dataset_paths(data_path, K, T, prob, dag, prob_decimals)
    A = _load_text_floats(paths["A"], K * K).reshape(K, K)
    B = _load_text_floats(paths["B"], K * M).reshape(K, M)
    Pi = _load_text_floats(paths["Pi"], K)
    y = np.fromfile(paths["ob"], dtype=np.int64, count=T, sep=" ").astype(np.int32)
    if as_float32:
        A, B, Pi = (x.astype(np.float32).astype(np.float64) for x in (A, B, Pi))
    return HMM(A=A, B=B, Pi=Pi), y
