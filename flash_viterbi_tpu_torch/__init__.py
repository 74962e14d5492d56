"""flash_viterbi_tpu_torch — the FLASH Viterbi decoder on PyTorch and CUDA.

A port of ``flash_viterbi_tpu`` (JAX/Pallas) that runs all 13 of its
decoders: the FLASH decoder in pointer and lean modes and in groups of
steps (``flash_long``), checkpoint and fused, the beam family
(``flash_bs``, ``beam``), the SIEVE family (``sieve_mp``, ``sieve_bs_mp``,
``sieve_bs``, ``sieve``, ``sieve_dag``), vanilla and ``auto`` (the fastest
of the FLASH family for the shape, or the leanest under a memory budget),
and batched decoding, on an NVIDIA H100 through hand-written CUDA kernels
and on the CPU through their plain PyTorch versions.  It never imports JAX
or the JAX package.

Quick start::

    from flash_viterbi_tpu_torch import decode, decode_batch, make_sparse_hmm
    hmm, y = make_sparse_hmm(K=512, M=50, T=256, prob=0.25, seed=1)
    result = decode(hmm, y, algorithm="auto", device="cuda")
    lean = decode(hmm, y, algorithm="flash", mode="lean", num_segments=8, device="cuda")
    print(result.path, result.time_s, result.memory_bytes)
    beamed = decode(hmm, y, algorithm="flash_bs", beam_width=64, device="cuda")
    sieved = decode(hmm, y, algorithm="sieve_mp", device="cuda")
    long = decode(hmm, y, algorithm="flash_long", num_segments=4, group_steps=64, device="cuda")
    batch = decode_batch(hmm, [y, y], algorithm="fused", device="cuda")
    sharded = decode_batch(hmm, [y, y], mesh=make_mesh(1, 1, 1), device="cuda")

``make_mesh`` and ``flash_decode_sharded`` (``parallel.sharded``) are
imported on first use, so importing the package loads no
``torch.distributed`` machinery and starts no process group.
"""

from .algorithms import auto as _auto  # noqa: F401
from .algorithms import beam as _beam  # noqa: F401
from .algorithms import checkpoint as _checkpoint  # noqa: F401
from .algorithms import flash as _flash  # noqa: F401
from .algorithms import flash_bs as _flash_bs  # noqa: F401
from .algorithms import fused as _fused  # noqa: F401
from .algorithms import longform as _longform  # noqa: F401
from .algorithms import sieve as _sieve  # noqa: F401
from .algorithms import sieve_bs as _sieve_bs  # noqa: F401
from .algorithms import sieve_dyn as _sieve_dyn  # noqa: F401
from .algorithms import vanilla as _vanilla  # noqa: F401
from .algorithms.base import DecodeResult, available_algorithms, build, decode
from .models.generate import make_sparse_hmm
from .models.hmm import HMM, LogHMM
from .parallel.batch import decode_batch

__version__ = "0.1.0"

_LAZY = {"make_mesh", "flash_decode_sharded"}


def __getattr__(name: str):
    if name in _LAZY:
        from .parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DecodeResult",
    "HMM",
    "LogHMM",
    "available_algorithms",
    "build",
    "decode",
    "decode_batch",
    "flash_decode_sharded",
    "make_mesh",
    "make_sparse_hmm",
]
