"""Algorithm registry, the decode entry point, timing and memory reporting.

Counterpart of ``flash_viterbi_tpu/algorithms/base.py``.  PyTorch runs
eagerly, so a decoder is a plain function on tensors; ``decode()`` uploads
the tables to an explicit device, builds the kernels, warms up, and times
one synchronized decode.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models.hmm import HMM, LogHMM, resolve_device
from ..ops import cuda as cuda_ops
from ..runtime import build as kernel_build
from ..utils.failsafe import with_redispatch

_REGISTRY: dict[str, Callable[..., "Decoder"]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def available_algorithms() -> list[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class DecodeResult:
    path: np.ndarray  # (T,) int32 hidden state path
    time_s: float  # one synchronized decode, excluding upload, build and warmup
    memory_bytes: int  # analytic peak working set (reference-style accounting)
    algorithm: str
    extra: dict = dataclasses.field(default_factory=dict)

    def reference_stdout(self) -> str:
        """The reference output protocol (``FLASH_Viterbi_multithread.c:117-124,378``)."""
        body = " ".join(str(int(s)) for s in self.path)
        return f"time: {self.time_s:.6f} \npath: [{body} ]\nmemory: {self.memory_bytes}\n"


class Decoder:
    """A configured decoder: ``fn(logA, logB, logPi, y)`` on tensors of
    one device returns the (T,) int32 path on that device; ``batch_fn``,
    where a decoder has one, the (Bs, T) paths of a (Bs, T) batch."""

    def __init__(self, name: str, fn: Callable, static: dict, memory_fn: Callable,
                 batch_fn: Callable | None = None):
        self.name = name
        self._fn = fn
        self.static = static
        self._memory_fn = memory_fn
        self.batch_fn = batch_fn

    def __call__(self, logA, logB, logPi, y) -> torch.Tensor:
        return self._fn(logA, logB, logPi, y)

    def analytic_memory(self, K: int, T: int, K_padded: int | None = None) -> int:
        """Reference-style analytic working set at logical shape (K, T).

        ``K_padded`` (the device tables' state count) lets a decoder that
        chooses by shape (``auto``) re-derive the configuration that ran,
        chosen at the padded K, while the figure stays at the logical K.
        Other decoders ignore it."""
        kw = {} if K_padded is None else {"K_padded": int(K_padded)}
        return int(self._memory_fn(K=K, T=T, **kw, **self.static))


def build(algorithm: str, **static) -> Decoder:
    if algorithm not in _REGISTRY:
        raise KeyError(f"unknown algorithm {algorithm!r}; have {available_algorithms()}")
    return _REGISTRY[algorithm](**static)


def check_observations(y, M: int) -> np.ndarray:
    """``y`` as int64 numpy; raises on a symbol outside [0, M).  Runs on
    the host before anything is uploaded: the emission-gather kernel reads
    logB rows by symbol with no bound check on the card."""
    yv = np.asarray(y, dtype=np.int64)
    if yv.size and (yv.min() < 0 or yv.max() >= M):
        bad = yv[(yv < 0) | (yv >= M)]
        raise ValueError(f"observations outside [0, {M}): {bad[:8].tolist()}")
    return yv


def upload(hmm: HMM | LogHMM, dev: torch.device, pad_to: int) -> tuple[int, LogHMM]:
    """(logical K, the log tables on ``dev`` padded to ``pad_to``)."""
    lh = hmm if isinstance(hmm, LogHMM) else hmm.log(device=dev)
    padded = LogHMM(lh.logA.to(dev), lh.logB.to(dev), lh.logPi.to(dev), lh.K)
    return lh.K, padded.padded(pad_to)


def timed(run: Callable[[], torch.Tensor], dev: torch.device, warmup: bool):
    """Build the kernels (on ``cuda``), warm up, and time one synchronized
    ``run()``: with CUDA events on the card, with ``perf_counter`` on the
    CPU.  Returns (output, seconds, kernel launches of the timed run)."""
    if dev.type == "cuda":
        kernel_build.kernels()
    if warmup:
        run()
    before = cuda_ops.launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        time_s = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = run()
        time_s = time.perf_counter() - t0
    after = cuda_ops.launch_counts()
    return out, time_s, {k: after[k] - before[k] for k in after}


def decode(
    hmm: HMM | LogHMM,
    y: np.ndarray,
    algorithm: str = "flash",
    pad_to: int = 128,
    warmup: bool = True,
    device="cuda",
    retries: int = 0,
    **static: Any,
) -> DecodeResult:
    """End-to-end decode of one observation sequence on ``device``.

    Checks the observations, computes the log tables once, uploads them,
    pads K with dead states to a multiple of ``pad_to``, builds the CUDA
    kernels (on ``cuda``), and times one synchronized decode after an
    optional warmup: with CUDA events on the card, with ``perf_counter``
    on the CPU.  ``extra`` holds the kernel launches each wrapper made
    during the timed decode.

    ``retries > 0`` issues a decode that failed with a transient error
    again on the same device, synchronising after each attempt
    (``utils.failsafe``); the default fails fast.
    """
    dev = resolve_device(device)
    dec = build(algorithm, **static)
    yv = check_observations(y, hmm.M)
    K, lh = upload(hmm, dev, pad_to)
    T = int(len(yv))
    yd = torch.as_tensor(yv, device=dev)

    def issue():
        out = dec(lh.logA, lh.logB, lh.logPi, yd)
        if retries > 0 and dev.type == "cuda":
            torch.cuda.synchronize(dev)  # an asynchronous error raises in the retried call
        return out

    def run():
        return with_redispatch(issue, retries=retries) if retries > 0 else issue()

    path, time_s, launches = timed(run, dev, warmup)
    return DecodeResult(
        path=path.cpu().numpy()[:T],
        time_s=time_s,
        memory_bytes=dec.analytic_memory(K=K, T=T, K_padded=lh.Kp),
        algorithm=algorithm,
        extra={"K": K, "K_padded": lh.Kp, "T": T, "device": str(dev),
               "launches": launches, **dec.static},
    )
