"""Batched decoding: many sequences at once on one device.

Counterpart of ``flash_viterbi_tpu/parallel/batch.py``.  ``"fused"`` stacks
the batch as lanes of the scan kernels (``fused_decode_batch``), so one
read of ``logA`` per step serves up to 16 sequences; any other registered
algorithm decodes the sequences one by one.  The multi-chip mesh path is
not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..algorithms.base import (DecodeResult, build, check_observations,
                               resolve_device, timed, upload)
from ..algorithms.fused import fused_decode_batch
from ..models.hmm import HMM, LogHMM


def decode_batch(
    hmm: HMM | LogHMM,
    ys: np.ndarray,
    algorithm: str = "fused",
    pad_to: int = 128,
    warmup: bool = True,
    device="cuda",
    mesh=None,
    **static: Any,
) -> DecodeResult:
    """Decode a (Bs, T) batch of observation sequences on ``device``.

    Timing and launch counts are taken as ``decode`` takes them;
    ``memory_bytes`` is Bs times the decoder's analytic working set at the
    logical K, and the result's ``path`` is (Bs, T).
    """
    if mesh is not None:
        raise NotImplementedError(
            "decode_batch(mesh=...) is not ported yet (ROADMAP.md, queue 1 item 15)")
    dev = resolve_device(device)
    dec = build(algorithm, **static)
    yv = check_observations(ys, hmm.M)
    if yv.ndim != 2:
        raise ValueError(f"ys must be (Bs, T), got shape {yv.shape}")
    Bs, T = yv.shape
    K, lh = upload(hmm, dev, pad_to)
    yd = torch.as_tensor(yv, device=dev)
    tables = (lh.logA, lh.logB, lh.logPi)

    if algorithm == "fused":
        def run():
            return fused_decode_batch(*tables, yd, pointers=dec.static["pointers"])
    else:
        def run():
            return torch.stack([dec(*tables, yd[b]) for b in range(Bs)])

    paths, time_s, launches = timed(run, dev, warmup)
    return DecodeResult(
        path=paths.cpu().numpy()[:, :T],
        time_s=time_s,
        memory_bytes=Bs * dec.analytic_memory(K=K, T=T),
        algorithm=f"batched:{algorithm}",
        extra={"batch": Bs, "K": K, "K_padded": lh.Kp, "T": T, "device": str(dev),
               "launches": launches, **dec.static},
    )
