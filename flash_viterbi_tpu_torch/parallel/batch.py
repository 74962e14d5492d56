"""Batched decoding: many sequences at once on one device.

Counterpart of ``flash_viterbi_tpu/parallel/batch.py``.  ``"fused"`` stacks
the batch as lanes of the scan kernels (``fused_decode_batch``), so one
read of ``logA`` per step serves up to 16 sequences; a decoder with a
``batch_fn`` (``sieve_bs``: one level queue for the whole batch) takes the
batch at once; any other registered algorithm decodes the sequences one by
one.  A ``mesh`` from
``parallel.sharded.make_mesh`` routes to the multi-device FLASH decode
(``flash_decode_sharded``), which every rank of the mesh calls; as in the
JAX package, it takes no ``precision`` and decodes in fp32 whatever the
caller asks.
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
    logical K, and the result's ``path`` is (Bs, T).  With ``mesh`` the
    batch goes through ``flash_decode_sharded`` with ``num_segments`` (a
    static option, None for the mesh's default) whatever ``algorithm``
    says, and ``memory_bytes`` counts ``flash`` at ``num_segments or 8``
    segments; ``extra["launches"]`` holds this rank's launches.
    """
    if mesh is not None:
        from .sharded import Mesh, flash_decode_sharded

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must come from parallel.sharded.make_mesh, "
                            f"got {type(mesh).__name__}")
        num_segments = static.pop("num_segments", None)
        algorithm = "flash"
        dec = build("flash", num_segments=num_segments or 8, **static)
    else:
        dec = build(algorithm, **static)
    dev = resolve_device(device)
    yv = check_observations(ys, hmm.M)
    if yv.ndim != 2:
        raise ValueError(f"ys must be (Bs, T), got shape {yv.shape}")
    Bs, T = yv.shape
    K, lh = upload(hmm, dev, pad_to)
    yd = torch.as_tensor(yv, device=dev)
    tables = (lh.logA, lh.logB, lh.logPi)

    if mesh is not None:
        def run():
            return flash_decode_sharded(mesh, *tables, yd, num_segments=num_segments)
    elif algorithm == "fused":
        def run():
            return fused_decode_batch(*tables, yd, pointers=dec.static["pointers"],
                                      precision=dec.static["precision"])
    elif dec.batch_fn is not None:
        def run():
            return dec.batch_fn(*tables, yd)
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
               "mesh": None if mesh is None else dict(mesh.shape),
               "launches": launches, **dec.static},
    )
