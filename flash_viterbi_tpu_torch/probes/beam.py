"""The beam-step cost probes: CUDA kernels and the plain version of the
variants that compute the beam scan.

Counterparts of ``scripts/beam_profile.py:run_variant`` (the parts of a
step switched off) and ``scripts/beam_profile2.py:run_variant`` (other
top-B selects), at their shape: one lane, B=64, K=4096, T'=255, logA and
the emission rows standard normal from numpy's seed 0, the first beam the
B best of a sorted normal draw on states 0..B-1.  The kernels are
``csrc/probe_beam.cu``, copies of ``csrc/beam_scan.cu``'s kernel; each
call writes ``codes (T', 1, B)`` int32, ``state * 256 + slot`` (the TPU
probes' output).

``full`` (the production step: row reads, fold, bitonic sort; also
``beam_profile2``'s baseline ``sort``), ``pick``, ``nosmem`` and ``blockm``
compute the beam scan: their codes equal ``hist * 256 + slots`` of
:func:`~flash_viterbi_tpu_torch.ops.beam.beam_scan_plain` and of the
production ``beam_scan`` bit for bit.  ``onereduce`` and the switched-off
variants (``no-pick``, ``no-fold``, ``no-dma``, ``dma-only``, ``empty``)
are cost attribution only, as ``beam_profile2.py:12-13`` says of its
``onereduce``: they are timed and never compared, and they have no plain
version, so they run only on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench.harness import device_name, marginal_time
from ..models.hmm import resolve_device
from ..ops.beam import beam_scan_plain
from ..ops.cuda.beam import SMEM_LIMIT
from ..ops.cuda.common import expect, expect_contiguous, launch, on_cuda
from ..runtime import build

# kernel variants, in the order of csrc/probe_beam.cu:VARIANTS
VARIANTS = ("full", "no-pick", "no-fold", "no-dma", "dma-only", "empty", "pick", "nosmem",
            "blockm", "onereduce")
# beam_profile.py's variants: port name -> its name there
PARTS = {"full": "full(dma+fold+pick)", "no-pick": "no-pick", "no-fold": "no-fold(dma+pick)",
         "no-dma": "no-dma(fold+pick)", "dma-only": "dma-only", "empty": "empty"}
# beam_profile2.py's variants: port name -> its names there ("sort", the
# production select, has none; its kernel is "full")
SELECTS = {"sort": [], "pick": ["prod", "packed"], "nosmem": ["nosmem"],
           "blockm": ["blockm"], "onereduce": ["onereduce"]}
EXACT = ("full", "sort", "pick", "nosmem", "blockm")
B, K, TM = 64, 4096, 255  # the TPU probes' shape


def _check(logA, emits, vals0, states0) -> tuple[int, int, int]:
    if emits.dim() != 3 or vals0.dim() != 2:
        raise ValueError(f"emits must be (T', 1, K) and vals0 (1, B), got "
                         f"{tuple(emits.shape)} and {tuple(vals0.shape)}")
    Tm, _, Kp = emits.shape
    Bw = vals0.shape[1]
    if Tm < 1 or not 1 <= Bw <= min(Kp, 256):
        raise ValueError(f"need T' >= 1 and 1 <= B <= min(K, 256), got T'={Tm}, B={Bw}, K={Kp}")
    expect("logA", logA, torch.float32, (Kp, Kp))
    expect("emits", emits, torch.float32, (Tm, 1, Kp))
    expect("vals0", vals0, torch.float32, (1, Bw))
    expect("states0", states0, torch.int32, (1, Bw))
    return Tm, Kp, Bw


def probe_beam_plain(logA, emits, vals0, states0) -> torch.Tensor:
    """The codes ``hist * 256 + slots`` of the one-lane beam scan."""
    hist, slots, _ = beam_scan_plain(logA, emits, vals0, states0)
    return hist * 256 + slots


def _probe_beam(counter, logA, emits, vals0, states0, variant: str) -> torch.Tensor:
    Tm, Kp, Bw = _check(logA, emits, vals0, states0)
    kernel = "full" if variant == "sort" else variant
    if kernel not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if not on_cuda(logA, emits, vals0, states0):
        if variant not in EXACT:
            raise ValueError(f"variant {variant!r} is cost attribution only: it runs on the "
                             f"card and has no plain version")
        return probe_beam_plain(logA, emits, vals0, states0)
    need = build.kernels().fvt_probe_beam_smem(Kp, Bw)
    if need > SMEM_LIMIT:
        raise ValueError(f"the beam probe at K={Kp}, B={Bw} needs {need} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} one H100 block can use")
    expect_contiguous(logA=logA, emits=emits, vals0=vals0, states0=states0)
    codes = torch.empty((Tm, 1, Bw), dtype=torch.int32, device=emits.device)
    launch("fvt_probe_beam", counter, emits.device, logA.data_ptr(), emits.data_ptr(),
           vals0.data_ptr(), states0.data_ptr(), codes.data_ptr(), Tm, Kp, Bw,
           VARIANTS.index(kernel))
    return codes


def probe_beam_parts(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
                     states0: torch.Tensor, variant: str = "full") -> torch.Tensor:
    """One ``beam_profile`` variant (a key of :data:`PARTS`) over T' steps.

    Args: logA (K, K), emits (T', 1, K), vals0 (1, B) descending, float32;
    states0 (1, B) int32; B <= 256.  Returns codes (T', 1, B) int32.
    """
    return _probe_beam(probe_beam_parts, logA, emits, vals0, states0, variant)


def probe_beam_select(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
                      states0: torch.Tensor, variant: str = "pick") -> torch.Tensor:
    """One ``beam_profile2`` select (a key of :data:`SELECTS`); as
    :func:`probe_beam_parts`."""
    return _probe_beam(probe_beam_select, logA, emits, vals0, states0, variant)


probe_beam_parts.launches = 0
probe_beam_select.launches = 0


def inputs(Bw: int = B, Kp: int = K, Tm: int = TM, device="cuda", seed: int = 0):
    """``run_variant``'s inputs: logA (K, K), emits (T', 1, K), vals0
    (1, B) descending, float32; states0 (1, B) = 0..B-1."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    logA = rng.standard_normal((Kp, Kp)).astype(np.float32)
    emits = rng.standard_normal((Tm, 1, Kp)).astype(np.float32)
    vals0 = np.sort(rng.standard_normal(Bw))[::-1].astype(np.float32)[None]
    states0 = np.arange(Bw, dtype=np.int32)[None]
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (logA, emits, vals0, states0))


def work(args, codes: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of the beam scan on ``args``: the distinct logA
    rows its beams fold (each once, from the production codes), the
    emission rows, the first beam and the codes; an add and a compare per
    (step, slot, column) and a select of K."""
    logA, emits, vals0, states0 = args
    Tm, _, Kp = emits.shape
    Bw = vals0.shape[1]
    beams = torch.cat([states0, codes[:-1, 0] // 256])  # the beam each step folds
    rows = int(torch.unique(beams).numel())
    return (rows + Tm) * Kp * 4 + (vals0.numel() + states0.numel() + codes.numel()) * 4, \
        Tm * (2 * Bw * Kp + Kp)


def _run(probe: str, fn, names: dict, device, Bw: int, Kp: int, Tm: int) -> list[dict]:
    args = inputs(Bw, Kp, Tm, device)
    dev = args[0].device
    on_card = dev.type == "cuda"
    moved, ops = work(args, probe_beam_plain(*args) if not on_card else
                      _probe_beam(fn, *args, "full"))
    records = []
    for variant, jax in names.items():
        if not on_card and variant not in EXACT:
            records.append({"probe": probe, "variant": variant, "jax": jax,
                            "skipped": "cost attribution only: runs on the card"})
            continue
        per = marginal_time(lambda k, v=variant: (
            lambda: [fn(*args, variant=v) for _ in range(k)][-1]))
        records.append({"probe": probe, "variant": variant, "jax": jax, "kernel": fn.__name__,
                        "device": device_name(dev), "B": Bw, "K": Kp, "Tm": Tm,
                        "exact": variant in EXACT, "per_call_s": per, "per_step_s": per / Tm,
                        "bytes": moved, "operations": ops})
    return records


def run_parts(device="cuda", Bw: int = B, Kp: int = K, Tm: int = TM) -> list[dict]:
    """``beam_profile.py``: every variant of :data:`PARTS`, chains of 1
    and 5 calls; one record each."""
    return _run("beam_profile", probe_beam_parts, {v: [j] for v, j in PARTS.items()},
                device, Bw, Kp, Tm)


def run_select(device="cuda", Bw: int = B, Kp: int = K, Tm: int = TM) -> list[dict]:
    """``beam_profile2.py``: every select of :data:`SELECTS`; as
    :func:`run_parts`."""
    return _run("beam_profile2", probe_beam_select, SELECTS, device, Bw, Kp, Tm)
