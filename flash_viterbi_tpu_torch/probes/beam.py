"""The beam-step cost probes: CUDA kernels and the plain version of the
variants that compute the beam scan.

Counterparts of ``scripts/beam_profile.py:run_variant`` (the parts of a
step switched off) and ``scripts/beam_profile2.py:run_variant`` (other
top-B selects), at their shape: one lane, B=64, K=4096, T'=255, logA and
the emission rows standard normal from numpy's seed 0, the first beam the
B best of a sorted normal draw on states 0..B-1.  The kernels are
``csrc/probe_beam.cu``: instantiations of the production beam scan's
cluster kernel (``csrc/beam_cluster.cuh``) at one lane under the cluster
size :func:`~flash_viterbi_tpu_torch.ops.cuda.beam.beam_plan` picks, each
a part switched off or another select in place of the production one; each
call returns ``codes (T', 1, B)`` int32, ``state * 256 + slot`` (the TPU
probes' output).

``full`` (the production step: row reads through the bulk-copy ring, the
fold, the cluster-wide 32-bit radix select) and ``sort`` (``beam_profile2``'s
baseline, which keeps its name for the production select and runs the same
kernel), ``pick``, ``nosmem`` and ``blockm`` (B rounds of a cluster-wide
minimum over packed 64-bit keys) compute the beam scan: their codes equal
``hist * 256 + slots`` of
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
import torch.nn.functional as F

from ..bench.harness import device_name, marginal_time
from ..models.hmm import resolve_device
from ..ops.beam import beam_scan_plain
from ..ops.cuda import beam as kbeam
from ..ops.cuda.common import SMEM_LIMIT, expect, expect_contiguous, launch, on_cuda
from ..ops.cuda.maxplus import error_word, raise_on_error, sm_count

# kernel variants, in the order of csrc/probe_beam.cu:VARIANTS
VARIANTS = ("full", "no-pick", "no-fold", "no-dma", "dma-only", "empty", "pick", "nosmem",
            "blockm", "onereduce")
# beam_profile.py's variants: port name -> its name there
PARTS = {"full": "full(dma+fold+pick)", "no-pick": "no-pick", "no-fold": "no-fold(dma+pick)",
         "no-dma": "no-dma(fold+pick)", "dma-only": "dma-only", "empty": "empty"}
# beam_profile2.py's variants: port name -> its names there ("sort", the
# production select, the cluster-wide radix select, has none; its kernel is
# "full")
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


def plan(Kp: int, Bw: int, device) -> kbeam.BeamPlan:
    """The production beam scan's one-lane plan on ``device``'s card: the
    probes run under its cluster size."""
    return kbeam._card_plan(device.index, sm_count(device), Kp, Bw, 1, 0)


def _probe_beam(counter, logA, emits, vals0, states0, variant: str, err) -> torch.Tensor:
    Tm, Kp, Bw = _check(logA, emits, vals0, states0)
    kernel = "full" if variant == "sort" else variant
    if kernel not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if not on_cuda(logA, emits, vals0, states0):
        if variant not in EXACT:
            raise ValueError(f"variant {variant!r} is cost attribution only: it runs on the "
                             f"card and has no plain version")
        return probe_beam_plain(logA, emits, vals0, states0)
    expect_contiguous(logA=logA, emits=emits, vals0=vals0, states0=states0)
    dev = emits.device
    pl = plan(Kp, Bw, dev)
    if not pl.state_smem:
        raise ValueError(f"the beam probe at K={Kp}, B={Bw} keeps a CTA's keys and beam in "
                         f"shared memory, and they need more than the {SMEM_LIMIT} bytes one "
                         f"H100 block can use")
    if kbeam._clusters(dev.index, pl) < 1:
        raise RuntimeError(f"the card cannot keep one cluster of {pl.C} CTAs with {pl.smem} "
                           f"bytes of shared memory resident")
    if pl.lda != Kp:  # bulk copies read rows of a stride of a multiple of 4 floats
        logA = F.pad(logA, (0, pl.lda - Kp))
    elif logA.data_ptr() % 16:
        logA = logA.clone()
    hist = torch.empty((Tm, 1, Bw), dtype=torch.int32, device=dev)
    slots = torch.empty_like(hist)
    own = err is None
    if own:
        err = error_word(dev)
    launch("fvt_probe_beam", counter, dev, logA.data_ptr(), emits.data_ptr(),
           vals0.data_ptr(), states0.data_ptr(), hist.data_ptr(), slots.data_ptr(),
           err.data_ptr(), pl.c_args(), Tm, Kp, Bw, VARIANTS.index(kernel))
    if own:
        raise_on_error(err, "probe_beam")
    return hist * 256 + slots


def probe_beam_parts(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
                     states0: torch.Tensor, variant: str = "full", *,
                     err: torch.Tensor | None = None) -> torch.Tensor:
    """One ``beam_profile`` variant (a key of :data:`PARTS`) over T' steps.

    Args: logA (K, K), emits (T', 1, K), vals0 (1, B) descending, float32;
    states0 (1, B) int32; B <= 256; ``err``, an error word shared by several
    calls and read by the caller (by default the call reads its own and
    raises if a ring wait timed out).  Returns codes (T', 1, B) int32.
    """
    return _probe_beam(probe_beam_parts, logA, emits, vals0, states0, variant, err)


def probe_beam_select(logA: torch.Tensor, emits: torch.Tensor, vals0: torch.Tensor,
                      states0: torch.Tensor, variant: str = "pick", *,
                      err: torch.Tensor | None = None) -> torch.Tensor:
    """One ``beam_profile2`` select (a key of :data:`SELECTS`); as
    :func:`probe_beam_parts`."""
    return _probe_beam(probe_beam_select, logA, emits, vals0, states0, variant, err)


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
    err = error_word(dev) if on_card else None
    moved, ops = work(args, probe_beam_plain(*args) if not on_card else
                      _probe_beam(fn, *args, "full", err))
    C = plan(Kp, Bw, dev).C if on_card else None
    records = []
    for variant, jax in names.items():
        if not on_card and variant not in EXACT:
            records.append({"probe": probe, "variant": variant, "jax": jax,
                            "skipped": "cost attribution only: runs on the card"})
            continue
        per = marginal_time(lambda k, v=variant: (
            lambda: [fn(*args, variant=v, err=err) for _ in range(k)][-1]))
        records.append({"probe": probe, "variant": variant, "jax": jax, "kernel": fn.__name__,
                        "device": device_name(dev), "B": Bw, "K": Kp, "Tm": Tm, "C": C,
                        "exact": variant in EXACT, "per_call_s": per, "per_step_s": per / Tm,
                        "bytes": moved, "operations": ops})
    if on_card:
        raise_on_error(err, probe)
    return records


def run_parts(device="cuda", Bw: int = B, Kp: int = K, Tm: int = TM,
              variants=None) -> list[dict]:
    """``beam_profile.py``: every variant of :data:`PARTS` (or those named
    in ``variants``), chains of 1 and 5 calls; one record each."""
    names = {v: [j] for v, j in PARTS.items() if variants is None or v in variants}
    return _run("beam_profile", probe_beam_parts, names, device, Bw, Kp, Tm)


def run_select(device="cuda", Bw: int = B, Kp: int = K, Tm: int = TM) -> list[dict]:
    """``beam_profile2.py``: every select of :data:`SELECTS`; as
    :func:`run_parts`."""
    return _run("beam_profile2", probe_beam_select, SELECTS, device, Bw, Kp, Tm)
