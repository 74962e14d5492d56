"""The scan-ablation probe: the production persistent scan with parts of a
step cut, so that a step's time splits into its parts.

Counterpart of ``scripts/vpu_probe.py:ablation`` (``_abl_kernel``) and the
shapes of its ``main()``, with the two scans of the headline decode beside
them.  The kernel is ``scan_persistent`` of ``csrc/maxplus_scan.cu``
(entry ``fvt_maxplus_scan_deltas_ablation``): the deltas scan's production
instance (``EMIT_ROWS``) at one lane or at groups of 16, with the
template's ``PARTS`` cut as each variant of :data:`VARIANTS` says, one
cooperative launch a call under the card's plan
(``ops/cuda/maxplus.py:scan_plan``).  An N of 2 to 15 runs as one group of
16 with N live lanes (the production scan would group them at their power
of two).  Where the production deltas scan takes the ring route (K=16384 at
16 lanes: ``scan_plan(..., deltas=True)``), the probe still times the
resident route's instance.

==================  ========================================  ====================
variant             what runs                                 held to
==================  ========================================  ====================
``full``            the production deltas scan                dfin, deltas bit-exact
``no-hist``         the history write cut                     dfin bit-exact
``all-streamed``    ``full`` under the plan with no row in    dfin, deltas bit-exact
                    shared memory: every row streamed a step
``no-stream``       the streamed rows' loads cut: the rows    timing only
                    prefetched once a pass fold in their place
``no-fold``         each loaded value into the partials by    timing only
                    one max: no carry read, no add+max
``no-combine``      no partial written or combined: the       timing only
                    carry stays the first one
``barrier-only``    the step loop's grid barriers alone       timing only
==================  ========================================  ====================

The timing-only variants have no plain version: on the CPU they raise.
:func:`split` reads a step's parts from one shape's times: its fixed cost
(``barrier-only``), the combine (``full`` - ``no-combine``), the streamed
rows (``full`` - ``no-stream``, with their rate), the fold (``full`` -
``no-fold``) and the history (``full`` - ``no-hist``).

How the TPU probe's variants map onto plans the kernel takes:

- ``phaseA_baseline``, ``phaseA_N32`` and ``b64_shape_K4096`` are ``full``
  at their shapes, ``phaseA_no_hist`` is ``no-hist``.
- ``BK`` and ``BI`` shape the TPU kernel's (BK, BI) logA tiles, which
  stream all of logA every step whatever their shape.  The card's tiles
  are its plan's, so the nearest run of every ``phaseA_BK*`` variant and
  of ``b64_K4096_BK512`` is ``all-streamed``.  A plan with one source range
  (R=1, the TPU's sequential walk over source tiles) would leave 100 of
  the 132 SMs idle at 16 lanes and time the idle SMs, not a tile shape.
- ``transpose`` has no counterpart: the carry is staged lane-minor and read
  as a broadcast, never transposed, so ``phaseA_no_transpose`` has no run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import bounds
from ..bench.harness import device_name, queued_ms
from ..models.hmm import resolve_device
from ..ops.cuda.common import expect_contiguous, on_cuda
from ..ops.cuda.maxplus import (LANES_MAX, ScanPlan, _check, error_word, launch_scan,
                                maxplus_scan_deltas_plain, raise_on_error, scan_plan, sm_count,
                                streamed_bytes)

# kernel variants, in the order of csrc/maxplus_scan.cu:ABLATION
VARIANTS = ("full", "no-hist", "all-streamed", "no-stream", "no-fold", "no-combine",
            "barrier-only")
EXACT = ("full", "no-hist", "all-streamed")
# shape name -> (K, N, Tm): vpu_probe.py's main(), and the headline decode's
# scans (K=3965 padded to 3968): flash's phase 1 and its 16 segment lanes
SHAPES = {"phaseA": (16384, 16, 32), "phaseA_N32": (16384, 32, 16),
          "b64_shape_K4096": (4096, 64, 64), "headline_N1": (3968, 1, 255),
          "headline_N16": (3968, 16, 16)}
# (shape, variant) -> the vpu_probe.py variants it stands for
JAX_NAMES = {
    ("phaseA", "full"): ["phaseA_baseline"],
    ("phaseA", "no-hist"): ["phaseA_no_hist"],
    ("phaseA", "all-streamed"): ["phaseA_BK256", "phaseA_BK512_BI2048", "phaseA_BK512_BI4096",
                                 "phaseA_BK1024_BI2048", "phaseA_BK256_BI8192"],
    ("phaseA_N32", "full"): ["phaseA_N32"],
    ("b64_shape_K4096", "full"): ["b64_shape_K4096"],
    ("b64_shape_K4096", "all-streamed"): ["b64_K4096_BK512"],
}
NO_RUN = {"phaseA_no_transpose": "the carry is never transposed: no counterpart"}
CHAIN = 5  # calls a timed chain, queued behind a sleep of the card


def all_streamed(plan: ScanPlan) -> ScanPlan:
    """``plan`` with no tile row in shared memory: every row streamed every
    step, the carry's passes unchanged."""
    return plan._replace(rows_smem=0, rows_streamed=plan.rows_smem + plan.rows_streamed,
                         smem=plan.smem - plan.rows_smem * plan.stride * 4)


def ablation_plan(K: int, N: int, sm_count: int, variant: str = "full") -> ScanPlan:
    """The plan a variant runs under on ``sm_count`` SMs: the production
    plan of one lane or of 16 lanes a group, all streamed for
    ``all-streamed``."""
    plan = scan_plan(K, 1 if N == 1 else LANES_MAX, sm_count)
    return all_streamed(plan) if variant == "all-streamed" else plan


def _variant(variant: str, on_card: bool) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    if not on_card and variant not in EXACT:
        raise ValueError(f"variant {variant!r} is cost attribution only: it runs on the card "
                         f"and has no plain version")


def probe_scan_ablation_plain(logA, emits, delta0, variant: str = "full"):
    """Plain version of :func:`probe_scan_ablation` for the variants of
    :data:`EXACT`: (dfin, deltas) of ``maxplus_scan_deltas_plain``, deltas
    None for ``no-hist``."""
    _variant(variant, on_card=False)
    dfin, deltas = maxplus_scan_deltas_plain(logA, emits, delta0)
    return dfin, None if variant == "no-hist" else deltas


def probe_scan_ablation(logA: torch.Tensor, emits: torch.Tensor, delta0: torch.Tensor,
                        variant: str = "full", *, err: torch.Tensor | None = None):
    """One variant of :data:`VARIANTS` of the deltas scan
    (``maxplus_scan_deltas``'s layouts: logA (K, K), emits (T', N, K),
    delta0 (N, K), float32; T' >= 1).

    Returns (dfin (N, K), deltas (T', N, K), None for ``no-hist``),
    bit-identical to :func:`probe_scan_ablation_plain` for the variants of
    :data:`EXACT` and undefined for the others, which raise on the CPU.
    ``err``: an error word several calls share, read by the caller (by
    default the call reads its own and raises if a grid barrier timed out).
    """
    Tm, N, K = _check(logA, emits, delta0)
    if Tm < 1:
        raise ValueError("the probe needs T' >= 1")
    on_card = on_cuda(logA, emits, delta0)
    _variant(variant, on_card)
    if not on_card:
        return probe_scan_ablation_plain(logA, emits, delta0, variant)
    expect_contiguous(logA=logA, emits=emits, delta0=delta0)
    dev = delta0.device
    hist = torch.empty((Tm, N, K), dtype=torch.float32, device=dev)
    dfin, deltas = launch_scan("fvt_maxplus_scan_deltas_ablation", probe_scan_ablation,
                               {"logA": logA, "emits": emits}, delta0, hist,
                               ablation_plan(K, N, sm_count(dev), variant), err,
                               VARIANTS.index(variant))
    return dfin, None if variant == "no-hist" else deltas


probe_scan_ablation.launches = 0


def inputs(K: int, N: int, Tm: int, device="cuda", seed: int = 0, cache: dict | None = None):
    """``ablation``'s inputs: logA (K, K), emits (Tm, N, K) and delta0
    (N, K), standard normal float32 drawn in that order from ``seed``.
    ``cache`` keeps each K's logA and the generator's state after it, so
    the shapes of one K share its (K, K) draw."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cache is not None and K in cache:
        logA, state = cache[K]
        rng.bit_generator.state = state
    else:
        logA = torch.as_tensor(rng.standard_normal((K, K)).astype(np.float32), device=dev)
        if cache is not None:
            cache[K] = (logA, rng.bit_generator.state)
    emits = rng.standard_normal((Tm, N, K)).astype(np.float32)
    delta0 = rng.standard_normal((N, K)).astype(np.float32)
    return logA, torch.as_tensor(emits, device=dev), torch.as_tensor(delta0, device=dev)


def work(K: int, N: int, Tm: int, write_hist: bool, on: bounds.Card = bounds.H100
         ) -> tuple[int, int]:
    """(bytes, operations) of one call on the card ``on``: logA as
    ``bounds.table_bytes`` counts a table read whole every step, every
    other input and output once; an add and a max per (step, lane, source,
    destination)."""
    moved = bounds.table_bytes(K * K * 4, Tm, on) + (
        Tm * N * K + 2 * N * K + (Tm * N * K if write_hist else 0)) * 4
    return moved, 2 * Tm * N * K * K


def split(per_call_s: dict[str, float], Tm: int, groups: int, streamed: int) -> dict:
    """A step's parts from one shape's time a call of every variant
    (seconds): the fixed cost, the combine, the streamed rows and their
    rate (``streamed`` bytes a step a group of lanes over the time the
    loads add), the fold and the history, each in seconds a step.  A part
    is the time its cut saves, so parts that overlap in ``full`` (the
    loads behind the fold) do not sum to a step, and a rate above the
    memory's says how far the loads hide."""
    full = per_call_s["full"]
    stream_s = full - per_call_s["no-stream"]
    return {"fixed_step_s": per_call_s["barrier-only"] / Tm,
            "combine_step_s": (full - per_call_s["no-combine"]) / Tm,
            "stream_step_s": stream_s / Tm,
            "stream_bytes_per_s": streamed * Tm * groups / stream_s if stream_s > 0 else None,
            "fold_step_s": (full - per_call_s["no-fold"]) / Tm,
            "hist_step_s": (full - per_call_s["no-hist"]) / Tm}


def run(device="cuda", shapes=SHAPES, variants=VARIANTS) -> list[dict]:
    """Time every variant on every shape: the device's time a call, chains
    of ``CHAIN`` calls queued behind a sleep of the card, the variants in
    turns (in order, then in reverse; ``per_call_s`` the mean of the two,
    ``runs`` both), one error word a shape read at the end; one record
    each, one for each ``vpu_probe.py`` variant that has no run, and a
    shape's step split (variant ``<shape>_split``) where every variant
    ran."""
    records = []
    cache = {}
    for shape, (K, N, Tm) in shapes.items():
        args = inputs(K, N, Tm, device, cache=cache)
        dev = args[0].device
        on_card = dev.type == "cuda"
        err = error_word(dev) if on_card else None
        on = bounds.card(dev)
        timed = [v for v in variants if on_card or v in EXACT]
        runs = {v: [] for v in timed}
        for v in timed + timed[::-1]:
            runs[v].append(queued_ms(lambda v=v: probe_scan_ablation(*args, v, err=err), dev,
                                     k=CHAIN, reps=2) * 1e-3)
        times = {v: sum(t) / len(t) for v, t in runs.items()}
        for variant in variants:
            base = {"probe": "vpu_probe", "kernel": "probe_scan_ablation",
                    "variant": f"{shape}_{variant}", "ablation": variant,
                    "jax": JAX_NAMES.get((shape, variant), [])}
            if variant not in times:
                records.append({**base, "skipped": "cost attribution only: runs on the card"})
                continue
            per = times[variant]
            moved, ops = work(K, N, Tm, variant != "no-hist", on)
            rec = {**base, "device": device_name(dev), "K": K, "N": N, "Tm": Tm,
                   "exact": variant in EXACT, "per_call_s": per, "runs_s": runs[variant],
                   "per_step_s": per / Tm,
                   "counted_ops_per_s": 2 * N * K * K / (per / Tm), "bytes": moved,
                   "operations": ops}
            if on_card:
                plan = ablation_plan(K, N, sm_count(dev), variant)
                rec.update(R=plan.R, C=plan.C, rows_smem=plan.rows_smem,
                           rows_streamed=plan.rows_streamed, two_phase=plan.two_phase)
            records.append(rec)
        if on_card:
            raise_on_error(err, "probe_scan_ablation")
        if set(times) == set(VARIANTS):
            plan = ablation_plan(K, N, sm_count(dev))
            records.append({"probe": "vpu_probe", "kernel": "probe_scan_ablation",
                            "variant": f"{shape}_split", "device": device_name(dev), "K": K,
                            "N": N, "Tm": Tm, "streamed_bytes_a_step": streamed_bytes(plan),
                            "split": split(times, Tm, -(-N // plan.lanes),
                                           streamed_bytes(plan))})
    records += [{"probe": "vpu_probe", "kernel": "probe_scan_ablation", "variant": name,
                 "skipped": why} for name, why in NO_RUN.items()]
    return records
