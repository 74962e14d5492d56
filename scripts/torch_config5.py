#!/usr/bin/env python3
"""Config-5 at its specified scale on one NVIDIA GPU: 256 sequences x
K=16384 x T=65536 through the port's ``flash_long`` batched pipeline.

The port's counterpart of ``scripts/config5_full.py`` (and of
``scripts/config5_run.py``, which is ``--full 8 --limit 8 --segments 4``).
The problem is the JAX script's, letter for letter: ``make_sparse_hmm(K=16384,
M=50, T=65536, prob=0.112, seed=1)`` and, after its sequence, rows of
``RandomState(7).randint(0, 50, size=65536)`` (:func:`make_ys`).  ``--K``,
``--T`` and ``--limit`` cut it (the cut sequences are prefixes of the full
ones); a cut run has no JAX record to compare with.

* ``--probe``: the batch curve, ``--batches`` (8,16,32) at ``--probe-T``
  (16384) and ``--segments``: a batch's time by CUDA events, seconds a
  sequence, the same at T=65536 and for 256 sequences, and the peak
  allocation above the tables.
* ``--phase2-gib 6,12,24``: for each of ``--phase2-batches`` (8,16) at 4
  segments and ``--T``, phases A and B once, then phase 2 at each budget
  (``longform.PHASE2_BYTES``): its time, sub-batches and peak, and the
  paths equal at every budget.
* ``--full BATCH``: sequences 0..``--limit``-1 in batches through
  ``longform.flash_decode_long_batched``; after each batch one line is
  appended to ``--out`` (``config5_full.py``'s fields ``b0, b1, segments,
  batch, wall_s, scores``, plus ``card``, ``group_steps``, ``peak_bytes``
  and each path's SHA-256).  A rerun resumes: sequences recorded at the
  same segments are not decoded again.  Every score is
  ``oracle.validate.log_path_score_f64`` of the path on the fp32 tables,
  the function the JAX record used.  Gates, each failure naming its
  sequences: (1) every score finite; (2) on sequences 0, limit//2 and
  limit-1 the per-sequence pipeline (``flash_decode_long``: the pointer
  scan and the backtrack) scores bit-equal and gives the same path; (3)
  sequence 0 at 2 segments (4 if the run's are 2) within
  ``dp_divergence_tolerance_f64``; (4) with ``--against FILE``, every
  sequence the record holds at the run's segments scores bit-equal.  All
  hold: ``CONFIG5-FULL OK`` and exit 0; else exit 2.  The last line is one
  JSON object.

Imports only the port, numpy and torch, never JAX::

    python3 scripts/torch_config5.py --probe --segments 1
    python3 scripts/torch_config5.py --phase2-gib 6,12,24
    python3 scripts/torch_config5.py --full 16 --segments 1 \\
        --against results/config5_scores.jsonl

``--device cpu`` runs the kernels' plain versions; without a card the
default is an error, not the CPU.  The full run needs the card (the tables
and their transpose 2 GiB, a batch of 16 about 4 GiB more at 4096 steps a
group, 5 GiB for a per-sequence decode's pointer rows).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flash_viterbi_tpu_torch.algorithms import longform  # noqa: E402
from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm  # noqa: E402
from flash_viterbi_tpu_torch.models.hmm import resolve_device  # noqa: E402
from flash_viterbi_tpu_torch.oracle.validate import (  # noqa: E402
    dp_divergence_tolerance_f64,
    log_path_score_f64,
)

K_SPEC, M, T_SPEC, N_SEQS = 16384, 50, 65536, 256
PROB, SEED = 0.112, 1
N_SEGMENTS = 4
OUT = os.path.join(ROOT, "results", "torch_config5_scores.jsonl")
# the JAX package's records of its two full runs: read, never written
JAX_RECORDS = tuple(os.path.join(ROOT, "results", name)
                    for name in ("config5_scores.jsonl", "config5_scores_r4.jsonl"))


def emit(log=print, **kw) -> None:
    log(json.dumps(kw))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def make_ys(y0, n: int) -> np.ndarray:
    """``config5_full.make_ys``: ``y0``, then n - 1 rows of
    ``RandomState(7).randint(0, M, size=T_SPEC)``, each cut to len(y0)."""
    rng = np.random.RandomState(7)
    T = len(y0)
    return np.stack([np.asarray(y0, np.int32)]
                    + [rng.randint(0, M, size=T_SPEC).astype(np.int32)[:T] for _ in range(n - 1)])


def path_hash(path) -> str:
    return hashlib.sha256(np.ascontiguousarray(path, dtype=np.int32).tobytes()).hexdigest()


@dataclasses.dataclass
class Problem:
    """Config-5's tables on ``device`` (and the fp32 numpy tables the
    scores read, ``host``), the seed-1 sequence ``y0`` cut to T, and the
    transposed ``logA`` every decode's walk shares."""

    logA: torch.Tensor
    logB: torch.Tensor
    logPi: torch.Tensor
    host: tuple
    y0: np.ndarray
    device: torch.device
    card: str
    logAT: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        self.logAT = self.logA.t().contiguous()

    @classmethod
    def make(cls, K: int, T: int, device, log=print) -> "Problem":
        t0 = time.perf_counter()
        hmm, y0 = make_sparse_hmm(K=K, M=M, T=T, prob=PROB, seed=SEED)
        lh = hmm.log(device="cpu")
        del hmm
        device = torch.device(device)
        card = card_line() if device.type == "cuda" else "cpu"
        prob = cls(*(t.to(device) for t in (lh.logA, lh.logB, lh.logPi)),
                   host=(lh.logA.numpy(), lh.logB.numpy(), lh.logPi.numpy()), y0=y0,
                   device=device, card=card)
        emit(log, generated=f"K={K} T={T}", wall_s=time.perf_counter() - t0)
        return prob

    @property
    def K(self) -> int:
        return int(self.logA.shape[0])

    @property
    def T(self) -> int:
        return len(self.y0)

    @property
    def cut(self) -> bool:
        return (self.K, self.T) != (K_SPEC, T_SPEC)

    def ys(self, n: int) -> np.ndarray:
        return make_ys(self.y0, n)

    def on_device(self, ys) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ys, np.int64), device=self.device)

    def score(self, y, path) -> float:
        return log_path_score_f64(*self.host, y, path)

    def batched(self, ys, segments: int, group_steps: int = longform.GROUP_STEPS):
        return longform.flash_decode_long_batched(self.logA, self.logB, self.logPi,
                                                  self.on_device(ys), num_segments=segments,
                                                  group_steps=group_steps,
                                                  transposed=lambda a: self.logAT)

    def single(self, y, segments: int):
        """The per-sequence pipeline (``flash_decode_long``: pointer scans
        and the backtrack in phase 1) at the JAX gate's 4096 steps a group."""
        return longform.flash_decode_long(self.logA, self.logB, self.logPi, self.on_device(y),
                                          num_segments=segments, group_steps=4096,
                                          transposed=lambda a: self.logAT)

    def warm(self, segments: int) -> None:
        """Build and load the kernels (a short batch), outside every timing."""
        self.batched(self.ys(2)[:, :64], segments).cpu()

    def measure(self, fn):
        """(``fn()``'s result, its seconds, its peak bytes above what was
        allocated before): CUDA events and the allocator's peak on the
        card; the host clock and no peak on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0, None
        torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return (out, start.elapsed_time(end) / 1e3,
                torch.cuda.max_memory_allocated(self.device) - before)


def read_record(path: str, segments: int) -> dict:
    """seq -> (score, wall share, path hash or None) of every sequence
    ``path`` holds at ``segments`` (a later line wins); {} without a file."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("segments") != segments:
                continue
            n = r["b1"] - r["b0"]
            hashes = r.get("path_sha256") or [None] * n
            for b, sc, h in zip(range(r["b0"], r["b1"]), r["scores"], hashes):
                done[b] = (sc, r["wall_s"] / n, h)
    return done


def is_jax_record(path: str) -> bool:
    real = os.path.realpath(path)
    return any(real == os.path.realpath(p) for p in JAX_RECORDS)


@dataclasses.dataclass
class Run:
    """The scores, wall shares and path hashes of sequences 0..limit-1,
    the batches this call decoded and the largest peak among them."""

    scores: np.ndarray
    walls: np.ndarray
    hashes: list
    decoded: list
    peak: int | None


def decode_all(prob: Problem, batch: int, limit: int, segments: int, group_steps: int,
               out: str, log=print) -> Run:
    """Sequences 0..limit-1 in batches of ``batch``; a batch whose every
    sequence ``out`` holds at ``segments`` is read back, any other is
    decoded, scored and appended to ``out`` as one line."""
    if is_jax_record(out):
        raise ValueError(f"{out} is the JAX package's record: refusing to write to it")
    ys = prob.ys(limit)
    done = read_record(out, segments)
    scores, walls, hashes = np.zeros(limit), np.zeros(limit), [None] * limit
    emit(log, full_start=limit, batch=batch, group_steps=group_steps, segments=segments,
         resumed_seqs=sum(b in done for b in range(limit)))
    decoded, peak = [], None
    t_start = time.perf_counter()
    for b0 in range(0, limit, batch):
        b1 = min(b0 + batch, limit)
        if all(b in done for b in range(b0, b1)):
            for b in range(b0, b1):
                scores[b], walls[b], hashes[b] = done[b]
            continue
        t0 = time.perf_counter()
        paths, _, pk = prob.measure(lambda: prob.batched(ys[b0:b1], segments, group_steps))
        paths = paths.cpu().numpy()
        wall = time.perf_counter() - t0
        peak = pk if peak is None else max(peak, pk)
        for b in range(b0, b1):
            scores[b] = prob.score(ys[b], paths[b - b0])
            walls[b] = wall / (b1 - b0)
            hashes[b] = path_hash(paths[b - b0])
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps({"b0": b0, "b1": b1, "segments": segments, "batch": batch,
                                "wall_s": wall, "scores": [float(s) for s in scores[b0:b1]],
                                "card": prob.card, "group_steps": group_steps,
                                "peak_bytes": pk, "path_sha256": hashes[b0:b1]}) + "\n")
        decoded.append((b0, b1))
        emit(log, batch_done=[b0, b1], wall_s=wall, s_per_seq=wall / (b1 - b0),
             peak_bytes=pk, scores_finite=bool(np.isfinite(scores[b0:b1]).all()),
             elapsed_s=time.perf_counter() - t_start)
    return Run(scores, walls, hashes, decoded, peak)


def gates(prob: Problem, run: Run, segments: int, record: dict | None, log=print) -> dict:
    """The gates' verdicts: {gate: (ok, failing sequences)}, the against
    gate only with a record."""
    limit = len(run.scores)
    out = {"finite": (bool(np.isfinite(run.scores).all()),
                      [b for b in range(limit) if not np.isfinite(run.scores[b])])}
    ys = prob.ys(limit)
    bad = []
    for b in sorted({0, limit // 2, limit - 1}):
        t0 = time.perf_counter()
        alt = prob.single(ys[b], segments).cpu().numpy()
        s_alt = prob.score(ys[b], alt)
        bit = bool(s_alt == run.scores[b])
        path_equal = path_hash(alt) == run.hashes[b]
        emit(log, gate="cross_pipeline_f64_bit_identity", seq=b,
             score_batched=float(run.scores[b]), score_per_seq=s_alt, bit_equal=bit,
             path_equal=path_equal, wall_s=time.perf_counter() - t0)
        if not (bit and path_equal):
            bad.append(b)
    out["cross_pipeline"] = (not bad, bad)

    t0 = time.perf_counter()
    n2 = 2 if segments != 2 else 4
    s2 = prob.score(ys[0], prob.single(ys[0], n2).cpu().numpy())
    gap = abs(s2 - run.scores[0])
    tol = dp_divergence_tolerance_f64(prob.T, run.scores[0])
    ok = bool(np.isfinite(s2) and gap <= tol)
    emit(log, gate=f"cross_segmentation_N{n2}", score=float(run.scores[0]), score_alt=s2,
         gap=float(gap), tol=tol, wall_s=time.perf_counter() - t0)
    out["cross_segmentation"] = (ok, [] if ok else [0])

    if record is not None:
        common = sorted(b for b in record if b < limit)
        differ = [b for b in common if record[b][0] != run.scores[b]]
        for b in differ:
            emit(log, against_differs=b, score=float(run.scores[b]), record=record[b][0],
                 gap=float(run.scores[b] - record[b][0]))
        emit(log, against_compared=len(common), against_equal=len(common) - len(differ))
        out["against"] = (bool(common) and not differ, differ)
    return out


def full(prob: Problem, batch: int, limit: int, segments: int, group_steps: int, out: str,
         against: str | None = None, log=print) -> tuple[int, dict]:
    """``--full``: decode (resuming), gate, and the summary; (exit code,
    summary)."""
    record = None
    if against is not None:
        if prob.cut and is_jax_record(against):
            raise ValueError(f"a cut run (K={prob.K}, T={prob.T}) has no JAX record to compare "
                             f"with: {against} is config-5's at K={K_SPEC}, T={T_SPEC}")
        record = read_record(against, segments)
        if not record:
            raise ValueError(f"{against} holds no sequence at segments={segments}")
    if prob.cut:
        log(f"# a cut run (K={prob.K}, T={prob.T}): no JAX record exists at this shape")
    run = decode_all(prob, batch, limit, segments, group_steps, out, log)
    total = float(run.walls.sum())
    verdicts = gates(prob, run, segments, record, log)
    failing = {g: v[1] for g, v in verdicts.items() if not v[0]}
    compared = len([b for b in record or () if b < limit])
    summary = {
        "card": prob.card, "config": f"{limit}xK{prob.K}xT{prob.T}", "cut": prob.cut,
        "segments": segments, "batch": batch, "group_steps": group_steps,
        "total_wall_s": total,
        "decode_updates_per_s": limit * (prob.T - 1) * prob.K ** 2 / total if total else None,
        "peak_bytes": run.peak, "decoded_batches": len(run.decoded),
        "all_finite": verdicts["finite"][0],
        "score_min": float(run.scores.min()), "score_max": float(run.scores.max()),
        "gates": {g: v[0] for g, v in verdicts.items()},
        "against": None if record is None else {
            "file": os.path.relpath(os.path.realpath(against), ROOT), "compared": compared,
            "equal": compared - len(verdicts["against"][1]), "differ": verdicts["against"][1]},
    }
    if failing:
        log("CONFIG5-FULL VALIDATION FAILED: " + "; ".join(
            f"{g}: sequences {seqs}" for g, seqs in failing.items()))
    else:
        log("CONFIG5-FULL OK")
    return (2 if failing else 0), summary


def probe(prob: Problem, batches, probe_T: int, segments: int, group_steps: int,
          log=print) -> None:
    """The batch curve at ``probe_T``, one line a batch."""
    for bs in batches:
        ys = prob.ys(bs)[:, :probe_T]
        paths, s, peak = prob.measure(lambda: prob.batched(ys, segments, group_steps))
        paths = paths.cpu().numpy()
        per_seq = s / bs
        emit(log, probe_batch=bs, probe_T=probe_T, segments=segments, group_steps=group_steps,
             s=s, s_per_seq=per_seq, s_per_seq_at_T65536=per_seq * T_SPEC / probe_T,
             est_total_256_s=per_seq * T_SPEC / probe_T * N_SEQS, peak_bytes=peak,
             first_states=[int(p[0]) for p in paths[:4]])


def phase2_probe(prob: Problem, batches, budgets_gib, group_steps: int,
                 segments: int = N_SEGMENTS, log=print) -> None:
    """Phases A and B once a batch, then phase 2 at each budget: one line a
    budget (phase 2's time, sub-batches, peak); the paths equal at every
    budget, and their scores finite."""
    logBT = prob.logB.t()
    err = longform.error_word(prob.logA.device)
    _, mids = longform._segments(prob.T, segments)
    layout = longform._layout(mids, prob.T, prob.device)
    kept = longform.PHASE2_BYTES
    try:
        for bs in batches:
            ys = prob.ys(bs)
            yd = prob.on_device(ys)
            (path1, last), s1, peak1 = prob.measure(lambda: longform._phase1_batched(
                prob.logA, prob.logAT, prob.logPi, logBT, yd, group_steps, err))
            anchors = path1[:, layout[0]]
            first = None
            for gib in budgets_gib:
                longform.PHASE2_BYTES = int(gib * 2**30)
                paths, s2, peak2 = prob.measure(lambda: longform._phase2_batched(
                    prob.logA, prob.logAT, prob.logPi, logBT, yd, anchors, last, layout,
                    group_steps, err))
                paths = paths.cpu().numpy()
                longform.raise_on_error(err, "phase2_probe")
                if first is None:
                    first = paths
                    scores = [prob.score(ys[b], paths[b]) for b in range(bs)]
                    if not np.isfinite(scores).all():
                        raise RuntimeError(f"batch {bs}: path scores {scores}")
                elif not np.array_equal(paths, first):
                    raise RuntimeError(f"batch {bs}: phase 2 at {gib} GiB differs")
                per = longform.phase2_sequences(layout, prob.K)
                emit(log, phase2_batch=bs, T=prob.T, segments=segments, group_steps=group_steps,
                     phase1_s=s1, phase1_peak_bytes=peak1, budget_gib=gib, phase2_s=s2,
                     sub_batches=-(-bs // per), seqs_a_sub_batch=per, phase2_peak_bytes=peak2)
            del path1, last, anchors
    finally:
        longform.PHASE2_BYTES = kept
    log("# phase 2: the paths are equal at every budget, their f64 scores finite")


def main(argv=None, log=print) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--probe-T", type=int, default=16384)
    ap.add_argument("--batches", default="8,16,32")
    ap.add_argument("--phase2-gib", default="", metavar="GIB,...")
    ap.add_argument("--phase2-batches", default="8,16")
    ap.add_argument("--full", type=int, default=0, metavar="BATCH")
    ap.add_argument("--limit", type=int, default=N_SEQS)
    ap.add_argument("--segments", type=int, default=N_SEGMENTS)
    ap.add_argument("--group-steps", type=int, default=longform.GROUP_STEPS)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--against", default=None, metavar="FILE")
    ap.add_argument("--K", type=int, default=K_SPEC)
    ap.add_argument("--T", type=int, default=T_SPEC)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)  # raises without a card
    if a.full and is_jax_record(a.out):
        log(f"error: {a.out} is the JAX package's record: refusing to write to it")
        return 2
    prob = Problem.make(a.K, a.T, device, log)
    log(prob.card)
    prob.warm(a.segments)
    if a.probe:
        probe(prob, [int(x) for x in a.batches.split(",")], min(a.probe_T, prob.T), a.segments,
              a.group_steps, log)
    if a.phase2_gib:
        phase2_probe(prob, [int(x) for x in a.phase2_batches.split(",")],
                     [float(x) for x in a.phase2_gib.split(",")], a.group_steps, log=log)
    if not a.full:
        return 0
    try:
        rc, summary = full(prob, a.full, a.limit, a.segments, a.group_steps, a.out, a.against,
                           log)
    except ValueError as e:
        log(f"error: {e}")
        return 2
    log(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main(log=lambda s: print(s, flush=True)))
