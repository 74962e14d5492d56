#!/usr/bin/env python3
"""SIEVE-BS at the paper's own config, held to the JAX package's record.

    python3 scripts/torch_sieve_bs_witness.py [--device cpu] [--K K] [--T T]

The port's counterpart of parts 1 and 2 of ``scripts/sieve_bs_witness.py``,
at its config (K=3965, M=50, T=256, prob=0.112, seed=1, a beam of 32: the
paper's SIEVE-BS run, ``src/run.py:8-25``):

1. ``decode(hmm, y, "sieve_bs", beam_width=32)`` on the card (``--device
   cpu``: the plain versions), its -1 sentinels, and its quirk-scored f64
   score and junction breaks (``oracle.validate.beam_family_score_f64``);
2. the fp32 framework mirror (``oracle.framework.sieve_bs``), the decoder's
   bit-exactness yardstick, past the harness's cap (~3 min of one host
   core at this config): the path must equal it bit for bit.

Part 3 of the JAX script, the compiled reference C SIEVE-BS, needs the
reference C programs, which this repository does not hold; one line says
so.  Prints the device first (``nvidia-smi``'s name and power limit on the
card), then the JAX script's JSON steps (``device_decode`` adds the path's
SHA-256 over int32), then compares every figure with the JAX run's record
``results/sieve_bs_witness.log`` and exits 1 on a difference.  A run cut by
``--K`` or ``--T`` has no record and skips the comparison.  Without a card
the default device raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
BEAM_WIDTH = 32
RECORD = os.path.join(ROOT, "results", "sieve_bs_witness.log")
# step -> the keys held to the record (times are not)
COMPARED = {"fixture": ("K", "T", "prob", "seed"),
            "device_decode": ("sentinels",),
            "device_score_f64": ("score", "junction_breaks", "finite"),
            "fp32_mirror": ("bit_equal", "mismatches")}


def path_sha256(path) -> str:
    return hashlib.sha256(np.ascontiguousarray(path, dtype=np.int32).tobytes()).hexdigest()


def jax_record(path: str = RECORD) -> dict[str, dict]:
    """The JAX run's JSON steps by name (its log's other lines skipped)."""
    steps = {}
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                rec = json.loads(line)
                steps[rec["step"]] = rec
    return steps


def differences(steps: list[dict], record: dict[str, dict]) -> list[str]:
    """Every COMPARED figure of ``steps`` that differs from ``record``'s
    (exactly: the f64 score too)."""
    out = []
    for rec in steps:
        for key in COMPARED.get(rec["step"], ()):
            want = record[rec["step"]][key]
            if rec[key] != want or type(rec[key]) is not type(want):
                out.append(f"{rec['step']}.{key}: {rec[key]!r}, the JAX record {want!r}")
    return out


def decode_steps(hmm, y, device) -> tuple[np.ndarray, list[dict]]:
    """Part 1: the decoder's path on ``device`` and its two steps."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.oracle.validate import beam_family_score_f64

    t0 = time.perf_counter()
    r = decode(hmm, y, "sieve_bs", beam_width=BEAM_WIDTH, device=device)
    dev = np.asarray(r.path)[:len(y)].astype(np.int64)
    steps = [dict(step="device_decode", wall_s=round(r.time_s, 3),
                  elapsed_s=round(time.perf_counter() - t0, 1),
                  sentinels=int((dev < 0).sum()), path_sha256=path_sha256(dev))]
    s_dev, brk = beam_family_score_f64(hmm.A, hmm.B, hmm.Pi, y, dev)
    steps.append(dict(step="device_score_f64", score=s_dev, junction_breaks=brk,
                      finite=bool(np.isfinite(s_dev))))
    return dev, steps


def mirror_step(hmm, y, dev: np.ndarray) -> dict:
    """Part 2: ``dev`` against the fp32 framework mirror."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs
    from flash_viterbi_tpu_torch.oracle import framework

    t0 = time.perf_counter()
    pairs = framework.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=BEAM_WIDTH)
    mir = _flatten_pairs(pairs, len(y)).astype(np.int64)
    return dict(step="fp32_mirror", bit_equal=bool((dev == mir).all()),
                mismatches=int((dev != mir).sum()),
                elapsed_s=round(time.perf_counter() - t0, 1))


def device_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; the CPU
    as the plain versions' device."""
    if device == "cpu":
        return "cpu (the plain versions)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--K", type=int, default=CONFIG["K"])
    ap.add_argument("--T", type=int, default=CONFIG["T"])
    args = ap.parse_args(argv)

    import torch

    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu")
    print(device_line(args.device), flush=True)
    cfg = dict(CONFIG, K=args.K, T=args.T)
    t0 = time.perf_counter()
    hmm, y = make_sparse_hmm(**cfg)
    steps = [dict(step="fixture", K=cfg["K"], T=cfg["T"], prob=cfg["prob"], seed=cfg["seed"],
                  elapsed_s=round(time.perf_counter() - t0, 1))]
    emit(steps[0])
    dev, decoded = decode_steps(hmm, y, args.device)
    for rec in decoded:
        emit(rec)
    steps += decoded
    steps.append(mirror_step(hmm, y, dev))
    emit(steps[-1])
    emit(dict(step="c_binary", skipped="needs the reference C programs (SIEVE-BS.c), "
              "which this repository does not hold"))
    if cfg != CONFIG:
        emit(dict(step="DONE", compared="no JAX record at a cut config"))
        return 0 if steps[-1]["bit_equal"] else 1
    diffs = differences(steps, jax_record())
    emit(dict(step="DONE", compared=RECORD[len(ROOT) + 1:], differences=diffs))
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
