"""Benchmark harness: the reference's ``src/run.py`` sweep, and marginal
timing of chained calls.

Counterpart of ``flash_viterbi_tpu/bench/harness.py``.  A sweep is a list
of :class:`RunConfig`; each run makes (or loads) the seeded problem,
decodes it on the device and gives a row of the reference's CSV schema
(``src/run.py:105``) with the JAX package's columns added, ``CSV_FIELDS``.

Timing: ``time`` is the median of ``TIMED_DECODES`` synchronized decodes
after a warmup, each timed with CUDA events on the card
(``algorithms.base.timed``).  The JAX package's unrolled chain of decodes
is not ported: it can report less than one sweep's memory traffic allows.
Nothing falls back from a kernel to another path, so ``pallas_fallback``
is always empty.

``parity`` holds the path against the native C vanilla oracle up to
``_ORACLE_MAX_CELLS`` trellis cells, arbitrating a FLASH tie flip against
the f32 FLASH mirror (``oracle.validate.arbitrate_flash_tie_flip``); the
beam family against its numpy mirrors.  Above the oracle's cells a row
names its witness: the port's ``fused`` decode on the device (``checkpoint``
for a ``fused`` row), bit for bit, with the FLASH family's paths within
``dp_divergence_tolerance_f64`` of its f64 score labelled
``witness:fused:tie-equivalent``.  ``sieve_mp`` rows are held to the
SIEVE-Mp oracle in fp32 numerics, ``sieve_bs_mp`` rows to their numpy
mirror, ``sieve_bs`` rows to the float64 SIEVE-BS oracle for a uniform Pi
(the oracle threads ``Baseline.py``'s uniform root Pi) and to their numpy
mirror for another Pi or where the oracle is undefined (the decoder's
``(-1, -1)`` sentinel), up to ``_MIRROR_MAX_K`` states; above it, and for an unpruned
``sieve_mp`` row (the oracle prunes), to the port's decode of the same
options on the CPU, labelled ``witness:cpu:True`` or ``False``.

:func:`marginal_time`: a probe's kernel runs for microseconds, shorter than
one call can be timed well, so a chain of k calls is timed at two lengths
and the slope is the time per call: launch gaps between calls stay in it,
the fixed cost of the first launch and the final synchronisation drops
out.  On the card each chain is timed with CUDA events; on the CPU with
``time.perf_counter``.  The device is the one the chain's result lies on.
:func:`queued_ms` times the device alone: chains queued behind a sleep of
the card, so the host's launch path, often longer than such a kernel,
drops out.
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import os
import statistics
import time
from datetime import datetime
from typing import Sequence

import numpy as np
import torch

CSV_FIELDS = [
    "timestamp", "K_STATE", "T_STATE", "obserRouteLEN", "prob",
    "MAX_THREADS", "BeamSearchWidth", "time", "memory",
    "algorithm", "device", "updates_per_s", "parity", "pallas_fallback",
]
# synchronized decodes a row's time is the median of
TIMED_DECODES = 5


@dataclasses.dataclass
class RunConfig:
    algorithm: str = "fused"
    K: int = 256
    M: int = 50  # T_STATE in reference vocabulary (observation alphabet)
    T: int = 256  # obserRouteLEN
    prob: float = 0.112
    seed: int = 1
    num_segments: int = 8  # plays MAX_THREADS' role (src/run.py:34-35)
    beam_width: int | None = None
    dag: bool = False
    data_path: str | None = None  # load the problem instead of generating it
    check_parity: bool = True
    device: str = "cuda"
    extra: dict = dataclasses.field(default_factory=dict)


def _device_of(out) -> torch.device:
    """The device of the first tensor in ``out`` (a tensor or a nest of
    tuples and lists); the CPU when it holds none."""
    if torch.is_tensor(out):
        return out.device
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _device_of(x)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def device_name(dev: torch.device) -> str:
    """What a result names as the device it ran on."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def marginal_time(make_chain, k1: int = 1, k2: int = 5, reps: int = 3) -> float:
    """Seconds per call: the slope between chains of ``k1`` and ``k2``
    calls, each the median of ``reps`` timed runs.

    ``make_chain(k)`` returns a callable that makes k calls and returns a
    result on the device they ran on.  Both chains run once untimed first
    (kernels build at their first launch).
    """
    f1, f2 = make_chain(k1), make_chain(k2)
    f1()
    dev = _device_of(f2())

    def run(f) -> float:
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(dev))
                f()
                end.record(torch.cuda.current_stream(dev))
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                f()
                times.append(time.perf_counter() - t0)
        return statistics.median(times)

    return max((run(f2) - run(f1)) / (k2 - k1), 1e-9)


def queued_ms(fn, device, k: int = 20, reps: int = 5) -> float:
    """Median milliseconds a call of ``fn`` over chains of ``k`` calls,
    each chain queued behind a ~20 ms sleep of the card, so the calls run
    back to back on the device while the host enqueues them: the device's
    time a call, the host's launch cost hidden.  On the CPU, the median of
    ``reps`` chains timed by the host's clock."""
    dev = torch.device(device)
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / k)
            continue
        torch.cuda._sleep(40_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


# Above these trellis cells (K^2 T) the C oracle takes minutes: such rows
# take the device witness instead (labelled, so no parity cell is empty).
_ORACLE_MAX_CELLS = 2e10
# Above these state counts the SIEVE family's numpy mirrors are too slow for
# a sweep: such rows take the port's CPU decode as witness (the JAX
# package's figures, kept for the SIEVE decoders not ported yet too).
_MIRROR_MAX_K = {"sieve_mp": 1024, "sieve_bs": 512, "sieve_bs_mp": 512,
                 "sieve": 512, "sieve_dag": 256}
_EXACT = ("vanilla", "checkpoint", "flash", "fused")  # exact decoders: vanilla's path


def _routed(cfg: RunConfig, dec, Kp: int) -> tuple[str, dict]:
    """The decoder a row ran: ``auto``'s choice at the padded K with the
    decoder's own overrides, else the row's algorithm."""
    if cfg.algorithm != "auto":
        return cfg.algorithm, dec.static
    from ..algorithms.auto import choose

    st = {k: v for k, v in dec.static.items() if k not in ("memory_budget_bytes", "beam_width")}
    return choose(Kp, cfg.T, memory_budget_bytes=dec.static.get("memory_budget_bytes"),
                  beam_width=cfg.beam_width, static=st)


def _witness(cfg: RunConfig, hmm, y, path, routed: str, tables) -> str:
    """Above the oracle's cells: the port's ``fused`` decode on the same
    device (``checkpoint`` for a ``fused`` row), bit for bit; a FLASH-family
    path may differ from it within ``dp_divergence_tolerance_f64`` of its
    f64 score."""
    from ..algorithms.base import build
    from ..oracle.validate import dp_divergence_tolerance_f64, path_score_f64

    name = "checkpoint" if routed == "fused" else "fused"
    want = build(name)(*tables).cpu().numpy()[: cfg.T]
    if np.array_equal(path, want):
        return f"witness:{name}:True"
    if routed == "flash":
        s_got = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
        s_ref = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, want)
        if np.isfinite(s_got) and abs(s_got - s_ref) <= dp_divergence_tolerance_f64(cfg.T, s_ref):
            return f"witness:{name}:tie-equivalent"
    return f"witness:{name}:False"


def _parity(cfg: RunConfig, hmm, y, path, dec, tables):
    """Hold the decoded path to its yardstick: True / False against a
    mirror, "mirror-exact" / "tie-equivalent" for an arbitrated FLASH tie
    flip, "tie-flip-unarbitrated" where the mirror is too costly, or a
    ``witness:`` label above the oracle's cells."""
    from ..oracle import framework as fw

    bw = cfg.beam_width or 64
    routed, kw = _routed(cfg, dec, tables[0].shape[0])
    if routed in _EXACT:
        if cfg.K * cfg.K * cfg.T > _ORACLE_MAX_CELLS:
            return _witness(cfg, hmm, y, path, routed, tables)
        if np.array_equal(path, _oracle(_problem_key(cfg))):
            return True
        if routed != "flash":
            return False
        # a FLASH path may flip an fp32 tie against vanilla (docs/DESIGN.md
        # section 1): arbitrate against the f32 FLASH mirror
        from ..oracle.validate import arbitrate_flash_tie_flip

        ok = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, path,
                                      kw.get("num_segments", cfg.num_segments))
        return "tie-flip-unarbitrated" if ok is None else ok
    if routed == "flash_bs":
        want = fw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw,
                           num_segments=cfg.num_segments)
        return bool(np.array_equal(path, np.asarray(want)[: cfg.T]))
    if routed == "beam":
        want = fw.beam(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        return bool(np.array_equal(path, np.asarray(want)[: cfg.T]))
    if routed in ("sieve_mp", "sieve_bs_mp"):
        # the copied sieve_mp oracle always prunes: an unpruned row, like a
        # row above the mirror's K, is held to the port's CPU decode
        if cfg.K > _MIRROR_MAX_K[routed] or not kw.get("prune", True):
            return _cpu_witness(cfg, path, routed, kw, tables)
        if routed == "sieve_mp":
            from ..oracle.sieve import sieve_mp

            want = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
        else:
            # the fp32 framework mirror: bit-exact with the decoder even on
            # permuted-path ties where the f64 reference differs
            want = fw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        return bool(np.array_equal(path, np.asarray(want)[: cfg.T]))
    if routed == "sieve_bs":
        if cfg.K > _MIRROR_MAX_K[routed]:
            return _cpu_witness(cfg, path, routed, kw, tables)
        from ..algorithms.sieve_bs import _flatten_pairs

        from ..oracle import sieve_bs as osbs

        b_hops = kw.get("b_hops")
        pairs = None
        if np.allclose(hmm.Pi, 1.0 / len(hmm.Pi), rtol=0, atol=0):
            try:
                pairs = osbs.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, b_hops=b_hops)
            except osbs.ReferenceUndefined:
                pass  # the decoder's totality sentinel: only the mirror has it
        if pairs is None:
            pairs = fw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, b_hops=b_hops)
        return bool(np.array_equal(path, _flatten_pairs(pairs, cfg.T)))
    raise KeyError(f"no yardstick for {routed!r}")


def _cpu_witness(cfg: RunConfig, path, routed: str, kw: dict, tables) -> str:
    """Above a mirror's state count, or where the mirror does not compute
    the row's options: the port's decode of the same decoder and options
    on the CPU, bit for bit (the JAX package's alternate build
    without its kernels has no counterpart: the port has no kernel
    switch)."""
    from ..algorithms.base import build

    want = build(routed, **kw)(*(t.cpu() for t in tables)).numpy()[: cfg.T]
    return f"witness:cpu:{bool(np.array_equal(path, want))}"


def _problem_key(cfg: RunConfig) -> tuple:
    return (cfg.K, cfg.M, cfg.T, cfg.prob, cfg.seed, cfg.dag, cfg.data_path)


# the last problem and its C oracle path, shared by the consecutive rows of
# one problem (a sweep's decoders of one shape): making a K=16384 problem
# takes seconds of host time, its oracle more; nothing mutates either
@functools.lru_cache(maxsize=1)
def _problem(K, M, T, prob, seed, dag, data_path):
    from ..models.generate import make_dag_hmm, make_sparse_hmm
    from ..utils.io import load_dataset

    if data_path:
        return load_dataset(data_path, K, T, M, prob=prob, dag=dag)
    if dag:
        return make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
    return make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)


@functools.lru_cache(maxsize=1)
def _oracle(key: tuple) -> np.ndarray:
    from ..oracle import native

    hmm, y = _problem(*key)
    return native.vanilla(hmm.A, hmm.B, hmm.Pi, y)


def run_one(cfg: RunConfig) -> dict:
    """Decode one configuration and return its CSV row: the median time of
    ``TIMED_DECODES`` synchronized decodes after a warmup, the analytic
    memory at the logical K and the parity verdict.  The row also holds
    ``times``, every timed decode's seconds (not a CSV column)."""
    from ..algorithms.base import build, check_observations, timed, upload
    from ..models.hmm import resolve_device

    hmm, y = _problem(*_problem_key(cfg))
    static = dict(cfg.extra)
    if cfg.algorithm in ("flash", "flash_bs", "auto"):
        # for auto an override, so a routed flash or flash_bs runs the
        # segment count its parity mirror is checked with
        static.setdefault("num_segments", cfg.num_segments)
    if cfg.beam_width is not None:
        static.setdefault("beam_width", cfg.beam_width)
    dec = build(cfg.algorithm, **static)
    dev = resolve_device(cfg.device)
    yv = check_observations(y, hmm.M)
    K, lh = upload(hmm, dev, 128)
    tables = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(yv, device=dev))
    times = []
    for i in range(TIMED_DECODES):
        out, secs, _ = timed(lambda: dec(*tables), dev, warmup=i == 0)
        times.append(secs)
    wall = statistics.median(times)
    path = out.cpu().numpy()[: cfg.T]
    # never an empty cell: a row without a check says so
    parity = _parity(cfg, hmm, y, path, dec, tables) if cfg.check_parity else "skipped"
    return {
        "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "K_STATE": cfg.K,
        "T_STATE": cfg.M,
        "obserRouteLEN": cfg.T,
        "prob": cfg.prob,
        "MAX_THREADS": cfg.num_segments,
        "BeamSearchWidth": cfg.beam_width or "",
        "time": wall,
        # the logical K, as the C binaries account it; K_padded lets auto
        # re-derive the choice it made at the padded K
        "memory": dec.analytic_memory(K=K, T=cfg.T, K_padded=lh.Kp),
        "algorithm": cfg.algorithm,
        "device": device_name(dev),
        "updates_per_s": cfg.K * cfg.K * cfg.T / wall,
        "parity": parity,
        "pallas_fallback": "",
        "times": times,
    }


def append_csv(row: dict, csv_dir: str, algorithm: str) -> str:
    """Append ``row`` to ``{csv_dir}/{algorithm}.csv``, writing the header
    when the file is new (run.py's run_result, :80-107)."""
    os.makedirs(csv_dir, exist_ok=True)
    path = os.path.join(csv_dir, f"{algorithm}.csv")
    fresh = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS, extrasaction="ignore")
        if fresh:
            w.writeheader()
        w.writerow(row)
    return path


def sweep(configs: Sequence[RunConfig], csv_dir: str | None = None,
          verbose: bool = True) -> list[dict]:
    rows = []
    for cfg in configs:
        row = run_one(cfg)
        rows.append(row)
        if csv_dir:
            append_csv(row, csv_dir, cfg.algorithm)
        if verbose:
            print(f"{cfg.algorithm:10s} K={cfg.K:<6d} T={cfg.T:<6d} "
                  f"time={row['time'] * 1e3:9.3f} ms  "
                  f"{row['updates_per_s'] / 1e9:8.2f} G upd/s  parity={row['parity']}",
                  flush=True)
    return rows
