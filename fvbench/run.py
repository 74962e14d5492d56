"""Run one cell of ``BENCHMARK.json`` once on one NVIDIA GPU.

    python3 -m fvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``: the HMM's sizes)
and a traffic mix (``traffic/<mix>.json``: the loop, the sequences a
request, T, the pool, the entry and, where the cell promises a decode other
than the exact optimum, its ``decoder``); the entry (``entries/<entry>.py``)
calls one function of ``flash_viterbi_tpu_torch`` on tables uploaded once;
``cells/<cell>.json`` holds what the check samples and its limits; each
metric is read by ``endtoend/<name>.py`` or ``metrics/<name>.py``.  All are
found by name, so a cell, configuration, mix, entry or metric is added by
adding files and entries.

A ``decoder`` object, such as ``{"algorithm": "flash_bs", "beam_width": 64,
"num_segments": 8}``, states the decode once: the entry builds it from
these numbers, and the check decodes the sample again with the reference
of that name (``reference.<algorithm>``) and the same numbers.

Set-up draws the tables from ``--seed`` on the card, computes their float32
logs, uploads them padded with the port's ``algorithms.base.upload``, builds
the entry, draws the request pool and runs one warm-up request.  The window
then sends the pool's requests in a closed loop, one client, each from
handing the port the host's observations to holding its paths on the host,
until the first completion at or after ``--seconds``.  With ``--trace 1``
a ``torch.profiler`` session covers the traffic's ``trace_requests``
requests right after warm-up instead, and the per-layer metrics are read
from it.  After the window the program's state is freed and the paths are
judged (:func:`judge`): every completed path is checked in float64, and a
sample of the completed sequences, drawn from the seed, is decoded again by
the plain reference (``reference.py``).

Prints the result as the last line of standard output, the numbers
compared beside their limits as the last lines of standard error.  Exits 2
without a result where there is no card, and 3 where the process loaded
JAX or the JAX package, or the profiler lost the port's kernels.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches at fixed paths inside the checkout (the port builds its kernels
# into its own build/ directory; these are for anything else that compiles)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".fvbench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".fvbench_cache", "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fvbench import bounds, gen, reference, trace  # noqa: E402

T_IMPORTED = time.perf_counter()

#: top-level modules the process must not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "flash_viterbi_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared as a whole name (``flash_viterbi_tpu_torch`` is not
    ``flash_viterbi_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def _load(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"fvbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


#: what the harness reads from a configuration (the HMM's sizes), beside
#: the keys that only describe it
CONFIG_KEYS = {"K", "M", "prob", "source", "deployment", "generator", "published", "reduced",
               "assumed"}
#: what the harness reads from a traffic mix
TRAFFIC_KEYS = {"loop", "clients", "entry", "sequences_per_request", "T", "pool",
                "trace_requests", "decoder"}
#: the decodes a traffic mix's ``decoder`` may name, each with the numbers
#: it must state: the keyword arguments of its reference,
#: ``reference.<algorithm>``
DECODERS = {"flash_bs": {"beam_width", "num_segments"}}


def _implemented(kind: str, data: dict, keys: set) -> None:
    """Refuse a key the harness does not read, rather than run the file
    as if it were not there."""
    unknown = sorted(set(data) - keys)
    if unknown:
        raise ValueError(f"{kind} keys the harness does not implement: {', '.join(unknown)}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @property
    def decoder(self) -> dict | None:
        """The decode the cell promises where it is not the exact optimum."""
        return self.traffic.get("decoder")


def _decoder(dec: dict) -> None:
    """Refuse a ``decoder`` the check cannot hold a run to: an algorithm
    with no reference, or a number missing or not read."""
    params = DECODERS.get(dec.get("algorithm"))
    if params is None:
        raise ValueError(f"decoder {dec.get('algorithm')!r}: the harness implements "
                         f"{', '.join(sorted(DECODERS))}")
    _implemented("decoder", dec, params | {"algorithm"})
    missing = sorted(params - set(dec))
    if missing:
        raise ValueError(f"decoder {dec['algorithm']!r} states no {', '.join(missing)}")


def load_cell(name: str, bench: dict | None = None, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with its
    configuration, traffic and check files; ``overrides`` maps "config",
    "traffic" and "check" to keys replaced (the CPU tests' small sizes)."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    over = overrides or {}
    config = {**_json("configs", spec["config"]), **over.get("config", {})}
    traffic = {**_json("traffic", spec["traffic"]), **over.get("traffic", {})}
    check = {**_json("cells", name), **over.get("check", {})}
    _implemented("config", config, CONFIG_KEYS)
    _implemented("traffic", traffic, TRAFFIC_KEYS)
    if traffic.get("loop", "closed") != "closed" or int(traffic.get("clients", 1)) != 1:
        raise ValueError(f"traffic {spec['traffic']!r}: the harness runs a closed loop of one "
                         "client only")
    if "decoder" in traffic:
        _decoder(traffic["decoder"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, int(spec["chips"]), config, traffic, check, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


@dataclass
class Setup:
    """What set-up leaves for the window: the drawn tables (A, B, Pi), the
    port's padded log tables, the entry's call and the request pool."""

    A: torch.Tensor
    B: torch.Tensor
    Pi: torch.Tensor
    lh: object
    call: object
    pool: np.ndarray  # (requests, sequences a request, T) int32
    device: torch.device
    base_bytes: int = 0  # allocated once the tables were uploaded, before the entry was built

    @property
    def K(self) -> int:
        return int(self.A.shape[0])


def log_tables(A, B, Pi, block: int = 2048):
    """The program's float32 log tables: float64 logs truncated to float32,
    as the port's ``HMM.log`` computes them, on the tables' device."""
    logA = torch.empty_like(A)
    for i in range(0, A.shape[0], block):
        logA[i:i + block] = A[i:i + block].double().log().float()
    return logA, B.double().log().float(), Pi.double().log().float()


def prepare(cell: Cell, seed: int, device, control: bool = False) -> Setup:
    """Set-up: the tables, the upload, the entry, the pool and one warm-up
    request.  The tensors are made in one fixed order, so that the caching
    allocator places them alike in every run.  ``control`` builds the
    entry's control (its lower precision, or a narrower beam where the
    cell states a ``decoder``), or the reference at a bfloat16 table where
    the entry has none.  The entry takes the cell's ``decoder`` where it
    states one."""
    from flash_viterbi_tpu_torch.algorithms.base import decode, upload
    from flash_viterbi_tpu_torch.models.hmm import LogHMM

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    K, M = int(cfg["K"]), int(cfg["M"])
    marks = [("imports", T_IMPORTED), ("cell, card check, port import", time.perf_counter())]
    A, B, Pi = gen.tables(K, M, float(cfg["prob"]), seed, dev)
    logA, logB, logPi = log_tables(A, B, Pi)
    pad_to = inspect.signature(decode).parameters["pad_to"].default  # the port's own padding
    _, lh = upload(LogHMM(logA, logB, logPi, K), dev, pad_to)
    del logA, logB, logPi
    sync(dev)
    base_bytes = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    marks.append(("tables", time.perf_counter()))
    stated = {"decoder": cell.decoder} if cell.decoder else {}
    call = _load("entries", tr["entry"]).make(lh, control=control, **stated)
    in_place = call is None
    if in_place:
        if not control:
            raise ValueError(f"entry {tr['entry']!r} built nothing")

        def call(ys):
            return reference.viterbi(A, B, Pi, ys, table_dtype=torch.bfloat16)

    Bs, T = int(tr["sequences_per_request"]), int(tr["T"])
    pool = gen.observations(int(tr["pool"]) * Bs, T, M, seed).reshape(-1, Bs, T)
    marks.append(("pool", time.perf_counter()))
    s = Setup(A, B, Pi, lh, call, pool, dev, base_bytes)
    if not in_place:  # the reference in the program's place builds nothing
        request(s, pool[0])
        sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    starts = [T_START] + [t for _, t in marks]
    print("# set-up " + ", ".join(f"{n} {t - t0:.3f} s" for (n, t), t0 in zip(marks, starts)),
          file=sys.stderr)
    return s


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _spans(on: bool):
    """``record_function`` spans when tracing, else nothing."""
    return torch.profiler.record_function if on else (lambda name: contextlib.nullcontext())


def request(s: Setup, y: np.ndarray, span=_spans(False)) -> np.ndarray:
    """One request: the (Bs, T) int32 host observations in, the (Bs, T)
    paths out on the host."""
    with span("fvbench.copy_in"):
        yd = torch.from_numpy(y.astype(np.int64)).to(s.device)
    with span("fvbench.call"):
        out = s.call(yd)
    with span("fvbench.copy_out"):
        return out.cpu().numpy()


@dataclass
class Window:
    """What the window did; the end-to-end metrics read it."""

    K: int
    T: int
    Bs: int
    setup_s: float
    seconds: float = 0.0
    latencies: list = field(default_factory=list)
    paths: list = field(default_factory=list)  # (pool index, (Bs, T) paths)
    attempted: int = 0
    failed: int = 0
    base_bytes: int = 0
    peak_bytes: int | None = None
    launches: dict = field(default_factory=dict)

    @property
    def sequences(self) -> int:
        return len(self.paths) * self.Bs


def run_window(s: Setup, cell: Cell, seconds: float, traced: bool,
               requests: int | None = None) -> Window:
    """The closed loop: one client sends the pool's requests, from index 1,
    each when the last has come back, until the first completion at or
    after ``seconds``, or after ``requests`` completions where that comes
    first (traced: ``trace_requests``)."""
    from flash_viterbi_tpu_torch.ops import cuda as cuda_ops

    tr = cell.traffic
    w = Window(s.K, int(tr["T"]), int(tr["sequences_per_request"]), 0.0)
    span = _spans(traced)
    stop_after = int(tr["trace_requests"]) if traced else requests
    on_card = s.device.type == "cuda"
    w.base_bytes = s.base_bytes
    if on_card:
        torch.cuda.reset_peak_memory_stats(s.device)
    before = cuda_ops.launch_counts()
    i = 1
    t0 = time.perf_counter()
    w.setup_s = t0 - T_START
    while True:
        y = s.pool[i % len(s.pool)]
        w.attempted += 1
        ts = time.perf_counter()
        try:
            path = request(s, y, span)
        except Exception:  # a request that fails is counted, and the loop goes on
            path = None
            if not w.failed:
                traceback.print_exc()
            w.failed += 1
        te = time.perf_counter()
        with span("fvbench.host"):
            if path is not None:
                w.latencies.append(te - ts)
                w.paths.append((i % len(s.pool), path))
            i += 1
            done = te - t0 >= seconds or (stop_after is not None and len(w.paths) >= stop_after)
        if done:
            break
    w.seconds = te - t0
    after = cuda_ops.launch_counts()
    w.launches = {k: after[k] - before[k] for k in after}
    if on_card:
        w.peak_bytes = torch.cuda.max_memory_allocated(s.device)
    return w


def sample(w: Window, n: int, seed: int) -> list[tuple[int, int, int]]:
    """(index into ``w.paths``, lane, pool index) of ``n`` completed
    sequences drawn from the seed without replacement, the lanes cut into
    ``min(n, Bs)`` strata that share the draws evenly, so that a sample of
    two or more covers both halves of every batch."""
    R, Bs = len(w.paths), w.Bs
    if n >= R * Bs:
        return [(r, lane, w.paths[r][0]) for r in range(R) for lane in range(Bs)]
    rng = np.random.default_rng(gen.stream_seed(seed, 2))
    strata = min(n, Bs)
    picks = []
    for s in range(strata):
        lanes = range(s * Bs // strata, (s + 1) * Bs // strata)
        cands = [(r, lane) for r in range(R) for lane in lanes]
        count = n // strata + (s < n % strata)
        for c in rng.choice(len(cands), size=count, replace=False):
            r, lane = cands[int(c)]
            picks.append((r, lane, w.paths[r][0]))
    return picks


def judge(s: Setup, w: Window, cell: Cell, seed: int) -> tuple[dict, dict]:
    """(checks, readings): the numbers compared, each ``{"value",
    "limit"}``, and numbers reported beside them without a limit.

    A cell that states no ``decoder`` promises the exact optimum.  Its
    checks: requests that failed; returned sequences of the wrong shape,
    with a state outside [0, K) or of probability 0 (every completed path
    scored in float64); the widest float64 score gap between the
    reference's best path (``reference.viterbi``) and a sampled path the
    program returned.  A cell that states one is judged by
    :func:`judge_decoder`."""
    if cell.decoder:
        return judge_decoder(s, w, cell, seed)
    K, T, Bs = s.K, w.T, w.Bs
    shaped = [(r, p) for r, (_, p) in enumerate(w.paths) if p.shape == (Bs, T)]
    invalid = Bs * (len(w.paths) - len(shaped))
    score = {}  # (index into w.paths, lane) -> the returned path's float64 score
    per_block = max(1, 2**24 // (Bs * T))  # requests scored at once: 2^24 states
    for b in range(0, len(shaped), per_block):
        block = shaped[b:b + per_block]
        ys = torch.from_numpy(np.concatenate([s.pool[w.paths[r][0]] for r, _ in block])
                              .astype(np.int64)).to(s.device)
        ps = torch.from_numpy(np.concatenate([p for _, p in block]).astype(np.int64)).to(s.device)
        got = reference.path_scores(s.A, s.B, s.Pi, ys, ps).cpu().tolist()
        for k, (r, _) in enumerate(block):
            for lane in range(Bs):
                score[r, lane] = got[k * Bs + lane]
    invalid += sum(not np.isfinite(v) for v in score.values())
    picks = [(r, lane, pi) for r, lane, pi in sample(w, int(cell.check["sample"]), seed)
             if np.isfinite(score.get((r, lane), -np.inf))]
    gap = None
    if picks:
        ys = torch.from_numpy(np.stack([s.pool[pi][lane] for _, lane, pi in picks])
                              .astype(np.int64)).to(s.device)
        best = reference.viterbi(s.A, s.B, s.Pi, ys)
        ref_score = reference.path_scores(s.A, s.B, s.Pi, ys, best).cpu().tolist()
        gap = max(ref - score[r, lane] for ref, (r, lane, _) in zip(ref_score, picks))
    limits = cell.check["limits"]
    return {"failed": {"value": w.failed, "limit": limits["failed"]},
            "invalid_paths": {"value": invalid, "limit": limits["invalid_paths"]},
            "score_gap": {"value": gap, "limit": limits["score_gap"]}}, {}


def judge_decoder(s: Setup, w: Window, cell: Cell, seed: int) -> tuple[dict, dict]:
    """The check of a cell that states a ``decoder``, which promises that
    decode's own paths, not the optimum.  Checks: requests that failed;
    returned sequences (every completed one) of the wrong shape, with a
    state outside [-1, K), a run of -1 that is not a whole segment of the
    decoder's layout (``reference.segments``), or an edge or emission of
    probability 0 between positions that are not -1; sampled sequences
    whose path differs in any position, -1 included, from the reference's
    decode with the same numbers (limit 0: both sides make the same float32
    roundings and tie choices).  Reading: the sampled sequences whose path
    holds a -1 segment."""
    dec = cell.decoder
    params = {k: v for k, v in dec.items() if k != "algorithm"}
    T, Bs = w.T, w.Bs
    shaped = [(r, p) for r, (_, p) in enumerate(w.paths) if p.shape == (Bs, T)]
    invalid = Bs * (len(w.paths) - len(shaped))
    starts, lens = reference.segments(T, params["num_segments"])
    per_block = max(1, 2**24 // (Bs * T))
    for b in range(0, len(shaped), per_block):
        block = shaped[b:b + per_block]
        paths = np.concatenate([p for _, p in block]).astype(np.int64)
        gone = np.add.reduceat((paths == -1).astype(np.int64), starts, axis=1)
        partial = ((gone > 0) & (gone < np.asarray(lens))).any(axis=1)
        ys = torch.from_numpy(np.concatenate([s.pool[w.paths[r][0]] for r, _ in block])
                              .astype(np.int64)).to(s.device)
        got = reference.path_scores(s.A, s.B, s.Pi, ys, torch.from_numpy(paths).to(s.device),
                                    gaps=True).cpu().numpy()
        invalid += int((partial | ~np.isfinite(got)).sum())
    ok = {r for r, _ in shaped}
    picks = [(r, lane, pi) for r, lane, pi in sample(w, int(cell.check["sample"]), seed)
             if r in ok]
    mismatch = dropped = None
    if picks:
        ys = torch.from_numpy(np.stack([s.pool[pi][lane] for _, lane, pi in picks])
                              .astype(np.int64)).to(s.device)
        mine = np.stack([w.paths[r][1][lane] for r, lane, _ in picks]).astype(np.int64)
        want = getattr(reference, dec["algorithm"])(s.A, s.B, s.Pi, ys, **params).cpu().numpy()
        mismatch = int((mine != want).any(axis=1).sum())
        dropped = int((mine == -1).any(axis=1).sum())
    limits = cell.check["limits"]
    return ({"failed": {"value": w.failed, "limit": limits["failed"]},
             "invalid_paths": {"value": invalid, "limit": limits["invalid_paths"]},
             "path_mismatch": {"value": mismatch, "limit": limits["path_mismatch"]}},
            {"sampled_with_dropped_segment": dropped})


def passed(checks: dict) -> bool:
    """Every number present and within its limit (a score gap of None: no
    sampled path could be scored)."""
    return all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def card_facts(dev) -> dict:
    """The card's name, SMs, maximum SM clock and power limit (nvidia-smi;
    the data sheet's clock where it cannot say)."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "sms": bounds.H100.sms,
                "clock_hz": bounds.H100.clock_hz}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(idx), "count": 1,
             "sms": torch.cuda.get_device_properties(idx).multi_processor_count,
             "clock_hz": bounds.H100.clock_hz}
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(idx), "--query-gpu=power.limit,clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().split(",")
        facts["power_limit_w"] = float(out[0])
        facts["clock_hz"] = float(out[1]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        print(f"# nvidia-smi: {e}; the data sheet's SM clock", file=sys.stderr)
    return facts


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             control: bool = False, requests: int | None = None) -> dict:
    """One run: set-up, the window, the check; returns the result line's
    object (keys in the order printed, the judge's uncompared ``readings``
    where it has any, ``checks`` last).  ``requests`` ends
    an untraced window after that many completions (the control's
    readings)."""
    s = prepare(cell, seed, device, control)
    if traced:
        with trace.session() as rec:
            w = run_window(s, cell, seconds, traced=True)
    else:
        w = run_window(s, cell, seconds, traced=False, requests=requests)
    facts = card_facts(s.device)
    device_out = {k: facts[k] for k in ("platform", "kind", "count")}
    device_out["memory_peak_bytes"] = w.peak_bytes if w.peak_bytes is not None else 0
    if "power_limit_w" in facts:
        device_out["power_limit_w"] = facts["power_limit_w"]
    result = {"correct": False, "attempted": w.attempted, "failed": w.failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    extra = {}
    if traced:
        card = bounds.Card(sms=facts["sms"], clock_hz=facts["clock_hz"])
        floor, _ = bounds.floor_s(s.K, int(cell.config["M"]), w.T, w.Bs, card)
        tr = trace.Trace(ops=rec["ops"], spans=rec["spans"], window_s=w.seconds,
                         sequences=w.sequences, floor_s=floor * len(w.paths), K=s.K,
                         M=int(cell.config["M"]), T=w.T, Bs=w.Bs, decoder=cell.decoder,
                         card=card)
        lost = trace.lost_records(tr.ops, w.launches, _json("", "kernels"))
        if lost and s.device.type == "cuda":
            raise LostRecords("; ".join(lost))
        for m in cell.per_layer:
            v = _load("metrics", m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        device_out["busy_s"] = tr.busy_s
        device_out["window_s"] = tr.window_s
        extra["breakdown"] = trace.breakdown(tr)
    else:
        for m in cell.end_to_end:
            v = _load("endtoend", m["name"]).read(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    # the reference runs once the program's state is freed
    s.call = None
    s.lh = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, readings = judge(s, w, cell, seed)
    print(f"# reference check {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    result["correct"] = passed(checks)
    result["metrics"] = metrics
    result["device"] = device_out
    result.update(extra)
    if readings:
        result["readings"] = readings
    result["checks"] = checks
    return result


class LostRecords(RuntimeError):
    """The profiler recorded fewer of the port's kernels than it launched."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fvbench: the cell needs {cell.chips} CUDA device(s); this benchmark measures "
              "the card", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except LostRecords as e:
        print(f"fvbench: the profiler lost the port's kernels: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"fvbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The uncompared readings, then the numbers compared beside their
    limits as the last lines of standard error; then the result as the last
    line of standard output."""
    for name, v in result.get("readings", {}).items():
        print(f"reading {name} {v}", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
