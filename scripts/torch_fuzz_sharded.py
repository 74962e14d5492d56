"""Randomized drive of the PyTorch port's sharded FLASH decode.

Random meshes ``(n_data, n_seq, n_state)`` over gloo worlds of 2, 4 and 8
ranks, each world spawned once (``parallel.multihost.launch_workers``, this
script with rank arguments) and running all of its draws.  A draw takes
K 64-512, T 32-512, prob 0.05-0.3 (every fourth draw the tie-flip regime,
K 256-512, T 256-1024), a batch of ``n_data`` or twice as many sequences
(two distinct ones, alternating), segments rounded to a multiple of
``n_seq`` (``fuzz_hunt.py:149``), a microbatch that divides the shard and
``pipeline`` "auto", True or False; True on a shape the pipeline cannot
split must raise ValueError, and the draw then runs "auto".  Each rank's
``flash_decode_sharded`` output must equal the single-device ``decode(...,
"flash", num_segments=segs, pad_to=8)`` of every sequence bit for bit on
the same device (``fuzz_hunt.py:162-167``: flash, not vanilla, which flash
may tie-flip against).

On the card every rank of a world runs on ``cuda:0`` with gloo (NCCL
refuses two ranks on one GPU); on the CPU each rank takes one thread.
Imports only the port and numpy::

    python3 scripts/torch_fuzz_sharded.py [n_rounds] [seed0] [--device cuda|cpu]

Draw i goes to the world ``WORLDS[i % 3]`` with seed ``seed0 + i``.  One
line a draw, then a ``DONE:`` line; exits 1 if any draw failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLDS = (2, 4, 8)
DEFAULT = (54, 60_000)
PAD = 8
WORLD_TIMEOUT_S = 3000.0


def meshes(world: int) -> list[tuple[int, int, int]]:
    return [(d, s, world // (d * s)) for d in range(1, world + 1) if world % d == 0
            for s in range(1, world // d + 1) if (world // d) % s == 0]


def draw(seed: int, world: int) -> dict:
    rng = np.random.RandomState(seed)
    if seed % 4 == 0:  # the tie-flip regime
        K, T = int(rng.randint(256, 513)), int(rng.randint(256, 1025))
    else:
        K, T = int(rng.randint(64, 513)), int(rng.randint(32, 513))
    p = dict(seed=seed, K=K, T=T, M=int(rng.randint(4, 40)), prob=float(rng.uniform(0.05, 0.3)))
    opts = meshes(world)
    p["mesh"] = opts[int(rng.randint(len(opts)))]
    n_data, n_seq, _ = p["mesh"]
    p["nb"] = n_data * int(rng.choice([1, 2]))
    segs = int(rng.randint(2, 9))
    p["segs"] = max(n_seq, (segs // n_seq) * n_seq)
    shard = p["nb"] // n_data
    p["mb"] = int(rng.choice([m for m in range(1, shard + 1) if shard % m == 0]))
    p["pipeline"] = ["auto", True, False][int(rng.randint(3))]
    return p


def ctx(p: dict) -> str:
    return (f"seed={p['seed']} K={p['K']} T={p['T']} M={p['M']} prob={p['prob']:.3f} "
            f"mesh={tuple(p['mesh'])} nb={p['nb']} segs={p['segs']} mb={p['mb']} "
            f"pipeline={p['pipeline']}")


def problem(p: dict):
    """(HMM, the (nb, T) batch: the draw's sequence and a second one, alternating)."""
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hmm, y = make_sparse_hmm(K=p["K"], M=p["M"], T=p["T"], prob=p["prob"], seed=p["seed"])
    y2 = np.random.RandomState(p["seed"] + 1).randint(0, p["M"], size=p["T"])
    ys = np.stack([y if b % 2 == 0 else y2 for b in range(p["nb"])]).astype(np.int32)
    return hmm, ys


def rank_round(p: dict, mesh, device) -> dict:
    """One draw on this rank: the sharded decode against the single-device
    flash decode of each distinct sequence.  Returns {"failures", "ms",
    "path": "pipelined" or "legacy"}."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.parallel.sharded import _pipeline_plan, flash_decode_sharded

    hmm, ys = problem(p)
    lh = hmm.log(device=device).padded(PAD)
    out = {"failures": []}
    pipeline = p["pipeline"]
    plan = _pipeline_plan(p["T"], p["mesh"][1], p["segs"])
    if pipeline is True and plan is None:
        try:
            flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys, num_segments=p["segs"],
                                 microbatch=p["mb"], pipeline=True)
            out["failures"].append("pipeline=True on an uneven shape did not raise")
        except ValueError:
            pass
        pipeline = "auto"
    out["path"] = "legacy" if pipeline is False or plan is None else "pipelined"
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    paths = flash_decode_sharded(mesh, lh.logA, lh.logB, lh.logPi, ys, num_segments=p["segs"],
                                 microbatch=p["mb"], pipeline=pipeline).cpu().numpy()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    want = {}
    for b, row in enumerate(ys):
        key = row.tobytes()
        if key not in want:
            want[key] = decode(hmm, row, "flash", num_segments=p["segs"], pad_to=PAD,
                               device=device, warmup=False).path
        if paths.shape != ys.shape or not np.array_equal(paths[b], want[key]):
            out["failures"].append(f"sequence {b} differs from the single-device flash decode")
    return out


def rank_draws(params: list[dict], rank: int, device, outdir: str) -> None:
    """Every draw of ``params`` on this rank of the initialised world, each
    draw's record written as ``draw<seed>.rank<rank>.json`` in ``outdir``.
    An exception fails its draw; the rank goes on to the next."""
    from flash_viterbi_tpu_torch.parallel.sharded import make_mesh

    made = {}
    for p in params:
        t0 = time.perf_counter()
        try:
            shape = tuple(p["mesh"])
            if shape not in made:
                made[shape] = make_mesh(*shape)
            rec = rank_round(p, made[shape], device)
        except Exception as e:
            rec = {"failures": [f"{type(e).__name__}: {e}"], "trace": traceback.format_exc()}
        rec["s"] = time.perf_counter() - t0
        with open(os.path.join(outdir, f"draw{p['seed']}.rank{rank}.json"), "w") as f:
            json.dump(rec, f)


def rank_main(init_method: str, rank: str, world: str, outdir: str) -> None:
    """One rank of a world started by :func:`run_world` (the job in
    ``FVT_FUZZ_JOB``)."""
    from flash_viterbi_tpu_torch.parallel import multihost

    job = json.loads(os.environ["FVT_FUZZ_JOB"])
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = torch.device(job["device"], 0) if job["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(init_method, int(world), int(rank), backend="gloo")
    rank_draws(job["draws"], int(rank), device, outdir)
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


def world_results(params: list[dict], world: int, outdir: str) -> list[tuple[dict, list, dict]]:
    """(draw, its failures over every rank, rank 0's record) a draw."""
    out = []
    for p in params:
        fails, rec0 = [], {}
        for r in range(world):
            name = os.path.join(outdir, f"draw{p['seed']}.rank{r}.json")
            if not os.path.exists(name):
                fails.append(f"rank {r}: no record")
                continue
            with open(name) as f:
                rec = json.load(f)
            if r == 0:
                rec0 = rec
            fails += [f"rank {r}: {m}" for m in rec["failures"]]
        out.append((p, fails, rec0))
    return out


def run_world(params: list[dict], world: int, device: str, outdir: str) -> tuple[list, float, str]:
    """Spawn a world of ``world`` ranks that runs ``params``; returns (the
    per-draw results, the seconds, the launch error or "")."""
    from flash_viterbi_tpu_torch.parallel.multihost import launch_workers

    t0 = time.perf_counter()
    err = ""
    try:
        launch_workers(os.path.abspath(__file__), world, outdir, timeout=WORLD_TIMEOUT_S,
                       env={"FVT_FUZZ_JOB": json.dumps({"draws": params, "device": device})})
    except RuntimeError as e:
        err = str(e)
    return world_results(params, world, outdir), time.perf_counter() - t0, err


def run(n_rounds: int, seed0: int, device: str) -> int:
    from scripts.torch_fuzz_midscale import card_line

    t_start = time.perf_counter()
    print(f"# torch_fuzz_sharded: {n_rounds} rounds from seed0 {seed0}, worlds {WORLDS}, "
          f"ranks on {'cuda:0 (gloo)' if device == 'cuda' else 'the CPU (gloo)'}", flush=True)
    if device == "cuda":
        print(f"# card: {card_line()}", flush=True)
    by_world = {w: [] for w in WORLDS}
    for i in range(n_rounds):
        w = WORLDS[i % len(WORLDS)]
        by_world[w].append(draw(seed0 + i, w))
    failed, clean, paths = [], 0, {"pipelined": 0, "legacy": 0}
    for w, params in by_world.items():
        if not params:
            continue
        with tempfile.TemporaryDirectory() as outdir:
            results, secs, err = run_world(params, w, device, outdir)
        for p, fails, rec0 in results:
            if fails:
                failed.append((p["seed"], fails))
            else:
                clean += 1
                paths[rec0["path"]] += 1
            print(f"[world {w}] {'FAIL ' + '; '.join(fails) if fails else 'ok'} {ctx(p)} "
                  f"path={rec0.get('path')} rank 0: {rec0.get('ms', float('nan')):.1f} ms "
                  f"sharded, {rec0.get('s', float('nan')):.1f} s with its references", flush=True)
        print(f"# world {w}: {len(params)} draws in {secs:.1f} s with start-up"
              f"{'; launch error: ' + err[-2000:] if err else ''}", flush=True)
    print(f"DONE: {clean}/{n_rounds} clean rounds on {device} over worlds {WORLDS} "
          f"(pipelined {paths['pipelined']}, legacy {paths['legacy']}); failures: {failed}; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rounds", nargs="?", type=int, default=DEFAULT[0])
    ap.add_argument("seed0", nargs="?", type=int, default=DEFAULT[1])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_fuzz_sharded: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    return run(args.n_rounds, args.seed0, args.device)


if __name__ == "__main__":
    if len(sys.argv) == 5 and "FVT_FUZZ_JOB" in os.environ:  # one rank of a world
        rank_main(*sys.argv[1:])
    else:
        sys.exit(main())
