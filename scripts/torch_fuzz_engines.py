"""Randomized drive of the PyTorch port's dynamic-median SIEVE decoders.

The port's counterpart of ``scripts/fuzz_engines.py``: ``sieve_bs`` and
``sieve`` / ``sieve_dag`` on random problems drawn as that script draws
them (``default_rng(seed0)``: K 96-512, T 48-256, near-tie edge densities,
DAG inputs with ``sanitize=True``, beams of 2-32).  A dense DAG drives the
forward beam up to the last states, so under a beam narrower than about T
``sieve_bs`` decodes to one ``(-1, -1)`` pair: DAG draws take T 48 or 64
and a beam of 2T (``torch_fuzz_sieve_bs.py``'s rule), and a draw that
still decodes to that one pair is counted apart as degenerate.

The port has one engine, the level scheduler, so each draw's pair lists
(``sieve_bs_decode_many`` and ``sieve_dynamic_decode_many`` with the draw's
``dag``, on the card) must equal:

* the port's CPU decode of the same decoder (made in a worker process,
  card mode only);
* the oracles: ``oracle.framework.sieve_bs`` (the fp32 mirror) exactly,
  and ``oracle.sieve.sieve_dynamic`` / ``sieve_dag`` (float64) off exact
  fp ties: a pair list off the float64 oracle's passes as a tie only where
  its path is finite and within the f64 score tolerance of the oracle's
  (``oracle.validate``); such draws are counted apart;
* every fifth draw: a batch of three sequences equals the per-sequence
  decodes, for both decoders.

Any exception fails its draw and the run goes on; a CUDA error stops the
run at that draw.  The card mode imports only the port and numpy::

    python3 scripts/torch_fuzz_engines.py [n_rounds] [seed0] [--device cuda|cpu]
    python3 scripts/torch_fuzz_engines.py [n_rounds] [seed0] --against-jax

``--against-jax`` runs on the CPU and also holds the port's ``sieve`` /
``sieve_dag`` against the JAX package's ``sieve_dynamic_decode_many`` at
``engine="device"`` and ``engine="host"`` (it imports JAX).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os
import sys
import time
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts.torch_fuzz_midscale import card_line, is_cuda_error  # noqa: E402

DEFAULT = (25, 50_000)
WORKERS = 3
WORKER_THREADS = 2
BATCH_EVERY = 5


def draws(n_rounds: int, seed0: int) -> list[dict]:
    """The draws of ``fuzz_engines.py:39-52``, DAG draws resized."""
    rng = np.random.default_rng(seed0)
    out = []
    for i in range(n_rounds):
        p = dict(i=i, K=int(rng.choice([96, 128, 160, 256, 384, 512])),
                 T=int(rng.choice([48, 64, 96, 128, 192, 256])), M=int(rng.integers(4, 40)),
                 prob=float(rng.choice([0.02, 0.05, 0.1, 0.2])),
                 seed=int(rng.integers(0, 10_000)), dag=bool(rng.integers(0, 3) == 0),
                 bw=int(rng.choice([2, 4, 8, 16, 32])))
        if p["dag"]:  # sizes whose trees recurse
            p["T"] = 48 if p["T"] <= 96 else 64
            p["bw"] = 2 * p["T"]
        out.append(p)
    return out


def ctx(p: dict) -> str:
    return " ".join(f"{k}={p[k]}" for k in ("K", "T", "M", "prob", "seed", "dag", "bw"))


def draw_line(p: dict, r: dict, secs: float) -> str:
    """A draw's line: its verdict, parameters, pair counts, tie and
    degenerate marks and seconds."""
    return (f"{'FAIL ' + '; '.join(r['failures']) if r['failures'] else 'ok'} {ctx(p)} "
            f"sequences={1 + (p['i'] % BATCH_EVERY == 0) * 2} "
            f"pairs(sieve_bs, {'sieve_dag' if p['dag'] else 'sieve'})={r['pairs']}"
            f"{' TIE ' + ','.join(r['ties']) if r['ties'] else ''}"
            f"{' DEGENERATE' if r['degenerate'] else ''} {secs:.1f} s")


def make(p: dict):
    """(HMM, (S, T) int64 sequences: the draw's, and two more every fifth)."""
    from flash_viterbi_tpu_torch.models.generate import make_dag_hmm, make_sparse_hmm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if p["dag"]:
            hmm, y = make_dag_hmm(K=p["K"], M=p["M"], T=p["T"], seed=p["seed"], sanitize=True)
        else:
            hmm, y = make_sparse_hmm(K=p["K"], M=p["M"], T=p["T"], prob=p["prob"],
                                     seed=p["seed"])
    ys = np.asarray(y, dtype=np.int64)[None]
    if p["i"] % BATCH_EVERY == 0:
        more = np.random.default_rng(p["seed"] + 1).integers(0, p["M"], size=(2, p["T"]))
        ys = np.concatenate([ys, more.astype(np.int64)])
    return hmm, ys


def pairs(many) -> list:
    return [[[int(v) for v in pr] for pr in one] for one in many]


def decode_pairs(hmm, ys, p: dict, device) -> dict:
    """The port's pair lists of every sequence of ``ys`` on ``device``:
    ``sieve_bs`` at the draw's beam, and ``sieve`` or ``sieve_dag``."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import sieve_bs_decode_many
    from flash_viterbi_tpu_torch.algorithms.sieve_dyn import sieve_dynamic_decode_many

    lh = hmm.log(device=device)
    tbl = (lh.logA, lh.logB, lh.logPi)
    return {"sieve_bs": pairs(sieve_bs_decode_many(*tbl, ys, p["bw"])),
            "dyn": pairs(sieve_dynamic_decode_many(*tbl, ys, dag=p["dag"]))}


def reference(p: dict, cpu_decode: bool) -> dict:
    """A worker's record of draw ``p``: the oracles' pair lists of its first
    sequence and, with ``cpu_decode``, the port's CPU decode of it; with
    the seconds each took."""
    from flash_viterbi_tpu_torch.oracle import framework as ofw
    from flash_viterbi_tpu_torch.oracle.sieve import sieve_dag, sieve_dynamic

    hmm, ys = make(p)
    rec, y = {}, ys[0]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec["mirror_bs"] = pairs([ofw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=p["bw"])])[0]
        t1 = time.perf_counter()
        oracle = sieve_dag if p["dag"] else sieve_dynamic
        rec["oracle_dyn"] = pairs([oracle(hmm.A, hmm.B, hmm.Pi, y)])[0]
    t2 = time.perf_counter()
    rec["s"] = {"mirror_bs": t1 - t0, "oracle_dyn": t2 - t1}
    if cpu_decode:
        cpu = decode_pairs(hmm, ys[:1], p, "cpu")
        rec["cpu_bs"], rec["cpu_dyn"] = cpu["sieve_bs"][0], cpu["dyn"][0]
        rec["s"]["cpu"] = time.perf_counter() - t2
    return rec


def tie_equivalent(hmm, y, got: list, want: list) -> bool:
    """``got`` off the float64 oracle's ``want`` only by an exact fp tie:
    its path finite and within the f64 score tolerance of the oracle's."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs
    from flash_viterbi_tpu_torch.oracle.validate import path_score_f64, score_tolerance_f64

    T = len(y)
    pg, pw = _flatten_pairs(got, T), _flatten_pairs(want, T)
    if (pg < 0).any() or (pw < 0).any():
        return False
    with np.errstate(divide="ignore", invalid="ignore"):
        sg = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, pg)
        sw = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, pw)
    return bool(np.isfinite(sg) and abs(sg - sw) <= score_tolerance_f64(T, sw))


def jax_pairs(hmm, ys, dag: bool) -> dict:
    """The JAX package's ``sieve_dynamic_decode_many`` at both engines
    (``--against-jax`` only)."""
    import jax.numpy as jnp

    import flash_viterbi_tpu as jfv
    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode_many

    jl = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
    tbl = (jnp.asarray(jl.logA), jnp.asarray(jl.logB), jnp.asarray(jl.logPi))
    return {e: pairs(sieve_dynamic_decode_many(*tbl, ys, dag=dag, engine=e))
            for e in ("device", "host")}


def one_round(p: dict, device="cuda", ref=None, against_jax: bool = False) -> dict:
    """Draw ``p``'s checks on ``device`` against ``ref`` (a
    :func:`reference` record; made here if None).  Returns {"failures",
    "ties", "degenerate", "pairs"}."""
    hmm, ys = make(p)
    if ref is None:
        ref = reference(p, cpu_decode=torch.device(device).type != "cpu")
    got = decode_pairs(hmm, ys, p, device)
    out = {"failures": [], "ties": [], "degenerate": got["sieve_bs"][0] == [[-1, -1]],
           "pairs": (len(got["sieve_bs"][0]), len(got["dyn"][0]))}

    def check(name, ok):
        if not ok:
            out["failures"].append(name)

    dyn = "sieve_dag" if p["dag"] else "sieve"
    if "cpu_bs" in ref:
        check("sieve_bs != CPU decode", got["sieve_bs"][0] == ref["cpu_bs"])
        check(f"{dyn} != CPU decode", got["dyn"][0] == ref["cpu_dyn"])
    check("sieve_bs != fp32 mirror", got["sieve_bs"][0] == ref["mirror_bs"])
    if got["dyn"][0] != ref["oracle_dyn"]:
        if tie_equivalent(hmm, ys[0], got["dyn"][0], ref["oracle_dyn"]):
            out["ties"].append(dyn)
        else:
            check(f"{dyn} != float64 oracle", False)
    if len(ys) > 1:
        for s in range(1, len(ys)):
            one = decode_pairs(hmm, ys[s:s + 1], p, device)
            check(f"sieve_bs batched != single at sequence {s}",
                  got["sieve_bs"][s] == one["sieve_bs"][0])
            check(f"{dyn} batched != single at sequence {s}", got["dyn"][s] == one["dyn"][0])
    if against_jax:
        for engine, want in jax_pairs(hmm, ys[:1], p["dag"]).items():
            check(f"{dyn} != JAX engine={engine}", got["dyn"][:1] == want)
    return out


def _worker_init() -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(WORKER_THREADS)


def run(n_rounds: int, seed0: int, device: str, against_jax: bool) -> int:
    t_start = time.perf_counter()
    mode = "CPU against JAX's engines" if against_jax else device
    print(f"# torch_fuzz_engines: {n_rounds} rounds from seed0 {seed0}, {mode}", flush=True)
    if device == "cuda":
        print(f"# card: {card_line()}", flush=True)
    if against_jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
    ps = draws(n_rounds, seed0)
    failures, ties, degenerate = [], [], []
    with concurrent.futures.ProcessPoolExecutor(
            WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init) as pool:
        refs = [pool.submit(reference, p, device == "cuda") for p in ps]
        try:
            for p, ref in zip(ps, refs):
                t0 = time.perf_counter()
                try:
                    r = one_round(p, device, ref.result(), against_jax)
                except Exception as e:  # any exception fails the draw
                    what = f"{type(e).__name__}: {e}"
                    print(f"[{p['i']}] FAIL {ctx(p)}: {what}", flush=True)
                    traceback.print_exc()
                    failures.append((p["i"], [what]))
                    if is_cuda_error(e):
                        print(f"STOP: a CUDA error leaves the context unusable; draw "
                              f"{ctx(p)}", flush=True)
                        break
                    continue
                if r["failures"]:
                    failures.append((p["i"], r["failures"]))
                if r["ties"]:
                    ties.append(p["i"])
                if r["degenerate"]:
                    degenerate.append(p["i"])
                worker = ", ".join(f"{k} {v:.1f} s" for k, v in ref.result()["s"].items())
                print(f"[{p['i']}] {draw_line(p, r, time.perf_counter() - t0)} (worker: {worker})",
                      flush=True)
        finally:
            for f in refs:
                f.cancel()
    print(f"done: {n_rounds - len(failures)}/{n_rounds} ok on {mode} in "
          f"{time.perf_counter() - t_start:.1f} s; tie draws (off the float64 oracle by an "
          f"exact fp tie): {len(ties)} {ties}; degenerate draws (one sentinel pair): "
          f"{len(degenerate)} {degenerate}; failures: {failures}", flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rounds", nargs="?", type=int, default=DEFAULT[0])
    ap.add_argument("seed0", nargs="?", type=int, default=DEFAULT[1])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--against-jax", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.against_jax else args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_fuzz_engines: no CUDA device (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    return run(args.n_rounds, args.seed0, device, args.against_jax)


if __name__ == "__main__":
    sys.exit(main())
