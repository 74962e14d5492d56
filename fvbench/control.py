"""The readings a cell's limits are set from, on the card, in one process:
the program on each of ``--seeds`` and the control on each of
``--control-seeds``, each a short window at the cell's own load and sizes,
as many requests as hold the cell's sample, judged as ``run.py`` judges a
run.

    python3 -m fvbench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \\
        [--out FILE]

The control is the entry's own: its lower-precision path
(``precision="bf16"``), or, where the cell states a ``decoder``, the same
decode at half the beam; the reference at a bfloat16 table takes the
program's place where the entry has none (``run.prepare``).  Prints one JSON line a run: the side, the seed,
the numbers compared and the run's end-to-end metrics; ``--out`` appends
them to a file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from fvbench import run


def readings(workload: str, seeds, control_seeds, device="cuda", overrides=None, out=None):
    """Yield one record a run, the program's seeds first."""
    cell = run.load_cell(workload, overrides=overrides)
    per = int(cell.traffic["sequences_per_request"])
    requests = -(-int(cell.check["sample"]) // per)
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            r = run.run_cell(cell, seed, 3600.0, False, device, control=side == "control",
                             requests=requests)
            rec = {"workload": workload, "side": side, "seed": seed, "correct": r["correct"],
                   "checks": r["checks"], "metrics": r["metrics"], "device": r["device"],
                   "run_s": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")
            yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fvbench.control: no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    for _ in readings(args.workload, ints(args.seeds), ints(args.control_seeds), out=args.out):
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
