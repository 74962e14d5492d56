"""``python -m flash_viterbi_tpu_torch.probes [names] [--device cpu]``:
run the probes and print one JSON line a variant."""

from __future__ import annotations

import argparse
import json

from . import PROBES, run


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flash_viterbi_tpu_torch.probes",
                                     description=__doc__)
    parser.add_argument("names", nargs="*", choices=list(PROBES),
                        help="probes to run (default: all)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    for name in args.names or PROBES:
        for rec in run([name], device=args.device):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
