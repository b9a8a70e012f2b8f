"""The readings that a cell's limits are set from, on the card.

    python gpubench/readings.py --workload <cell> --seconds <s>
        [--control | --fault <name>] --seeds <n> [<n> ...]

Drives the cell once per seed in this one process, with a short window,
and prints each compared number (JSON, one line per seed): with
--control the reference computed in the precision below the
configuration's (TF32 for its f32) stands in for the program; with
--fault the program runs with a fault of faults.py planted. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    import contextlib

    import torch
    from gpubench import faults, harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        ctx = harness.Context(args.workload, seed, args.seconds, 0,
                              torch.device("cuda", 0),
                              overrides={"control": args.control})
        with (faults.FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            harness.load_driver(ctx.traffic["driver"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "checks": {k: v for k, (v, _) in
                                     ctx.checks.items()},
                          "worst_leaves": ctx.record.get("worst_leaves")}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
