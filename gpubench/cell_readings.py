"""The readings that the limits of the data-parallel and the stage-3
cells are set from, on the card.

    python gpubench/cell_readings.py --workload <cell> --seconds <s>
        [--control | --fault <name>] --seeds <n> [<n> ...]

readings.py for cells whose driver plants the fault itself (in every
rank's process, for the data-parallel one): the fault is one of
faults.py's or cell_faults.py's, handed to the driver in the run's
overrides. One JSON line per seed with each compared number, the worst
leaves and the run's peak memory. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    import torch
    from gpubench import cell_faults, harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(cell_faults.FAULTS))
    ap.add_argument("--warmup-iters", type=int,
                    help="in place of the traffic's warmup_iters (0: the "
                    "checked round alone, with --seconds 0)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        overrides = {"control": args.control}
        if args.fault:
            overrides["fault"] = args.fault
        if args.warmup_iters is not None:
            overrides["warmup_iters"] = args.warmup_iters
        ctx = harness.Context(args.workload, seed, args.seconds, 0,
                              torch.device("cuda", 0), overrides=overrides)
        torch.cuda.reset_peak_memory_stats()
        harness.load_driver(ctx.traffic["driver"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "checks": {k: v for k, (v, _) in
                                     ctx.checks.items()},
                          "worst_leaves": ctx.record.get("worst_leaves"),
                          "world": ctx.record.get("world"),
                          "iterations": ctx.record.get("iterations"),
                          "window_s": ctx.record.get("window_s"),
                          "memory_peak_bytes": ctx.record.get(
                              "memory_peak_bytes")}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
