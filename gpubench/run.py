"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard
output: {"correct", "attempted", "failed", "metrics", "device",
["breakdown"], "checks"}. With --trace 0 the metrics are the cell's
end-to-end ones, with --trace 1 its per-layer ones. Exits non-zero, with
no result, when there is no card, too few cards, or a JAX module was
loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.time()
# one process with few threads: the program's host work is one thread
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    from gpubench import harness
    start = harness.process_start() or T_IMPORT
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    spec = harness.spec()
    chips = harness.workload(spec, args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    # f32 matmuls and convolutions in full precision, as configured
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(args.workload, args.seed, args.seconds,
                          args.trace, torch.device("cuda", 0), start=start)
    out = measure(ctx, chips, torch.cuda.get_device_name(0))
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


def measure(ctx, chips, kind):
    """Drive the cell, then -> its result line (the compared numbers
    printed to standard error first), or None when a forbidden module
    was loaded."""
    from gpubench import harness
    harness.load_driver(ctx.traffic["driver"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded in a run: {found}",
              file=sys.stderr)
        return None
    metrics = harness.read_metrics(
        ctx, harness.metrics_for(ctx.spec, ctx.cell, ctx.trace))
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(ctx.record["memory_peak_bytes"])}
    if ctx.trace and ctx.trace_data is not None:
        device["busy_s"] = ctx.trace_data.busy_s
        device["window_s"] = ctx.trace_data.window_s
    for name, (value, limit) in ctx.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    return harness.result_line(ctx, metrics, device)


if __name__ == "__main__":
    sys.exit(main())
