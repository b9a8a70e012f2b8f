"""What every cell shares: finding its files by name, the run's context,
the import check, the metrics, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "nvsr_tpu")
# keys of a config file that document it and are not passed on
DOC_KEYS = ("source", "changed", "assumed")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def workload(spec_, name):
    for w in spec_["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec_, name):
    for c in spec_["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def experiment_config(config):
    """The configuration as the program reads it: a copy of the config
    file less the keys that document it."""
    return json.loads(json.dumps({k: v for k, v in config.items()
                                  if k not in DOC_KEYS}))


def cell_files(spec_, cell, root=ROOT):
    """The files a cell is made of, found by name: its config, its mix,
    its limits and its mix's driver."""
    w = workload(spec_, cell)
    cfg_path = Path(root) / config_entry(spec_, w["config"])["file"]
    mix_path = HERE / "traffic" / f"{w['traffic']}.json"
    mix = load_json(mix_path)
    return {"config": cfg_path, "traffic": mix_path,
            "limits": HERE / "limits" / f"{cell}.json",
            "driver": HERE / "drivers" / f"{mix['driver']}.py"}


def load_metric(name):
    """The reader module of metric `name` (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "gpubench_metric_" + re.sub(r"\W", "_", name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def load_driver(name):
    return importlib.import_module(f"gpubench.drivers.{name}")


def metrics_for(spec_, cell, trace):
    """The metric entries a run of `cell` reports: the end-to-end ones
    with --trace 0, the per-layer ones with --trace 1; an entry with a
    "workloads" key only in the cells it lists."""
    entries = spec_["per_layer"] if trace else spec_["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def process_start():
    """This process's start on the time.time() clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Context:
    """One run: the cell's names, data, seed, device and overrides. The
    drivers fill `record` (host-clock readings of the window),
    `trace_data` (trace.Reduced of the profiled part), `work` (what the
    profiled part did, for the roofline and MFU readers) and `checks`
    ({name: (value, limit)})."""

    def __init__(self, cell, seed, seconds, trace, device, root=ROOT,
                 overrides=None, start=None):
        s = spec(root)
        w = workload(s, cell)
        files = cell_files(s, cell, root)
        self.spec, self.cell, self.workload = s, cell, w
        self.config = load_json(files["config"])
        self.traffic = load_json(files["traffic"])
        self.limits = load_json(files["limits"]) \
            if files["limits"].exists() else {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = device
        self.overrides = overrides or {}
        self.start = start if start is not None else time.time()
        self.record, self.trace_data, self.work = {}, None, {}
        self.checks = {}
        self.peaks = load_json(HERE / "peaks.json")

    def note(self, what):
        """A set-up phase's end, in seconds since the process started, on
        standard error."""
        print(f"[setup] {what} at {time.time() - self.start:.3f} s",
              file=sys.stderr, flush=True)

    def param(self, key):
        """A traffic parameter, or its override (the CPU tests' sizes)."""
        return self.overrides.get(key, self.traffic.get(key))


def read_metrics(ctx, entries):
    """{name: {"value", "unit"}} of the entries whose readers find
    something to read."""
    out = {}
    for m in entries:
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def correct_of(checks):
    """Each compared number must be finite and at most its limit."""
    return bool(checks) and all(v == v and v <= lim
                                for v, lim in checks.values())


def result_line(ctx, metrics, device):
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in ctx.checks.items()}
    out = {"correct": correct_of(ctx.checks),
           "attempted": ctx.record.get("attempted", 0),
           "failed": ctx.record.get("failed", 0),
           "metrics": metrics, "device": device}
    if ctx.trace and ctx.trace_data is not None:
        out["breakdown"] = ctx.trace_data.breakdown
    out["checks"] = checks
    return out
