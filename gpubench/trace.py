"""torch.profiler over a bounded part of a window, reduced to what the
per-layer readers need: device operations with their intervals, host
runtime calls, and the host's operators (to name the idle gaps)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter

# CUDA runtime calls after which the host queues nothing until the
# device has drained
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# how many host events back to look for the one that covers an idle gap
LOOKBACK = 2000


def _external_id(e):
    return (e.get("args") or {}).get("External id")


class Reduced:
    """ops: [(name, start_us, end_us)] on the device; waits: host-wait
    calls; kernels: device ops that are kernels (not copies or sets);
    launched_by: for each kernel, the name of the host operator that
    launched it (the innermost, by the profiler's External id), or "";
    window_s: the traced span; busy_s: the union of the device ops'
    intervals; breakdown: the top device ops and idle gaps."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X"]
        op_of = {_external_id(e): e["name"] for e in xs
                 if e.get("cat") == "cpu_op" and _external_id(e) is not None}
        # a kernel names its launch's correlation; the launch its operator
        runtime = {(e.get("args") or {}).get("correlation"): _external_id(e)
                   for e in xs if e.get("cat") == "cuda_runtime"}
        dev = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0.0),
                e.get("cat", "")) for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0.0),
                 e.get("cat", "")) for e in events
                if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "cuda_runtime",
                                     "python_function", "user_annotation")]
        spans = [(s, t) for _, s, t, _ in dev + host]
        self.ops = [(n, s, t) for n, s, t, _ in dev]
        self.kernels = [(n, s, t) for n, s, t, c in dev if c == "kernel"]
        self.launched_by = []
        for e in xs:
            if e.get("cat") != "kernel":
                continue
            ext = _external_id(e)
            if ext is None:
                ext = runtime.get((e.get("args") or {}).get("correlation"))
            self.launched_by.append(op_of.get(ext, ""))
        self.waits = sum(1 for n, _, _, _ in host if n in HOST_WAITS)
        lo = min((s for s, _ in spans), default=0.0)
        hi = max((t for _, t in spans), default=0.0)
        self.window_s = (hi - lo) * 1e-6
        merged = union(self.ops)
        self.busy_s = sum(t - s for s, t in merged) * 1e-6
        self.breakdown = {
            "device_ops": top((n, (t - s) * 1e-6) for n, s, t in self.ops),
            "idle_gaps": top(gap_names(merged, host, lo, hi))}

    def op_kernel_time(self, match):
        """(seconds, launches) of the kernels launched by a host operator
        whose name `match` accepts."""
        sel = [(s, t) for (_, s, t), op in zip(self.kernels,
                                               self.launched_by)
               if match(op)]
        return sum(t - s for s, t in sel) * 1e-6, len(sel)


def idle_share(ctx, work_key):
    """The share (%) of the traced wall time that the union of device
    operations does not cover, where the run profiled some `work_key`
    (the profiled iterations) and the device ran something."""
    t = ctx.trace_data
    if t is None or not ctx.work.get(work_key) or t.window_s <= 0 \
            or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def top(pairs, n=10):
    """The n names with the most seconds, of (name, seconds) pairs."""
    total = Counter()
    for k, v in pairs:
        total[k] += v
    return [[k[:120], v] for k, v in total.most_common(n)]


def union(intervals):
    """Sorted, merged [(start, end)] of (name, start, end) intervals."""
    out = []
    for s, t in sorted((s, t) for _, s, t in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def gap_names(merged, host, lo, hi):
    """(what the host was doing, seconds) for each idle gap of the
    device: the innermost host event that covers the gap's middle."""
    edges = [lo] + [x for s, t in merged for x in (s, t)] + [hi]
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "(no host event)"
        # the latest-starting host event that still covers the middle
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - LOOKBACK, -1), -1):
            if host[i][2] >= mid:
                name = host[i][0]
                break
        yield name, (b - a) * 1e-6


def profile(fn, device_type):
    """fn() under torch.profiler (CPU and, on a card, CUDA activity),
    its chrome trace reduced -> Reduced. The trace file lives in TMPDIR
    and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        fn()
        if device_type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    red = Reduced(events)
    if device_type == "cuda":
        # the synchronize that closes the profiled part is not the
        # program's
        red.waits -= 1
    return red
