"""The closed training loop of drivers/train.py, for the drivers that set
their Experiment up another way (train_dp.py: one process a rank;
train_refine.py: from a logdir that set-up writes): the checked rounds,
the warm-up to a round's end, then the window of whole rounds, with the
profiled iterations inside it under --trace 1.

Under data parallelism every rank runs this loop in step: `share(flag)`
returns rank 0's flag on every rank (collective), and only rank 0
(`main`) keeps the checked iterations, profiles and fills the run's
record."""

from __future__ import annotations

import time
from collections import Counter

from gpubench.drivers import train


def edited(raw, *edits):
    """`raw` with each {dotted key: value} of `edits` set in turn."""
    for edit in edits:
        for key, value in edit.items():
            node = raw
            *path, last = key.split(".")
            for p in path:
                node = node[p]
            node[last] = value
    return raw


def drive(ctx, exp, draws, raw, dev, main=True, share=lambda flag: flag,
          work_kind=lambda kind: kind):
    """Train `exp` through the checked rounds, the warm-up and the window.
    -> the program's checked numbers {"losses", "first_grad", "after"}
    (main), else None. ctx.record, ctx.work (each iteration's work by
    `work_kind` of its kind) and ctx.trace_data are filled on main."""
    import torch
    from gpubench import trace as tr
    cuda = dev.type == "cuda"
    it, first_grad = 0, {}
    for _ in range(ctx.param("check_rounds")):
        while True:
            exp.train_iteration(it)
            if main:
                train._first_grads(exp, first_grad)
            it += 1
            if draws.at_round_start():
                break
    n_check = it
    draws.recording = False
    program = None
    if main:
        program = {
            "losses": [float(m[3][0])
                       for m in exp._pending_metrics[:n_check]],
            "first_grad": sorted(first_grad.items()),
            "after": [(f"{prefix}{p}", t.detach().clone())
                      for prefix, params, _ in train._opt_groups(exp)
                      for p, t in train._leaf_items(params)]}
    ctx.note(f"{n_check} checked iterations")
    # at least warmup_iters more, up to the end of a round, so that the
    # window starts a round
    warm_end = it + ctx.param("warmup_iters")
    while it < warm_end or not draws.at_round_start():
        exp.train_iteration(it)
        it += 1
    exp.flush_train_metrics()
    if cuda:
        torch.cuda.synchronize()
    if main:
        ctx.record["setup_s"] = time.time() - ctx.start

    every = int(raw["experiment"].get("print_every", 100))
    n_trace = ctx.param("trace_iters") if main and ctx.trace else 0
    done, traced = 0, []
    window_kinds = len(draws.kinds)
    t0 = time.perf_counter()
    end = t0 + (ctx.seconds if main else 0.0)
    # whole rounds: every run does the mix's work in its proportions
    while not draws.at_round_start() or share(time.perf_counter() < end):
        if done == ctx.param("trace_skip") and share(bool(n_trace)):
            n, first, k0 = ctx.param("trace_iters"), it, len(draws.kinds)

            def profiled():
                for j in range(first, first + n):
                    exp.train_iteration(j)

            if main:
                t = time.perf_counter()
                ctx.trace_data = tr.profile(profiled, dev.type)
                ctx.record["traced_s"] = time.perf_counter() - t
                ctx.record["traced_iterations"] = n
                traced = draws.kinds[k0:]
            else:
                profiled()
            it += n
            done += n
        else:
            exp.train_iteration(it)
            it += 1
            done += 1
        if done % every == 0:
            exp.flush_train_metrics()
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    exp.flush_train_metrics()
    if main:
        ctx.record.update(window_s=window, iterations=done, attempted=done,
                          failed=0, round=list(draws.mix))
        ctx.record["memory_peak_bytes"] = \
            torch.cuda.max_memory_allocated(dev) if cuda else 0
        untraced = Counter(work_kind(k) for k in draws.kinds[window_kinds:])
        untraced.subtract(Counter(work_kind(k) for k in traced))
        ctx.work = {"traced": [work_kind(k) for k in traced],
                    "untraced": dict(untraced),
                    "rays": int(raw["nerf"]["train"]["num_random_rays"]),
                    "n_coarse": int(raw["nerf"]["train"]["num_coarse"]),
                    "n_fine": int(raw["nerf"]["train"]["num_fine"])}
    return program
