"""allreduce_bytes_per_iter.stage1_dp4: the bytes that rank 0's
all_reduce carried in the profiled iterations (the `reduce` spans' arg
`bytes`, which the program reads from parallel.sharding.COLLECTIVES),
over the iterations. None where the program's `reduce` span has no such
arg."""


def read(ctx):
    try:
        from nvsr_tpu_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    roots = {r["index"] for r in recs if r["name"] == "train_iteration"}
    n = len(ctx.work.get("traced") or ())
    spans = [r for r in recs if r["name"] == "reduce"
             and r["parent"] in roots and "bytes" in r["args"]]
    if not spans or len(roots) != n:
        return None
    return sum(r["args"]["bytes"] for r in spans) / n
