"""The program's own spans (`nvsr_tpu_torch.utils.tracing`), read after
a traced run: the training iteration's phases on the device's clock."""


def phase_ms(ctx, phase):
    """The device-stream ms of the spans named `phase` whose parent is a
    `train_iteration` span, summed over the profiled iterations, over the
    number of `train_iteration` spans. None where the program records no
    span (a program without the tracing module, or none recorded), or
    where the count of `train_iteration` spans is not the count of
    profiled iterations."""
    try:
        from nvsr_tpu_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    roots = {r["index"] for r in recs if r["name"] == "train_iteration"}
    n = len(ctx.work.get("traced") or ())
    if not roots or len(roots) != n:
        return None
    return sum(r["ms"] for r in recs
               if r["name"] == phase and r["parent"] in roots) / n
