"""train_iter_ms: the window's seconds over the training iterations it
completed; one synchronize closes the window (host clock)."""


def read(ctx):
    rec = ctx.record
    if not rec.get("iterations"):
        return None
    return rec["window_s"] / rec["iterations"] * 1e3
