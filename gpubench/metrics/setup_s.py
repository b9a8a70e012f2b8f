"""setup_s: process start to the first timed iteration (host clock)."""


def read(ctx):
    return ctx.record.get("setup_s")
