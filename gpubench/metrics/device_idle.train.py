"""device_idle.train: the share (%) of the profiled iterations' wall
time that the union of device operations does not cover."""

from gpubench.trace import idle_share


def read(ctx):
    return idle_share(ctx, "traced")
