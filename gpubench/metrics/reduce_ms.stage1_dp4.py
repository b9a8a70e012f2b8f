"""reduce_ms.stage1_dp4: the device-stream ms of the training
iteration's `reduce` spans (`train.reduce_step`'s all_reduce of the
gradients and loss terms under a mesh) in rank 0's profiled iterations,
over the iterations (gpubench/spans.py)."""

from gpubench.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "reduce")
