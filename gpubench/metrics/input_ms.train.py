"""input_ms.train: the device-stream ms of the training iteration's
`input` spans (`nvsr_tpu_torch.utils.tracing`) in the profiled
iterations, over the iterations (gpubench/spans.py)."""

from gpubench.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "input")
