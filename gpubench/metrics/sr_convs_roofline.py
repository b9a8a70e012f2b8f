"""sr_convs_roofline: the plane SR's convolutions on cuDNN
(`models/plane_sr.py`, f32, TF32 off) in the profiled HR iterations as
a share (%) of their bound: the EDSR's forward multiply-adds (x2), 3x
for the forward and the backward (its blocks' recompute in the backward
not counted), at the f32 peak, over the device time of every kernel
that a convolution operator launched (host operators whose names match
CONV, by the trace's External id: cuDNN's direct, FFT and Winograd
kernels, their layout transposes and the complex GEMVs of its FFT
algorithm). The bytes bound is far below: ~0.3 GB of activations per
conv against ~0.3 TFLOP or more. An algorithm that does fewer
operations than the direct convolution (FFT, Winograd) counts as
doing the direct ones.

The EDSR's shapes (arithmetic frozen here): the LR planes [3, C, R, R]
replicate-padded by `pad` (the ceiling of the trunk's halo), VALID 3x3
convolutions: the input conv C -> hidden, 2 per residual block, the mid
conv, per x2 stage a conv hidden -> 4 hidden and a pixel shuffle, the
output conv hidden -> C."""

import math
import re

CONV = re.compile(r"conv", re.I)


def edsr_forward_flops(channels, hidden, n_blocks, scale, lr_res, planes=3):
    n_up = int(math.log2(scale))
    halo = 1 + 2 * n_blocks + 1
    step = 1.0
    for _ in range(n_up):
        halo += step
        step /= 2
    halo += step
    size = lr_res + 2 * math.ceil(halo)
    flops = 0

    def conv(cin, cout):
        nonlocal size, flops
        size -= 2
        flops += 2 * 9 * cin * cout * size * size * planes

    conv(channels, hidden)
    for _ in range(2 * n_blocks):
        conv(hidden, hidden)
    conv(hidden, hidden)
    for _ in range(n_up):
        conv(hidden, 4 * hidden)
        size *= 2
    conv(hidden, channels)
    return flops


def read(ctx):
    t = ctx.trace_data
    n = sum(1 for k in ctx.work.get("traced") or () if k == "sr")
    if t is None or not n or "edsr" not in ctx.work:
        return None
    secs, launches = t.op_kernel_time(lambda op: bool(CONV.search(op)))
    if not launches or secs <= 0:
        return None
    bound = 3 * edsr_forward_flops(*ctx.work["edsr"]) * n \
        / ctx.peaks["f32_flops_per_s"]
    return 100.0 * bound / secs
