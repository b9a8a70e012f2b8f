"""Chip smoke test of the PyTorch/CUDA port (nvsr_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:  python3 chip_smoke.py  (add --profile to also trace one
HR/SR and one LR training step, and one frame through each of the points
and from-rays entries, with torch.profiler)

Phases (any failure raises and the script exits non-zero):
  1. build every kernel from nvsr_tpu_torch/csrc/ with nvcc;
  2. hold each kernel against its plain PyTorch version at the flagship
     pass shapes (one 8192-ray block each: coarse S=16 sigma-only on 200^2
     LR planes, fine S=32 full decode on 800^2 SR planes), and time both
     with CUDA events;
  3. the main path once, as a user calls it: seeded random LR planes
     3x48x200^2, EDSR x4 (256 wide, 32 blocks, bf16) super-resolution,
     then an 800x800 render_image in 16x16 ray tiles, 16+16 samples,
     occupancy-tightened, 128-wide 4+4 decoders; launch counts are zeroed
     just before and read just after; then the frame is timed through the
     kernels and through the plain version;
  4. the committed trained gate scene through the kernel and the plain
     version (PSNR vs its ground truth, kernel vs plain >= 45 dB), and
     through the f32 reference path (the JAX reference reaches 39.593 dB
     on it on the CPU);
  5. training (TrainModels stage 1 at full width, nerf.train.tiled_gather
     on): the trainable plane sampler's forward and backward kernels
     against their plain versions at the coarse pass's shapes (4096 rays
     x 16 samples on 3x48x200^2 planes; the backward also on a uniformly
     random copy of the grids), timed beside F.grid_sample; the
     first HR/SR and LR steps through the kernels and through the plain
     sampler (losses must agree); then, with launch counts zeroed, 3
     HR/SR steps (EDSR 256x32 x4 bf16 trained, fine pass on the SR'd
     800^2 planes) and 3 LR steps, each followed by the Adam updates of
     the decoders, the SR net and the planes;
  6. bicubic planes (plane_interp 'bicubic', set on the triplane config
     and carried into the SR config's residual; otherwise the flagship of
     phase 3): the cubic megakernel's two entries against their plain
     versions at phase 2's pass shapes, and the cubic sampler kernel at
     the fine pass's (timed beside F.grid_sample bicubic); then, with
     launch counts zeroed, SR with the bicubic residual, the 800x800 frame
     through the cubic megakernel, and the same frame with an f32 decoder
     (the non-fused tiled route: the cubic sampler kernel and the plain
     decoder); the frame timed through the kernels and the plain version
     (kernel vs plain >= 45 dB); then the gate scene in bicubic (kernel vs
     plain, the f32 route vs the f32 reference path, the reference path's
     PSNR against JAX's, 39.130 dB on the CPU) and with its own f32
     bilinear config through the non-fused route;
  7. the points entry (apply_triplane_rays(tile_cfg=...), the flagship of
     phase 3 with seed 3): the four ray entries of triplane_render.cu
     against pinned output digests (those of the wmma decoder, which the
     wgmma decoder reproduces; compared when nvcc is the release they were
     taken with); the three grids entries against their plain versions at
     phase 2's pass shapes (v2 coarse sigma-only, v2 and v1 fine), the
     standalone decoder at the fine pass's tap pairs (its rgb and sigma
     must equal the v1 entry's bit for bit) and the row gather at
     gather_dma.py's own workload (beside torch.index_select, in turns);
     the decoder of the fine pass and of the standalone decoder also as
     per-layer cuBLAS calls (layered_ms); then, with launch counts
     zeroed, SR and the 800x800 frame through a point fn that calls the
     public points entry, v2 and v1 (each >= 45 dB from the from-rays
     frame), and the two public ops that no render path calls, as in JAX
     (fused_decode on the fine pass's tap pairs, gather_rows_dma on its
     2x2-tap rows of one SR plane); the points-entry and from-rays frames
     timed, median of 10 each.
Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the H100's peak for their type (989 TFLOP/s bf16 tensor
core, 67 TFLOP/s f32), counted from this run's shapes.
The last two lines are the kernels JSON and the result JSON.

python3 chip_smoke.py --times [ROOT ...] checks nothing: it times the
decoder's kernels, the plane sampler's kernels beside F.grid_sample, the
row gather, the flagship frame and the f32 bicubic frame for the package
under each ROOT (default: this checkout), each in its own process, to
compare builds in one call (e.g. a parent checkout unpacked under build/,
then this one).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of the kernel against its plain version: identical rounding
# up to the decoder; the tensor cores sum the bf16 products in another
# order, which can flip a bf16 activation by one ULP
MAX_ABS_TOL = 5e-2
MEAN_ABS_TOL = 2e-3
GATE_PSNR_MIN_DB = 45.0       # kernel vs plain frame (bench.py's gate)
GATE_REF_PSNR_DB = 39.593     # JAX reference path vs gt, CPU
# the same with plane_interp 'bicubic' (JAX's XLA path on the CPU; pinned
# by tests/test_torch_tiled_route.py)
GATE_BICUBIC_REF_PSNR_DB = 39.130
RAY_BLOCK = 8192
# the trainable sampler: the forward repeats its plain version's rounding
# step for step (bit-equal); the backward adds with atomics in another
# order than index_add_ (f32 summation order only)
SAMPLE_FWD_TOL = 0.0
SAMPLE_BWD_MAX_TOL, SAMPLE_BWD_MEAN_TOL = 1e-4, 1e-6
# a training step through the kernels vs the plain sampler: the same
# forward bit for bit, so the same loss up to the nondeterministic order
# of the SR net's cuDNN kernels; the planes' gradients differ by the two
# backwards' f32 summation orders (atomics, index_add_)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12


def fail(msg):
    raise RuntimeError(msg)


def bound(nbytes, *work):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the memory rate and, for each type of
    operation in `work` ((count, peak rate) pairs), the operations over
    their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / peak * 1e3 for ops, peak in work)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes_read(table, grids, cubic, align_corners=True):
    """Bytes of the plane-table cells that this run's points read, each
    cell once: table [P, H, W, Cp] bf16, grids one [N, 2] per plane."""
    import torch
    from nvsr_tpu_torch.ops.grid_sample import _corners, cubic_taps
    _, h, w, cp = table.shape
    cells = 0
    for g in grids:
        if cubic:
            cols, rows, _, _ = cubic_taps(g, h, w, align_corners)
            c = rows[:, :, None] * w + cols[:, None, :]
        else:
            _, _, x0, x1, y0, y1 = _corners(g, h, w, align_corners)
            c = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0,
                             y1 * w + x1], dim=-1)
        cells += torch.unique(c.reshape(-1)).numel()
    return cells * cp * table.element_size()


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def decode_flops(packed, sigma_only):
    """Multiply-adds (x2) of the decoder for one point."""
    flops = 0
    for branch, _, _, k, _ in packed.layers():
        if branch == "density" or not sigma_only:
            flops += 2 * k * 128
    return flops + 2 * 128 * (1 if sigma_only else 4)


def render_bound(args, sigma_only, cubic=False):
    """Bound of one triplane_render call: the table cells the points read
    and every other input read once, the output written once; the
    decoder's multiply-adds at the bf16 tensor core rate, the gather's f32
    arithmetic (per point, plane and channel: bilinear 4 products and 6
    sums, bicubic 16 products and 16 sums, the comb sum included) at the
    f32 rate."""
    from nvsr_tpu_torch.ops.fused_render import plane_grids
    table, packed, origins, directions, z, view, geom = args[:7]
    r, s = z.shape
    nbytes = (table_bytes_read(table, plane_grids(origins, directions, z,
                                                  geom), cubic)
              + nbytes_of(origins, directions, z, packed.w, packed.b,
                          packed.wh, packed.bh,
                          None if sigma_only else view) + r * s * 16)
    gather = r * s * 3 * packed.cp * (32 if cubic else 10)
    return bound(nbytes, (decode_flops(packed, sigma_only) * r * s,
                          BF16_TC_FLOPS), (gather, F32_FLOPS))


def grids_bound(table, packed, grids, view, sigma_only):
    """Bound of one grids-entry call: as render_bound, with the grids
    [3, N, 2] and the per-point view rows for inputs."""
    n = grids.shape[1]
    nbytes = (table_bytes_read(table, grids, False)
              + nbytes_of(grids, packed.w, packed.b, packed.wh, packed.bh,
                          None if sigma_only else view) + n * 16)
    return bound(nbytes, (decode_flops(packed, sigma_only) * n,
                          BF16_TC_FLOPS),
                 (n * 3 * packed.cp * 10, F32_FLOPS))


def cuda_ms(fn, warmup=2, reps=10):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(fn, reps):
    """Sorted host-clock times (ms) of `reps` calls, each ended by a
    synchronize, after one warm-up call: the frame is host-bound, so its
    spread is part of the result."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def interleaved_ms(fns, warmup=3, reps=25):
    """Per-call CUDA-event times (ms) of each fn, called in turns (a, b,
    a, b, ...) after `warmup` turns -> one sorted list per fn. Before each
    call the stream sleeps ~1 ms on the card, so the call is queued before
    its start event fires: the time is the device's, without the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return [sorted(ts) for ts in times]


def spread(ts):
    """'median (min .. max)' of sorted times."""
    return f"{ts[len(ts) // 2]:.4f} ms ({ts[0]:.4f} .. {ts[-1]:.4f})"


def layered_decoder(packed, parts):
    """The decoder as per-layer bf16 torch.matmul + bias + relu calls
    (cuBLAS), on bf16 feature parts {"comb", "f0", "f1", "f2", "fv"}
    [N, width] -> rgb [N, 3] and sigma [N, 1] (bf16): the yardstick of the
    hand-fused decoder (`layered_ms`); the port never calls it."""
    import torch
    acts = {}
    for li, (branch, _, off, k, names) in enumerate(packed.layers()):
        x = torch.cat([acts[branch] if nm == "x" else parts[nm]
                       for nm in names], dim=-1) if len(names) > 1 else (
            acts[branch] if names[0] == "x" else parts[names[0]])
        y = torch.matmul(x, packed.w[off:off + k])
        acts[branch] = y.add_(parts["bias"][li]).relu_()
    return (torch.matmul(acts["rgb"], parts["wh"][0][:, :3]),
            torch.matmul(acts["density"], parts["wh"][1][:, 3:4]))


def layered_parts(packed, f0, f1, f2, view, avg=True):
    """layered_decoder's inputs from f32 features [N, cp] of the three
    planes and view rows [N, >= cvp]."""
    import torch
    bf = torch.bfloat16
    comb = f0 + f1 + f2
    if avg:
        comb = comb / 3.0
    return {"comb": comb.to(bf).contiguous(), "f0": f0.to(bf).contiguous(),
            "f1": f1.to(bf).contiguous(), "f2": f2.to(bf).contiguous(),
            "fv": view[:, :packed.cvp].to(bf).contiguous(),
            "bias": packed.b.to(bf), "wh": packed.wh}


def camera(eye):
    import numpy as np
    eye = np.asarray(eye, dtype=np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def random_decoder(gen, cfg, device):
    """torch.nn.Linear-style init in the JAX pytree layout."""
    import torch

    def lin(i, o):
        bound = 1.0 / math.sqrt(i)
        return {"w": ((torch.rand((i, o), generator=gen) * 2 - 1) * bound
                      ).to(device),
                "b": ((torch.rand((o,), generator=gen) * 2 - 1) * bound
                      ).to(device)}

    def branch(in_ch, n):
        layers = [lin(in_ch, cfg.dec_channels)]
        for ln in range(n - 1):
            extra = in_ch if cfg.is_skip_layer(ln) else 0
            layers.append(lin(cfg.dec_channels + extra, cfg.dec_channels))
        return layers

    return {"members": [{
        "density": branch(cfg.density_in_channels, cfg.dec_density_layers),
        "fc_alpha": lin(cfg.dec_channels, 1),
        "rgb": branch(cfg.rgb_in_channels, cfg.dec_rgb_layers),
        "fc_rgb": lin(cfg.dec_channels, 3)}]}


def random_edsr(gen, cfg, device):
    """The reference PlanesSR init: N(0, sqrt(2/n)/10), n = k*k*out."""
    import torch
    from nvsr_tpu_torch.models.plane_sr import edsr_layer_plan
    plan = edsr_layer_plan(cfg.n_blocks, cfg.scale_factor,
                           cfg.receptive_field_bound)

    def conv(i, o, k):
        std = math.sqrt(2.0 / (k * k * o)) / 10.0
        return {"w": (torch.randn((o, i, k, k), generator=gen) * std
                      ).to(device)}

    hs = cfg.hidden_size
    return {"inner": {
        "conv_input": conv(cfg.in_channels, hs, plan["conv_input"]),
        "blocks": [{"conv1": conv(hs, hs, k), "conv2": conv(hs, hs, k)}
                   for k in plan["blocks"]],
        "conv_mid": conv(hs, hs, plan["conv_mid"]),
        "upscale": [conv(hs, 4 * hs, k) for k in plan["upscale"]],
        "conv_output": conv(hs, cfg.out_channels, plan["conv_output"])}}


def plain_point_fn(params, cfg, planes, plane_view, box, sigma_only):
    """The fused pass with the kernel's plain version in its place (what
    make_triplane_point_fn(tile_rays=...) builds for a bf16 config, on the
    plain path); bilinear or bicubic, as cfg.plane_interp says."""
    from nvsr_tpu_torch.models.triplane import (make_rot_mats,
                                                sample_viewdir_plane)
    from nvsr_tpu_torch.ops import fused_render
    table = fused_render.build_plane_table(planes)
    packed = fused_render.pack_decoder(params, cfg)
    geom = fused_render.geometry_args(box, make_rot_mats(3))

    def point_fn(pts, rays, z_vals):
        view = None
        if not sigma_only:
            view = fused_render.view_rows(sample_viewdir_plane(
                plane_view, rays.viewdirs, box, cfg, dense=True), packed.cvp)
        return fused_render.fused_render_reference(
            table, packed, rays.origins, rays.directions, z_vals, view,
            geom, align_corners=cfg.align_corners,
            avg=cfg.proj_combination == "avg", sigma_only=sigma_only,
            cubic=cfg.plane_interp == "bicubic")

    point_fn.consumes_rays = True
    return point_fn


def psnr(a, b):
    import torch
    from nvsr_tpu_torch.ops.rendering import mse2psnr
    return float(mse2psnr(torch.mean((a.float() - b.float()) ** 2)))


# TrainModels stage 1 (configs/TrainModels.yml, bench.py:417-496 occ16):
# 4096 rays of 8x8 tiles, 16+16 samples, 3x48x200^2 planes, 48x32^2 view
# plane, EDSR 256 wide x 32 blocks x4 bf16, on 800x800 views
TRAIN_FULL = dict(rays=4096, samples=16, channels=48, res=200, view_res=32,
                  sr_hidden=256, sr_blocks=32, sr_scale=4, image=800)


class PlainSampler:
    """Inside the block, the trainable sampler's dispatch sends CUDA
    tensors to its plain versions: the comparison run only. The port
    itself never does this."""

    def __enter__(self):
        from nvsr_tpu_torch.ops import plane_sample as ps
        self.ps = ps
        self.saved = ps.sample_forward, ps.sample_backward
        ps.sample_forward = ps.plane_sample_reference
        ps.sample_backward = ps.plane_sample_backward_reference

    def __exit__(self, *exc):
        self.ps.sample_forward, self.ps.sample_backward = self.saved


def sampler_checks(dev, planes_pos, grids, dout):
    """The two sampler kernels against their plain versions at the
    coarse pass's shapes, timed beside F.grid_sample -> kernel entries."""
    import torch
    import torch.nn.functional as F
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.ops import plane_sample as ps
    from nvsr_tpu_torch.ops.fused_render import build_plane_table
    p, c, h, w = planes_pos.shape
    n = grids.shape[1]
    table = build_plane_table(planes_pos)
    fwd = kernels.plane_sample_forward(table, grids, c, align_corners=True)
    fwd_ref = ps.plane_sample_reference(table, grids, c, True)
    # the backward on the coarse pass's grids (tile-coherent: a chunk's
    # taps share ~120 cells) and on a uniformly random copy of them (a cell
    # per tap: the chunk tables at their fullest, the adds uncoalesced)
    rand_grids = torch.rand(grids.shape, generator=torch.Generator(
        device=dev).manual_seed(6), device=dev) * 2 - 1
    e_b = {}
    for name, g in (("coherent", grids), ("random", rand_grids)):
        bwd = kernels.plane_sample_backward(dout, g, h, w, align_corners=True)
        bwd_ref = ps.plane_sample_backward_reference(dout, g, h, w, True)
        torch.cuda.synchronize()
        if not torch.isfinite(bwd).all():
            fail("plane_sample_bwd: non-finite kernel output")
        e_b[name] = (bwd - bwd_ref).abs()
    worst = max(e.max().item() for e in e_b.values())
    if not torch.isfinite(fwd).all():
        fail("plane_sample_fwd: non-finite kernel output")
    e_f = (fwd - fwd_ref).abs()

    g4 = grids.reshape(p, 1, n, 2)
    x = planes_pos.detach().requires_grad_(True)

    def lib_fwd():
        return F.grid_sample(x, g4, mode="bilinear", padding_mode="border",
                             align_corners=True)

    y = lib_fwd()
    cot = dout.permute(0, 2, 1).reshape(p, c, 1, n).contiguous()
    # kernels and library calls: device-time medians of 25 in turns
    # (interleaved_ms); plain versions: CUDA-event means
    ms = dict(zip(("fwd", "fwd_lib", "bwd", "bwd_random", "bwd_lib",
                   "fwdbwd_lib"), (ts[len(ts) // 2] for ts in interleaved_ms((
        lambda: kernels.plane_sample_forward(table, grids, c,
                                             align_corners=True),
        lambda: lib_fwd().detach(),
        lambda: kernels.plane_sample_backward(dout, grids, h, w,
                                              align_corners=True),
        lambda: kernels.plane_sample_backward(dout, rand_grids, h, w,
                                              align_corners=True),
        lambda: torch.autograd.grad(y, x, cot, retain_graph=True),
        lambda: torch.autograd.grad(lib_fwd(), x, cot))))))
    ms["fwd_plain"] = cuda_ms(lambda: ps.plane_sample_reference(
        table, grids, c, True), warmup=1, reps=5)
    ms["bwd_plain"] = cuda_ms(lambda: ps.plane_sample_backward_reference(
        dout, grids, h, w, True), warmup=1, reps=5)
    f32 = 4
    # forward: 4 products, 2 sums, 2 roundings, 2 products, 1 sum per
    # output value; backward: 4 products, 2 roundings, 4 adds per dout
    b_f = bound(p * n * c * f32 + table_bytes_read(table, grids, False)
                + grids.numel() * f32, (11 * p * n * c, F32_FLOPS))
    b_b = bound(dout.numel() * f32 + grids.numel() * f32
                + p * c * h * w * f32, (10 * p * n * c, F32_FLOPS))
    shape = f"P={p}, N={n}, C={c}, {h}x{w} planes"
    print(f"[train] plane_sample_fwd ({shape}): max err "
          f"{e_f.max().item():.3e}, mean {e_f.mean().item():.3e} (tol "
          f"{SAMPLE_FWD_TOL}); kernel {ms['fwd']:.4f} ms, plain "
          f"{ms['fwd_plain']:.4f} ms, F.grid_sample {ms['fwd_lib']:.4f} ms; "
          f"bound {b_f[0]:.4f} ms by {b_f[1]} ({b_f[0] / ms['fwd']:.1%})")
    errs = ", ".join(f"{k} grids max {e.max().item():.3e}, mean "
                     f"{e.mean().item():.3e}" for k, e in e_b.items())
    print(f"[train] plane_sample_bwd ({shape}): {errs} (tol max "
          f"{SAMPLE_BWD_MAX_TOL}, mean {SAMPLE_BWD_MEAN_TOL}); kernel "
          f"{ms['bwd']:.4f} ms (random grids {ms['bwd_random']:.4f} ms), "
          f"plain {ms['bwd_plain']:.4f} ms, grid_sample "
          f"backward {ms['bwd_lib']:.4f} ms (forward+backward "
          f"{ms['fwdbwd_lib']:.4f} ms); bound {b_b[0]:.4f} ms by {b_b[1]} "
          f"({b_b[0] / ms['bwd']:.1%})")
    if e_f.max() > SAMPLE_FWD_TOL:
        fail("plane_sample_fwd disagrees with its plain version")
    if any(e.max() > SAMPLE_BWD_MAX_TOL or e.mean() > SAMPLE_BWD_MEAN_TOL
           for e in e_b.values()):
        fail("plane_sample_bwd disagrees with its plain version")
    src = "nvsr_tpu_torch/csrc/plane_sample.cu"
    return {
        "plane_sample_fwd": {
            "name": "plane_sample_fwd", "route": "cuda", "source": src,
            "replaces": "nvsr_tpu/ops/pallas/tile_sampler.py:311",
            "max_abs_err": e_f.max().item(), "ms": ms["fwd"],
            "plain_ms": ms["fwd_plain"], "bound_ms": b_f[0],
            "bound_by": b_f[1], "library_ms": ms["fwd_lib"]},
        "plane_sample_bwd": {
            "name": "plane_sample_bwd", "route": "cuda", "source": src,
            "replaces": "nvsr_tpu/ops/pallas/tile_sampler.py:1801",
            "max_abs_err": worst, "ms": ms["bwd"],
            "plain_ms": ms["bwd_plain"], "bound_ms": b_b[0],
            "bound_by": b_b[1], "library_ms": ms["bwd_lib"]}}


# CUDA runtime calls that make the host wait for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def profile_run(label, fn):
    """fn() once under torch.profiler: its kernels by device time, device
    time against wall time (the profiler slows the host, not the device),
    and the host's waits on the device (HOST_WAITS: after each, the host
    queues no work until the device has drained)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the device-side events only: an operator's row repeats the device
    # time of the kernels it launched
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    waits = {e.key: (e.count, e.cpu_time_total / 1e3) for e in events
             if e.key in HOST_WAITS}
    print(f"[profile] {label}: device {dev_ms:.2f} ms in "
          f"{sum(e.count for e in kern)} kernel launches, wall {wall:.2f} "
          f"ms under the profiler (device idle {1 - dev_ms / wall:.1%}); "
          f"host waits (count, ms) {waits}")
    for e in kern[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def train_batches(dev, c2w, w):
    """The training phase's ray batches: w["rays"] rays as random 8x8
    tiles of a w["image"]^2 view (bench.py's occ16), occupancy-tightened,
    from numpy seed 0 -> batch() -> (rays, target rgb)."""
    import numpy as np
    import torch
    from nvsr_tpu_torch.render import build_sampled_rays, tighten_bundle
    from nvsr_tpu_torch.train import choose_tile_pixels
    occ = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]], np.float32)
    img = w["image"]
    focal = 0.5 * img / np.tan(0.3)
    rng = np.random.default_rng(0)
    views = rng.uniform(size=(img, img, 3)).astype(np.float32)
    pose = torch.as_tensor(c2w, device=dev)

    def batch():
        rows, cols, tgt = choose_tile_pixels(rng, views, w["rays"], (8, 8))
        rays = build_sampled_rays(pose, rows, cols, img, img, focal, 0.0,
                                  2.0, 6.0, use_viewdirs=True)
        return tighten_bundle(rays, occ), torch.as_tensor(tgt, device=dev)

    return batch


def coarse_grids(rays, box, samples):
    """The training coarse pass's plane coordinates of `rays` (stratified,
    perturbed depths from seed 4) -> [3, R * samples, 2] in the order
    training hands them to the sampler (ray-major, tile after tile)."""
    import torch
    from nvsr_tpu_torch.models.triplane import (make_rot_mats,
                                                project_to_planes)
    from nvsr_tpu_torch.ops.geometry import normalize_coords
    from nvsr_tpu_torch.ops.sampling import stratified_z_vals
    dev = rays.origins.device
    z = stratified_z_vals(rays.near, rays.far, samples, lindisp=False,
                          perturb=True,
                          generator=torch.Generator(device=dev).manual_seed(4))
    pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
    xyz = normalize_coords(pts.reshape(-1, 3),
                           torch.as_tensor(box[:, :3], device=dev))
    return project_to_planes(xyz, make_rot_mats(3)).contiguous()


def train_phase(dev, c2w, w=TRAIN_FULL, on_card=True, profile=False):
    """Phase 5 (see the module docstring). With on_card=False (a CPU
    rehearsal at a small `w`) the kernel checks and launch counts are
    skipped and every step runs the plain versions. profile: after the
    phase, one HR/SR and one LR step under torch.profiler."""
    import contextlib

    import numpy as np
    import torch
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig,
                                                init_plane_sr_params)
    from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                                init_decoder_params)
    from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
    from nvsr_tpu_torch.planes_store import PlanesOptimizer
    from nvsr_tpu_torch.render import RenderConfig
    from nvsr_tpu_torch.train import ModuleOptimizer, StepFlags, train_step

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c, s = w["channels"], w["samples"]
    gen = torch.Generator().manual_seed(1)
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, num_plane_channels=c,
                         gather_table_dtype="bfloat16")
    sr_cfg = PlaneSRConfig(in_channels=c, out_channels=c,
                           hidden_size=w["sr_hidden"],
                           n_blocks=w["sr_blocks"],
                           scale_factor=w["sr_scale"],
                           compute_dtype="bfloat16")
    dc = init_decoder_params(gen, cfg, dev)
    df = init_decoder_params(gen, cfg, dev)
    sr = init_plane_sr_params(gen, sr_cfg, dev)
    planes = {"pos": (0.03 * torch.randn((3, c, w["res"], w["res"]),
                                         generator=gen)).to(dev),
              "view": (0.03 * torch.randn((c, w["view_res"], w["view_res"]),
                                          generator=gen)).to(dev)}
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    batch = train_batches(dev, c2w, w)

    rcfg = RenderConfig(num_coarse=s, num_fine=s, perturb=True,
                        radiance_field_noise_std=0.2)
    tile = TileSamplerConfig(tile_rays=64)
    flags = {"HR/SR": StepFlags(sr_iter=True, tile_cfg=tile),
             "LR": StepFlags(sr_iter=False, tile_cfg=tile)}

    def step(kind, rays, target, seed):
        fl = flags[kind]
        g = torch.Generator(device=dev).manual_seed(seed)
        return train_step(dc, df, sr if fl.sr_iter else None, planes, box,
                          rays, target, g, model_cfg=cfg, sr_cfg=sr_cfg,
                          rcfg=rcfg, flags=fl)

    rays0, tgt0 = batch()
    entries = {}
    if on_card:
        with torch.no_grad():
            grids = coarse_grids(rays0, box, s)
            dout = torch.randn((3, grids.shape[1], c),
                               generator=torch.Generator().manual_seed(5)
                               ).to(dev)
        entries = sampler_checks(dev, planes["pos"], grids, dout)

    # the first step of each kind through the kernels and the plain
    # sampler, on the same batch and seed, in turns
    for kind in ("HR/SR", "LR"):
        step(kind, rays0, tgt0, 3)
        times, losses, dpos = {"kernels": [], "plain": []}, {}, {}
        for route in ("plain", "kernels", "kernels", "plain"):
            ctx = PlainSampler() if route == "plain" \
                else contextlib.nullcontext()
            sync()
            t0 = time.perf_counter()
            with ctx:
                m, grads = step(kind, rays0, tgt0, 3)
                loss = float(m["loss"])
            sync()
            times[route].append((time.perf_counter() - t0) * 1e3)
            losses.setdefault(route, loss)
            dpos.setdefault(route, grads["planes"]["pos"])
            del grads
        rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
        g_rel = ((dpos["kernels"] - dpos["plain"]).abs().max()
                 / dpos["plain"].abs().max()).item()
        print(f"[train] first {kind} step, kernels vs plain sampler: loss "
              f"{losses['kernels']:.9f} vs {losses['plain']:.9f} (rel diff "
              f"{rel:.2e}, tol {STEP_LOSS_RTOL}); planes grad max diff "
              f"{g_rel:.2e} of its largest (tol {STEP_GRAD_RTOL}); step "
              f"{min(times['kernels']):.2f} vs {min(times['plain']):.2f} ms "
              f"(best of 2 each, in turns)")
        if not (rel <= STEP_LOSS_RTOL and g_rel <= STEP_GRAD_RTOL):
            fail(f"{kind} step: kernel and plain steps disagree")

    # the training path once: 3 HR/SR + 3 LR steps with Adam updates
    opts = {"dc": ModuleOptimizer(dc, 5e-4), "df": ModuleOptimizer(df, 5e-4),
            "sr": ModuleOptimizer(sr, 5e-5)}
    popt = PlanesOptimizer({"scene": planes}, 5e-4)

    def watched():
        return {"dc": dc["members"][0]["density"][0]["w"],
                "df": df["members"][0]["rgb"][0]["w"],
                "sr": sr["inner"]["blocks"][0]["conv1"]["w"],
                "planes.pos": planes["pos"], "planes.view": planes["view"]}

    before = {k: v.clone() for k, v in watched().items()}
    mine = (kernels.plane_sample_fwd, kernels.plane_sample_bwd)
    for k in kernels.KERNELS:
        k.launches = 0
    sync()
    times, peak = {"HR/SR": [], "LR": []}, {}
    for i, kind in enumerate(["HR/SR"] * 3 + ["LR"] * 3):
        rays, tgt = batch()
        if on_card and not times[kind]:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        m, grads = step(kind, rays, tgt, 10 + i)
        for name, opt in opts.items():
            if name in grads:
                opt.accumulate(grads[name])
                opt.step()
        popt.apply_grads("scene", grads["planes"])
        loss = float(m["loss"])
        sync()
        times[kind].append((time.perf_counter() - t0) * 1e3)
        if on_card:
            peak[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[train] step {i} ({kind}): loss {loss:.6f}, psnr "
              f"{float(m['psnr']):.3f} dB, overflow_frac "
              f"{m.get('overflow_frac')}, {times[kind][-1]:.2f} ms")
        if not np.isfinite(loss):
            fail(f"step {i}: non-finite loss")
    launches = {k.symbol: k.launches for k in mine}
    moved = {k: not torch.equal(v, before[k]) for k, v in watched().items()}
    for kind, ts in times.items():
        med = sorted(ts)[len(ts) // 2]
        print(f"[train] {kind} step (train_step + Adam updates): median of "
              f"{len(ts)} {med:.2f} ms (all {[round(x, 2) for x in ts]}); "
              f"peak memory {peak.get(kind, float('nan')):.2f} GiB")
    print(f"[train] launches {launches}; parameters moved {moved}")
    if not all(moved.values()):
        fail(f"a trained group did not change: {moved}")
    if on_card:
        if min(launches.values()) == 0:
            fail(f"a kernel of the training path was never launched: "
                 f"{launches}")
        for name in launches:
            entries[name]["launches"] = launches[name]
    if profile:
        for kind in ("HR/SR", "LR"):
            rays, tgt = batch()
            profile_run(f"{kind} step", lambda: step(kind, rays, tgt, 20))
    return entries


def tiled_fn(params, cfg, planes, plane_view, box, sigma_only):
    """The port's tiled eval point fn, 16x16 ray tiles: the fused kernel
    for a bf16 config, the eval sampler kernel and the plain decoder for
    any other."""
    from nvsr_tpu_torch.render import make_triplane_point_fn
    return make_triplane_point_fn(params, cfg, planes, plane_view, box,
                                  tile_rays=256, sigma_only=sigma_only)


def reference_fn(params, cfg, planes, plane_view, box, sigma_only):
    """The port's reference (non-kernel) point fn."""
    from nvsr_tpu_torch.render import make_triplane_point_fn
    return make_triplane_point_fn(params, cfg, planes, plane_view, box,
                                  sigma_only=sigma_only)


def gate_scene(dev):
    """The committed trained gate scene on `dev` -> (asset, frame):
    frame(make_fn, cfg, tile) renders its held-out view (16+16 samples,
    occupancy bounds, white background) with the point fns that
    make_fn(decoder, cfg, planes, plane_view, box, sigma_only) builds and
    returns the fine rgb."""
    import torch
    from nvsr_tpu_torch import bridge
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.render import RenderConfig, render_image
    a = bridge.load_gate_asset(os.path.join(ROOT, "assets",
                                            "gate_scene.pkl"))
    ro, rd = get_ray_bundle(
        a["h"], a["w"], a["focal"], torch.as_tensor(a["pose"], device=dev),
        downsampling_offset=(a["ds_factor"] - 1) / (2 * a["ds_factor"]))
    planes = torch.as_tensor(a["planes_pos"], device=dev)
    view = torch.as_tensor(a["plane_view"], device=dev)
    dc = bridge.decoder_from_jax(a["decoder_coarse"], dev)
    df = bridge.decoder_from_jax(a["decoder_fine"], dev)
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        white_background=True, ray_block=RAY_BLOCK)

    def frame(make_fn, cfg, tile):
        return render_image(
            make_fn(dc, cfg, planes, view, a["box"], True),
            make_fn(df, cfg, planes, view, a["box"], False), ro, rd, rcfg,
            near=a["near"], far=a["far"], occ_aabb=a["occ_aabb"],
            tile=tile).fine.rgb

    return a, frame


def pass_args(cfg, dec_c, dec_f, planes_lr, planes_sr, plane_view, box,
              occ, ro, rd):
    """The triplane kernel's arguments for one RAY_BLOCK block of the
    flagship passes (coarse S=16 sigma-only on the LR planes, fine S=32 on
    the SR planes, depths from the coarse pass through the kernel) for
    cfg.plane_interp -> (coarse args, fine args)."""
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.triplane import (make_rot_mats,
                                                sample_viewdir_plane)
    from nvsr_tpu_torch.ops import fused_render
    from nvsr_tpu_torch.ops.rendering import volume_render
    from nvsr_tpu_torch.ops.sampling import (hierarchical_z_vals,
                                             stratified_z_vals)
    from nvsr_tpu_torch.render import (make_ray_bundle, tighten_bundle,
                                       tile_ray_maps)
    cubic = cfg.plane_interp == "bicubic"
    rays = make_ray_bundle(tile_ray_maps(ro, 16), tile_ray_maps(rd, 16),
                           2.0, 6.0, use_viewdirs=True)
    rays = tighten_bundle(rays, occ, tile_rays=256)
    blk = type(rays)(*[f[:RAY_BLOCK] for f in rays])
    geom = fused_render.geometry_args(box, make_rot_mats(3))
    z_c = stratified_z_vals(blk.near, blk.far, 16, lindisp=False,
                            perturb=False)
    tab_c = fused_render.build_plane_table(planes_lr)
    tab_f = fused_render.build_plane_table(planes_sr)
    pk_c = fused_render.pack_decoder(dec_c, cfg)
    pk_f = fused_render.pack_decoder(dec_f, cfg)
    coarse_args = (tab_c, pk_c, blk.origins.contiguous(),
                   blk.directions.contiguous(), z_c.contiguous(), None, geom)
    rf_c = kernels.triplane_render(*coarse_args, align_corners=True,
                                   avg=True, sigma_only=True, cubic=cubic)
    z_f = hierarchical_z_vals(
        z_c, volume_render(rf_c, z_c, blk.directions).weights, 16, det=True)
    view = fused_render.view_rows(sample_viewdir_plane(
        plane_view, blk.viewdirs, box, cfg, dense=True), pk_f.cvp)
    fine_args = (tab_f, pk_f, blk.origins.contiguous(),
                 blk.directions.contiguous(), z_f.contiguous(), view, geom)
    return coarse_args, fine_args


def render_checks(cfg, dec_c, dec_f, planes_lr, planes_sr, plane_view, box,
                  occ, ro, rd):
    """The triplane kernel's two entries for cfg.plane_interp against their
    plain versions at the flagship pass shapes (pass_args), timed with
    CUDA events; the sigma-only entry's sigma bit-equal to the full one's
    -> (kernel entries, the fine call's arguments)."""
    import torch
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.ops import fused_render
    cubic = cfg.plane_interp == "bicubic"
    kind = "triplane_render_cubic_" if cubic else "triplane_render_"
    coarse_args, fine_args = pass_args(cfg, dec_c, dec_f, planes_lr,
                                       planes_sr, plane_view, box, occ, ro,
                                       rd)
    tab_c, tab_f = coarse_args[0], fine_args[0]
    entries = {}
    for name, args, so, shape in (
            (kind + "sigma_only", coarse_args, True, "coarse S=16 on "
             f"{tab_c.shape[1]}^2"),
            (kind + "full", fine_args, False,
             f"fine S=32 on {tab_f.shape[1]}^2")):
        kw = dict(align_corners=True, avg=True, sigma_only=so, cubic=cubic)
        out = kernels.triplane_render(*args, **kw)
        ref = fused_render.fused_render_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{name}: non-finite kernel output")
        err = (out - ref).abs()
        e_rgb, e_sig = err[..., :3], err[..., 3]
        ms = cuda_ms(lambda: kernels.triplane_render(*args, **kw))
        plain_ms = cuda_ms(
            lambda: fused_render.fused_render_reference(*args, **kw),
            warmup=1, reps=3)
        print(f"[check] {name} ({shape}, {args[4].shape[0]} rays): "
              f"rgb max {e_rgb.max().item():.3e} mean "
              f"{e_rgb.mean().item():.3e}; sigma max "
              f"{e_sig.max().item():.3e} mean {e_sig.mean().item():.3e}"
              f" (tol max {MAX_ABS_TOL}, mean {MEAN_ABS_TOL}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not (err.max() <= MAX_ABS_TOL and err.mean() <= MEAN_ABS_TOL):
            fail(f"{name} disagrees with its plain version")
        b_ms, b_by = render_bound(args, so, cubic)
        print(f"[check] {name}: bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.1%} of it); no single PyTorch call "
              f"computes gather + decoder")
        entries[name] = {"name": name, "route": "cuda",
                         "source": "nvsr_tpu_torch/csrc/triplane_render.cu",
                         "replaces": "nvsr_tpu/ops/pallas/"
                                     "tile_sampler.py:904",
                         "max_abs_err": err.max().item(), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
        if not so:
            # the yardstick: the same decoder as cuBLAS layers, on the
            # pass's features (the gather not included)
            tab, pk, o, d, z, view, geom = args
            r, s_ = z.shape
            parts = layered_parts(pk, *fused_render.gather_features(
                tab, o, d, z, geom, True, cubic), view[:, None, :].expand(
                    r, s_, pk.cvp).reshape(r * s_, pk.cvp))
            lay_ms = cuda_ms(lambda: layered_decoder(pk, parts), warmup=3,
                             reps=20)
            del parts
            entries[name]["layered_ms"] = lay_ms
            print(f"[check] {name}: the decoder alone as bf16 cuBLAS layers "
                  f"(torch.matmul + bias + relu per layer, N={r * s_}) "
                  f"layered_ms {lay_ms:.3f}, against the kernel's "
                  f"{ms:.3f} ms with its gather")
    # sigma_only sigma == full-decode sigma, bit for bit
    kw = dict(align_corners=True, avg=True, cubic=cubic)
    so_out = kernels.triplane_render(*fine_args, sigma_only=True, **kw)
    full_out = kernels.triplane_render(*fine_args, sigma_only=False, **kw)
    torch.cuda.synchronize()
    if not torch.equal(so_out[..., 3], full_out[..., 3]):
        fail(f"{kind}sigma_only sigma differs from the full decode's")
    print(f"[check] {kind}sigma_only sigma bit-identical to the full "
          f"decode: yes")
    return entries, fine_args


def fine_grids(fine_args):
    """The fine pass's plane coordinates [3, R * S, 2] from its
    triplane_render arguments (pass_args)."""
    import torch
    from nvsr_tpu_torch.ops.fused_render import plane_grids
    _, _, origins, directions, z, _, geom = fine_args
    return torch.stack(plane_grids(origins, directions, z, geom)
                       ).contiguous()


def cubic_sampler_check(planes_sr, fine_args):
    """plane_sample_cubic_fwd against its plain version at the fine pass's
    shapes (the fine block's points on the SR planes), timed beside
    F.grid_sample bicubic -> its kernel entry."""
    import torch
    import torch.nn.functional as F
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.ops import plane_sample as ps
    table = fine_args[0]
    grids = fine_grids(fine_args)
    p, c, h, w = planes_sr.shape
    n = grids.shape[1]
    out = kernels.plane_sample_forward(table, grids, c, align_corners=True,
                                       cubic=True)
    ref = ps.plane_sample_reference(table, grids, c, True, cubic=True)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("plane_sample_cubic_fwd: non-finite kernel output")
    err = (out - ref).abs()
    g4 = grids[:, None]
    # kernel and library call: device-time medians of 25 in turns
    ms, lib_ms = (ts[len(ts) // 2] for ts in interleaved_ms((
        lambda: kernels.plane_sample_forward(table, grids, c,
                                             align_corners=True, cubic=True),
        lambda: F.grid_sample(planes_sr, g4, mode="bicubic",
                              padding_mode="border", align_corners=True))))
    plain_ms = cuda_ms(lambda: ps.plane_sample_reference(
        table, grids, c, True, cubic=True), warmup=1, reps=3)
    # per output value: 16 products, 12 sums, 4 roundings (the rows), 4
    # products and 3 sums (the y-combine)
    b_ms, b_by = bound(p * n * c * 4 + table_bytes_read(table, grids, True)
                       + grids.numel() * 4, (39 * p * n * c, F32_FLOPS))
    print(f"[bicubic] plane_sample_cubic_fwd (P={p}, N={n}, C={c}, {h}x{w} "
          f"planes): max err {err.max().item():.3e} (tol {SAMPLE_FWD_TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.grid_sample "
          f"bicubic {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
          f"({b_ms / ms:.1%})")
    if err.max() > SAMPLE_FWD_TOL:
        fail("plane_sample_cubic_fwd disagrees with its plain version")
    return {"plane_sample_cubic_fwd": {
        "name": "plane_sample_cubic_fwd", "route": "cuda",
        "source": "nvsr_tpu_torch/csrc/plane_sample.cu",
        "replaces": "nvsr_tpu/ops/pallas/tile_sampler.py:311",
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}}


# the flagship eval frame (bench.py:96-157) at TrainModels widths: 800x800,
# 3x48x200^2 LR planes, 48x32^2 view plane, EDSR 256 wide x 32 blocks x4
EVAL_FULL = dict(image=800, channels=48, res=200, view_res=32,
                 sr_hidden=256, sr_blocks=32, sr_scale=4, reps=10)


def bicubic_phase(dev, c2w, w=EVAL_FULL, on_card=True):
    """Phase 6 (see the module docstring). With on_card=False (a CPU
    rehearsal at a small `w`) the kernel checks, launch counts and timings
    are skipped and every pass runs the plain versions."""
    import numpy as np
    import torch
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig, apply_plane_sr
    from nvsr_tpu_torch.models.triplane import TriplaneConfig
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.render import RenderConfig, render_image

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c, res, vr = w["channels"], w["res"], w["view_res"]
    gen = torch.Generator().manual_seed(2)
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, num_plane_channels=c,
                         plane_interp="bicubic", compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, compute_dtype=None)
    sr_cfg = PlaneSRConfig(in_channels=c, out_channels=c,
                           hidden_size=w["sr_hidden"],
                           n_blocks=w["sr_blocks"],
                           scale_factor=w["sr_scale"],
                           plane_interp=cfg.plane_interp,
                           compute_dtype="bfloat16")
    dec_c = random_decoder(gen, cfg, dev)
    dec_f = random_decoder(gen, cfg, dev)
    for dec in (dec_c, dec_f):
        dec["members"][0]["fc_alpha"]["b"].fill_(1.0)
    sr_params = random_edsr(gen, sr_cfg, dev)
    planes_lr = (0.03 * torch.randn((3, c, res, res), generator=gen)).to(dev)
    plane_view = (0.03 * torch.randn((c, vr, vr), generator=gen)).to(dev)
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    occ = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]], np.float32)
    img = w["image"]
    ro, rd = get_ray_bundle(img, img, 0.5 * img / np.tan(0.3),
                            torch.as_tensor(c2w, device=dev))
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        ray_block=RAY_BLOCK)

    def point_fns(make_fn, mcfg, planes_sr):
        return (make_fn(dec_c, mcfg, planes_lr, plane_view, box, True),
                make_fn(dec_f, mcfg, planes_sr, plane_view, box, False))

    def frame(fns):
        return render_image(*fns, ro, rd, rcfg, near=2.0, far=6.0,
                            occ_aabb=occ, tile=16).fine.rgb

    entries = {}
    with torch.no_grad():
        if on_card:
            planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
            entries, fine_args = render_checks(
                cfg, dec_c, dec_f, planes_lr, planes_sr, plane_view, box,
                occ, ro, rd)
            entries.update(cubic_sampler_check(planes_sr, fine_args))

        # the bicubic path once: SR with the bicubic residual, the bf16
        # frame through the cubic megakernel, and the same frame with an
        # f32 decoder through the cubic sampler kernel and the plain decoder
        mine = (kernels.triplane_render_cubic_full,
                kernels.triplane_render_cubic_sigma_only,
                kernels.plane_sample_cubic_fwd)
        for k in kernels.KERNELS:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        fns, fns32 = (point_fns(tiled_fn, cfg, planes_sr),
                      point_fns(tiled_fn, cfg32, planes_sr))
        rgb, rgb32 = frame(fns), frame(fns32)
        sync()
        main_s = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in mine}
        print(f"[bicubic] SR + {img}x{img} bf16 frame + f32 frame in "
              f"{main_s:.3f} s (first run); launches {launches}")
        for name, x in (("bf16", rgb), ("f32", rgb32)):
            if tuple(x.shape) != (img, img, 3) or not torch.isfinite(x).all():
                fail(f"bicubic {name} frame: shape {tuple(x.shape)} or "
                     f"non-finite")
        print(f"[bicubic] rgb mean {rgb.mean().item():.4f} (bf16 fused), "
              f"{rgb32.mean().item():.4f} (f32 sampler + plain decoder); "
              f"the two frames agree to {psnr(rgb, rgb32):.2f} dB")
        if on_card:
            if min(launches.values()) == 0:
                fail(f"a kernel of the bicubic path was never launched: "
                     f"{launches}")
            for name in entries:
                entries[name]["launches"] = launches[name]
            sr_ms = cuda_ms(lambda: apply_plane_sr(sr_params, sr_cfg,
                                                   planes_lr),
                            warmup=1, reps=3)
            print(f"[bicubic] plane SR with the bicubic residual: "
                  f"{sr_ms:.2f} ms")
            kern_ms = frame_ms(lambda: frame(fns), reps=w["reps"])
            plain_fns = point_fns(plain_point_fn, cfg, planes_sr)
            plain_rgb = frame(plain_fns)
            plain_ms = frame_ms(lambda: frame(plain_fns), reps=3)
            f32_ms = frame_ms(lambda: frame(fns32), reps=3)
            for name, ts in (("the cubic megakernel", kern_ms),
                             ("its plain version", plain_ms),
                             ("the cubic sampler kernel + f32 decoder",
                              f32_ms)):
                med = ts[len(ts) // 2]
                print(f"[bicubic] frame through {name}: median of "
                      f"{len(ts)} {med:.2f} ms (min {ts[0]:.2f}, max "
                      f"{ts[-1]:.2f}) = {img * img / med * 1e3:.0f} rays/s")
            p_kp = psnr(rgb, plain_rgb)
            print(f"[bicubic] kernel vs plain frame PSNR {p_kp:.2f} dB (min "
                  f"{GATE_PSNR_MIN_DB})")
            if p_kp < GATE_PSNR_MIN_DB:
                fail("bicubic frame: kernel and plain version disagree")

        # the gate scene with plane_interp 'bicubic', and its own f32
        # (bilinear) config through the non-fused tiled route
        a, gate_frame = gate_scene(dev)
        gt = torch.as_tensor(a["gt"].astype(np.float32) / 255.0, device=dev)
        g32 = dataclasses.replace(a["model_cfg"], plane_interp="bicubic")
        g16 = dataclasses.replace(g32, compute_dtype="bfloat16")
        kern = gate_frame(tiled_fn, g16, 16)
        plain = gate_frame(plain_point_fn, g16, 16)
        routed = {}
        for name, gcfg, kern_ in (
                ("bicubic", g32, kernels.plane_sample_cubic_fwd),
                ("bilinear", a["model_cfg"], kernels.plane_sample_fwd)):
            before = kern_.launches
            routed[name] = (gate_frame(tiled_fn, gcfg, 16),
                            gate_frame(reference_fn, gcfg, 16))
            sync()
            if on_card and kern_.launches == before:
                fail(f"the {name} f32 gate frame did not launch "
                     f"{kern_.symbol}")
        ref32 = gate_frame(reference_fn, g32, None)
        p_kp, p_r = psnr(kern, plain), psnr(ref32, gt)
        p_cub, p_lin = (psnr(*routed["bicubic"]), psnr(*routed["bilinear"]))
        print(f"[gate bicubic] held-out PSNR vs gt: kernel "
              f"{psnr(kern, gt):.3f} dB, plain {psnr(plain, gt):.3f} dB, "
              f"f32 sampler route {psnr(routed['bicubic'][0], gt):.3f} dB, "
              f"f32 reference path {p_r:.3f} dB (JAX reference on the CPU: "
              f"{GATE_BICUBIC_REF_PSNR_DB} dB); kernel vs plain "
              f"{p_kp:.2f} dB; f32 sampler route vs reference path, 16x16 "
              f"tiles: bicubic {p_cub:.2f} dB, bilinear (the scene's own "
              f"config) {p_lin:.2f} dB (min {GATE_PSNR_MIN_DB})")
        if not (min(p_kp, p_cub, p_lin) >= GATE_PSNR_MIN_DB
                and abs(p_r - GATE_BICUBIC_REF_PSNR_DB) < 0.05):
            fail("bicubic gate scene check failed")
    return entries


# sha256 of the four ray entries' outputs on the inputs of
# triplane_digests(), as csrc/triplane_render.cu gave them on the H100
# (nvcc 12.9) with the wmma decoder, before and after it moved to
# csrc/decoder.cuh. The wgmma decoder (persistent blocks, activations in
# registers) gives the same digests: its tensor cores sum each point's
# products in the same K order, so the redesign changed no bit, and any
# later refactor must not either. Another nvcc may schedule the f32 steps
# otherwise, so they are compared only under the release they were taken
# with; a deliberate change of the ray entries' numerics replaces them
TRIPLANE_DIGESTS_NVCC = "12.9"
TRIPLANE_DIGESTS = {
    "triplane_render_full":
        "2ba2af9de965668a6ac319244010dd64b34e4fa52417bb76c6a9d233672b8f42",
    "triplane_render_sigma_only":
        "eebec0223c117e5cc7c9b00d0c995ba167497bb43effac8a0a91903ca99737d5",
    "triplane_render_cubic_full":
        "4185a4ae862f5684787b5770c2e510179ac8376f8ee88231c30538bf13031629",
    "triplane_render_cubic_sigma_only":
        "db1ddbf8aaf1a6551e243296ce13b9f384c5f1ee3a962f57f7d6ad4a58c2bfa8",
}


def nvcc_release():
    """The release of the nvcc that builds the kernels, e.g. "12.8"."""
    import re

    from nvsr_tpu_torch import kernels
    out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    m = re.search(r"release ([0-9.]+)", out)
    return m.group(1) if m else out.strip()


def triplane_digests(dev):
    """{entry: sha256 of its [R, S, 4] f32 output} for the four ray entries
    of triplane_render.cu on fixed inputs made on the host from seed 11
    (4096 rays x 16 depths on 3x48x200^2 planes, the flagship decoder)."""
    import hashlib

    import numpy as np
    import torch
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.triplane import TriplaneConfig, make_rot_mats
    from nvsr_tpu_torch.ops import fused_render
    gen = torch.Generator().manual_seed(11)
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, compute_dtype="bfloat16")
    packed = fused_render.pack_decoder(random_decoder(gen, cfg, dev), cfg)
    table = fused_render.build_plane_table(
        (0.5 * torch.randn((3, 48, 200, 200), generator=gen)).to(dev))
    r, s = 4096, 16
    origins = (torch.rand((r, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.randn((r, 3), generator=gen).to(dev)
    z = torch.sort(torch.rand((r, s), generator=gen) * 3 + 0.5, -1
                   ).values.to(dev)
    view = fused_render.view_rows(torch.randn((r, 48), generator=gen).to(dev),
                                  packed.cvp)
    box = np.stack([[-2, -2, -2, -np.pi, -np.pi / 2],
                    [2, 2, 2, np.pi, np.pi / 2]]).astype(np.float32)
    geom = fused_render.geometry_args(box, make_rot_mats(3))
    digests = {}
    for cubic in (False, True):
        for so in (False, True):
            name = ("triplane_render_" + ("cubic_" if cubic else "")
                    + ("sigma_only" if so else "full"))
            out = kernels.triplane_render(table, packed, origins, dirs, z,
                                          view, geom, align_corners=True,
                                          avg=True, sigma_only=so,
                                          cubic=cubic)
            digests[name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()
    return digests


def points_fn(params, cfg, planes, plane_view, box, sigma_only, form="v2",
              rot_mats=None):
    """A point fn through the port's public points entry,
    apply_triplane_rays(tile_cfg=TileSamplerConfig(tile_rays=256)), with
    the plane table and the packed decoder built once (table=, packed=);
    form "v1": the TPU v1 kernel's rounding; rot_mats as the entry takes
    them (None: its default)."""
    import torch
    from nvsr_tpu_torch.models.triplane import apply_triplane_rays
    from nvsr_tpu_torch.ops import fused_render
    from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
    tile = TileSamplerConfig(tile_rays=256)
    table = fused_render.build_plane_table(planes)
    packed = fused_render.pack_decoder(params, cfg) \
        if fused_render.supports(cfg) else None
    box_dev = torch.as_tensor(box, dtype=torch.float32, device=planes.device)

    def point_fn(pts, rays, z_vals):
        return apply_triplane_rays(params, cfg, planes, plane_view, box_dev,
                                   pts, rays.viewdirs, tile_cfg=tile,
                                   table=table, packed=packed,
                                   sigma_only=sigma_only, form=form,
                                   rot_mats=rot_mats)

    return point_fn


def grids_block(cfg, dec_c, dec_f, planes_lr, planes_sr, plane_view, box,
                occ, ro, rd):
    """One RAY_BLOCK block of the flagship passes in the points entry's
    form: {"coarse": (table, packed, grids [3, N, 2], None) for S=16 on
    the LR planes, "fine": (..., view rows [N, cvp]) for S=32 on the SR
    planes}, through the port's public functions (the coarse pass that
    places the fine depths too)."""
    import torch
    from nvsr_tpu_torch.models.triplane import (make_rot_mats,
                                                sample_viewdir_plane)
    from nvsr_tpu_torch.ops import fused_render
    from nvsr_tpu_torch.ops.rendering import volume_render
    from nvsr_tpu_torch.ops.sampling import (hierarchical_z_vals,
                                             stratified_z_vals)
    from nvsr_tpu_torch.render import (make_ray_bundle, tighten_bundle,
                                       tile_ray_maps)
    rays = make_ray_bundle(tile_ray_maps(ro, 16), tile_ray_maps(rd, 16),
                           2.0, 6.0, use_viewdirs=True)
    rays = tighten_bundle(rays, occ, tile_rays=256)
    blk = type(rays)(*[f[:RAY_BLOCK] for f in rays])
    geom = fused_render.geometry_args(box, make_rot_mats(3))
    z_c = stratified_z_vals(blk.near, blk.far, 16, lindisp=False,
                            perturb=False)
    tab_c = fused_render.build_plane_table(planes_lr)
    tab_f = fused_render.build_plane_table(planes_sr)
    pk_c = fused_render.pack_decoder(dec_c, cfg)
    pk_f = fused_render.pack_decoder(dec_f, cfg)
    rf_c, _ = fused_render.fused_render_rays(
        tab_c, pk_c, blk.origins, blk.directions, z_c, None, geom,
        align_corners=True, avg=True, sigma_only=True)
    z_f = hierarchical_z_vals(
        z_c, volume_render(rf_c, z_c, blk.directions).weights, 16, det=True)
    r, s = z_f.shape
    view = fused_render.view_rows(sample_viewdir_plane(
        plane_view, blk.viewdirs, box, cfg), pk_f.cvp)
    view_pts = view[:, None, :].expand(r, s, pk_f.cvp).reshape(
        r * s, pk_f.cvp).contiguous()

    def grids(z):
        return torch.stack(fused_render.plane_grids(
            blk.origins, blk.directions, z, geom)).contiguous()

    return {"coarse": (tab_c, pk_c, grids(z_c), None),
            "fine": (tab_f, pk_f, grids(z_f), view_pts)}


def tap_pair_rows(table, grids, align_corners=True):
    """The fine pass's input to the standalone decoder, as the TPU tile
    gather gives it: per plane and point the bf16 x-interpolated rows of
    the two bilinear taps (top in lanes 0:64, bottom in 64:128) -> rows
    [3N, 128] bf16, ty [3N] f32 (plane-major)."""
    import torch
    from nvsr_tpu_torch.ops.grid_sample import _corners
    _, h, w, cp = table.shape
    n = grids.shape[1]
    rows = torch.zeros((3, n, 128), dtype=torch.bfloat16,
                       device=table.device)
    ty = torch.empty((3, n), dtype=torch.float32, device=table.device)
    for p in range(3):
        x, y, x0, x1, y0, y1 = _corners(grids[p], h, w, align_corners)
        tx = (x - torch.floor(x))[:, None]
        w0 = (1.0 - tx).to(torch.bfloat16).float()
        w1 = tx.to(torch.bfloat16).float()
        cells = table[p].reshape(h * w, cp)
        for half, ya in ((0, y0), (64, y1)):
            rows[p, :, half:half + cp] = (
                w0 * cells[ya * w + x0].float()
                + w1 * cells[ya * w + x1].float()).to(torch.bfloat16)
        ty[p] = y - torch.floor(y)
    return rows.reshape(3 * n, 128), ty.reshape(3 * n)


def tap_table(plane):
    """One plane [C, H, W] (C <= 64) -> [H*W, 256] f32 rows of its 2x2
    bilinear taps, (y, x), (y, x+1), (y+1, x), (y+1, x+1) clamped to the
    border, 64 channels each (the packed-tap table of JAX's
    packed_bilinear_sample, whose row gather gather_dma.py measured)."""
    import torch
    c, h, w = plane.shape
    p = torch.zeros((64, h, w), dtype=torch.float32, device=plane.device)
    p[:c] = plane
    xs = torch.clamp(torch.arange(w, device=plane.device) + 1, max=w - 1)
    ys = torch.clamp(torch.arange(h, device=plane.device) + 1, max=h - 1)
    taps = [p, p[:, :, xs], p[:, ys, :], p[:, ys][:, :, xs]]
    return torch.cat(taps, dim=0).permute(1, 2, 0).reshape(
        h * w, 256).contiguous()


def grids_checks(blk):
    """The three grids entries against their plain versions at the block's
    pass shapes, timed with CUDA events -> (kernel entries, the v1 fine
    output, its ms)."""
    import torch
    from nvsr_tpu_torch.ops import fused_render
    entries, v1 = {}, None
    for name, (tab, pk, grids, view), so, form in (
            ("triplane_render_grids_sigma_only", blk["coarse"], True, "v2"),
            ("triplane_render_grids_full", blk["fine"], False, "v2"),
            ("triplane_render_grids_v1", blk["fine"], False, "v1")):
        kw = dict(align_corners=True, avg=True, sigma_only=so, form=form)
        out, _ = fused_render.tiled_render_chunked(tab, pk, grids, view, **kw)
        ref = fused_render.tiled_render_chunked_reference(tab, pk, grids,
                                                          view, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{name}: non-finite kernel output")
        err = (out - ref).abs()
        ms = cuda_ms(lambda: fused_render.tiled_render_chunked(
            tab, pk, grids, view, **kw))
        plain_ms = cuda_ms(lambda: fused_render.tiled_render_chunked_reference(
            tab, pk, grids, view, **kw), warmup=1, reps=3)
        b_ms, b_by = grids_bound(tab, pk, grids, view, so)
        print(f"[points] {name} (N={grids.shape[1]} on {tab.shape[1]}^2): "
              f"max err {err.max().item():.3e} mean {err.mean().item():.3e} "
              f"(tol max {MAX_ABS_TOL}, mean {MEAN_ABS_TOL}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"by {b_by} ({b_ms / ms:.1%})")
        if not (err.max() <= MAX_ABS_TOL and err.mean() <= MEAN_ABS_TOL):
            fail(f"{name} disagrees with its plain version")
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "nvsr_tpu_torch/csrc/triplane_render.cu",
            "replaces": "nvsr_tpu/ops/pallas/tile_sampler.py:"
                        + ("794" if form == "v1" else "904"),
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if form == "v1":
            v1 = (out, ms)
    return entries, v1


def decoder_inputs(fine):
    """(rows, ty, view [N, 64] f32, packed) of the fine pass for the
    standalone decoder."""
    import torch
    tab, pk, grids, view = fine
    rows, ty = tap_pair_rows(tab, grids)
    view32 = torch.zeros((view.shape[0], 64), dtype=torch.float32,
                         device=view.device)
    view32[:, :pk.cvp] = view.float()
    return rows, ty, view32, pk


def decoder_check(fine, v1):
    """fused_decode against its plain version at the fine pass's point
    count, its result beside the v1 grids entry's (the same features and
    decoder), timed -> its kernel entry."""
    import torch
    from nvsr_tpu_torch.ops import fused_decoder
    rows, ty, view32, pk = decoder_inputs(fine)
    n = view32.shape[0]
    out = fused_decoder.fused_decode(rows, ty, view32, pk, avg=True)
    ref = fused_decoder.fused_decode_reference(rows, ty, view32, pk,
                                               avg=True)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("fused_decode: non-finite kernel output")
    err = (out - ref).abs()
    same = torch.equal(out[:, :4], v1[0])
    ms = cuda_ms(lambda: fused_decoder.fused_decode(rows, ty, view32, pk,
                                                    avg=True))
    plain_ms = cuda_ms(lambda: fused_decoder.fused_decode_reference(
        rows, ty, view32, pk, avg=True), warmup=1, reps=3)
    feats = fused_decoder.lerp_pair(rows, ty, pk.cp).reshape(3, n, pk.cp)
    parts = layered_parts(pk, *feats, view32)
    lay_ms = cuda_ms(lambda: layered_decoder(pk, parts), warmup=3, reps=20)
    del feats, parts
    # bytes: what the kernel reads, once: per plane and point the first cp
    # channels of each tap half and ty, per point cvp view lanes (the pad
    # lanes cannot count), the weights; the output once. Operations: the
    # decoder; per point, plane and channel the lerp's 2 products, 1
    # difference, 1 sum and the comb sum
    b_ms, b_by = bound(3 * n * (2 * pk.cp * rows.element_size()
                                + ty.element_size())
                       + n * pk.cvp * view32.element_size()
                       + nbytes_of(pk.w, pk.b, pk.wh, pk.bh, out),
                       (decode_flops(pk, False) * n, BF16_TC_FLOPS),
                       (n * 3 * pk.cp * 5, F32_FLOPS))
    print(f"[points] fused_decode (N={n}): max err {err.max().item():.3e} "
          f"mean {err.mean().item():.3e} (tol max {MAX_ABS_TOL}, mean "
          f"{MEAN_ABS_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%}); the same "
          f"decoder as bf16 cuBLAS layers, layered_ms {lay_ms:.3f}; rgb "
          f"and sigma "
          f"bit-identical to the v1 grids entry on the same tap pairs: "
          f"{'yes' if same else 'no'}; the v1 entry (gather + decode) "
          f"{v1[1]:.3f} ms")
    if not (err.max() <= MAX_ABS_TOL and err.mean() <= MEAN_ABS_TOL):
        fail("fused_decode disagrees with its plain version")
    if not same:
        fail("fused_decode on the v1 grids entry's tap pairs differs from "
             "that entry's rgb and sigma")
    return {"fused_decode": {
        "name": "fused_decode", "route": "cuda",
        "source": "nvsr_tpu_torch/csrc/fused_decode.cu",
        "replaces": "nvsr_tpu/ops/pallas/fused_decoder.py:220",
        "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "layered_ms": lay_ms}}


# gather_dma.py's own workload (its docstring): 524,288 rows of 256 f32
# from a 655,360-row table
GATHER_ROWS, GATHER_TABLE_ROWS, GATHER_WIDTH = 524288, 655360, 256


def gather_check(dev):
    """gather_rows_dma against its plain version (bit-equal) at
    gather_dma.py's own workload, timed beside torch.index_select -> its
    kernel entry."""
    import torch
    from nvsr_tpu_torch.ops import gather_dma
    gen = torch.Generator(device=dev).manual_seed(12)
    table = torch.randn((GATHER_TABLE_ROWS, GATHER_WIDTH), generator=gen,
                        device=dev)
    idx = torch.randint(0, GATHER_TABLE_ROWS, (GATHER_ROWS,), generator=gen,
                        device=dev, dtype=torch.int32)
    out = gather_dma.gather_rows_dma(table, idx)
    ref = gather_dma.gather_rows_reference(table, idx)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # the public op as a caller pays it, in turns with index_select and
    # the plain version: medians of 25 calls each
    t_k, t_lib, t_plain = interleaved_ms((
        lambda: gather_dma.gather_rows_dma(table, idx),
        lambda: torch.index_select(table, 0, idx),
        lambda: gather_dma.gather_rows_reference(table, idx)))
    ms, lib_ms, plain_ms = (ts[len(ts) // 2] for ts in (t_k, t_lib, t_plain))
    # bytes: each distinct table row the indices name, read once; the
    # indices and the output once
    b_ms, b_by = bound(torch.unique(idx).numel() * GATHER_WIDTH
                       * table.element_size() + nbytes_of(idx, out),
                       (0, F32_FLOPS))
    print(f"[points] gather_rows_dma ({GATHER_ROWS} rows of {GATHER_WIDTH} "
          f"f32 from {GATHER_TABLE_ROWS}): bit-equal to its plain version: "
          f"{'yes' if torch.equal(out, ref) else 'no'}; in turns, median "
          f"(min .. max) of {len(t_k)}: kernel {spread(t_k)}, "
          f"torch.index_select {spread(t_lib)}, plain {spread(t_plain)}; "
          f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%})")
    if not torch.equal(out, ref):
        fail("gather_rows_dma disagrees with its plain version")
    return {"gather_rows_dma": {
        "name": "gather_rows_dma", "route": "cuda",
        "source": "nvsr_tpu_torch/csrc/gather_rows.cu",
        "replaces": "nvsr_tpu/ops/pallas/gather_dma.py:29",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}}


def points_phase(dev, c2w, w=EVAL_FULL, on_card=True, profile=False):
    """Phase 7 (see the module docstring). With on_card=False (a CPU
    rehearsal at a small `w`) the kernel checks, launch counts and timings
    are skipped and every pass runs the plain versions. profile: after the
    timed frames, one frame through each entry under torch.profiler."""
    import numpy as np
    import torch
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig, apply_plane_sr
    from nvsr_tpu_torch.models.triplane import TriplaneConfig, make_rot_mats
    from nvsr_tpu_torch.ops import fused_decoder, gather_dma
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.ops.grid_sample import _corners
    from nvsr_tpu_torch.render import RenderConfig, render_image

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c, res, vr = w["channels"], w["res"], w["view_res"]
    gen = torch.Generator().manual_seed(3)
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, num_plane_channels=c,
                         gather_table_dtype="bfloat16",
                         compute_dtype="bfloat16")
    sr_cfg = PlaneSRConfig(in_channels=c, out_channels=c,
                           hidden_size=w["sr_hidden"],
                           n_blocks=w["sr_blocks"],
                           scale_factor=w["sr_scale"],
                           compute_dtype="bfloat16")
    dec_c = random_decoder(gen, cfg, dev)
    dec_f = random_decoder(gen, cfg, dev)
    for dec in (dec_c, dec_f):
        dec["members"][0]["fc_alpha"]["b"].fill_(1.0)
    sr_params = random_edsr(gen, sr_cfg, dev)
    planes_lr = (0.03 * torch.randn((3, c, res, res), generator=gen)).to(dev)
    plane_view = (0.03 * torch.randn((c, vr, vr), generator=gen)).to(dev)
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    occ = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]], np.float32)
    img = w["image"]
    ro, rd = get_ray_bundle(img, img, 0.5 * img / np.tan(0.3),
                            torch.as_tensor(c2w, device=dev))
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        ray_block=RAY_BLOCK)

    def frame(make_fn, planes_sr, **kw):
        return render_image(
            make_fn(dec_c, cfg, planes_lr, plane_view, box, True, **kw),
            make_fn(dec_f, cfg, planes_sr, plane_view, box, False, **kw),
            ro, rd, rcfg, near=2.0, far=6.0, occ_aabb=occ,
            tile=16).fine.rgb

    entries = {}
    with torch.no_grad():
        if on_card:
            digests, rel = triplane_digests(dev), nvcc_release()
            if rel != TRIPLANE_DIGESTS_NVCC:
                print(f"[points] ray-entry digests pinned under nvcc "
                      f"{TRIPLANE_DIGESTS_NVCC}, this build's is {rel}: not "
                      f"compared; {digests}")
            else:
                same = {k: digests[k] == TRIPLANE_DIGESTS[k]
                        for k in digests}
                print(f"[points] the four ray entries' outputs equal to "
                      f"the pinned digests (nvcc {rel}): {same}")
                if not all(same.values()):
                    fail(f"a ray entry's output changed: {digests}")
            planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
            blk = grids_block(cfg, dec_c, dec_f, planes_lr, planes_sr,
                              plane_view, box, occ, ro, rd)
            entries, v1 = grids_checks(blk)
            entries.update(decoder_check(blk["fine"], v1))
            del blk, v1
            entries.update(gather_check(dev))

        # the points entry once: SR, the frame through the public points
        # entry (v2, then v1), and the two public ops that no render path
        # calls, on the fine pass's data
        mine = (kernels.triplane_render_grids_full,
                kernels.triplane_render_grids_sigma_only,
                kernels.triplane_render_grids_v1, kernels.fused_decode,
                kernels.gather_rows)
        for k in kernels.KERNELS:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        rgb = frame(points_fn, planes_sr)
        rgb_v1 = frame(points_fn, planes_sr, form="v1")
        fine = grids_block(cfg, dec_c, dec_f, planes_lr, planes_sr,
                           plane_view, box, occ, ro, rd)["fine"]
        dec_in = decoder_inputs(fine)
        dec = fused_decoder.fused_decode(*dec_in, avg=True)
        taps = tap_table(planes_sr[0])
        h, w_ = planes_sr.shape[-2:]
        n = fine[2].shape[1] // gather_dma.BLOCK * gather_dma.BLOCK
        _, _, x0, _, y0, _ = _corners(fine[2][0, :n], h, w_, True)
        cells = (y0 * w_ + x0).to(torch.int32)
        got = gather_dma.gather_rows_dma(taps, cells)
        sync()
        main_s = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in mine}
        print(f"[points] SR + {img}x{img} frame through the points entry, "
              f"v2 and v1, + fused_decode ({dec.shape[0]} points) + "
              f"gather_rows_dma ({n} rows) in {main_s:.3f} s (first run); "
              f"launches {launches}")
        for name, x in (("v2", rgb), ("v1", rgb_v1)):
            if tuple(x.shape) != (img, img, 3) or not torch.isfinite(x).all():
                fail(f"points-entry {name} frame: shape {tuple(x.shape)} or "
                     f"non-finite")
        e_dec = (dec - fused_decoder.fused_decode_reference(
            *dec_in, avg=True)).abs()
        if not (e_dec.max() <= MAX_ABS_TOL and e_dec.mean() <= MEAN_ABS_TOL):
            fail("fused_decode on the fine pass disagrees with its plain "
                 "version")
        if not torch.equal(got, gather_dma.gather_rows_reference(taps,
                                                                 cells)):
            fail("gather_rows_dma on the fine pass disagrees with its "
                 "plain version")
        rays_rgb = frame(tiled_fn, planes_sr)
        p_v2, p_v1 = psnr(rgb, rays_rgb), psnr(rgb_v1, rays_rgb)
        print(f"[points] frame through the points entry vs the from-rays "
              f"entry: v2 {p_v2:.2f} dB, v1 {p_v1:.2f} dB (min "
              f"{GATE_PSNR_MIN_DB}); fused_decode max err "
              f"{e_dec.max().item():.3e}, gather_rows_dma bit-equal")
        if min(p_v2, p_v1) < GATE_PSNR_MIN_DB:
            fail("the points-entry frame disagrees with the from-rays frame")
        if on_card:
            if min(launches.values()) == 0:
                fail(f"a kernel of the points path was never launched: "
                     f"{launches}")
            for name in entries:
                entries[name]["launches"] = launches[
                    "gather_rows" if name == "gather_rows_dma" else name]

            def fns(make, **kw):
                return (make(dec_c, cfg, planes_lr, plane_view, box, True,
                             **kw),
                        make(dec_f, cfg, planes_sr, plane_view, box, False,
                             **kw))

            def timed(pf):
                return render_image(*pf, ro, rd, rcfg, near=2.0, far=6.0,
                                    occ_aabb=occ, tile=16).fine.rgb

            runs = [("the points entry", fns(points_fn)),
                    ("the from-rays entry", fns(tiled_fn))]
            if profile:
                # and the points entry given numpy rotation matrices,
                # which it copies to the card on every call
                runs.append(("the points entry, numpy rot_mats",
                             fns(points_fn, rot_mats=make_rot_mats(3))))
            for name, pf in runs:
                ts = frame_ms(lambda: timed(pf), reps=w["reps"])
                med = ts[len(ts) // 2]
                print(f"[points] frame through {name}: median of {len(ts)} "
                      f"{med:.2f} ms (min {ts[0]:.2f}, max {ts[-1]:.2f}) = "
                      f"{img * img / med * 1e3:.0f} rays/s")
            for name, pf in runs if profile else ():
                profile_run(f"frame through {name}", lambda: timed(pf))
    return entries


def flagship(dev):
    """bench.py's eval frame at TrainModels widths, weights random from
    seed 0 -> (cfg, sr_cfg, dec_c, dec_f, sr_params, planes_lr, plane_view,
    box, occ, ro, rd, rcfg)."""
    import numpy as np
    import torch
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig
    from nvsr_tpu_torch.models.triplane import TriplaneConfig
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.render import RenderConfig
    gen = torch.Generator().manual_seed(0)
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, gather_table_dtype="bfloat16",
                         compute_dtype="bfloat16")
    sr_cfg = PlaneSRConfig(in_channels=48, out_channels=48, hidden_size=256,
                           n_blocks=32, scale_factor=4,
                           compute_dtype="bfloat16")
    dec_c = random_decoder(gen, cfg, dev)
    dec_f = random_decoder(gen, cfg, dev)
    for dec in (dec_c, dec_f):
        # a positive density bias, so the random field is not empty and
        # the frame has content to compare
        dec["members"][0]["fc_alpha"]["b"].fill_(1.0)
    sr_params = random_edsr(gen, sr_cfg, dev)
    planes_lr = (0.03 * torch.randn((3, 48, 200, 200), generator=gen)
                 ).to(dev)
    plane_view = (0.03 * torch.randn((48, 32, 32), generator=gen)).to(dev)
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    occ = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]], np.float32)
    ro, rd = get_ray_bundle(800, 800, 0.5 * 800 / np.tan(0.3),
                            torch.as_tensor(camera([3.8, 0.5, 0.7]),
                                            device=dev))
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        ray_block=RAY_BLOCK)
    return (cfg, sr_cfg, dec_c, dec_f, sr_params, planes_lr, plane_view, box,
            occ, ro, rd, rcfg)


def sampler_times(dev, planes_lr, planes_sr, fine_args, box):
    """The plane sampler's kernels through their public wrappers, beside
    F.grid_sample (device-time medians of 25 in turns, interleaved_ms,
    which the host's launch time cannot inflate): the
    trainable forward and backward at the training coarse pass's shapes
    (train_phase's first batch on 3x48x200^2 planes), the backward also on
    a uniformly random copy of the grids, and the bicubic forward on the
    fine pass's grids (800^2 planes) -> {name: ms}."""
    import torch
    import torch.nn.functional as F
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.ops.fused_render import build_plane_table
    p, c, h, w = planes_lr.shape
    rays, _ = train_batches(dev, camera([3.8, 0.5, 0.7]), TRAIN_FULL)()
    grids = coarse_grids(rays, box, TRAIN_FULL["samples"])
    n = grids.shape[1]
    dout = torch.randn((p, n, c), generator=torch.Generator().manual_seed(
        5)).to(dev)
    rand_grids = torch.rand(grids.shape, generator=torch.Generator(
        device=dev).manual_seed(6), device=dev) * 2 - 1
    table = build_plane_table(planes_lr)
    x = planes_lr.detach().requires_grad_(True)
    cot = dout.permute(0, 2, 1).reshape(p, c, 1, n).contiguous()

    def lib(planes, g, mode):
        return F.grid_sample(planes, g[:, None], mode=mode,
                             padding_mode="border", align_corners=True)

    with torch.enable_grad():
        y = lib(x, grids, "bilinear")
    fine = fine_grids(fine_args)
    fns = {
        "sample_fwd": lambda: kernels.plane_sample_forward(
            table, grids, c, align_corners=True),
        "sample_fwd_lib": lambda: lib(planes_lr, grids, "bilinear"),
        "sample_bwd": lambda: kernels.plane_sample_backward(
            dout, grids, h, w, align_corners=True),
        "sample_bwd_random": lambda: kernels.plane_sample_backward(
            dout, rand_grids, h, w, align_corners=True),
        "sample_bwd_lib": lambda: torch.autograd.grad(
            y, x, cot, retain_graph=True),
        "cubic_fwd": lambda: kernels.plane_sample_forward(
            fine_args[0], fine, c, align_corners=True, cubic=True),
        "cubic_fwd_lib": lambda: lib(planes_sr, fine, "bicubic")}
    return {name: ts[len(ts) // 2]
            for name, ts in zip(fns, interleaved_ms(tuple(fns.values())))}


def times_of(root):
    """--times-of ROOT: the decoder's kernels at the main path's shapes
    (CUDA events, mean of 20 after 3 warm-ups) and the plane sampler's
    (sampler_times), the row gather and torch.index_select at
    gather_dma.py's workload (medians of 25 in turns), the flagship frame
    and the same frame in bicubic with an f32 decoder (the cubic sampler
    route; medians of 10) for the package under ROOT, with no checks ->
    one JSON line. The cubic entries run on the bilinear pass's points."""
    import torch
    sys.path.insert(0, root)
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import apply_plane_sr
    from nvsr_tpu_torch.ops import fused_decoder, fused_render, gather_dma
    from nvsr_tpu_torch.render import render_image
    kernels.build()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    (cfg, sr_cfg, dec_c, dec_f, sr_params, planes_lr, plane_view, box, occ,
     ro, rd, rcfg) = flagship(dev)
    out = {"root": root, "package": kernels.__file__}
    with torch.no_grad():
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        ca, fa = pass_args(cfg, dec_c, dec_f, planes_lr, planes_sr,
                           plane_view, box, occ, ro, rd)
        out.update(sampler_times(dev, planes_lr, planes_sr, fa, box))
        for name, args, so, cubic in (
                ("coarse", ca, True, False), ("fine", fa, False, False),
                ("cubic_coarse", ca, True, True),
                ("cubic_fine", fa, False, True)):
            out[name] = cuda_ms(lambda: kernels.triplane_render(
                *args, align_corners=True, avg=True, sigma_only=so,
                cubic=cubic), warmup=3, reps=20)
        blk = grids_block(cfg, dec_c, dec_f, planes_lr, planes_sr,
                          plane_view, box, occ, ro, rd)
        tab, pk, grids, view = blk["fine"]
        for name, form in (("grids_fine", "v2"), ("grids_v1", "v1")):
            out[name] = cuda_ms(lambda: fused_render.tiled_render_chunked(
                tab, pk, grids, view, align_corners=True, avg=True,
                sigma_only=False, form=form), warmup=3, reps=20)
        dec_in = decoder_inputs(blk["fine"])
        out["fused_decode"] = cuda_ms(lambda: fused_decoder.fused_decode(
            *dec_in, avg=True), warmup=3, reps=20)
        del blk, dec_in
        gen = torch.Generator(device=dev).manual_seed(12)
        table = torch.randn((GATHER_TABLE_ROWS, GATHER_WIDTH), generator=gen,
                            device=dev)
        idx = torch.randint(0, GATHER_TABLE_ROWS, (GATHER_ROWS,),
                            generator=gen, device=dev, dtype=torch.int32)
        t_k, t_lib = interleaved_ms((
            lambda: gather_dma.gather_rows_dma(table, idx),
            lambda: torch.index_select(table, 0, idx)))
        out["gather"], out["index_select"] = (t_k[len(t_k) // 2],
                                              t_lib[len(t_lib) // 2])
        del table, idx
        pf_c = tiled_fn(dec_c, cfg, planes_lr, plane_view, box, True)
        pf_f = tiled_fn(dec_f, cfg, planes_sr, plane_view, box, False)
        ts = frame_ms(lambda: render_image(
            pf_c, pf_f, ro, rd, rcfg, near=2.0, far=6.0, occ_aabb=occ,
            tile=16).fine.rgb, reps=10)
        out["frame_median"], out["frame_min"], out["frame_max"] = (
            ts[len(ts) // 2], ts[0], ts[-1])
        cfg32 = dataclasses.replace(cfg, plane_interp="bicubic",
                                    compute_dtype=None)
        pf_c = tiled_fn(dec_c, cfg32, planes_lr, plane_view, box, True)
        pf_f = tiled_fn(dec_f, cfg32, planes_sr, plane_view, box, False)
        ts = frame_ms(lambda: render_image(
            pf_c, pf_f, ro, rd, rcfg, near=2.0, far=6.0, occ_aabb=occ,
            tile=16).fine.rgb, reps=10)
        out["f32_bicubic_frame_median"] = ts[len(ts) // 2]
        out["f32_bicubic_frame_min"] = ts[0]
        out["f32_bicubic_frame_max"] = ts[-1]
    print(json.dumps(out))


def compare(roots):
    """--times [ROOT ...]: times_of for each ROOT (default: this
    checkout), each in its own process, in the order given (e.g. parent,
    change, change, parent)."""
    for root in roots or [ROOT]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--times-of", os.path.abspath(root)],
                           capture_output=True, text=True, timeout=900)
        print(r.stdout.strip().splitlines()[-1] if r.returncode == 0 else
              f"{root}: exit {r.returncode}\n{r.stdout[-3000:]}"
              f"{r.stderr[-3000:]}", flush=True)


def main(profile=False):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "GPU")
    sys.path.insert(0, ROOT)
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import apply_plane_sr
    from nvsr_tpu_torch.render import render_image

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    # f32 matmuls (the plain decoder) and f32 convs in full precision;
    # the flagship EDSR runs bf16, where TF32 does not apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.build(verbose=True)
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # -- flagship setup (bench.py's eval frame) -------------------------
    (cfg, sr_cfg, dec_c, dec_f, sr_params, planes_lr, plane_view, box, occ,
     ro, rd, rcfg) = flagship(dev)
    H = W = 800

    with torch.no_grad():
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        torch.cuda.synchronize()

        # -- 2. kernels vs plain at the pass shapes ----------------------
        entries, _ = render_checks(cfg, dec_c, dec_f, planes_lr, planes_sr,
                                   plane_view, box, occ, ro, rd)

        # -- 3. the main path once ---------------------------------------
        frame_kernels = (kernels.triplane_render_full,
                         kernels.triplane_render_sigma_only)
        for k in kernels.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        pf_c = tiled_fn(dec_c, cfg, planes_lr, plane_view, box, True)
        pf_f = tiled_fn(dec_f, cfg, planes_sr, plane_view, box, False)
        res = render_image(pf_c, pf_f, ro, rd, rcfg, near=2.0, far=6.0,
                           occ_aabb=occ, tile=16)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in frame_kernels}
        rgb = res.fine.rgb
        print(f"[main] SR + 800x800 frame in {main_s:.3f} s (first run); "
              f"launches {launches}; aux {res.aux}")
        if tuple(rgb.shape) != (H, W, 3) or not torch.isfinite(rgb).all():
            fail(f"flagship frame: shape {tuple(rgb.shape)} or non-finite")
        if min(launches.values()) == 0:
            fail(f"a kernel of the path was never launched: {launches}")
        for name in entries:
            entries[name]["launches"] = launches[name]
        print(f"[main] frame finite, rgb mean {rgb.mean().item():.4f}, "
              f"acc mean {res.fine.acc.mean().item():.4f}")

        sr_ms = cuda_ms(lambda: apply_plane_sr(sr_params, sr_cfg, planes_lr),
                        warmup=1, reps=3)
        print(f"[main] plane SR (3x48x200^2 -> 800^2, EDSR 256x32 bf16): "
              f"{sr_ms:.2f} ms")

        def frame(pc, pf):
            return render_image(pc, pf, ro, rd, rcfg, near=2.0, far=6.0,
                                occ_aabb=occ, tile=16).fine.rgb

        kern_ms = frame_ms(lambda: frame(pf_c, pf_f), reps=10)
        pp_c = plain_point_fn(dec_c, cfg, planes_lr, plane_view, box, True)
        pp_f = plain_point_fn(dec_f, cfg, planes_sr, plane_view, box, False)
        plain_rgb = frame(pp_c, pp_f)
        plain_ms = frame_ms(lambda: frame(pp_c, pp_f), reps=3)
        for name, ts in (("the kernels", kern_ms),
                         ("the plain version", plain_ms)):
            med = ts[len(ts) // 2]
            print(f"[main] frame through {name}: median of {len(ts)} "
                  f"{med:.2f} ms (min {ts[0]:.2f}, max {ts[-1]:.2f}) = "
                  f"{H * W / med * 1e3:.0f} rays/s")
        print(f"[main] kernel vs plain frame PSNR "
              f"{psnr(rgb, plain_rgb):.2f} dB")

        # -- 4. the gate scene -------------------------------------------
        a, gate_frame = gate_scene(dev)
        gt = torch.as_tensor(a["gt"].astype(np.float32) / 255.0, device=dev)
        g_cfg = dataclasses.replace(a["model_cfg"], compute_dtype="bfloat16")
        kern = gate_frame(tiled_fn, g_cfg, 16)
        plain = gate_frame(plain_point_fn, g_cfg, 16)
        ref = gate_frame(reference_fn, a["model_cfg"], None)
        p_k, p_p, p_r = psnr(kern, gt), psnr(plain, gt), psnr(ref, gt)
        p_kp = psnr(kern, plain)
        print(f"[gate] held-out PSNR vs gt: kernel {p_k:.3f} dB, plain "
              f"{p_p:.3f} dB, f32 reference path {p_r:.3f} dB (JAX "
              f"reference on the CPU: {GATE_REF_PSNR_DB} dB); kernel vs "
              f"plain {p_kp:.2f} dB (min {GATE_PSNR_MIN_DB})")
        if not (p_kp >= GATE_PSNR_MIN_DB and abs(p_k - p_p) < 0.05
                and abs(p_r - GATE_REF_PSNR_DB) < 0.05):
            fail("gate scene check failed")

    # -- 5. training ------------------------------------------------------
    entries.update(train_phase(dev, camera([3.8, 0.5, 0.7]),
                               profile=profile))

    # -- 6. bicubic planes ------------------------------------------------
    entries.update(bicubic_phase(dev, camera([3.8, 0.5, 0.7])))

    # -- 7. the points entry ----------------------------------------------
    entries.update(points_phase(dev, camera([3.8, 0.5, 0.7]),
                                profile=profile))

    print(card)
    print(json.dumps({"kernels": [entries[name] for name in (
        "triplane_render_sigma_only", "triplane_render_full",
        "plane_sample_fwd", "plane_sample_bwd",
        "triplane_render_cubic_sigma_only", "triplane_render_cubic_full",
        "plane_sample_cubic_fwd", "triplane_render_grids_sigma_only",
        "triplane_render_grids_full", "triplane_render_grids_v1",
        "fused_decode", "gather_rows_dma")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # --profile: also profile one HR/SR and one LR training step, and one
    # frame through each of the points and from-rays entries; --times
    # [ROOT ...]: compare builds (see compare), no checks
    argv = sys.argv[1:]
    if argv[:1] == ["--times-of"]:
        times_of(argv[1])
    elif argv[:1] == ["--times"]:
        compare(argv[1:])
    else:
        main(profile="--profile" in argv)
