"""Chip smoke test of the PyTorch/CUDA port (nvsr_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:  python3 chip_smoke.py  (add --profile to also trace one
HR/SR and one LR training step, one frame through each of the points
and from-rays entries, one Experiment eval view, and one LR and one
HR/SR Experiment iteration, with torch.profiler)

Phases (any failure raises and the script exits non-zero):
  0. build and load the native plane-store library (native/nvsr_native.cpp
     into build/nvsr_tpu_torch/native/), printing its path and build
     seconds: the Experiment phases write their plane files through it,
     and there is no fallback to npz;
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
     timed, median of 10 each;
  8. the Experiment's eval half, as `python -m nvsr_tpu_torch.cli
     --config ... --eval images` drives it: a synthetic Blender-style
     scene at 800x800 (train, val and two test views) written through
     the port's PNG writer, and a logdir in the JAX package's layout at
     TrainModels width (configs/TrainModels.yml as a dict: LR group
     8,200,32, HR group 2,800,32 evaluated at 400x400, 4+4 decoders 128
     wide, 3x48x200^2 planes, EDSR 256x32 x4 bf16, 16+16 samples, ray
     blocks of 8192), random weights from seed 4, written with the port's
     save_pickle and PlaneStore; then, with launch counts zeroed,
     Experiment(cfg, eval_mode="images").run() on the card. Checks:
     metrics.txt (the keys JAX writes for an SR group) and PNGs; the full
     gather+decode entry launched exactly once per 8192-ray block per
     pass, two renders per view (SR and no SR), no other kernel; the
     plane SR once; the first view against the port's reference path on
     the Experiment's own planes, SR planes, box and weights (>= 45 dB).
     Prints the logdir load, plane SR set-up, eval per view and the two
     renders of a view, in ms;
  9. the Experiment's training half, as `python -m nvsr_tpu_torch.cli
     --config ...` drives it: the synthetic scene of phase 8 (its own val
     views the eval set), TrainModels width (configs/TrainModels.yml as a
     dict: 4096 rays, 16+16 samples, surface occupancy,
     nerf.train.tiled_gather on), trained from scratch with counts zeroed
     just before: 8 iterations, an evaluate at the first and the last,
     a save every 4; then a resume to 12. Checks: every flushed loss
     finite; plane_sample_fwd and plane_sample_bwd launched once per
     iteration on the trainable route and triplane_render_full once per
     8192-ray block per pass of each evaluate's renders, no other entry;
     the rolling and best checkpoints, SR checkpoints, exp_info.pkl and
     the plane files with their Adam leaves; a committed occupied box
     inside the scene box; an eval view on the trained planes against
     the reference path (>= 45 dB); the resume at the saved start_i with
     every parameter and Adam state bit-equal to the first run's. Prints
     the LR and HR/SR iteration ms, save_checkpoints, evaluate and the
     resume's load ms, and the phase's seconds;
 10. what the port does beside the triplane path: (a) the baseline stage
     of configs/MipNeRF_baseline.yml (as a dict: 8 layers x 256, skip
     every 4, IPE of num_encoding_fn_xyz 16, dir PE 4, mip, 64+64
     samples, 1024 rays, density noise 0.2, consistency iterations, Adam
     5e-4) on phase 8's scene under the YAML's groups (8, trains at
     100^2, 2, validates at 400^2): 6 iterations then a resume to 10,
     an eval at each run's first and last iteration, a save every 2;
     checks finite losses, the logdir in the JAX layout, a bit-equal
     resume, a 48x48 crop of the val view rendered on the card against
     the port's own CPU render of the same rays and weights (>= 45 dB),
     and `--eval images` of the logdir (metrics.txt and PNGs, from the
     best checkpoint); prints the iteration, save, evaluate, resume-load
     and eval-per-view ms (--profile: one eval view's device time and
     idle share); (b) reference-layout torch checkpoints at TrainModels
     width (two 4+4x128 decoders with rot_mats_NON_LEARNED, EDSR 256x32
     x4 with the inner_model. prefix, a .par of 3x48x200^2 + 48x32^2
     planes with Adam moments) from a seeded generator, torch.save'd,
     read back by convert.load_torch_checkpoint and converted onto the
     card; then, with launch counts zeroed, SR and phase 3's 800x800
     frame through the fused kernel on the converted weights (>= 45 dB
     from the plain version; 79 launches of each frame entry); (c)
     SRResNet (64 wide, 16 blocks, x4, with and without BatchNorm, eval
     and train mode) on 3x48x200^2 planes, finite and of the right
     shape, and EDSR 256x32 x4 with tile_size 100 against the full plane
     in f32 (TF32 off; within 1e-3 of the trunk output's largest) and
     bf16 (>= 45 dB), each timed.
 11. data parallel through the entry point, as a user launches it:
     `python -m torch.distributed.run --standalone --nproc_per_node=N
     chip_smoke.py --cli REPORT --config <yml> ...` runs
     nvsr_tpu_torch.cli's main in each rank with probes (cli_rank:
     iterations timed between synchronizes, collectives, flushed losses,
     eval renders, plane files and pickles written, launches, peak
     memory, the PlaneStore backends, which must all be native on every
     rank of every run of phases 11 and 12). Phase 9's TrainModels config
     (as YAML, full width, `experiment.data_parallel: true`, the trainable
     route, an evaluate at the first and the last of 16 iterations, one
     save) on phase 9's scene, trained (a) without torchrun and as a world
     of 1 under NCCL, each alone on the card, (b) as a world of 2 under
     gloo with both ranks on cuda:0 beside a second plain run (the
     run-to-run control) and the port's dry run (`python -m
     nvsr_tpu_torch.parallel.dryrun 2 --device cuda:0 --dist-backend
     gloo`: one sharded step and eval render against the world of 1, gated
     by its own checks); then
     `--eval images` of the plain run's logdir by each, and of the world
     of 2's own logdir. Checks: the world of 1's first iteration (no
     update before it), its eval renders and PNGs bit-equal to the plain
     run's; every loss and PSNR of either world within JAX's bounds
     (rtol 2e-5 / 2e-4), the world of 2's eval renders, of the plain
     logdir and of its own, within rtol 1e-4 / atol 2e-5 of the plain
     eval; after an update two runs of one command differ by the order
     of the backward's atomics (plane_sample_bwd, index_add_, cuDNN), so
     the world of 1's parameters are held within DP_PARAM_BOUND of each
     leaf's largest (fixed from several runs' readings), with every
     run's deltas printed; each plane file written by its crc32 owner only,
     checkpoints and exp_info by rank 0 only; the sampler launched once
     per iteration and the full entry twice per eval block of each
     rank's. Prints both per-iteration medians (the distributed path's
     cost), the collectives per iteration and each rank's peak memory.
 12. tensor parallel and the device pool through the entry point, as
     phase 11 drives data parallel (`chip_smoke.py --cli` under
     torchrun), at phase 9's widths (4+4 decoders 128 wide, 3x48x200^2
     planes, EDSR 256 wide x4 bf16 with remat, 4096 rays, 16+16, the
     trainable route, the tiled eval: a tensor-parallel rank renders
     with the decoders gathered once a pass, a pooled one on the lent
     planes), cut to: the EDSR trunk 4
     blocks deep (of 32), synthetic scenes 400 pixels wide (eval views of
     200^2 and 50^2 rays), 4 iterations (an evaluate at the first and
     the last, one save); every cut because two gloo ranks sharing the
     card move each split conv's output and each row layer's partial
     sums through host memory. (a) `model_parallel: 2` as a world of 2
     (gloo, both ranks on cuda:0) on phase 9's scene, beside a plain run
     (timed alone first) and a second plain run (the control) and the
     dry run `python -m nvsr_tpu_torch.parallel.dryrun 2
     --model-parallel 2 --device cuda:0 --dist-backend gloo`; then
     `--eval images` of its logdir by a world of 2 and by one process.
     (b) `store_planes.device_pool: true` as a world of 2 on four
     synthetic scenes in both groups (each rank home to two) beside the
     replicated world of 2; then `--eval images` of its logdir likewise.
     Checks: the tensor-parallel losses and PSNRs within JAX's bounds of
     the plain run's (rtol 2e-4 / atol 1e-6), its logdir in the full
     layout (the plain run's files, keys and shapes) with parameters
     within TP_PARAM_BOUND (fixed from several calls' readings), the
     evals of one logdir within rtol 1e-3 / atol 1e-4, each rank's split
     decoder, SR and Adam bytes half the full ones with only the heads
     and the row layers' biases whole; the pool's first loss equal to
     the replicated world's and the rest within JAX's data-parallel
     bounds, its parameters within DP_PARAM_BOUND, its eval, its homes
     JAX's round robin, each plane file written by its home only, and
     after every step each rank keeping exactly its home scenes' planes
     and moments and nothing of the others; the sampler launched once
     per iteration per rank and the full entry twice per eval block of
     the rank's data index, nothing else. `--controls` also trains a
     second tensor-parallel run and two with a fault planted
     (plant_fault), whose parameters must lie outside TP_PARAM_BOUND.
     Prints the iteration medians
     beside the plain ones, the collectives of an iteration by group and
     kind with bytes, and each rank's peak memory.
Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the H100's peak for their type (989 TFLOP/s bf16 tensor
core, 67 TFLOP/s f32), counted from this run's shapes.
The last two lines are the kernels JSON and the result JSON.

python3 chip_smoke.py --cli REPORT <cli arguments> is the process of one
rank of phases 11 and 12 (see cli_rank). python3 chip_smoke.py --phase 12
[--controls] builds the kernels and runs phase 12 alone, with its checks
(--controls: also its record runs, see tp_phase), and prints no result
lines.

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
import signal
import statistics
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
    queues no work until the device has drained). Returns their counts
    by call (the profiler's own synchronize included)."""
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
    return {k: n for k, (n, _) in waits.items()}


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


def train_phase(dev, c2w, w=TRAIN_FULL, on_card=True, profile=False,
                host_waits=None):
    """Phase 5 (see the module docstring). With on_card=False (a CPU
    rehearsal at a small `w`) the kernel checks and launch counts are
    skipped and every step runs the plain versions. profile: after the
    phase, one HR/SR and one LR step under torch.profiler, their host
    waits recorded in `host_waits` by kind."""
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
            n = profile_run(f"{kind} step", lambda: step(kind, rays, tgt,
                                                          20))
            if host_waits is not None:
                host_waits[kind] = n
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


def trainmodels_cfg(w, scene):
    """configs/TrainModels.yml written out as a dict (so no YAML reader is
    needed), its dataset cut to one synthetic scene: an LR group at
    ds 2*sr_scale on res^2 planes, an HR group at ds 2 (the SR scene) and
    the HR group as the eval set; the plane widths from `w`."""
    from nvsr_tpu_torch.utils.config import CfgNode
    lr_ds, s, res, vr = 2 * w["sr_scale"], w["sr_scale"], w["res"], \
        w["view_res"]
    lr_key, hr_key = f"{lr_ds},{res},{vr}", f"2,{res * s},{vr}"
    return CfgNode({
        "experiment": {"logdir": "logs/TrainModels", "randomseed": 0,
                       "train_iters": 1500000,
                       "validate_every": [0.1, 5000], "save_every": 10.0,
                       "print_every": 100},
        "dataset": {
            "synt": {"root": "synt", "near": 2, "far": 6, "no_ndc": True},
            "llff": {"root": "llff", "near": 0, "far": 1, "no_ndc": False},
            "max_scenes_eval": 2,
            "dir": {"train": {lr_key: [scene], hr_key: [scene]},
                    "val": {hr_key: [scene]}},
            "testskip": 10, "llffhold": 2},
        "models": {
            "coarse": {"type": "TwoDimPlanesModel",
                       "plane_interp": "bilinear", "dec_density_layers": 4,
                       "dec_rgb_layers": 4, "dec_channels": 128,
                       "num_plane_channels": w["channels"],
                       "rgb_dec_input": "projections",
                       "proj_combination": "avg",
                       "viewdir_proj_combination": "concat_pos",
                       "align_corners": True, "skip_connect_every": 3},
            "fine": {"type": "TwoDimPlanesModel"}},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "nerf": {
            "use_viewdirs": True,
            "train": {"what": ["LR_planes", "decoder", "SR"],
                      "num_random_rays": 4096, "chunksize": 131072,
                      "store_planes": {"steps_per_buffer": 200},
                      "perturb": True, "num_coarse": 16, "num_fine": 16,
                      "occupancy": {"enabled": True},
                      "white_background": False,
                      "im_inconsistency_loss_w": 0,
                      "radiance_field_noise_std": 0.2, "lindisp": False},
            "validation": {"chunksize": 131072, "perturb": False,
                           "num_coarse": 16, "num_fine": 16,
                           "white_background": False,
                           "radiance_field_noise_std": 0.0,
                           "lindisp": False, "eval_train_scenes": True}},
        "super_resolution": {
            "lr": 5e-5, "training": {"loss": "fine"},
            "apply_2_coarse": False,
            "model": {"type": "EDSR", "hidden_size": w["sr_hidden"],
                      "n_blocks": w["sr_blocks"],
                      "compute_dtype": "bfloat16"}}})


def write_synthetic_scene(root, name, size, n_train=3, n_val=2, n_test=2,
                          camera_angle_x=0.8):
    """A Blender-style scene folder (transforms_{train,val,test}.json +
    RGBA PNGs) with the layout of tests/helpers_synth.py, written through
    the port's PNG writer: eyes on a circle of radius 4 at height 2,
    gradient images with seeded noise -> the poses by split."""
    import numpy as np
    from nvsr_tpu_torch.utils import png
    scene_dir = os.path.join(root, name)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    angles = np.linspace(0, 2 * np.pi, sum(counts.values()), endpoint=False)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    base = np.stack([xx, yy, 0.3 + 0.4 * xx * yy], -1)
    idx, poses = 0, {}
    for split, n in counts.items():
        os.makedirs(os.path.join(scene_dir, split), exist_ok=True)
        frames = []
        for i in range(n):
            a = angles[idx]
            c2w = camera(4.0 * np.array([np.cos(a), np.sin(a), 0.5]))
            rng = np.random.default_rng(idx)
            img = np.clip(base + 0.05 * rng.standard_normal(base.shape), 0,
                          1)
            rgba = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            fpath = f"{split}/r_{i}"
            png.imwrite(os.path.join(scene_dir, fpath + ".png"),
                        (255 * rgba).astype(np.uint8))
            frames.append({"file_path": fpath,
                           "transform_matrix": c2w.tolist()})
            idx += 1
        with open(os.path.join(scene_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                      f)
        poses[split] = np.stack([np.asarray(fr["transform_matrix"],
                                            np.float32) for fr in frames])
    return poses


def write_trained_logdir(root, cfg, w, poses, scene, lr_scene):
    """A logdir in the JAX package's layout, as a TrainModels run leaves
    it: checkpoint.ckpt_best (decoders, plane bases, models config),
    SR_checkpoint.ckpt_best, exp_info.pkl and planes/coarse_<LR
    scene>.planes_best (planes, box, occupied box), written with the
    port's save_pickle and PlaneStore. Weights random from seed 4 through
    the port's init functions (the density bias set to 1, so the field is
    not empty); the box from calc_scene_box over the LR train and val
    views, as the training run computes it."""
    import numpy as np
    import torch
    from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig,
                                                init_plane_sr_params)
    from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                                init_decoder_params,
                                                make_rot_mats)
    from nvsr_tpu_torch.ops.geometry import calc_scene_box
    from nvsr_tpu_torch.planes_store import PlaneStore, create_scene_planes
    from nvsr_tpu_torch.utils.io import save_pickle

    def numpy_tree(tree):
        if isinstance(tree, dict):
            return {k: numpy_tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy_tree(v) for v in tree]
        return tree.numpy()

    gen = torch.Generator().manual_seed(4)
    mcfg = TriplaneConfig.from_cfg(cfg.models.coarse, cfg.nerf)
    decs = [init_decoder_params(gen, mcfg, "cpu") for _ in range(2)]
    for dec in decs:
        dec["members"][0]["fc_alpha"]["b"].fill_(1.0)
    sr_cfg = PlaneSRConfig.from_cfg(cfg.super_resolution, w["sr_scale"],
                                    w["channels"], "bilinear", True)
    sr = init_plane_sr_params(gen, sr_cfg, "cpu")
    logdir = os.path.join(root, cfg.experiment["logdir"])
    os.makedirs(os.path.join(logdir, "planes"))
    save_pickle(os.path.join(logdir, "checkpoint.ckpt"), {
        "model_coarse_state_dict": numpy_tree(decs[0]),
        "model_fine_state_dict": numpy_tree(decs[1]),
        "rot_mats": make_rot_mats(3),
        "models_config": cfg.models.to_dict()}, suffix="ckpt", best=True)
    save_pickle(os.path.join(logdir, "SR_checkpoint.ckpt"),
                {"SR_model": numpy_tree(sr)}, suffix="ckpt", best=True)
    save_pickle(os.path.join(logdir, "exp_info.pkl"), {
        "start_i": 1, "eval_counter": 1, "best_loss": (0, 0.01),
        "last_saved": {"decoder": [], "SR": []}})
    lr_size = w["image"] // (2 * w["sr_scale"])
    focal = 0.5 / np.tan(0.5 * 0.8) * lr_size
    train_val = np.concatenate([poses["train"], poses["val"]])
    box = calc_scene_box(
        {"camera_poses": train_val[:, :3, :4], "near": 2, "far": 6,
         "H": [lr_size] * len(train_val), "W": [lr_size] * len(train_val),
         "f": [focal] * len(train_val)}, including_dirs=True, no_ndc=True)
    planes = create_scene_planes(
        gen, num_planes=3, num_channels=w["channels"],
        resolution=w["res"], viewdir_resolution=w["view_res"],
        viewdir_channels=w["channels"], init_std=0.03, box=box,
        device="cpu")
    planes.occ_aabb = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]],
                               np.float32)
    PlaneStore([os.path.join(logdir, "planes")]).save(lr_scene, planes,
                                                      as_best=True)


def reference_check(tag, exp, scene, view, mine):
    """An Experiment's SR render `mine` of `view` (through the kernels)
    against the port's reference point fns on the Experiment's own
    planes, SR planes, box, occupied box and weights, on the same rays
    (16x16 tiles, each sampling its hit rays' union interval): finite, of
    the view's shape, >= GATE_PSNR_MIN_DB."""
    import torch
    from nvsr_tpu_torch.models.plane_sr import apply_plane_sr
    from nvsr_tpu_torch.planes_store import materialize_pos_planes
    from nvsr_tpu_torch.render import render_image
    with torch.no_grad():
        planes = exp.planes_buffer.get(scene)
        pos = materialize_pos_planes(planes.planes_pos, planes.rank)
        hr = apply_plane_sr(exp.sr_params, exp.sr_cfg, pos)
        img, ro, rd, hwf = exp._view_rays(view)
        ref = render_image(
            reference_fn(exp.decoder_coarse, exp.model_cfg, pos,
                         planes.plane_view, planes.box, False),
            reference_fn(exp.decoder_fine, exp.model_cfg, hr,
                         planes.plane_view, planes.box, False),
            ro, rd, exp._mode_render_cfg("validation", scene),
            near=2.0, far=6.0, occ_aabb=planes.occ_aabb,
            tile=exp.eval_tile_shape()).fine.rgb
    p_ref = psnr(mine, ref)
    print(f"[{tag}] view {view}: Experiment (kernel) vs the reference "
          f"path {p_ref:.2f} dB (min {GATE_PSNR_MIN_DB}); rgb mean "
          f"{mine.mean().item():.4f}")
    if not (torch.isfinite(mine).all()
            and tuple(mine.shape) == tuple(img.shape[:2]) + (3,)
            and p_ref >= GATE_PSNR_MIN_DB):
        fail(f"[{tag}] the Experiment's render disagrees with the "
             f"reference path")


# the keys of metrics.txt that JAX's evaluate writes for an SR group
SR_GROUP_METRICS = {"SR_psnr_gain", "im_inconsistency", "fine_psnr", "loss",
                    "psnr", "ssim", "fine_loss"}


def experiment_phase(dev, w=EVAL_FULL, on_card=True, profile=False):
    """Phase 8 (see the module docstring): the Experiment's eval half on
    a logdir in the JAX layout at TrainModels width. With on_card=False (a
    CPU rehearsal at a small `w`) the tiled route is switched on by the
    config (the CPU default is off) and runs the kernels' plain versions;
    launch counts and timings are skipped. profile: one eval view's two
    renders under torch.profiler, with their host waits."""
    import tempfile
    import numpy as np
    import torch
    from nvsr_tpu_torch import experiment, kernels

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    scene = "lego"
    lr_ds, s = 2 * w["sr_scale"], w["sr_scale"]
    hr_scene = f"{scene}_DS2_PlRes{w['res'] * s}_{w['view_res']}"
    lr_scene = f"{scene}_DS{lr_ds}_PlRes{w['res']}_{w['view_res']}"
    with tempfile.TemporaryDirectory() as root:
        cfg = trainmodels_cfg(w, scene)
        if not on_card:
            cfg.nerf.validation["tiled_gather"] = True
        t0 = time.perf_counter()
        poses = write_synthetic_scene(os.path.join(root, "synt"), scene,
                                      w["image"])
        write_trained_logdir(root, cfg, w, poses, scene, lr_scene)
        print(f"[experiment] {w['image']}^2 synthetic scene and a "
              f"TrainModels-width logdir written in "
              f"{time.perf_counter() - t0:.2f} s")

        # the main path once, as `cli --eval images` drives it, with the
        # counts zeroed just before; the plane SR and each render timed
        # (each ended by a synchronize), and each view's data load (host)
        sr_calls, renders, loads = [], [], []
        real_sr = experiment.apply_plane_sr

        def timed_sr(*a, **kw):
            sync()
            t = time.perf_counter()
            out = real_sr(*a, **kw)
            sync()
            sr_calls.append((time.perf_counter() - t) * 1e3)
            return out

        experiment.apply_plane_sr = timed_sr
        try:
            for k in kernels.KERNELS:
                k.launches = 0
            sync()
            t0 = time.perf_counter()
            exp = experiment.Experiment(
                cfg, eval_mode="images", results_path="results",
                root_path=root, device=dev)
            exp.planes_buffer.draw_scenes()
            sync()
            load_ms = (time.perf_counter() - t0) * 1e3
            real_render, real_item = exp.render_eval_image, exp.dataset.item

            def timed_item(index):
                t = time.perf_counter()
                out = real_item(index)
                loads.append((time.perf_counter() - t) * 1e3)
                return out

            def timed_render(scene_id, img_idx, skip_sr=False):
                sync()
                n_sr, n_ld = len(sr_calls), len(loads)
                t = time.perf_counter()
                out = real_render(scene_id, img_idx, skip_sr=skip_sr)
                sync()
                ms = (time.perf_counter() - t) * 1e3 - sum(
                    sr_calls[n_sr:]) - sum(loads[n_ld:])
                renders.append((img_idx, skip_sr, t, ms, out[0]))
                return out

            exp.render_eval_image = timed_render
            exp.dataset.item = timed_item
            exp.run()
            sync()
            t_end = time.perf_counter()
            view_loads = list(loads)
        finally:
            experiment.apply_plane_sr = real_sr
        launches = {k.symbol: k.launches for k in kernels.KERNELS}

        # check 1: metrics.txt and PNGs for each eval sequence
        for seq in exp.evaluation_sequences:
            folder = os.path.join(exp.results_dir, seq)
            with open(os.path.join(folder, "metrics.txt")) as f:
                metrics = dict(line.rsplit(": ", 1) for line in f)
            pngs = [fn for _, _, fs in os.walk(folder) for fn in fs
                    if fn.endswith(".png")]
            print(f"[experiment] {seq}: {len(pngs)} PNGs, metrics "
                  f"{ {k: float(v) for k, v in metrics.items()} }")
            keys = {k.split("/")[1] for k in metrics}
            if keys != SR_GROUP_METRICS or not pngs:
                fail(f"{seq}: metrics {sorted(keys)} (want "
                     f"{sorted(SR_GROUP_METRICS)}), {len(pngs)} PNGs")
        if exp.evaluation_sequences != [hr_scene]:
            fail(f"eval sequences {exp.evaluation_sequences}")

        # check 2: one launch of the full entry per 8192-ray block per
        # pass (the eval coarse pass decodes in full, as JAX's), two
        # renders per SR view, nothing else
        views = [i for idx in exp.i_val.values() for i in idx]
        expected = 0
        for i in views:
            h, wd = exp.dataset.hwfDs[i][:2]
            th, tw = exp.eval_tile_shape()
            rays = -(-h // th) * th * -(-wd // tw) * tw
            blocks = -(-rays // exp._mode_render_cfg("validation",
                                                     hr_scene).ray_block)
            expected += 2 * 2 * blocks
        want = {k.symbol: 0 for k in kernels.KERNELS}
        want["triplane_render_full"] = expected
        print(f"[experiment] {len(views)} views x 2 renders: launches "
              f"{ {k: v for k, v in launches.items() if v} } (expected "
              f"{ {k: v for k, v in want.items() if v} }, every other "
              f"entry 0)")
        if on_card and launches != want:
            fail(f"Experiment eval launches {launches}, expected {want}")

        # check 3: the plane SR ran once for the scene
        print(f"[experiment] plane SR ran {len(sr_calls)} time(s)")
        if len(sr_calls) != 1:
            fail(f"the plane SR ran {len(sr_calls)} times, not once")

        # check 4: the first view, Experiment (kernel) against the port's
        # reference path
        mine = next(r[4].fine.rgb for r in renders
                    if r[0] == views[0] and not r[1])
        reference_check("experiment", exp, hr_scene, views[0], mine)

        if on_card:
            # in view order; the first view builds the scene's point fns
            # (plane tables, packed decoders) in its renders
            starts = [r[2] for r in renders if not r[1]] + [t_end]
            per_view = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
            frames = [sum(r[3] for r in renders if r[0] == i)
                      for i in views]
            print(f"[experiment] logdir load (config, dataset index, "
                  f"checkpoints, planes to the card) {load_ms:.2f} ms; "
                  f"plane SR set-up {sr_calls[0]:.2f} ms; eval per view "
                  f"(first render to the next view's, the last with the "
                  f"PNG and metrics writes) median "
                  f"{statistics.median(per_view):.2f} ms of "
                  f"{[round(t, 2) for t in per_view]}; data load (PNG "
                  f"read and area resize) a view "
                  f"{[round(t, 2) for t in view_loads]} ms; the two "
                  f"renders of a view (SR and data load excluded) median "
                  f"{statistics.median(frames):.2f} ms of "
                  f"{[round(t, 2) for t in frames]}")
        print(f"[experiment] phase in {time.perf_counter() - t_phase:.1f} "
              f"s")
        if profile:
            exp.render_eval_image, exp.dataset.item = real_render, real_item
            exp._last_view = None
            profile_run("one Experiment eval view (two renders)",
                        lambda: [exp.render_eval_image(hr_scene, views[-1],
                                                       skip_sr=sk)
                                 for sk in (False, True)])


def experiment_train_phase(dev, w=TRAIN_FULL, on_card=True, profile=False,
                           card="", host_waits=None):
    """Phase 9 (see the module docstring): the Experiment's training half
    at TrainModels width, as `python -m nvsr_tpu_torch.cli --config ...`
    drives it, then a resume. With on_card=False (a CPU rehearsal at a
    small `w`) every step and render runs the plain versions; launch
    counts and timings are skipped. profile: one LR and one HR/SR
    Experiment iteration under torch.profiler, their host waits printed
    beside the bare step's (`host_waits`, from phase 5). `card`: the
    card's name and power limit, printed with every time."""
    import tempfile
    import numpy as np
    import torch
    from nvsr_tpu_torch import experiment, kernels
    from nvsr_tpu_torch.planes_store import PlaneStore
    from nvsr_tpu_torch.utils.io import load_pickle

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, log):
        def wrapper(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            log.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    t_phase = time.perf_counter()
    scene = "lego"
    lr_ds, s = 2 * w["sr_scale"], w["sr_scale"]
    hr_scene = f"{scene}_DS2_PlRes{w['res'] * s}_{w['view_res']}"
    lr_scene = f"{scene}_DS{lr_ds}_PlRes{w['res']}_{w['view_res']}"
    first_iters, resume_iters = 8, 12
    with tempfile.TemporaryDirectory() as root:
        cfg = trainmodels_cfg(w, scene)
        # the cuts (listed in the output): 8 iterations, then a resume to
        # 12; an eval at the first and at the last iteration of each run;
        # a save every 4 iterations; every iteration's metrics flushed;
        # occupancy boxes from iteration 2 on, every 2 iterations
        cfg.experiment.update(validate_every=1000, save_every=4,
                              print_every=1)
        # training refuses an eval set that overlaps the training scenes:
        # the scene's own val views are the eval set (both groups, each
        # also on its train views, eval_train_scenes)
        cfg.dataset["dir"]["val"] = {}
        cfg.nerf.train["occupancy"] = {"enabled": True, "warmup_iters": 2,
                                       "update_every": 2}
        # the trainable route (as phase 5 and bench.py): the shipped YAML
        # leaves it off, and then no training step runs a kernel
        cfg.nerf.train["tiled_gather"] = True
        cfg.nerf.train["num_random_rays"] = w["rays"]
        cfg.nerf.train["num_coarse"] = cfg.nerf.train["num_fine"] = \
            w["samples"]
        if not on_card:
            cfg.nerf.validation["tiled_gather"] = True
        t0 = time.perf_counter()
        write_synthetic_scene(os.path.join(root, "synt"), scene, w["image"])
        print(f"[train-exp] cuts: one synthetic {w['image']}^2 scene (LR "
              f"group ds {lr_ds} on {w['res']}^2 planes, HR/SR group ds 2, "
              f"both evaluated on their val and train views), "
              f"{first_iters} iterations then a "
              f"resume to {resume_iters}, an eval at each run's first and "
              f"last iteration, save_every 4, print_every 1, occupancy "
              f"warmup_iters 2 / update_every 2; scene written in "
              f"{time.perf_counter() - t0:.2f} s")

        # the main path once, with the counts zeroed just before
        iters, saves, evals, losses = [], [], [], []

        def instrument(exp):
            real_iter = exp.train_iteration

            def iteration(i):
                sync()
                t = time.perf_counter()
                out = real_iter(i)
                sync()
                # (sr_iter, consistency_iter, ms) of the iteration
                iters.append((exp._pending_metrics[-1][2],
                              exp._pending_metrics[-1][1],
                              (time.perf_counter() - t) * 1e3))
                return out

            real_scalar = exp.logger.write_scalar

            def write_scalar(name, value, index):
                if name == "train/loss":
                    losses.append(value)
                return real_scalar(name, value, index)

            exp.train_iteration = iteration
            exp.logger.write_scalar = write_scalar
            exp.save_checkpoints = timed(exp.save_checkpoints, saves)
            exp.evaluate = timed(exp.evaluate, evals)
            return exp

        for k in kernels.KERNELS:
            k.launches = 0
        exp = instrument(experiment.Experiment(cfg, root_path=root,
                                               device=dev))
        exp.run(max_iters=first_iters)
        sync()
        launches = {k.symbol: k.launches for k in kernels.KERNELS}

        # check 1: every flushed loss finite
        print(f"[train-exp] losses {[round(v, 6) for v in losses]}")
        if len(losses) != first_iters or not np.all(np.isfinite(losses)):
            fail(f"flushed losses {losses}")

        # check 2: launches. The trainable sampler: one forward and one
        # backward per iteration whose coarse pass takes the trainable
        # route (every iteration but a consistency one); the fused entry:
        # per evaluate, one view per eval sequence, two renders (SR and no
        # SR) for a view of an SR scene and one otherwise, two passes per
        # render, one launch per 8192-ray block
        trainable = sum(1 for _, cons, _ in iters if not cons)
        blocks = 0
        for idx in exp.i_val.values():
            h, wd = exp.dataset.hwfDs[idx[0]][:2]
            th, tw = exp.eval_tile_shape()
            rays = -(-h // th) * th * -(-wd // tw) * tw
            renders = 2 if exp.dataset.per_im_scene_id[idx[0]] in \
                exp.scene_coupler.downsample_couples else 1
            blocks += renders * 2 * -(-rays // exp._mode_render_cfg(
                "validation", hr_scene).ray_block)
        want = {k.symbol: 0 for k in kernels.KERNELS}
        want["plane_sample_fwd"] = want["plane_sample_bwd"] = trainable
        want["triplane_render_full"] = len(evals) * blocks
        print(f"[train-exp] {len(iters)} iterations ({trainable} through "
              f"the trainable route), {len(evals)} evaluates of "
              f"{list(exp.i_val)} ({blocks} launches each): launches "
              f"{ {k: v for k, v in launches.items() if v} }"
              f" (expected { {k: v for k, v in want.items() if v} }, every "
              f"other entry 0)")
        if on_card and launches != want:
            fail(f"Experiment training launches {launches}, expected {want}")

        # check 3: the logdir in the JAX layout
        logdir = exp.logdir
        files = sorted(os.listdir(logdir))
        plane_files = sorted(os.listdir(os.path.join(logdir, "planes")))
        print(f"[train-exp] logdir {files}; planes {plane_files}")
        need = {f"checkpoint{first_iters - 1:05d}.ckpt",
                f"SR_checkpoint{first_iters - 1:05d}.ckpt",
                "checkpoint.ckpt_best", "SR_checkpoint.ckpt_best",
                "exp_info.pkl", "time_sig.txt"}
        need_planes = {f"coarse_{lr_scene}.planes",
                       f"coarse_{lr_scene}.planes_best"}
        if not need <= set(files) or not need_planes <= set(plane_files):
            fail(f"logdir misses {sorted(need - set(files))} "
                 f"{sorted(need_planes - set(plane_files))}")
        stored, adam = PlaneStore([os.path.join(logdir, "planes")]).load(
            lr_scene, with_opt_state=True)
        ckpt = load_pickle(os.path.join(
            logdir, f"checkpoint{first_iters - 1:05d}.ckpt"), suffix="ckpt")
        if adam is None or int(np.asarray(adam.count).reshape(-1)[0]) \
                != first_iters or "optimizer" not in ckpt:
            fail("the plane file or the checkpoint lacks its Adam state")

        # check 4: a committed occupied box inside the scene box
        planes = exp.planes_buffer.get(lr_scene)
        occ, box = planes.occ_aabb, np.asarray(planes.box)
        print(f"[train-exp] occupied box "
              f"{None if occ is None else occ.tolist()} in the scene box "
              f"{box[:, :3].tolist()}")
        if occ is None or not (np.all(occ[0] >= box[0, :3])
                               and np.all(occ[1] <= box[1, :3])
                               and np.all(occ[0] < occ[1])):
            fail("no occupied box committed inside the scene box")

        # check 5: an evaluate view on the trained planes through the
        # kernels against the reference path
        with torch.no_grad():
            view = exp.i_val[hr_scene][0]
            exp._eval_pf_cache = {}
            mine = exp.render_eval_image(hr_scene, view)[0].fine.rgb
        reference_check("train-exp", exp, hr_scene, view, mine)

        # check 6: the resume starts at the saved start_i, with every
        # parameter and Adam state equal to the first run's, bit for bit
        def state_of(e):
            out = {"decoder": e.decoder_opt.params,
                   "decoder_adam": e.decoder_opt.state[0],
                   "sr": e.sr_opt.params, "sr_adam": e.sr_opt.state[0]}
            for sc, p in e.planes_buffer.resident.items():
                out[sc] = p.params()
                out[sc + "_adam"] = e.planes_buffer.opt.state(sc)
            return out

        before = state_of(exp)
        cfg.experiment["train_iters"] = resume_iters
        sync()
        t0 = time.perf_counter()
        exp2 = experiment.Experiment(cfg, load_checkpoint="resume",
                                     root_path=root, device=dev)
        exp2.planes_buffer.draw_scenes()
        sync()
        resume_ms = (time.perf_counter() - t0) * 1e3
        after = state_of(exp2)
        same = {k: trees_equal(before[k], after.get(k, {})) for k in before}
        print(f"[train-exp] resume: start_i "
              f"{exp2.experiment_info['start_i']} (saved {first_iters}); "
              f"loaded equal to the first run's {same}")
        if exp2.experiment_info["start_i"] != first_iters \
                or not all(same.values()):
            fail("the resume did not load what the first run saved")
        n_first = len(losses)
        instrument(exp2).run()
        sync()
        if len(losses) - n_first != resume_iters - first_iters \
                or not np.all(np.isfinite(losses)):
            fail(f"the resumed run's losses {losses[n_first:]}")

        if on_card:
            def med(xs):
                return statistics.median(xs) if xs else float("nan")
            lr = [ms for sr, _, ms in iters if not sr]
            hr = [ms for sr, _, ms in iters if sr]
            print(f"[train-exp] on {card}: iteration ms (each between two "
                  f"synchronizes, its metrics flushed): HR/SR median "
                  f"{med(hr):.2f} of {[round(x, 2) for x in hr]}; LR median "
                  f"{med(lr):.2f} of {[round(x, 2) for x in lr]}; "
                  f"save_checkpoints ms {[round(x, 2) for x in saves]}; "
                  f"evaluate ms {[round(x, 2) for x in evals]}; resume "
                  f"load {resume_ms:.2f} ms")
        print(f"[train-exp] phase in {time.perf_counter() - t_phase:.1f} s"
              f"{f' on {card}' if card else ''}")
        if profile:
            # the iteration itself, without the timing's synchronizes
            step = experiment.Experiment.train_iteration
            for label, sc in (("LR", lr_scene), ("HR/SR", hr_scene)):
                idx = exp2.i_train[sc][0]
                exp2.image_sampler.sample = lambda sc=sc, idx=idx: (sc, idx)
                step(exp2, resume_iters)
                n = profile_run(f"one {label} Experiment iteration",
                                lambda: step(exp2, resume_iters + 1))
                print(f"[train-exp] on {card}: host waits of one {label} "
                      f"Experiment iteration {n}, of the bare {label} "
                      f"train_step (phase 5) "
                      f"{(host_waits or {}).get(label, 'not profiled')}")


# configs/MipNeRF_baseline.yml's widths: 8 layers x 256, IPE of
# num_encoding_fn_xyz 16, dir PE 4, mip, 64+64 samples, 1024 rays a
# batch; on phase 8's 800^2 synthetic scene; `crop`^2 rays of the val
# view are rendered on the card and on the CPU
BASELINE_FULL = dict(image=800, layers=8, hidden=256, rays=1024, samples=64,
                     crop=48)


def baseline_cfg(w, scene):
    """configs/MipNeRF_baseline.yml written out as a dict (so no YAML
    reader is needed), its dataset cut to one synthetic scene under the
    YAML's groups (8, for training, 2, for validation); the widths from
    `w`."""
    from nvsr_tpu_torch.utils.config import CfgNode
    return CfgNode({
        "experiment": {"id": "lr_nerf_mip_baseline", "logdir": "logs",
                       "randomseed": 0, "train_iters": 1500000,
                       "validate_every": [0.01, 5000], "save_every": 10.0,
                       "print_every": 100},
        "dataset": {
            "synt": {"root": "synt", "near": 2, "far": 6, "no_ndc": True},
            "llff": {"root": "llff", "near": 0, "far": 1, "no_ndc": False},
            "max_scenes_eval": 9,
            "dir": {"train": {"8,": [scene]}, "val": {"2,": [scene]}},
            "testskip": 10, "llffhold": 2},
        "models": {
            "coarse": {"type": "FlexibleNeRFModel",
                       "num_layers": w["layers"], "hidden_size": w["hidden"],
                       "skip_connect_every": 4, "num_encoding_fn_xyz": 16,
                       "num_encoding_fn_dir": 4, "include_input_xyz": True,
                       "include_input_dir": True, "use_viewdirs": True},
            "fine": {"type": "FlexibleNeRFModel"}},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "nerf": {
            "use_viewdirs": True, "encode_position_fn": "mip",
            "encode_direction_fn": "positional_encoding",
            "train": {"num_random_rays": w["rays"], "chunksize": 131072,
                      "perturb": True, "num_coarse": w["samples"],
                      "num_fine": w["samples"], "white_background": False,
                      "im_inconsistency_loss_w": 1,
                      "im_consistency_iters_freq": 0.25,
                      "radiance_field_noise_std": 0.2, "lindisp": False},
            "validation": {"chunksize": 131072, "perturb": False,
                           "num_coarse": w["samples"],
                           "num_fine": w["samples"],
                           "white_background": False,
                           "radiance_field_noise_std": 0.0,
                           "lindisp": False}}})


def flat_leaves(tree):
    """A tree's leaves (sorted dict keys, list order) as flat CPU tensors:
    the bit-equality checks of the resumes."""
    import numpy as np
    import torch
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_leaves(v)]
    # the native plane store keeps a 0-d array as shape (1,)
    return [(torch.as_tensor(np.asarray(tree)) if not torch.is_tensor(tree)
             else tree.detach().cpu()).reshape(-1)]


def trees_equal(a, b):
    """Two non-empty trees with the same leaves, bit for bit."""
    import torch
    la, lb = flat_leaves(a), flat_leaves(b)
    return len(la) == len(lb) > 0 and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))


def baseline_phase(dev, w=BASELINE_FULL, on_card=True, profile=False,
                   card=""):
    """Phase 10 (a) (see the module docstring): the baseline stage of
    configs/MipNeRF_baseline.yml, as `python -m nvsr_tpu_torch.cli
    --config ...` trains it and `--eval images` evaluates it. With
    on_card=False (a CPU rehearsal at a small `w`) timings are skipped.
    profile: one eval view under torch.profiler (device time, idle share,
    host waits). `card`: the card's name and power limit, printed with
    every time."""
    import tempfile
    import numpy as np
    import torch
    from nvsr_tpu_torch import bridge, experiment
    from nvsr_tpu_torch.render import render_image
    from nvsr_tpu_torch.train import baseline_point_fn
    from nvsr_tpu_torch.utils.io import load_pickle

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, log):
        def wrapper(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            log.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    t_phase = time.perf_counter()
    scene = "lego"
    val_scene = f"{scene}_DS2"
    first_iters, resume_iters = 6, 10
    with tempfile.TemporaryDirectory() as root:
        cfg = baseline_cfg(w, scene)
        # the cuts (listed in the output): first_iters iterations, then a
        # resume to resume_iters; an eval at each run's first and last
        # iteration; a save every 2 iterations; every iteration's
        # metrics flushed
        cfg.experiment.update(validate_every=first_iters, save_every=2,
                              print_every=1)
        t0 = time.perf_counter()
        write_synthetic_scene(os.path.join(root, "synt"), scene, w["image"])
        print(f"[baseline] cuts: one synthetic {w['image']}^2 scene (group "
              f"8, trains, 2, validates and joins the consistency "
              f"iterations), {first_iters} iterations then a resume to "
              f"{resume_iters}, an eval at each run's first and last "
              f"iteration, save_every 2, print_every 1; widths as the "
              f"YAML: {w['layers']} layers x {w['hidden']}, "
              f"{w['samples']}+{w['samples']} samples, {w['rays']} rays; "
              f"scene written in {time.perf_counter() - t0:.2f} s")

        iters, saves, evals, losses = [], [], [], []

        def instrument(exp):
            real_iter = exp.train_iteration

            def iteration(i):
                sync()
                t = time.perf_counter()
                out = real_iter(i)
                sync()
                # (consistency_iter, ms) of the iteration
                iters.append((exp._pending_metrics[-1][1],
                              (time.perf_counter() - t) * 1e3))
                return out

            real_scalar = exp.logger.write_scalar

            def write_scalar(name, value, index):
                if name in ("train/loss", "train/im_inconsistency"):
                    losses.append(value)
                return real_scalar(name, value, index)

            exp.train_iteration = iteration
            exp.logger.write_scalar = write_scalar
            exp.save_checkpoints = timed(exp.save_checkpoints, saves)
            exp.evaluate = timed(exp.evaluate, evals)
            return exp

        exp = instrument(experiment.Experiment(cfg, root_path=root,
                                               device=dev))
        if exp.planes_model or exp.planes_buffer is not None:
            fail("the baseline config built a triplane Experiment")
        exp.run(max_iters=first_iters)
        sync()

        # check 1: every flushed loss finite
        print(f"[baseline] losses {[round(v, 6) for v in losses]} "
              f"({sum(c for c, _ in iters)} consistency iterations)")
        if len(losses) != first_iters or not np.all(np.isfinite(losses)):
            fail(f"flushed losses {losses}")

        # check 2: the logdir in the JAX layout
        logdir = exp.logdir
        files = set(os.listdir(logdir))
        need = {f"checkpoint{first_iters - 1:05d}.ckpt",
                "checkpoint.ckpt_best", "exp_info.pkl", "time_sig.txt"}
        ckpt = load_pickle(os.path.join(
            logdir, f"checkpoint{first_iters - 1:05d}.ckpt"), suffix="ckpt")
        print(f"[baseline] logdir {sorted(files)}; checkpoint keys "
              f"{sorted(ckpt)}")
        if not need <= files or sorted(ckpt) != [
                "model_coarse_state_dict", "model_fine_state_dict",
                "optimizer"]:
            fail(f"logdir misses {sorted(need - files)} or the checkpoint "
                 f"has keys {sorted(ckpt)}")

        # check 3: the resume starts at the saved start_i with both MLPs
        # and their Adam state equal to the first run's, bit for bit
        before = {"mlp": exp.decoder_opt.params,
                  "adam": exp.decoder_opt.state[0]}
        cfg.experiment["train_iters"] = resume_iters
        sync()
        t0 = time.perf_counter()
        exp2 = experiment.Experiment(cfg, load_checkpoint="resume",
                                     root_path=root, device=dev)
        sync()
        resume_ms = (time.perf_counter() - t0) * 1e3
        same = {k: trees_equal(v, {"mlp": exp2.decoder_opt.params,
                                   "adam": exp2.decoder_opt.state[0]}[k])
                for k, v in before.items()}
        print(f"[baseline] resume: start_i "
              f"{exp2.experiment_info['start_i']} (saved {first_iters}); "
              f"loaded equal to the first run's {same}")
        if exp2.experiment_info["start_i"] != first_iters \
                or not all(same.values()):
            fail("the resume did not load what the first run saved")
        n_first = len(losses)
        instrument(exp2).run()
        sync()
        if len(losses) - n_first != resume_iters - first_iters \
                or not np.all(np.isfinite(losses)):
            fail(f"the resumed run's losses {losses[n_first:]}")

        # check 4: a crop of the val view from the trained weights, on
        # the device against the port's own CPU render of the same rays
        with torch.no_grad():
            view = exp2.i_val[val_scene][0]
            exp2._eval_pf_cache = {}
            _, ro, rd, _ = exp2._view_rays(view)
            h, wd, c = ro.shape[0], ro.shape[1], w["crop"]
            y0, x0 = (h - c) // 2, (wd - c) // 2
            ro, rd = ro[y0:y0 + c, x0:x0 + c], rd[y0:y0 + c, x0:x0 + c]
            rcfg = exp2._mode_render_cfg("validation", val_scene)
            mine = render_image(*exp2._point_fns_for_eval(val_scene, None),
                                ro, rd, rcfg, near=2.0, far=6.0).fine.rgb
            enc = exp2._enc_for(val_scene)

            def cpu_fn(params):
                return baseline_point_fn(
                    bridge.nerf_mlp_from_jax(bridge.nerf_mlp_to_jax(params),
                                             "cpu"), exp2.mlp_cfg, enc)

            t0 = time.perf_counter()
            ref = render_image(cpu_fn(exp2.decoder_coarse),
                               cpu_fn(exp2.decoder_fine), ro.cpu(),
                               rd.cpu(), rcfg, near=2.0,
                               far=6.0).fine.rgb
            cpu_ms = (time.perf_counter() - t0) * 1e3
        p_crop = psnr(mine.cpu(), ref)
        print(f"[baseline] {c}x{c} crop of the val view ({c * c} rays): "
              f"{'card' if on_card else 'plain'} render vs the CPU render "
              f"{p_crop:.2f} dB (min {GATE_PSNR_MIN_DB}); rgb mean "
              f"{mine.mean().item():.4f}; CPU render {cpu_ms:.0f} ms")
        if not (torch.isfinite(mine).all()
                and tuple(mine.shape) == (c, c, 3)
                and p_crop >= GATE_PSNR_MIN_DB):
            fail("the baseline's render disagrees with the CPU render")

        # check 5: `--eval images` of the logdir: metrics.txt and PNGs
        # for each eval sequence, from the best checkpoint
        ev = experiment.Experiment(cfg, eval_mode="images",
                                   results_path="results", root_path=root,
                                   device=dev)
        best = load_pickle(os.path.join(logdir, "checkpoint.ckpt_best"),
                           suffix="ckpt_best")
        if not trees_equal(ev.decoder_coarse,
                           best["model_coarse_state_dict"]):
            fail("the eval did not load the best checkpoint")
        n_views = sum(len(v) for v in ev.i_val.values())
        sync()
        t0 = time.perf_counter()
        ev.run()
        sync()
        eval_ms = (time.perf_counter() - t0) * 1e3 / max(n_views, 1)
        for seq in ev.evaluation_sequences:
            folder = os.path.join(ev.results_dir, seq)
            with open(os.path.join(folder, "metrics.txt")) as f:
                metrics = {k: float(v) for k, v in
                           (line.rsplit(": ", 1) for line in f)}
            pngs = [fn for _, _, fs in os.walk(folder) for fn in fs
                    if fn.endswith(".png")]
            print(f"[baseline] eval {seq}: {len(pngs)} PNGs, metrics "
                  f"{metrics}")
            psnrs = [v for k, v in metrics.items()
                     if k.endswith("/psnr")]
            if not pngs or not psnrs or not np.all(np.isfinite(psnrs)):
                fail(f"{seq}: {len(pngs)} PNGs, metrics {metrics}")

        if on_card:
            def med(xs):
                return statistics.median(xs) if xs else float("nan")
            plain = [ms for cons, ms in iters if not cons]
            cons = [ms for c_, ms in iters if c_]
            print(f"[baseline] on {card}: iteration ms (each between two "
                  f"synchronizes, its metrics flushed): median "
                  f"{med(plain):.2f} of {[round(x, 2) for x in plain]}; "
                  f"consistency iterations {[round(x, 2) for x in cons]}; "
                  f"save_checkpoints ms {[round(x, 2) for x in saves]}; "
                  f"evaluate (training, one view a sequence) ms "
                  f"{[round(x, 2) for x in evals]}; resume load "
                  f"{resume_ms:.2f} ms; eval per view (--eval images, "
                  f"{n_views} views) {eval_ms:.2f} ms")
        print(f"[baseline] phase (a) in "
              f"{time.perf_counter() - t_phase:.1f} s"
              f"{f' on {card}' if card else ''}")
        if profile:
            ev._last_view = None
            profile_run(f"one baseline eval view ({val_scene}, "
                        f"{'x'.join(map(str, exp2.dataset.hwfDs[view][:2]))})",
                        lambda: ev.render_eval_image(val_scene, view))


def reference_checkpoints(gen, cfg, sr_cfg, w):
    """Reference-layout torch state dicts at the widths of cfg / sr_cfg /
    w, drawn from `gen`: two TwoDimPlanesModel decoders (`density_dec.0.l`,
    `fc_alpha.0`, ..., torch Linear's [out, in] weights, a density bias of
    1 so the field is not empty, `rot_mats_NON_LEARNED`), the PlanesSR
    EDSR (`inner_model.` prefix, OIHW, its upscale convs at the
    Sequential's even indices) and a `.par` of the scene's planes (3
    positional, 1 view) with their torch Adam states."""
    import torch
    from nvsr_tpu_torch.models.plane_sr import edsr_layer_plan
    from nvsr_tpu_torch.models.triplane import make_rot_mats

    def lin(sd, prefix, i, o):
        bound = 1.0 / math.sqrt(i)
        sd[prefix + ".weight"] = (torch.rand((o, i), generator=gen) * 2
                                  - 1) * bound
        sd[prefix + ".bias"] = (torch.rand((o,), generator=gen) * 2
                                - 1) * bound

    def decoder():
        sd = {}
        for name, in_ch, n in (
                ("density_dec", cfg.density_in_channels,
                 cfg.dec_density_layers),
                ("rgb_dec", cfg.rgb_in_channels, cfg.dec_rgb_layers)):
            lin(sd, f"{name}.0.0", in_ch, cfg.dec_channels)
            for ln in range(n - 1):
                extra = in_ch if cfg.is_skip_layer(ln) else 0
                lin(sd, f"{name}.0.{ln + 1}", cfg.dec_channels + extra,
                    cfg.dec_channels)
        lin(sd, "fc_alpha.0", cfg.dec_channels, 1)
        lin(sd, "fc_rgb.0", cfg.dec_channels, 3)
        sd["fc_alpha.0.bias"].fill_(1.0)
        for d, m in enumerate(make_rot_mats(cfg.num_planes)):
            sd[f"coord_projector.rot_mats_NON_LEARNED.{d}"] = \
                torch.as_tensor(m)
        return sd

    def conv(o, i, k):
        std = math.sqrt(2.0 / (k * k * o)) / 10.0
        return torch.randn((o, i, k, k), generator=gen) * std

    plan = edsr_layer_plan(sr_cfg.n_blocks, sr_cfg.scale_factor)
    hs, ch = sr_cfg.hidden_size, sr_cfg.in_channels
    sr = {"inner_model.conv_input.weight": conv(hs, ch, plan["conv_input"])}
    for i, k in enumerate(plan["blocks"]):
        sr[f"inner_model.residual.{i}.conv1.weight"] = conv(hs, hs, k)
        sr[f"inner_model.residual.{i}.conv2.weight"] = conv(hs, hs, k)
    sr["inner_model.conv_mid.weight"] = conv(hs, hs, plan["conv_mid"])
    for j, k in enumerate(plan["upscale"]):
        sr[f"inner_model.upscale.{2 * j}.weight"] = conv(4 * hs, hs, k)
    sr["inner_model.conv_output.weight"] = conv(ch, hs, plan["conv_output"])

    shapes = [(1, ch, w["res"], w["res"])] * 3 + [
        (1, ch, w["view_res"], w["view_res"])]
    par = {"params": {f"sclego_DS8_PlRes{w['res']}_{w['view_res']}_D{d}":
                      0.03 * torch.randn(s, generator=gen)
                      for d, s in enumerate(shapes)},
           "opt_states": [{"step": torch.tensor(7.0),
                           "exp_avg": 1e-3 * torch.randn(s, generator=gen),
                           "exp_avg_sq": 1e-6 * torch.rand(s, generator=gen)}
                          for s in shapes],
           "coords_normalization": torch.tensor(
               [[-4, -4, -4, -math.pi, -math.pi / 2],
                [4, 4, 4, math.pi, math.pi / 2]], dtype=torch.float32)}
    return decoder(), decoder(), sr, par


def convert_phase(dev, w=EVAL_FULL, on_card=True, card=""):
    """Phase 10 (b) (see the module docstring): reference checkpoints at
    TrainModels width, saved with torch.save, read back with
    convert.load_torch_checkpoint and converted onto the card, then SR and
    phase 3's frame through the fused kernel with the converted weights,
    against the plain version. With on_card=False (a CPU rehearsal at a
    small `w`) launch counts and timings are skipped."""
    import tempfile
    import numpy as np
    import torch
    from nvsr_tpu_torch import convert, kernels
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig, apply_plane_sr
    from nvsr_tpu_torch.models.triplane import TriplaneConfig, make_rot_mats
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.render import (RenderConfig, make_triplane_point_fn,
                                       render_image)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    cfg = TriplaneConfig(proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         skip_connect_every=3, gather_table_dtype="bfloat16",
                         compute_dtype="bfloat16",
                         num_plane_channels=w["channels"])
    sr_cfg = PlaneSRConfig(in_channels=w["channels"],
                           out_channels=w["channels"],
                           hidden_size=w["sr_hidden"],
                           n_blocks=w["sr_blocks"],
                           scale_factor=w["sr_scale"],
                           compute_dtype="bfloat16")
    dec_c, dec_f, sr_sd, par = reference_checkpoints(
        torch.Generator().manual_seed(10), cfg, sr_cfg, w)
    with tempfile.TemporaryDirectory() as root:
        paths = {name: os.path.join(root, name) for name in
                 ("checkpoint.ckpt", "SR_checkpoint.ckpt", "lego.par")}
        torch.save({"model_coarse_state_dict": dec_c,
                    "model_fine_state_dict": dec_f},
                   paths["checkpoint.ckpt"])
        torch.save({"SR_model": sr_sd}, paths["SR_checkpoint.ckpt"])
        torch.save(par, paths["lego.par"])
        sync()
        t0 = time.perf_counter()
        ck = convert.load_torch_checkpoint(paths["checkpoint.ckpt"])
        dc, rot = convert.convert_triplane_decoder(
            ck["model_coarse_state_dict"], device=dev)
        df, _ = convert.convert_triplane_decoder(
            ck["model_fine_state_dict"], device=dev)
        sr_params = convert.convert_plane_sr(convert.load_torch_checkpoint(
            paths["SR_checkpoint.ckpt"])["SR_model"], device=dev)
        planes, box, moments = convert.convert_par_file(
            convert.load_torch_checkpoint(paths["lego.par"]), device=dev)
        sync()
        convert_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(os.path.getsize(p) for p in paths.values())
    ok = (torch.equal(rot.cpu(), torch.as_tensor(make_rot_mats(3)))
          and tuple(planes["pos"].shape) == (3, w["channels"], w["res"],
                                             w["res"])
          and moments is not None and moments["count"] == 7
          and len(sr_params["inner"]["blocks"]) == w["sr_blocks"]
          and torch.equal(dc["members"][0]["density"][0]["w"].cpu(),
                          dec_c["density_dec.0.0.weight"].T)
          and planes["pos"].device.type == torch.device(dev).type)
    print(f"[convert] {nbytes / 1e6:.1f} MB of reference checkpoints (two "
          f"4+4x{cfg.dec_channels} decoders, EDSR {sr_cfg.hidden_size}x"
          f"{sr_cfg.n_blocks} x{sr_cfg.scale_factor}, a .par of 3x"
          f"{w['channels']}x{w['res']}^2 + {w['channels']}x"
          f"{w['view_res']}^2 planes with Adam moments) read and "
          f"converted onto {torch.device(dev).type} in {convert_ms:.1f} ms"
          f"{f' on {card}' if card else ''}; layout checks "
          f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the converted trees do not hold what the checkpoints hold")

    image = w["image"]
    ro, rd = get_ray_bundle(image, image, 0.5 * image / np.tan(0.3),
                            torch.as_tensor(camera([3.8, 0.5, 0.7]),
                                            device=dev))
    occ = np.array([[-1.4, -1.1, -1.1], [1.5, 1.3, 1.2]], np.float32)
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        ray_block=RAY_BLOCK)
    frame_kernels = (kernels.triplane_render_sigma_only,
                     kernels.triplane_render_full)
    with torch.no_grad():
        for k in kernels.KERNELS:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes["pos"])
        pf_c = make_triplane_point_fn(dc, cfg, planes["pos"], planes["view"],
                                      box, rot_mats=rot, tile_rays=256,
                                      sigma_only=True)
        pf_f = make_triplane_point_fn(df, cfg, planes_sr, planes["view"],
                                      box, rot_mats=rot, tile_rays=256)
        rgb = render_image(pf_c, pf_f, ro, rd, rcfg, near=2.0, far=6.0,
                           occ_aabb=occ, tile=16).fine.rgb
        sync()
        frame_s = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels.KERNELS}
        plain = render_image(
            plain_point_fn(dc, cfg, planes["pos"], planes["view"], box,
                           True),
            plain_point_fn(df, cfg, planes_sr, planes["view"], box, False),
            ro, rd, rcfg, near=2.0, far=6.0, occ_aabb=occ,
            tile=16).fine.rgb
    p = psnr(rgb, plain)
    blocks = -(-image * image // RAY_BLOCK)
    want = {k.symbol: 0 for k in kernels.KERNELS}
    want.update({k.symbol: blocks for k in frame_kernels})
    print(f"[convert] SR + {image}x{image} frame on the converted weights "
          f"in {frame_s:.3f} s (first run{f' on {card}' if card else ''}); "
          f"kernel vs plain "
          f"{p:.2f} dB (min {GATE_PSNR_MIN_DB}); rgb mean "
          f"{rgb.mean().item():.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }, every other entry 0)")
    if (tuple(rgb.shape) != (image, image, 3)
            or not torch.isfinite(rgb).all() or p < GATE_PSNR_MIN_DB):
        fail("the frame on the converted weights disagrees with the plain "
             "version")
    if on_card and launches != want:
        fail(f"conversion frame launches {launches}, expected {want}")
    print(f"[convert] phase (b) in {time.perf_counter() - t_phase:.1f} s"
          f"{f' on {card}' if card else ''}")


# the SR branches of phase 10 (c): SRResNet at the SRGAN generator's
# published width (64 channels, 16 residual blocks) on TrainModels'
# 3x48x200^2 planes x4; EDSR at TrainModels width in tiles of `tile`
SR_GAPS_FULL = dict(channels=48, res=200, sr_hidden=256, sr_blocks=32,
                    sr_scale=4, srresnet_hidden=64, srresnet_blocks=16,
                    tile=100, reps=3)
# tiled against full-plane EDSR: in f32 (TF32 off) the same sums over
# another input extent, so cuDNN may pick another algorithm per shape:
# the largest difference within 1e-3 of the trunk output's largest; in
# bf16, >= GATE_PSNR_MIN_DB between the two
TILED_F32_RTOL = 1e-3


def flat_params(tree):
    """The tensors of a parameter tree, in place."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_params(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_params(v)]
    return [tree]


def sr_gaps_phase(dev, w=SR_GAPS_FULL, on_card=True, card=""):
    """Phase 10 (c) (see the module docstring): SRResNet (with and without
    BatchNorm, eval and train mode) and EDSR with tile_size against the
    full-plane EDSR, in f32 and bf16, each timed. With on_card=False (a
    CPU rehearsal at a small `w`) timings are skipped."""
    import dataclasses as dc
    import torch
    from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig,
                                                apply_plane_sr,
                                                init_plane_sr_params)
    from nvsr_tpu_torch.ops.resize import upsample_plane

    t_phase = time.perf_counter()
    on = f" on {card}" if card else ""
    gen = torch.Generator().manual_seed(11)
    ch, res = w["channels"], w["res"]
    planes = (0.5 * torch.randn((3, ch, res, res), generator=gen)).to(dev)

    def ms(fn):
        return cuda_ms(fn, warmup=1, reps=w["reps"]) if on_card \
            else float("nan")

    with torch.no_grad():
        for no_bn in (False, True):
            scfg = PlaneSRConfig(arch="SRResNet", in_channels=ch,
                                 out_channels=ch,
                                 hidden_size=w["srresnet_hidden"],
                                 n_blocks=w["srresnet_blocks"],
                                 scale_factor=4, no_batch_norm=no_bn)
            params = init_plane_sr_params(gen, scfg, dev)
            for train in (False, True):
                out = apply_plane_sr(params, scfg, planes, train=train)
                t = ms(lambda: apply_plane_sr(params, scfg, planes,
                                              train=train))
                print(f"[sr-gaps] SRResNet {scfg.hidden_size}x"
                      f"{scfg.n_blocks} x4 {'without' if no_bn else 'with'}"
                      f" BN, {'train' if train else 'eval'}: "
                      f"{tuple(out.shape)}, |out| max "
                      f"{out.abs().max().item():.4f}, {t:.2f} ms{on}")
                if (tuple(out.shape) != (3, ch, 4 * res, 4 * res)
                        or not torch.isfinite(out).all()):
                    fail("SRResNet's output is not finite or of the wrong "
                         "shape")

        ecfg = PlaneSRConfig(in_channels=ch, out_channels=ch,
                             hidden_size=w["sr_hidden"],
                             n_blocks=w["sr_blocks"],
                             scale_factor=w["sr_scale"])
        # the reference init times 5, so the trunk's output (~0.1 of the
        # planes') is not negligible beside the residual, as it is at the
        # init (~1e-4)
        params = init_plane_sr_params(gen, ecfg, dev)
        for p_ in flat_params(params):
            p_.mul_(5.0)
        up = upsample_plane(planes, ecfg.scale_factor,
                            align_corners=ecfg.align_corners,
                            mode=ecfg.plane_interp)
        for dtype in (None, "bfloat16"):
            full_cfg = dc.replace(ecfg, compute_dtype=dtype)
            tiled_cfg = dc.replace(full_cfg, tile_size=w["tile"])
            full = apply_plane_sr(params, full_cfg, planes)
            tiled = apply_plane_sr(params, tiled_cfg, planes)
            t_full = ms(lambda: apply_plane_sr(params, full_cfg, planes))
            t_tiled = ms(lambda: apply_plane_sr(params, tiled_cfg, planes))
            trunk = (full.float() - up).abs().max().item()
            err = (full.float() - tiled.float()).abs().max().item()
            p = psnr(full, tiled)
            agree = "bit-equal" if err == 0 else (
                f"max diff {err:.3e} ({err / trunk:.3e} of the trunk "
                f"output's largest), {p:.2f} dB")
            print(f"[sr-gaps] EDSR {ecfg.hidden_size}x{ecfg.n_blocks} "
                  f"x{ecfg.scale_factor} {dtype or 'float32'} on 3x{ch}x"
                  f"{res}^2 (trunk output up to {trunk:.3e}): tiles of "
                  f"{w['tile']} vs the full plane {agree}; full "
                  f"{t_full:.2f} ms, tiled {t_tiled:.2f} ms{on}")
            if tuple(tiled.shape) != tuple(full.shape) \
                    or not torch.isfinite(tiled).all():
                fail("tiled EDSR: wrong shape or not finite")
            if dtype is None and err > TILED_F32_RTOL * trunk:
                fail(f"tiled EDSR in f32 differs by {err / trunk:.3e} of "
                     f"the trunk output (bound {TILED_F32_RTOL})")
            if dtype is not None and p < GATE_PSNR_MIN_DB:
                fail(f"tiled EDSR in bf16: {p:.2f} dB from the full plane")
    print(f"[sr-gaps] phase (c) in {time.perf_counter() - t_phase:.1f} s"
          f"{on}")


# phase 11: data parallel through the entry point, as a user launches it:
# `python -m torch.distributed.run --standalone --nproc_per_node=N
# chip_smoke.py --cli REPORT <cli arguments>` runs nvsr_tpu_torch.cli's
# main in every rank with the probes of cli_rank
DIST_ITERS = 16
# JAX's bounds of a data-parallel run against the unsharded one
# (tests/test_experiment_mesh.py:52-54)
DP_LOSS_RTOL, DP_LOSS_ATOL, DP_PSNR_RTOL = 2e-5, 1e-7, 2e-4
DP_IMG_RTOL, DP_IMG_ATOL = 1e-4, 2e-5
# the world of 1's parameters after DIST_ITERS steps against the plain
# run's: max |delta| / leaf max by group (decoders, SR net, planes). On
# the card two runs of one command differ after their first update: the
# backward's atomics (plane_sample_bwd, the plain gathers' index_add_,
# cuDNN's) sum in another order each run. Each bound lies above every
# reading of a second plain run and of the world of 1 in PERF.md's
# record, and below the world of 2's: its gradients round in another
# order at every step (the dry run's first step: 2e-7 to 5e-7 by group),
# which the bf16 SR convolutions grow (tests/test_torch_experiment_dp.py).
# The SR net's readings do not separate the two, so its bound only sits
# above both
DP_PARAM_BOUND = {"planes": 3e-3, "decoders": 1.5e-4, "SR": 1e-5}


def tensor_bytes(tree):
    """The bytes of the tensors in a nested dict / list / tuple."""
    import torch
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def pool_probe(buf):
    """What a rank's PlanesBuffer keeps between steps: its plane and Adam
    bytes, the bytes its home scenes' planes and moments make (planes, mu
    and nu of each trained home scene), the tensors it holds of scenes
    homed elsewhere, and whether a scene is still lent."""
    part = buf.host_partition
    home = [s for s in buf.resident if part.owns(s)]
    want = sum(tensor_bytes(buf.resident[s].params())
               * (3 if s in buf.opt.planes else 1) for s in home)
    foreign = sum(tensor_bytes(buf.resident[s].params())
                  for s in buf.resident if not part.owns(s)) + sum(
        1 for s in buf.opt.planes if not part.owns(s))
    return {"bytes": buf.resident_bytes(), "home_bytes": want,
            "foreign": foreign, "lent": buf._lent is not None}


def plant_fault(name):
    """A deliberately broken tensor-parallel port, for phase 12's controls
    (the readings its parameter bound must fail): "drop_pair" leaves
    copy_to_model out (identity both ways: a replicated input's gradient
    keeps this rank's part only), "bf16_reduce" rounds a row layer's
    partial sums to bf16 before they are summed."""
    from nvsr_tpu_torch.parallel import tensor
    if name == "drop_pair":
        tensor.copy_to_model = lambda x, mesh: x
    elif name == "bf16_reduce":
        real = tensor.reduce_from_model
        tensor.reduce_from_model = lambda x, mesh: real(
            x.bfloat16().to(x.dtype), mesh)
    else:
        raise ValueError(f"no planted fault {name!r}")


def cli_rank(report, argv):
    """One process of phases 11 and 12: nvsr_tpu_torch.cli.main(argv) with
    probes (argv may start with --plant NAME: plant_fault first): each
    train_iteration between two synchronizes, with the collectives it
    made (and under the device pool what the buffer keeps after it:
    pool_probe); the flushed train/loss and train/psnr; each
    eval render's rgb (eval mode) and the kernel launches this rank's
    share of its blocks needs; the plane files and pickles this rank
    wrote; the scene homes, and the bytes of this rank's decoder and SR
    slices and their Adam moments; launch counts and peak device memory.
    Pickled to REPORT.<rank>.pkl."""
    import pickle
    import torch
    sys.path.insert(0, ROOT)
    from nvsr_tpu_torch import cli, experiment, kernels
    from nvsr_tpu_torch.parallel import sharding
    from nvsr_tpu_torch.planes_store import PlaneStore
    from nvsr_tpu_torch.utils.logging import ExperimentLogger

    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    on_card = torch.cuda.is_available()
    if argv[:1] == ["--plant"]:
        plant_fault(argv[1])
        argv = argv[2:]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rec = {"iters": [], "scalars": [], "renders": [], "planes_written": [],
           "pickles": [], "want_full": 0, "modules": None, "homes": None,
           "store_backends": []}
    made = []
    exp_cls = experiment.Experiment
    real_iter, real_render = exp_cls.train_iteration, \
        exp_cls.render_eval_image
    real_scalar, real_save = ExperimentLogger.write_scalar, PlaneStore.save
    real_store_init = PlaneStore.__init__
    real_pickle = experiment.save_pickle

    def train_iteration(self, i):
        before = dict(sharding.COLLECTIVES)
        sync()
        t = time.perf_counter()
        out = real_iter(self, i)
        sync()
        rec["iters"].append({
            "sr": self._pending_metrics[-1][2],
            "ms": (time.perf_counter() - t) * 1e3,
            "collectives": {k: v - before.get(k, 0)
                            for k, v in sharding.COLLECTIVES.items()},
            "pool": pool_probe(self.planes_buffer)
            if self.planes_buffer.device_pool else None})
        if not made:
            made.append(self)
        return out

    def render_eval_image(self, scene_id, img_idx, skip_sr=False):
        out, img = real_render(self, scene_id, img_idx, skip_sr)
        fine = out.fine if out.fine is not None else out.coarse
        if self.eval_tile_cfg(scene_id) is not None:
            # two passes through the full entry per block of this rank's
            # (block 0 for a rank without one of its own)
            th, tw = self.eval_tile_shape()
            h, w = fine.rgb.shape[:2]
            rays = -(-h // th) * th * -(-w // tw) * tw
            block = self._mode_render_cfg("validation", scene_id).ray_block
            blocks = -(-rays // block)
            mine = len(range(self.mesh.data_index, blocks,
                             self.mesh.data_size)) if self.mesh else blocks
            rec["want_full"] += 2 * max(mine, 1)
        if self.eval_mode:
            rec["renders"].append(((scene_id, img_idx, skip_sr),
                                   fine.rgb.cpu().numpy()))
        return out, img

    def write_scalar(self, name, value, index):
        if name in ("train/loss", "train/psnr"):
            rec["scalars"].append((name, index, float(value)))
        return real_scalar(self, name, value, index)

    def store_init(self, *a, **kw):
        real_store_init(self, *a, **kw)
        rec["store_backends"].append(self.backend)

    def save(self, scene, *a, **kw):
        rec["planes_written"].append(scene)
        return real_save(self, scene, *a, **kw)

    def save_pickle(name, *a, **kw):
        rec["pickles"].append(os.path.basename(name))
        return real_pickle(name, *a, **kw)

    exp_cls.train_iteration = train_iteration
    exp_cls.render_eval_image = render_eval_image
    ExperimentLogger.write_scalar = write_scalar
    PlaneStore.__init__ = store_init
    PlaneStore.save = save
    experiment.save_pickle = save_pickle
    for k in kernels.KERNELS:
        k.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli.main(argv)
    sync()
    if made:
        exp = made[0]
        part = exp.planes_buffer.host_partition
        rec["homes"] = None if part is None else part.owners

        def split_whole(tree, layout):
            """(bytes of split leaves, bytes of whole ones) on this rank."""
            if not exp._layouts:
                return 0, tensor_bytes(tree)
            pairs = sharding.zip_layout(tree, layout)
            return tuple(sum(tensor_bytes(t) for t, a in pairs
                             if (a is None) != split) for split in (1, 0))

        dec = exp._layouts.get("decoder")
        rec["modules"] = {
            "decoders": split_whole([exp.decoder_coarse, exp.decoder_fine],
                                    [dec, dec]),
            "SR": split_whole(exp.sr_params, exp._layouts.get("SR")),
            "moments": [split_whole(opt.state[0][m], exp._opt_layout(opt)
                                    if exp._layouts else None)
                        for opt in (exp.decoder_opt, exp.sr_opt)
                        if opt is not None for m in (1, 2)]}
    rec.update(seconds=time.perf_counter() - t0, rank=rank, world=world,
               launches={k.symbol: k.launches for k in kernels.KERNELS},
               collectives=dict(sharding.COLLECTIVES),
               peak_mib=(torch.cuda.max_memory_allocated() / 2 ** 20
                         if on_card else None))
    with open(f"{report}.{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)


class CliRuns:
    """The CLI runs of phases 11 and 12 in a scratch `root`: each run a
    process in a session of its own (stopping it stops torchrun's
    workers), started from `root` with the repo importable and gloo (and
    NCCL) on the loopback interface; `make_cfg(logdir)` writes a run's
    config the first time its name is launched."""

    def __init__(self, root, on_card, iters, phase, make_cfg):
        self.root, self.on_card, self.iters = root, on_card, iters
        self.phase, self.make_cfg = phase, make_cfg
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]),
            GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
        if not on_card:
            self.env["OMP_NUM_THREADS"] = "1"
        self.device = [] if on_card else ["--device", "cpu"]
        # two gloo ranks: on the one card, or on the CPU
        self.gloo = ["--dist-backend", "gloo"] + (["--device", "cuda:0"]
                                                  if on_card else [])
        self.started = []

    def stop_all(self):
        """Stop every run still going, torchrun's workers with it."""
        for proc in self.started:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()

    def start(self, report, cmd):
        with open(report + ".log", "w") as log:
            proc = subprocess.Popen(cmd, cwd=self.root, env=self.env,
                                    stdout=log, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        self.started.append(proc)
        return proc

    def launch(self, name, cfg_of, world=None, extra=(), plant=None):
        """`chip_smoke.py --cli` (cli_rank) on the config of `cfg_of` (its
        logdir logs/<cfg_of>), under torchrun with `world` ranks when
        given, with the fault `plant` planted when given."""
        path = os.path.join(self.root, f"{cfg_of}.yml")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(self.make_cfg(f"logs/{cfg_of}").dump())
        report = os.path.join(self.root, f"report_{name}")
        cmd = [sys.executable]
        if world:
            cmd += ["-m", "torch.distributed.run", "--standalone",
                    f"--nproc_per_node={world}"]
        cmd += [os.path.join(ROOT, "chip_smoke.py"), "--cli", report,
                *(["--plant", plant] if plant else []), "--config", path,
                "--max-iters", str(self.iters), *self.device, *extra]
        return name, self.start(report, cmd), report, world or 1

    def launch_dryrun(self, extra=()):
        """The port's dry run on the card: two gloo ranks on cuda:0
        against the world of 1 and a second world of 1."""
        report = os.path.join(self.root, "report_dryrun")
        return "dryrun", self.start(report, [
            sys.executable, "-m", "nvsr_tpu_torch.parallel.dryrun", "2",
            "--device", "cuda:0", "--dist-backend", "gloo", *extra]), \
            report, 0

    def wait(self, *runs, timeout=600):
        """Each run's rank reports (the dry run's: its output)."""
        import pickle
        deadline = time.monotonic() + timeout
        rcs = {}
        for name, proc, _, _ in runs:
            try:
                rcs[name] = proc.wait(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                rcs[name] = "timeout"
        self.stop_all()
        out = {}
        for name, proc, report, world in runs:
            if rcs[name] != 0:
                with open(report + ".log") as f:
                    print(f.read()[-6000:])
                fail(f"phase {self.phase} run {name} ended with {rcs[name]}")
            if not world:
                with open(report + ".log") as f:
                    out[name] = f.read()
                continue
            ranks = []
            for r in range(world):
                with open(f"{report}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            backends = [sorted(set(rep["store_backends"])) for rep in ranks]
            print(f"[phase {self.phase}] {name}: PlaneStore backend by rank "
                  f"{backends}")
            if any(b != ["native"] for b in backends):
                fail(f"phase {self.phase} run {name}: a rank's plane store "
                     f"is not native: {backends}")
            out[name] = ranks
        return out


def logdir_state(d, lr_scenes):
    """A logdir's module checkpoints and plane files as (params, adam):
    {file:key: tree} of the decoders' and SR net's parameters and of
    their optimizer states, and "planes:<scene>" for each LR scene's
    planes and their Adam leaves."""
    from nvsr_tpu_torch.planes_store import PlaneStore
    from nvsr_tpu_torch.utils.io import load_pickle
    params, adam = {}, {}
    for f in sorted(os.listdir(d)):
        if ".ckpt" in f:
            c = load_pickle(os.path.join(d, f), suffix=f.split(".")[-1])
            for k in ("model_coarse_state_dict", "model_fine_state_dict",
                      "SR_model"):
                if k in c:
                    params[f + ":" + k] = c[k]
            for k in ("optimizer", "SR_optimizer"):
                if k in c:
                    adam[f + ":" + k] = c[k]
    for sc in lr_scenes:
        planes, opt = PlaneStore([os.path.join(d, "planes")]).load(
            sc, with_opt_state=True)
        params["planes:" + sc] = [planes.planes_pos, planes.plane_view]
        adam["planes:" + sc] = opt.leaves()
    return params, adam


def logdir_delta(states, n, ref, phase):
    """Run n's logdir state against run ref's (logdir_state): the max
    |delta| / leaf max by group (planes, SR, decoders), and whether every
    parameter and Adam leaf is bit-equal. The two must hold the same
    files, keys and leaf shapes (a full layout like ref's)."""
    other, adam = states[n]
    mine, mine_adam = states[ref]
    if sorted(other) != sorted(mine) or sorted(adam) != sorted(mine_adam):
        fail(f"phase {phase}: {n}'s logdir {sorted(other)}, {ref}'s "
             f"{sorted(mine)}")
    worst = {}
    for k in mine:
        if shapes(other[k]) != shapes(mine[k]):
            fail(f"phase {phase}: {n}'s {k} has the leaf shapes "
                 f"{shapes(other[k])}, {ref}'s {shapes(mine[k])}")
        group = ("planes" if k.startswith("planes") else "SR"
                 if "SR_model" in k else "decoders")
        for a, b in zip(flat_leaves(other[k]), flat_leaves(mine[k])):
            a, b = a.double(), b.double()
            scale = max(float(b.abs().max()), 1e-30)
            worst[group] = max(worst.get(group, 0.0),
                               float((a - b).abs().max()) / scale)
    if not all(shapes(adam[k]) == shapes(mine_adam[k]) for k in adam):
        fail(f"phase {phase}: {n}'s Adam leaves are not {ref}'s shapes")
    return worst, trees_equal(other, mine) and trees_equal(adam, mine_adam)


def shapes(tree):
    """The leaf shapes of a tree (sorted dict keys, list order)."""
    import numpy as np
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in shapes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in shapes(v)]
    return [tuple(np.shape(tree))]


def dist_cfg(w, scene, logdir):
    """Phase 9's TrainModels config (as a dict) with
    experiment.data_parallel, cut to this phase: an evaluate at the first
    and the last iteration, of the val views only; one save, at the last
    iteration (save_every is 600 minutes); every iteration's metrics
    flushed; occupancy boxes from
    iteration 2 on, every 2 iterations; the trainable route."""
    cfg = trainmodels_cfg(w, scene)
    cfg.experiment.update(logdir=logdir, validate_every=1000,
                          save_every=600.0, print_every=1,
                          data_parallel=True)
    cfg.dataset["dir"]["val"] = {}
    cfg.nerf.train["occupancy"] = {"enabled": True, "warmup_iters": 2,
                                   "update_every": 2}
    cfg.nerf.train["tiled_gather"] = True
    cfg.nerf.train["num_random_rays"] = w["rays"]
    cfg.nerf.train["num_coarse"] = cfg.nerf.train["num_fine"] = w["samples"]
    cfg.nerf.validation["eval_train_scenes"] = False
    cfg.nerf.validation["tiled_gather"] = True
    return cfg


def dist_phase(dev, w=TRAIN_FULL, on_card=True, card="", iters=DIST_ITERS,
               controls=False):
    """Phase 11 (see the module docstring). With on_card=False (a CPU
    rehearsal at a small `w`) every rank runs on the CPU under gloo, the
    world of 1 too, and every comparison of (a) is bit for bit; the dry
    run is left to tests/test_torch_parallel.py there. controls=True
    also trains a second plain run and a second world of 1 alone and a
    second world of 2, and prints every reading against the plain run
    and each run's against its twin: the record behind DP_PARAM_BOUND."""
    import tempfile
    import numpy as np
    from nvsr_tpu_torch.parallel.host_pool import scene_owner
    from nvsr_tpu_torch.utils.png import imread as png_read

    t_phase = time.perf_counter()
    on = f" on {card}" if card else ""
    scene = "chair"
    lr_scene = f"{scene}_DS{2 * w['sr_scale']}_PlRes{w['res']}_" \
        f"{w['view_res']}"

    with tempfile.TemporaryDirectory() as root:
        write_synthetic_scene(os.path.join(root, "synt"), scene, w["image"])
        cli = CliRuns(root, on_card, iters, "11",
                      lambda logdir: dist_cfg(w, scene, logdir))
        launch, launch_dryrun, wait, stop_all = (
            cli.launch, cli.launch_dryrun, cli.wait, cli.stop_all)

        try:
            gloo2 = cli.gloo
            # training: on the card, the plain run and the world of 1 alone,
            # one after the other (their iterations are timed), then a second
            # plain run (the run-to-run control) beside the world of 2 (a
            # correctness run: two ranks share the card) and the dry run;
            # on the CPU, where nothing is timed and the arithmetic repeats
            # itself, the three runs at once and no control
            if on_card:
                runs = wait(launch("plain", "plain"))
                runs.update(wait(launch("w1", "w1", world=1)))
                if controls:
                    runs.update(wait(launch("plain_b", "plain_b")))
                    runs.update(wait(launch("w1_b", "w1_b", world=1)))
                runs.update(wait(
                    launch("again", "again"),
                    launch("w2", "w2", world=2, extra=gloo2),
                    launch_dryrun(),
                    *([launch("w2_b", "w2_b", world=2, extra=gloo2)]
                      if controls else [])))
            else:
                runs = wait(launch("plain", "plain"),
                            launch("w1", "w1", world=1),
                            launch("w2", "w2", world=2, extra=gloo2))
            dry_log = runs.pop("dryrun", None)
            trained = [n for n in ("plain", "plain_b", "again", "w1", "w1_b",
                                   "w2", "w2_b") if n in runs]
            # eval: each of them --eval images of the plain run's logdir,
            # and the world of 2 of its own logdir: its trained state
            ev = ["--eval", "images", "--results_path"]
            runs.update(wait(
                launch("eval_plain", "plain", extra=ev + ["results_plain"]),
                launch("eval_w1", "plain", world=1, extra=ev + ["results_w1"]),
                launch("eval_w2", "plain", world=2,
                       extra=ev + ["results_w2"] + gloo2),
                launch("own_w2", "w2", world=2,
                       extra=ev + ["results_ow2"] + gloo2)))

            if dry_log is not None:
                lines = [ln for ln in dry_log.splitlines()
                         if ln.startswith("dryrun_multichip")]
                print(f"[dist] {lines[-1] if lines else dry_log[-2000:]}"
                      f"{on}")

            def scalars(name, key):
                return np.array([v for n, _, v in runs[name][0]["scalars"]
                                 if n == key])

            # check 1: the flushed losses and PSNRs
            loss = {n: scalars(n, "train/loss") for n in trained}
            psnr = {n: scalars(n, "train/psnr") for n in loss}
            for n in loss:
                print(f"[dist] {n} losses {loss[n].tolist()}")
            if any(len(v) != iters or not np.all(np.isfinite(v))
                   for v in loss.values()):
                fail("phase 11: missing or non-finite losses")

            def rel(a, b):
                return float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                               1e-30)))

            print(f"[dist] loss max rel delta vs plain: "
                  f"{ {n: rel(loss[n], loss['plain']) for n in trained} }; "
                  f"first iteration "
                  f"(no update before it) world 1 "
                  + ("bit-equal" if loss["w1"][0] == loss["plain"][0]
                     else "DIFFERS"))
            exact_w1 = on_card is False
            if exact_w1:
                if not (np.array_equal(loss["w1"], loss["plain"])
                        and np.array_equal(psnr["w1"], psnr["plain"])):
                    fail("phase 11 (a): world 1 losses are not the plain "
                         "run's")
            elif not (loss["w1"][0] == loss["plain"][0]
                      and psnr["w1"][0] == psnr["plain"][0]):
                fail("phase 11 (a): the first iteration differs at world 1")
            for n in [n for n in trained if n.startswith("w")]:
                if not (np.allclose(loss[n], loss["plain"], rtol=DP_LOSS_RTOL,
                                    atol=DP_LOSS_ATOL)
                        and np.allclose(psnr[n], psnr["plain"],
                                        rtol=DP_PSNR_RTOL)):
                    fail(f"phase 11: {n} losses or PSNRs outside JAX's bounds")

            # check 2: the logdirs: module checkpoints and plane files (with
            # their Adam leaves) against the plain run's. Adam's moments of
            # the SR net hold gradients near 0 (down to 1e-26 at a small
            # width), whose relative deltas say nothing, so they are held
            # only bit for bit where the arithmetic is (a CPU world of 1)
            states = {n: logdir_state(os.path.join(root, "logs", n),
                                      [lr_scene]) for n in trained}
            base = states["plain"][0]

            def param_delta(n, ref="plain"):
                return logdir_delta(states, n, ref, "11")

            deltas = {n: param_delta(n) for n in trained if n != "plain"}
            print(f"[dist] logdir checkpoints and plane files {sorted(base)}: "
                  f"parameters vs plain, max delta / leaf max by group, and "
                  f"whether every parameter and Adam leaf is bit-equal: "
                  f"{deltas}")
            for n, twin in (("w1_b", "w1"), ("w2_b", "w2")):
                if n in states:
                    print(f"[dist] {n} vs {twin} (one command twice): "
                          f"{param_delta(n, twin)}")
            if exact_w1 and not deltas["w1"][1]:
                fail("phase 11 (a): world 1's logdir is not the plain run's")
            if on_card:
                print(f"[dist] world 1's parameters held within "
                      f"{DP_PARAM_BOUND}")
                for n in ("w1", "w1_b"):
                    if n in deltas and any(v > DP_PARAM_BOUND[g] for g, v
                                           in deltas[n][0].items()):
                        fail(f"phase 11 (a): {n}'s parameters outside "
                             f"{DP_PARAM_BOUND}")

            # check 3: the eval of one logdir: world 1 bit-equal to the plain
            # eval (rgb and PNG files), world 2 inside JAX's image bounds; and
            # world 2's eval of its own logdir inside JAX's image bounds of
            # the plain run's
            def pngs(n):
                d = os.path.join(root, f"results_{n}")
                return {os.path.relpath(os.path.join(p, f), d):
                        png_read(os.path.join(p, f))
                        for p, _, fs in os.walk(d) for f in fs
                        if f.endswith(".png")}

            ref_png = pngs("plain")
            ref = dict(runs["eval_plain"][0]["renders"])
            for n in ("w1", "w2", "ow2"):
                name = "own_w2" if n == "ow2" else f"eval_{n}"
                got = dict(runs[name][0]["renders"])
                if sorted(got) != sorted(ref) or not ref:
                    fail(f"phase 11: {name} rendered {sorted(got)}")
                worst = max(float(np.max(np.abs(got[k] - ref[k])))
                            for k in ref)
                inside = all(np.allclose(got[k], ref[k], rtol=DP_IMG_RTOL,
                                         atol=DP_IMG_ATOL) for k in ref)
                if n == "ow2":
                    print(f"[dist] --eval images of w2's own logdir against "
                          f"the plain run's: max |rgb delta| {worst:.3e}, "
                          f"inside JAX's image bounds: {inside}")
                    if not inside:
                        fail("phase 11 (b): world 2's trained state renders "
                             "outside JAX's image bounds")
                    continue
                same = all(np.array_equal(got[k], ref[k]) for k in ref)
                mine_png = pngs(n)
                png_diff = sorted(set(mine_png) ^ set(ref_png)) + [
                    k for k in ref_png if k in mine_png
                    and not np.array_equal(mine_png[k], ref_png[k])]
                png_same = not png_diff
                print(f"[dist] --eval images world {n[1]}: {len(ref)} "
                      f"renders, "
                      f"max |rgb - plain| {worst:.3e} (bit-equal: {same}); "
                      f"{len(ref_png)} PNGs equal: {png_same}"
                      + (f" (differ: {png_diff})" if png_diff else ""))
                if n == "w1" and not (same and png_same):
                    fail("phase 11 (a): world 1's eval is not the plain eval")
                if not inside:
                    fail(f"phase 11: eval_{n} outside JAX's image bounds")

            # check 4: ownership: each plane file written by its crc32 owner
            # only; checkpoints, exp_info and images by rank 0 only
            for n in [n for n in runs if "w2" in n]:
                for r, rep in enumerate(runs[n]):
                    bad = [s for s in rep["planes_written"]
                           if scene_owner(s, 2) != r]
                    if bad or (r and rep["pickles"]):
                        fail(f"phase 11: rank {r} of {n} wrote planes {bad}, "
                             f"pickles {rep['pickles']}")
            owner = scene_owner(lr_scene, 2)
            w2 = runs["w2"]
            print(f"[dist] world 2: {lr_scene} owned by rank {owner}; planes "
                  f"written by rank: {[rep['planes_written'] for rep in w2]}; "
                  f"pickles by rank: "
                  f"{[sorted(set(rep['pickles'])) for rep in w2]}")
            if not w2[owner]["planes_written"] or not w2[0]["pickles"]:
                fail("phase 11: the owner or rank 0 wrote nothing")

            # check 5: launches, per rank: the trainable sampler once per
            # iteration, the full gather+decode entry twice per eval block of
            # the rank's, nothing else
            for n, reps in runs.items():
                for rep in reps:
                    want = {k: 0 for k in rep["launches"]}
                    if "eval" not in n and "own" not in n:
                        want["plane_sample_fwd"] = want["plane_sample_bwd"] = \
                            len(rep["iters"])
                    want["triplane_render_full"] = rep["want_full"]
                    got = {k: v for k, v in rep["launches"].items() if v}
                    print(f"[dist] {n} rank {rep['rank']}/{rep['world']}: "
                          f"launches {got}")
                    if on_card and rep["launches"] != want:
                        fail(f"phase 11: {n} rank {rep['rank']} launched "
                             f"{rep['launches']}, expected {want}")

            # the numbers: collectives, iteration times, memory
            for n in ("w1", "w2"):
                rep = runs[n][0]
                per = [it["collectives"] for it in rep["iters"]]
                ctl = rep["collectives"].get("control", 0)
                print(f"[dist] {n}: collectives per iteration (inside "
                      f"train_iteration) {per[-1]}; all over the run "
                      f"{rep['collectives']} in {len(per)} iterations "
                      f"(control "
                      f"broadcasts {ctl / len(per):.2f} an iteration)")
            seconds = {n: round(r[0]["seconds"], 2) for n, r in runs.items()}
            print(f"[dist] seconds in cli.main by run (rank 0){on}: "
                  f"{seconds}")
            if on_card:
                def med(xs):
                    return statistics.median(xs) if xs else float("nan")
                for n in ("plain", "w1", "w2"):
                    its = runs[n][0]["iters"]
                    hr = [it["ms"] for it in its if it["sr"]]
                    lr = [it["ms"] for it in its if not it["sr"]]
                    print(f"[dist]{on}: {n} iteration ms (between two "
                          f"synchronizes): HR/SR median {med(hr):.2f} of "
                          f"{[round(x, 2) for x in hr]}; LR median "
                          f"{med(lr):.2f} of {[round(x, 2) for x in lr]}; run "
                          f"{runs[n][0]['seconds']:.2f} s"
                          + (" (rank 0; two ranks share the card: a "
                             "correctness run, not a scaling number)"
                             if n == "w2" else ""))
                for n in ("plain", "w1", "w2"):
                    print(f"[dist]{on}: {n} peak memory by rank "
                          f"{[round(rep['peak_mib'], 1) for rep in runs[n]]} "
                          f"MiB" + (" (two ranks share the card: a "
                                    "correctness run, not a scaling "
                                    "number)" if n == "w2" else ""))
        finally:
            stop_all()
        print(f"[dist] phase in {time.perf_counter() - t_phase:.1f} s{on}")


# phase 12: tensor parallelism and the device pool through the entry
# point, as phase 11 drives data parallel
TP_ITERS = 4
# phase 12's cuts (PERF.md §4): the EDSR trunk 4 blocks deep (of 32) and
# the synthetic scenes 400 pixels wide (eval views of 200^2 and 50^2
# rays). Two gloo ranks on the one card move every split conv's output,
# and every row layer's partial sums, through host memory; the widths
# are phase 9's
TP_W = dict(TRAIN_FULL, sr_blocks=4, image=400)
POOL_SCENES = ("chair", "drums", "ficus", "hotdog")
# JAX's bounds of a tensor-parallel run against the unsharded one
# (tests/test_experiment_mesh.py:57-65)
TP_LOSS_RTOL, TP_LOSS_ATOL = 2e-4, 1e-6
TP_IMG_RTOL, TP_IMG_ATOL = 1e-3, 1e-4
# the tensor-parallel run's parameters after TP_ITERS steps against the
# plain run's: max |delta| / leaf max by group, ~3x the readings of five
# calls (PERF.md §6, the table under TP_PARAM_BOUND), which were the
# same in each: a row layer's partial sums add up in another order every
# step, the same order each run; the backward's atomics add a run-to-run
# spread of ~1e-7, which the second plain run prints. The faults
# --controls plants read 30x and more above it (bf16_reduce: planes
# 2.5e-2, decoders 1.3e-2)
TP_PARAM_BOUND = {"planes": 8e-4, "decoders": 1.8e-4, "SR": 2e-7}
# the faults phase 12's controls plant (plant_fault), by run name
FAULTS = {"tp_drop": "drop_pair", "tp_bf16": "bf16_reduce"}


def tp_cfg(w, logdir, scenes, model_parallel=1, pool=False):
    """Phase 11's config (dist_cfg: the trainable route and the tiled
    eval) on `scenes` in both of its groups, with
    experiment.model_parallel or store_planes.device_pool."""
    cfg = dist_cfg(w, scenes[0], logdir)
    cfg.dataset["dir"]["train"] = {k: list(scenes)
                                   for k in cfg.dataset["dir"]["train"]}
    if model_parallel > 1:
        cfg.experiment["model_parallel"] = model_parallel
    if pool:
        cfg.nerf.train.store_planes["device_pool"] = True
    return cfg


def tp_phase(dev, w=TP_W, on_card=True, card="", iters=TP_ITERS,
             controls=False):
    """Phase 12 (see the module docstring). Returns each run's kernel
    launches per rank ({kernel: count}, the nonzero ones; every run, the
    evals too). With on_card=False (a CPU
    rehearsal at a small `w`) the ranks run on the CPU under gloo, the
    dry run is left to tests/test_torch_parallel.py, and the pool is held
    bit for bit to the replicated world of 2. controls=True also trains
    a second tensor-parallel run and two with a fault planted
    (plant_fault), prints their readings, and fails if a fault's lie
    inside TP_PARAM_BOUND: the record behind the bound."""
    import tempfile
    import numpy as np
    from nvsr_tpu_torch.parallel.host_pool import pool_homes

    t_phase = time.perf_counter()
    on = f" on {card}" if card else ""

    def lr_id(sc):
        return f"{sc}_DS{2 * w['sr_scale']}_PlRes{w['res']}_{w['view_res']}"

    def make_cfg(logdir):
        name = logdir.split("/")[-1]
        pooled = name.startswith(("pool", "rep"))
        return tp_cfg(w, logdir, POOL_SCENES if pooled else POOL_SCENES[:1],
                      model_parallel=2 if name.startswith("tp") else 1,
                      pool=name.startswith("pool"))

    with tempfile.TemporaryDirectory() as root:
        for sc in POOL_SCENES:
            write_synthetic_scene(os.path.join(root, "synt"), sc, w["image"])
        cli = CliRuns(root, on_card, iters, "12", make_cfg)
        launch, gloo = cli.launch, cli.gloo
        ev = ["--eval", "images", "--results_path"]
        try:
            # training: the plain run alone on the card (timed), then the
            # tensor-parallel world of 2 beside a second plain run (the
            # control) and the tensor-parallel dry run, then the pool
            # beside the replicated world of 2; on the CPU all at once
            # (a launch starts its run; each wait stops what it left)
            def first():
                return [launch("plain", "plain")]

            def tp():
                return [launch("tp", "tp", world=2, extra=gloo),
                        launch("again", "again")] + ([
                    launch("tp_b", "tp_b", world=2, extra=gloo),
                    *[launch(f, f, world=2, extra=gloo, plant=plant)
                      for f, plant in FAULTS.items()]] if controls else [])

            def pool():
                return [launch("pool", "pool", world=2, extra=gloo),
                        launch("rep", "rep", world=2, extra=gloo)]

            if on_card:
                runs = cli.wait(*first())
                runs.update(cli.wait(*tp(), cli.launch_dryrun(
                    ["--model-parallel", "2"])))
                runs.update(cli.wait(*pool()))
            else:
                runs = cli.wait(*first(), *tp(), *pool())
            dry_log = runs.pop("dryrun", None)
            trained = [n for n in ("plain", "again", "tp", "tp_b", "pool",
                                   "rep") if n in runs]
            faults = [n for n in FAULTS if n in runs]
            # eval: --eval images of the tensor-parallel logdir by a world
            # of 2 (model_parallel from the logdir's config) and by one
            # process; of the pool's likewise
            runs.update(cli.wait(
                launch("own_tp", "tp", world=2, extra=ev + ["res_tp2"] + gloo),
                launch("one_tp", "tp", extra=ev + ["res_tp1"]),
                launch("own_pool", "pool", world=2,
                       extra=ev + ["res_pool2"] + gloo),
                launch("one_pool", "pool", extra=ev + ["res_pool1"])))
            if dry_log is not None:
                lines = [ln for ln in dry_log.splitlines()
                         if ln.startswith("dryrun_multichip")]
                print(f"[tp] {lines[-1] if lines else dry_log[-2000:]}{on}")

            def scalars(name, key):
                return np.array([v for n, _, v in runs[name][0]["scalars"]
                                 if n == key])

            def rel(a, b):
                return float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                               1e-30)))

            # check 1: losses and PSNRs, each rank's the same
            loss = {n: scalars(n, "train/loss") for n in trained}
            psnr = {n: scalars(n, "train/psnr") for n in trained}
            for n in trained:
                print(f"[tp] {n} losses {loss[n].tolist()}")
                if len(loss[n]) != iters or not np.all(np.isfinite(loss[n])):
                    fail(f"phase 12: {n}'s losses missing or non-finite")
                if any([v for _, _, v in rep["scalars"]]
                       != [v for _, _, v in runs[n][0]["scalars"]]
                       for rep in runs[n]):
                    fail(f"phase 12: the ranks of {n} logged apart")
            print(f"[tp] loss max rel delta: tp vs plain "
                  f"{rel(loss['tp'], loss['plain']):.3e}, again vs plain "
                  f"{rel(loss['again'], loss['plain']):.3e}, pool vs rep "
                  f"{rel(loss['pool'], loss['rep']):.3e}"
                  + (f", tp_b vs tp {rel(loss['tp_b'], loss['tp']):.3e}"
                     if "tp_b" in loss else ""))
            for n in faults:
                got = scalars(n, "train/loss")
                print(f"[tp] {n} (fault planted: {FAULTS[n]}) losses "
                      f"{got.tolist()}, max rel delta vs plain "
                      f"{rel(got, loss['plain']):.3e}")
            for n in [n for n in trained if n.startswith("tp")]:
                if not (np.allclose(loss[n], loss["plain"], rtol=TP_LOSS_RTOL,
                                    atol=TP_LOSS_ATOL)
                        and np.allclose(psnr[n], psnr["plain"],
                                        rtol=TP_LOSS_RTOL)):
                    fail(f"phase 12 (a): {n}'s losses or PSNRs outside "
                         f"JAX's tensor-parallel bounds")
            if not (loss["pool"][0] == loss["rep"][0]
                    and np.allclose(loss["pool"], loss["rep"],
                                    rtol=DP_LOSS_RTOL, atol=DP_LOSS_ATOL)
                    and np.allclose(psnr["pool"], psnr["rep"],
                                    rtol=DP_PSNR_RTOL)):
                fail("phase 12 (b): the pool's losses are not the replicated "
                     "world's")
            if not on_card and not (np.array_equal(loss["pool"], loss["rep"])
                                    and np.array_equal(psnr["pool"],
                                                       psnr["rep"])):
                fail("phase 12 (b): on the CPU the pool is not bit-equal to "
                     "the replicated world of 2")

            # check 2: the logdirs, in the full layout: the tensor-parallel
            # one against the plain one, the pool's against the replicated
            states = {n: logdir_state(os.path.join(root, "logs", n), [
                lr_id(sc) for sc in (POOL_SCENES if n in ("pool", "rep")
                                     else POOL_SCENES[:1])])
                for n in trained + faults}
            deltas = {n: logdir_delta(states, n, ref, "12")
                      for n, ref in (("tp", "plain"), ("again", "plain"),
                                     ("tp_b", "tp"), ("pool", "rep"),
                                     *((f, "plain") for f in faults))
                      if n in states}
            print(f"[tp] logdir parameters, max delta / leaf max by group, "
                  f"and whether every parameter and Adam leaf is "
                  f"bit-equal: tp vs plain {deltas['tp']}; again vs plain "
                  f"(the control) {deltas['again']}; pool vs rep "
                  f"{deltas['pool']}"
                  + (f"; tp_b vs tp {deltas['tp_b']}" if "tp_b" in deltas
                     else "")
                  + "".join(f"; {f} (fault planted) vs plain {deltas[f]}"
                            for f in faults))
            if on_card:
                print(f"[tp] held within {TP_PARAM_BOUND} (tp), "
                      f"{DP_PARAM_BOUND} (pool)")
                for n, bound in (("tp", TP_PARAM_BOUND),
                                 ("pool", DP_PARAM_BOUND)):
                    if any(v > bound[g] for g, v in deltas[n][0].items()):
                        fail(f"phase 12: {n}'s parameters outside {bound}")
                for f in faults:
                    if not any(v > TP_PARAM_BOUND[g]
                               for g, v in deltas[f][0].items()):
                        fail(f"phase 12 controls: the planted fault {f} "
                             f"lies inside {TP_PARAM_BOUND}")
            elif not deltas["pool"][1]:
                fail("phase 12 (b): on the CPU the pool's logdir is not the "
                     "replicated world's")

            # check 3: the evals of one logdir by a world of 2 and by one
            # process
            for n, ref, rtol, atol in (
                    ("own_tp", "one_tp", TP_IMG_RTOL, TP_IMG_ATOL),
                    ("own_pool", "one_pool", DP_IMG_RTOL, DP_IMG_ATOL)):
                got, want = dict(runs[n][0]["renders"]), dict(
                    runs[ref][0]["renders"])
                if sorted(got) != sorted(want) or not want:
                    fail(f"phase 12: {n} rendered {sorted(got)}, {ref} "
                         f"{sorted(want)}")
                worst = max(float(np.max(np.abs(got[k] - want[k])))
                            for k in want)
                print(f"[tp] --eval images {n} vs {ref}: {len(want)} "
                      f"renders, max |rgb delta| {worst:.3e}")
                if not all(np.allclose(got[k], want[k], rtol=rtol, atol=atol)
                           for k in want):
                    fail(f"phase 12: {n}'s eval outside rtol {rtol} / atol "
                         f"{atol} of {ref}'s")

            # check 4: what a tensor-parallel rank keeps: its split leaves
            # are half of the full ones, the replicated ones (the heads, the
            # row layers' biases) whole
            full = runs["plain"][0]["modules"]
            for rep in runs["tp"]:
                mine = rep["modules"]
                print(f"[tp] tp rank {rep['rank']} bytes (split, whole): "
                      f"{mine}; plain {full}")
                for k in ("decoders", "SR"):
                    if 2 * mine[k][0] + mine[k][1] != sum(full[k]) or \
                            mine[k][1] > 0.02 * sum(full[k]):
                        fail(f"phase 12 (a): tp rank {rep['rank']} keeps "
                             f"{mine[k]} bytes of {k}, not half of "
                             f"{sum(full[k])}")
                if [2 * a + b for a, b in mine["moments"]] != \
                        [sum(m) for m in full["moments"]]:
                    fail("phase 12 (a): the Adam moments are not in the "
                         "parameters' layout")

            # check 5: the pool: JAX's homes; each plane file written by its
            # home only; between steps each rank keeps its home scenes'
            # planes and moments, and nothing of the others
            ids = [lr_id(sc) for sc in POOL_SCENES]
            homes = pool_homes(ids, 2)
            if homes != {s: i % 2 for i, s in enumerate(sorted(ids))}:
                fail("phase 12 (b): pool_homes is not JAX's round robin")
            for rep in runs["pool"] + runs["own_pool"]:
                r = rep["rank"]
                if rep["homes"] is not None and rep["homes"] != homes:
                    fail(f"phase 12 (b): rank {r}'s homes {rep['homes']}")
                bad = [s for s in rep["planes_written"] if homes[s] != r]
                if bad:
                    fail(f"phase 12 (b): rank {r} wrote {bad}")
            for rep in runs["pool"]:
                probes = [it["pool"] for it in rep["iters"]]
                print(f"[tp] pool rank {rep['rank']}: home of "
                      f"{sorted(s for s in homes if homes[s] == rep['rank'])}"
                      f", wrote {sorted(set(rep['planes_written']))}; kept "
                      f"between steps {[p['bytes'] for p in probes]} bytes "
                      f"(its home scenes' planes and moments "
                      f"{[p['home_bytes'] for p in probes]})")
                if not rep["planes_written"] or any(
                        p["bytes"] != p["home_bytes"] or p["foreign"]
                        or p["lent"] or not p["bytes"] for p in probes):
                    fail(f"phase 12 (b): pool rank {rep['rank']} kept "
                         f"{probes}")

            # check 6: launches per rank: the trainable sampler once per
            # iteration, the full gather+decode entry twice per eval block
            # of the rank's data index (tensor-parallel ranks render with
            # the decoders gathered, pooled ones on the lent planes),
            # nothing else
            launches = {}
            for n, reps in runs.items():
                for rep in reps:
                    want = {k: 0 for k in rep["launches"]}
                    if n in trained or n in faults:
                        want["plane_sample_fwd"] = want["plane_sample_bwd"] = \
                            len(rep["iters"])
                    want["triplane_render_full"] = rep["want_full"]
                    launches.setdefault(n, []).append(
                        {k: v for k, v in rep["launches"].items() if v})
                    if on_card and (rep["launches"] != want
                                    or not rep["want_full"]):
                        fail(f"phase 12: {n} rank {rep['rank']} launched "
                             f"{rep['launches']}, expected {want}")
            print(f"[tp] launches per rank: {launches}")

            # the numbers: iteration times, collectives, memory
            def med(xs):
                return statistics.median(xs) if xs else float("nan")

            for n in trained:
                rep = runs[n][0]
                hr = [it["ms"] for it in rep["iters"] if it["sr"]]
                lr = [it["ms"] for it in rep["iters"] if not it["sr"]]
                print(f"[tp]{on}: {n} iteration ms (between two "
                      f"synchronizes): HR/SR median {med(hr):.2f} of "
                      f"{[round(x, 2) for x in hr]}; LR median {med(lr):.2f} "
                      f"of {[round(x, 2) for x in lr]}; run "
                      f"{rep['seconds']:.2f} s; peak memory by rank "
                      f"{[rep_['peak_mib'] for rep_ in runs[n]]} MiB"
                      + (" (two gloo ranks share the card: a correctness "
                         "run)" if len(runs[n]) > 1 else ""))
            for n in ("tp", "pool", "rep"):
                for kind in (True, False):
                    its = [it for it in runs[n][0]["iters"]
                           if it["sr"] == kind]
                    if its:
                        print(f"[tp] {n} collectives of an "
                              f"{'HR/SR' if kind else 'LR'} iteration "
                              f"(rank 0): {its[-1]['collectives']}")
            seconds = {n: round(r[0]["seconds"], 2) for n, r in runs.items()}
            print(f"[tp] seconds in cli.main by run (rank 0){on}: {seconds}")
        finally:
            cli.stop_all()
    print(f"[tp] phase in {time.perf_counter() - t_phase:.1f} s{on}")
    return launches


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


def card_setup():
    """The card's name and power limit (nvidia-smi), printed with the
    software; TF32 off; every kernel built. Returns (card, device)."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "GPU")
    sys.path.insert(0, ROOT)
    from nvsr_tpu_torch import kernels

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

    # -- 0. the native plane store --------------------------------------
    from nvsr_tpu_torch.utils import native_store
    t0 = time.perf_counter()
    try:
        lib = native_store._build_library()
    except RuntimeError as e:
        fail(f"the native plane store did not build: {e}")
    if not native_store.available():
        fail(f"the native plane store did not load: "
             f"{native_store._lib_error}")
    print(f"[native] plane store library {lib} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s ({card})")

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.build(verbose=True)
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return card, torch.device("cuda", 0)


def main(profile=False):
    import numpy as np
    import torch
    card, dev = card_setup()
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.models.plane_sr import apply_plane_sr
    from nvsr_tpu_torch.render import render_image

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
    host_waits = {}
    entries.update(train_phase(dev, camera([3.8, 0.5, 0.7]),
                               profile=profile, host_waits=host_waits))

    # -- 6. bicubic planes ------------------------------------------------
    entries.update(bicubic_phase(dev, camera([3.8, 0.5, 0.7])))

    # -- 7. the points entry ----------------------------------------------
    entries.update(points_phase(dev, camera([3.8, 0.5, 0.7]),
                                profile=profile))

    # -- 8. the Experiment's eval half ------------------------------------
    experiment_phase(dev, profile=profile)

    # -- 9. the Experiment's training half --------------------------------
    experiment_train_phase(dev, profile=profile, card=card,
                           host_waits=host_waits)

    # -- 10. the baseline stage, reference conversion, the SR branches ---
    baseline_phase(dev, profile=profile, card=card)
    convert_phase(dev, card=card)
    sr_gaps_phase(dev, card=card)

    # -- 11. data parallel through the entry point ----------------------
    torch.cuda.empty_cache()
    dist_phase(dev, card=card)

    # -- 12. tensor parallel and the device pool through the entry point -
    torch.cuda.empty_cache()
    tp_launches = tp_phase(dev, card=card)
    for name in ("plane_sample_fwd", "plane_sample_bwd",
                 "triplane_render_full"):
        entries[name]["phase12_launches_per_rank"] = {
            n: [ranks.get(name, 0) for ranks in reps]
            for n, reps in tp_launches.items()}

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
    if argv[:1] == ["--cli"]:
        cli_rank(argv[1], argv[2:])
    elif argv[:2] == ["--phase", "12"]:
        card_name, device = card_setup()
        tp_phase(device, card=card_name, controls="--controls" in argv)
        print(card_name)
    elif argv[:1] == ["--times-of"]:
        times_of(argv[1])
    elif argv[:1] == ["--times"]:
        compare(argv[1:])
    else:
        main(profile="--profile" in argv)
