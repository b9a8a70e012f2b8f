"""Chip smoke test of the PyTorch/CUDA port (nvsr_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:  python3 chip_smoke.py  (add --profile to also trace one
HR/SR and one LR training step with torch.profiler)

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
     x 16 samples on 3x48x200^2 planes), timed beside F.grid_sample; the
     first HR/SR and LR steps through the kernels and through the plain
     sampler (losses must agree); then, with launch counts zeroed, 3
     HR/SR steps (EDSR 256x32 x4 bf16 trained, fine pass on the SR'd
     800^2 planes) and 3 LR steps, each followed by the Adam updates of
     the decoders, the SR net and the planes.
Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the H100's peak for their type (989 TFLOP/s bf16 tensor
core, 67 TFLOP/s f32), counted from this run's shapes.
The last two lines are the kernels JSON and the result JSON.
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


def bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def render_bound(args, sigma_only):
    """Bound of one triplane_render call: every input read once, the
    output written once; the decoder's multiply-adds at the bf16 tensor
    core rate."""
    table, packed, origins, directions, z, view = args[:6]
    r, s = z.shape
    ins = [table, origins, directions, z, packed.w, packed.b, packed.wh,
           packed.bh] + ([] if sigma_only else [view])
    nbytes = sum(t.numel() * t.element_size() for t in ins) + r * s * 16
    flops = 0
    for branch, _, _, k, _ in packed.layers():
        if branch == "density" or not sigma_only:
            flops += 2 * k * 128
    flops += 2 * 128 * (1 if sigma_only else 4)
    return bound(nbytes, flops * r * s, BF16_TC_FLOPS)


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
    make_triplane_point_fn(tile_rays=...) builds, on the plain path)."""
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
            avg=cfg.proj_combination == "avg", sigma_only=sigma_only)

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
    bwd = kernels.plane_sample_backward(dout, grids, h, w,
                                        align_corners=True)
    bwd_ref = ps.plane_sample_backward_reference(dout, grids, h, w, True)
    torch.cuda.synchronize()
    for t in (fwd, bwd):
        if not torch.isfinite(t).all():
            fail("plane_sample: non-finite kernel output")
    e_f, e_b = (fwd - fwd_ref).abs(), (bwd - bwd_ref).abs()

    g4 = grids.reshape(p, 1, n, 2)
    x = planes_pos.detach().requires_grad_(True)

    def lib_fwd():
        return F.grid_sample(x, g4, mode="bilinear", padding_mode="border",
                             align_corners=True)

    y = lib_fwd()
    cot = dout.permute(0, 2, 1).reshape(p, c, 1, n).contiguous()
    ms = {
        "fwd": cuda_ms(lambda: kernels.plane_sample_forward(
            table, grids, c, align_corners=True), warmup=3, reps=20),
        "fwd_plain": cuda_ms(lambda: ps.plane_sample_reference(
            table, grids, c, True), warmup=1, reps=5),
        "fwd_lib": cuda_ms(lambda: lib_fwd().detach(), warmup=3, reps=20),
        "bwd": cuda_ms(lambda: kernels.plane_sample_backward(
            dout, grids, h, w, align_corners=True), warmup=3, reps=20),
        "bwd_plain": cuda_ms(lambda: ps.plane_sample_backward_reference(
            dout, grids, h, w, True), warmup=1, reps=5),
        "bwd_lib": cuda_ms(lambda: torch.autograd.grad(
            y, x, cot, retain_graph=True), warmup=3, reps=20),
        "fwdbwd_lib": cuda_ms(lambda: torch.autograd.grad(
            lib_fwd(), x, cot), warmup=3, reps=20),
    }
    f32 = 4
    # forward: 4 products, 2 sums, 2 roundings, 2 products, 1 sum per
    # output value; backward: 4 products, 2 roundings, 4 adds per dout
    b_f = bound(p * n * c * f32 + table.numel() * 2 + grids.numel() * f32,
                11 * p * n * c, F32_FLOPS)
    b_b = bound(dout.numel() * f32 + grids.numel() * f32
                + p * c * h * w * f32, 10 * p * n * c, F32_FLOPS)
    shape = f"P={p}, N={n}, C={c}, {h}x{w} planes"
    print(f"[train] plane_sample_fwd ({shape}): max err "
          f"{e_f.max().item():.3e}, mean {e_f.mean().item():.3e} (tol "
          f"{SAMPLE_FWD_TOL}); kernel {ms['fwd']:.4f} ms, plain "
          f"{ms['fwd_plain']:.4f} ms, F.grid_sample {ms['fwd_lib']:.4f} ms; "
          f"bound {b_f[0]:.4f} ms by {b_f[1]} ({b_f[0] / ms['fwd']:.1%})")
    print(f"[train] plane_sample_bwd ({shape}): max err "
          f"{e_b.max().item():.3e}, mean {e_b.mean().item():.3e} (tol max "
          f"{SAMPLE_BWD_MAX_TOL}, mean {SAMPLE_BWD_MEAN_TOL}); kernel "
          f"{ms['bwd']:.4f} ms, plain {ms['bwd_plain']:.4f} ms, grid_sample "
          f"backward {ms['bwd_lib']:.4f} ms (forward+backward "
          f"{ms['fwdbwd_lib']:.4f} ms); bound {b_b[0]:.4f} ms by {b_b[1]} "
          f"({b_b[0] / ms['bwd']:.1%})")
    if e_f.max() > SAMPLE_FWD_TOL:
        fail("plane_sample_fwd disagrees with its plain version")
    if e_b.max() > SAMPLE_BWD_MAX_TOL or e_b.mean() > SAMPLE_BWD_MEAN_TOL:
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
            "max_abs_err": e_b.max().item(), "ms": ms["bwd"],
            "plain_ms": ms["bwd_plain"], "bound_ms": b_b[0],
            "bound_by": b_b[1], "library_ms": ms["bwd_lib"]}}


def profile_step(step, batch, kind):
    """One training step (train_step alone) under torch.profiler: its
    kernels by device time, and device time against the step's wall
    time (the profiler slows the host, not the device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rays, tgt = batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(kind, rays, tgt, 20)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device-side events only: an operator's row repeats the device
    # time of the kernels it launched
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"[profile] {kind} step: device {dev_ms:.2f} ms in "
          f"{sum(e.count for e in kern)} kernel launches, wall {wall:.2f} "
          f"ms under the profiler")
    for e in kern[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


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
                                                init_decoder_params,
                                                make_rot_mats,
                                                project_to_planes)
    from nvsr_tpu_torch.ops.geometry import normalize_coords
    from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
    from nvsr_tpu_torch.ops.sampling import stratified_z_vals
    from nvsr_tpu_torch.planes_store import PlanesOptimizer
    from nvsr_tpu_torch.render import (RenderConfig, build_sampled_rays,
                                       tighten_bundle)
    from nvsr_tpu_torch.train import (ModuleOptimizer, StepFlags,
                                      choose_tile_pixels, train_step)

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
            z = stratified_z_vals(
                rays0.near, rays0.far, s, lindisp=False, perturb=True,
                generator=torch.Generator(device=dev).manual_seed(4))
            pts = rays0.origins[:, None] + rays0.directions[:, None] \
                * z[..., None]
            xyz = normalize_coords(pts.reshape(-1, 3),
                                   torch.as_tensor(box[:, :3], device=dev))
            grids = project_to_planes(xyz, make_rot_mats(3)).contiguous()
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
            profile_step(step, batch, kind)
    return entries


def main(profile=False):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "GPU")
    sys.path.insert(0, ROOT)
    from nvsr_tpu_torch import bridge, kernels
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig, apply_plane_sr
    from nvsr_tpu_torch.models.triplane import TriplaneConfig, make_rot_mats
    from nvsr_tpu_torch.ops import fused_render
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.ops.rendering import volume_render
    from nvsr_tpu_torch.ops.sampling import (hierarchical_z_vals,
                                             stratified_z_vals)
    from nvsr_tpu_torch.render import (RenderConfig, make_ray_bundle,
                                       make_triplane_point_fn, render_image,
                                       tighten_bundle, tile_ray_maps)

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
    H = W = 800
    ro, rd = get_ray_bundle(H, W, 0.5 * W / np.tan(0.3),
                            torch.as_tensor(camera([3.8, 0.5, 0.7]),
                                            device=dev))
    rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                        ray_block=RAY_BLOCK)

    with torch.no_grad():
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        torch.cuda.synchronize()

        # -- 2. kernels vs plain at the pass shapes ----------------------
        rays = make_ray_bundle(tile_ray_maps(ro, 16), tile_ray_maps(rd, 16),
                               2.0, 6.0, use_viewdirs=True)
        rays = tighten_bundle(rays, occ, tile_rays=256)
        blk = type(rays)(*[f[:RAY_BLOCK] for f in rays])
        geom = fused_render.geometry_args(box, make_rot_mats(3))
        from nvsr_tpu_torch.models.triplane import sample_viewdir_plane
        z_c = stratified_z_vals(blk.near, blk.far, 16, lindisp=False,
                                perturb=False)
        tab_c = fused_render.build_plane_table(planes_lr)
        tab_f = fused_render.build_plane_table(planes_sr)
        pk_c = fused_render.pack_decoder(dec_c, cfg)
        pk_f = fused_render.pack_decoder(dec_f, cfg)
        coarse_args = (tab_c, pk_c, blk.origins.contiguous(),
                       blk.directions.contiguous(), z_c.contiguous(), None,
                       geom)
        rf_c = kernels.triplane_render(*coarse_args, align_corners=True,
                                       avg=True, sigma_only=True)
        z_f = hierarchical_z_vals(
            z_c, volume_render(rf_c, z_c, blk.directions).weights, 16,
            det=True)
        view = fused_render.view_rows(sample_viewdir_plane(
            plane_view, blk.viewdirs, box, cfg, dense=True), pk_f.cvp)
        fine_args = (tab_f, pk_f, blk.origins.contiguous(),
                     blk.directions.contiguous(), z_f.contiguous(), view,
                     geom)
        entries = {}
        for name, args, so, shape in (
                ("triplane_render_sigma_only", coarse_args, True,
                 "coarse S=16 on 200^2"),
                ("triplane_render_full", fine_args, False,
                 "fine S=32 on 800^2")):
            kw = dict(align_corners=True, avg=True, sigma_only=so)
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
            b_ms, b_by = render_bound(args, so)
            print(f"[check] {name}: bound {b_ms:.4f} ms by {b_by} "
                  f"({b_ms / ms:.1%} of it); no single PyTorch call "
                  f"computes gather + decoder")
            entries[name] = {"name": name, "route": "cuda",
                             "source": "nvsr_tpu_torch/csrc/"
                                       "triplane_render.cu",
                             "replaces": "nvsr_tpu/ops/pallas/"
                                         "tile_sampler.py:904",
                             "max_abs_err": err.max().item(), "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": None}
        # sigma_only sigma == full-decode sigma, bit for bit
        so_out = kernels.triplane_render(*fine_args, align_corners=True,
                                         avg=True, sigma_only=True)
        full_out = kernels.triplane_render(*fine_args, align_corners=True,
                                           avg=True, sigma_only=False)
        torch.cuda.synchronize()
        if not torch.equal(so_out[..., 3], full_out[..., 3]):
            fail("sigma_only sigma differs from the full decode's")
        print("[check] sigma_only sigma bit-identical to the full decode: "
              "yes")

        # -- 3. the main path once ---------------------------------------
        frame_kernels = (kernels.triplane_render_full,
                         kernels.triplane_render_sigma_only)
        for k in kernels.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes_sr = apply_plane_sr(sr_params, sr_cfg, planes_lr)
        pf_c = make_triplane_point_fn(dec_c, cfg, planes_lr, plane_view, box,
                                      tile_rays=256, sigma_only=True)
        pf_f = make_triplane_point_fn(dec_f, cfg, planes_sr, plane_view,
                                      box, tile_rays=256)
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
        a = bridge.load_gate_asset(os.path.join(ROOT, "assets",
                                                "gate_scene.pkl"))
        g_ro, g_rd = get_ray_bundle(
            a["h"], a["w"], a["focal"], torch.as_tensor(a["pose"],
                                                        device=dev),
            downsampling_offset=(a["ds_factor"] - 1) / (2 * a["ds_factor"]))
        g_planes = torch.as_tensor(a["planes_pos"], device=dev)
        g_view = torch.as_tensor(a["plane_view"], device=dev)
        g_dc = bridge.decoder_from_jax(a["decoder_coarse"], dev)
        g_df = bridge.decoder_from_jax(a["decoder_fine"], dev)
        g_rcfg = RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                              white_background=True, ray_block=RAY_BLOCK)
        gt = torch.as_tensor(a["gt"].astype(np.float32) / 255.0, device=dev)
        g_cfg = dataclasses.replace(a["model_cfg"], compute_dtype="bfloat16")

        def gate_frame(mk, gcfg, tile):
            return render_image(
                mk(g_dc, gcfg, True), mk(g_df, gcfg, False), g_ro, g_rd,
                g_rcfg, near=a["near"], far=a["far"],
                occ_aabb=a["occ_aabb"], tile=tile).fine.rgb

        kern = gate_frame(lambda d, c, so: make_triplane_point_fn(
            d, c, g_planes, g_view, a["box"], tile_rays=256, sigma_only=so),
            g_cfg, 16)
        plain = gate_frame(lambda d, c, so: plain_point_fn(
            d, c, g_planes, g_view, a["box"], so), g_cfg, 16)
        ref = gate_frame(lambda d, c, so: make_triplane_point_fn(
            d, c, g_planes, g_view, a["box"], sigma_only=so),
            a["model_cfg"], None)
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

    print(card)
    print(json.dumps({"kernels": [entries["triplane_render_sigma_only"],
                                  entries["triplane_render_full"],
                                  entries["plane_sample_fwd"],
                                  entries["plane_sample_bwd"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # --profile: also profile one HR/SR and one LR training step
    main(profile="--profile" in sys.argv[1:])
