"""The training step, its optimizers and the training ray selection
(counterpart of nvsr_tpu/train.py).

`train_step` computes the loss of one ray batch and the gradients of
every group the flags make trainable (coarse decoder, fine decoder, SR
net, the scene's planes) with one `torch.autograd.grad`; frozen groups
enter as detached tensors, so the backward never reaches them. Which
groups then step is the caller's choice, through `ModuleOptimizer`
(decoders, SR) and `planes_store.PlanesBuffer.apply_grads` (planes).
`ModuleOptimizer.state` reads and writes optax.adam's state layout, so
the JAX package's checkpoints carry over both ways. `train_step_baseline`
is the entry for the baseline NeRF (models/nerf_mlp.py), whose only
trained groups are its two MLPs. The two entries build only their
inputs and point functions; the render, the losses and the backward are
one body (`_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nvsr_tpu_torch.models.plane_sr import (BlockRecompute, PlaneConv,
                                            PlaneSRConfig, apply_plane_sr)
from nvsr_tpu_torch.models.triplane import TriplaneConfig
from nvsr_tpu_torch.ops import draws
from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
from nvsr_tpu_torch.ops.rendering import img2mse, mse2psnr
from nvsr_tpu_torch.ops.resize import avg_downsample_pixels
from nvsr_tpu_torch.parallel.sharding import all_reduce_
from nvsr_tpu_torch.planes_store import materialize_pos_planes
from nvsr_tpu_torch.render import (RayBundle, RenderConfig,
                                   make_baseline_point_fn,
                                   make_triplane_point_fn, render_rays)
from nvsr_tpu_torch.utils.io import EmptyState, ScaleByAdamState
from nvsr_tpu_torch.utils.tracing import NO_SPAN, span


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """Per-iteration switches (the JAX StepFlags field for field).

    tile_cfg: the opt-in trainable route (nerf.train.tiled_gather): a
    TileSamplerConfig whose tile_rays is the tile size of the tile-major
    batch (choose_tile_pixels). The coarse pass's positional gathers then
    run the trainable plane sampler's kernels in both directions; the
    fine pass keeps the plain gather, as in JAX. The mirror holds only
    tile_rays: the TPU kernel's region geometry (th, tw, slab, group) has
    no counterpart, since on the card each tap is a plain load and no
    chunk of points shares a region."""
    sr_iter: bool = False
    consistency_iter: bool = False
    detach_lr_planes: bool = False
    apply_sr_to_coarse: bool = False
    compute_coarse_loss: bool = True
    compute_fine_loss: bool = True
    rendering_loss_w: float = 1.0
    im_inconsistency_loss_w: float = 0.0
    ds_factor: int = 1
    share_coarse_fine: bool = False
    member: int = 0
    plane_rank: Optional[int] = None
    # scene's stored plane resolution, for point_coords_noise scaling
    plane_resolution: Optional[int] = None
    train_planes: bool = True
    train_decoder: bool = True
    train_sr: bool = True
    # this batch's rendering-mass moments (surf_w, surf_wx, surf_wx2 in
    # the metrics) for the surface-based occupancy estimator
    track_surface_aabb: bool = False
    surf_weight_eps: float = 0.01
    tile_cfg: Optional[TileSamplerConfig] = None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _leaves_like(tree, other) -> list:
    """The leaves of `other` in the leaf order of `tree`, matched by dict
    key and list index (a tree from a pickle may order its keys in
    another way); KeyError or IndexError where the structures differ."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_like(v, other[k])]
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(other):
            raise IndexError(f"{len(other)} entries, not {len(tree)}")
        return [x for v, o in zip(tree, other) for x in _leaves_like(v, o)]
    return [other]


def _loss_weight(flags: "StepFlags") -> float:
    return (flags.im_inconsistency_loss_w if flags.consistency_iter
            else flags.rendering_loss_w)


def _inputs(tree, trainable: bool):
    """The group as autograd sees it: detached views of the caller's
    tensors, leaves that require grad when the group is trained."""
    return _tree_map(lambda t: t.detach().requires_grad_(trainable), tree)


def _decoder_inputs(decoder_coarse, decoder_fine, flags: StepFlags,
                    diff: dict):
    """The decoders as autograd sees them -> (dc, df), df being dc with
    share_coarse_fine; trained ones are added to `diff` as "dc", "df"."""
    dc = _inputs(decoder_coarse, flags.train_decoder)
    df = dc if flags.share_coarse_fine \
        else _inputs(decoder_fine, flags.train_decoder)
    if flags.train_decoder:
        diff["dc"] = dc
        if not flags.share_coarse_fine:
            diff["df"] = df
    return dc, df


def _step(build, rays: RayBundle, target, generator, rcfg: RenderConfig,
          flags: StepFlags):
    """The step of either model kind. Under the `forward` span: build()
    -> (the trained groups' inputs, a tree whose leaves require grad;
    the coarse point fn; the fine point fn), render_rays, on a
    consistency iteration each ds x ds patch's mean colour (a
    `consistency_loss` span), the coarse and fine losses and their
    weighted total. Under `backward`: one torch.autograd.grad over the
    trained leaves. -> (metrics, grads) as train_step returns them."""
    if flags.track_surface_aabb and not rcfg.keep_z:
        rcfg = dataclasses.replace(rcfg, keep_z=True)
    with span("forward"):
        diff, pf_coarse, pf_fine = build()
        out = render_rays(pf_coarse, pf_fine, rays, rcfg, generator)
        rgb_coarse = out.coarse.rgb
        rgb_fine = out.fine.rgb if out.fine is not None else None
        # a consistency iteration's loss: each ds x ds patch's mean
        # colour against its LR pixel (target's rows)
        with span("consistency_loss", patches=target.shape[0],
                  ds=flags.ds_factor) if flags.consistency_iter else NO_SPAN:
            if flags.consistency_iter:
                rgb_coarse = avg_downsample_pixels(rgb_coarse,
                                                   flags.ds_factor)
                if rgb_fine is not None:
                    rgb_fine = avg_downsample_pixels(rgb_fine,
                                                     flags.ds_factor)

            def loss(rgb, computed):
                if computed and rgb is not None:
                    return img2mse(rgb, target[..., :3])
                return torch.zeros((), device=target.device)

            coarse_loss = loss(rgb_coarse, flags.compute_coarse_loss)
            fine_loss = loss(rgb_fine, flags.compute_fine_loss)
            rendering_loss = coarse_loss + fine_loss
        total = _loss_weight(flags) * rendering_loss
        metrics = _step_metrics(rendering_loss, coarse_loss, fine_loss)
        if flags.track_surface_aabb:
            metrics.update(_surface_moments(out, rays, flags, rcfg.mip))
    with span("backward"):
        leaves = _leaves(diff)
        grads = {}
        if leaves:
            # a loss that reaches no trained group (e.g. only a detached
            # coarse loss) has no graph: every gradient is zero, as in JAX
            gl = [None] * len(leaves) if not total.requires_grad else \
                torch.autograd.grad(total, leaves, allow_unused=True)
            grads = _unflatten(diff, [torch.zeros_like(x) if g is None else g
                                      for x, g in zip(leaves, gl)])
    return metrics, grads


def train_step(decoder_coarse, decoder_fine, sr_params, plane_params, box,
               rays: RayBundle, target, generator: torch.Generator, *,
               model_cfg: TriplaneConfig, sr_cfg: Optional[PlaneSRConfig],
               rcfg: RenderConfig, flags: StepFlags, mesh=None):
    """Forward and backward for one ray batch.

    decoder_coarse/decoder_fine: decoder pytrees (fine is ignored with
    share_coarse_fine); sr_params: plane-SR pytree or None; plane_params:
    {"pos": [P, C, R, R], "view": [Cv, Rv, Rv]?}; box [2, D]; rays: the
    batch's flat RayBundle; target [R, 3]; generator: a torch.Generator
    on the rays' device, which draws every random number of the step
    (jitter, density noise, SR noise, point noise) in the JAX key's
    place; a shard of a batch split over ranks passes an
    ops.draws.RowShard of it (render.render_rays). mesh: a
    tensor-parallel mesh (model_parallel > 1) whose slices the decoders
    and the SR net hold (parallel.sharding.decoder_tp_shardings,
    plane_sr_tp_shardings): their forward and backward run the model
    group's collectives, and each sliced gradient is this rank's block;
    None otherwise.

    Returns (metrics, grads): metrics holds detached scalar tensors
    (loss, coarse_loss, fine_loss, psnr, fine_psnr, and with
    track_surface_aabb surf_w, surf_wx, surf_wx2); grads has the JAX
    layout {"planes", "dc", "df", "sr"} for the trained groups, each the
    structure of its input. Under a profiler, the `plane_sr` span gets
    the args `conv_data_grads` and `recomputed_blocks` after the
    backward: the SR convs' data gradients taken as forward convolutions
    (models.plane_sr.PlaneConv) and the EDSR's residual blocks
    recomputed in the backward (models.plane_sr.BlockRecompute), both
    counted in the backward only; on a consistency iteration the patch
    means and the loss are a `consistency_loss` span (args `patches`,
    the LR pixels of this batch, and `ds`).
    """
    data_grads, recomputed = PlaneConv.data_grads, BlockRecompute.blocks
    sr_span = None

    def build():
        nonlocal sr_span
        diff = {}
        planes = _inputs(plane_params, flags.train_planes)
        if flags.train_planes:
            diff["planes"] = planes
        dc, df = _decoder_inputs(decoder_coarse, decoder_fine, flags, diff)
        sr = None
        if sr_params is not None:
            sr = _inputs(sr_params, flags.train_sr)
            if flags.train_sr:
                diff["sr"] = sr
        planes_pos = materialize_pos_planes(planes["pos"], flags.plane_rank)
        plane_view = planes.get("view")
        # point_coords_noise draws only when it is on, so the other draws
        # stay in step
        noise_gen = generator if (model_cfg.point_coords_noise
                                  and flags.plane_resolution) else None
        coarse_planes = fine_planes = planes_pos
        if flags.sr_iter and sr is not None:
            sr_in = planes_pos.detach() if flags.detach_lr_planes \
                else planes_pos
            # the SR net's noise is of the planes, not of the batch's rows
            with span("plane_sr") as sr_span:
                fine_planes = apply_plane_sr(
                    sr, sr_cfg, sr_in, train=True,
                    generator=draws.base(generator), mesh=mesh)
            if flags.apply_sr_to_coarse:
                coarse_planes = fine_planes
        tiled = {}
        if flags.tile_cfg is not None:
            tiled = dict(tile_rays=flags.tile_cfg.tile_rays, tile_train=True)
        pf_coarse = make_triplane_point_fn(
            dc, model_cfg, coarse_planes, plane_view, box,
            member=flags.member, noise_generator=noise_gen,
            plane_resolution=flags.plane_resolution, mesh=mesh, **tiled)
        # the fine pass keeps the plain gather even with tile_cfg, as in JAX
        pf_fine = make_triplane_point_fn(
            df, model_cfg, fine_planes, plane_view, box,
            member=flags.member, noise_generator=noise_gen,
            plane_resolution=flags.plane_resolution, mesh=mesh)
        return diff, pf_coarse, pf_fine

    metrics, grads = _step(build, rays, target, generator, rcfg, flags)
    if sr_span is not None:
        sr_span.set(conv_data_grads=PlaneConv.data_grads - data_grads,
                    recomputed_blocks=BlockRecompute.blocks - recomputed)
    return metrics, grads


def _step_metrics(rendering_loss, coarse_loss, fine_loss) -> dict:
    """A step's detached loss terms and PSNRs."""
    with torch.no_grad():
        return {"loss": rendering_loss.detach(),
                "coarse_loss": coarse_loss.detach(),
                "fine_loss": fine_loss.detach(),
                "psnr": mse2psnr(rendering_loss),
                "fine_psnr": mse2psnr(fine_loss)}


_MEAN_METRICS = ("loss", "coarse_loss", "fine_loss")
_SUM_METRICS = ("surf_w", "surf_wx", "surf_wx2")


def reduce_step(mesh, metrics: dict, grads: dict):
    """One step's metrics and gradients over a mesh's data axis (the psum
    XLA inserts in JAX). Gradients and the loss terms are averaged over
    the data group: the shards are equal, so the mean of their losses'
    gradients is the gradient of the global batch's mean loss. Under
    model_parallel > 1 a sliced gradient is averaged with the same
    slices of the other data indices, and a replicated one (the heads',
    BatchNorm's, the planes') is already equal over the model group,
    whose backward collectives summed its parts. The PSNRs are
    recomputed from the averaged MSEs (a mean of PSNRs is not the PSNR of
    the mean); the surface moments are sums. One all_reduce (SUM)
    carries all of it. Returns (metrics, grads); both as given without a
    mesh."""
    if mesh is None:
        return metrics, grads
    mean = {"grads": grads, **{k: metrics[k] for k in _MEAN_METRICS}}
    sums = {k: metrics[k] for k in _SUM_METRICS if k in metrics}
    mean, sums = all_reduce_((mean, sums), mesh=mesh, axis="data")
    if mesh.data_size > 1:
        torch._foreach_div_(_leaves(mean), float(mesh.data_size))
    out = dict(metrics, **sums, **{k: mean[k] for k in _MEAN_METRICS})
    out["psnr"] = mse2psnr(out["loss"])
    out["fine_psnr"] = mse2psnr(out["fine_loss"])
    return out, mean["grads"]


def _surface_moments(out, rays: RayBundle, flags: StepFlags,
                     mip: bool = False) -> dict:
    """Weighted moments of the sample points whose compositing weight
    exceeds surf_weight_eps. Without mip, the last sample owns the 1e10
    background interval and is left out (on rays that hit nothing it
    takes the whole residual transmittance); with mip every interval is
    real and every sample counts."""
    o = out.fine if out.fine is not None else out.coarse
    w = o.weights.detach()
    z = o.z_vals.detach()
    pts = rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]
    wm = torch.where(w > flags.surf_weight_eps, w, torch.zeros_like(w))
    if not mip:
        last = torch.arange(w.shape[-1], device=w.device) < w.shape[-1] - 1
        wm = wm * last[None, :]
    wm = wm[..., None]
    return {"surf_w": torch.sum(wm) * torch.ones(3, device=w.device),
            "surf_wx": torch.sum(wm * pts, dim=(0, 1)),
            "surf_wx2": torch.sum(wm * pts * pts, dim=(0, 1))}


def baseline_point_fn(params, mlp_cfg, enc_cfg: tuple):
    """make_baseline_point_fn from an enc_cfg tuple (num_fn_xyz,
    num_fn_dir, include_xyz, include_dir, mip, ds_factor,
    ipe_multires)."""
    n_xyz, n_dir, inc_xyz, inc_dir, mip, ds_factor, multires = enc_cfg
    return make_baseline_point_fn(
        params, mlp_cfg, num_encoding_fn_xyz=n_xyz,
        num_encoding_fn_dir=n_dir, include_input_xyz=inc_xyz,
        include_input_dir=inc_dir, mip=mip, ds_factor=ds_factor,
        ipe_multires=multires)


def train_step_baseline(decoder_coarse, decoder_fine, rays: RayBundle,
                        target, generator: torch.Generator, *, mlp_cfg,
                        rcfg: RenderConfig, flags: StepFlags,
                        enc_cfg: tuple):
    """train_step for the baseline NeRF (PE or mip-IPE): its two MLPs
    (one with flags.share_coarse_fine) are its only groups.

    enc_cfg: (num_fn_xyz, num_fn_dir, include_xyz, include_dir, mip,
    ds_factor, ipe_multires). Returns (metrics, grads) as train_step
    does, grads {"dc", "df"?}."""

    def build():
        diff = {}
        dc, df = _decoder_inputs(decoder_coarse, decoder_fine, flags, diff)
        return (diff, baseline_point_fn(dc, mlp_cfg, enc_cfg),
                baseline_point_fn(df, mlp_cfg, enc_cfg))

    return _step(build, rays, target, generator, rcfg, flags)


# ---------------------------------------------------------------------------
# Host-side trainer: optimizers, virtual batches
# ---------------------------------------------------------------------------

class PlateauScheduler:
    """ReduceLROnPlateau for the planes learning rate: mode 'min' with
    relative threshold 1e-4 (improvement means loss < best * (1 -
    threshold)), cooldown 0, and the lr-delta eps=1e-8 gate that skips
    negligible reductions (torch's defaults at the reference's call)."""

    def __init__(self, lr: float, patience: int, factor: float,
                 min_lr: float = 0.0, threshold: float = 1e-4,
                 cooldown: int = 0, eps: float = 1e-8):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.threshold = threshold
        self.cooldown = cooldown
        self.eps = eps
        self.best = float("inf")
        self.bad_steps = 0
        self.cooldown_counter = 0

    def _is_better(self, loss: float) -> bool:
        return loss < self.best * (1.0 - self.threshold)

    def step(self, loss: float) -> float:
        """Feed a smoothed loss; returns the (possibly reduced) lr."""
        if self._is_better(loss):
            self.best = loss
            self.bad_steps = 0
        else:
            self.bad_steps += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_steps = 0
        if self.bad_steps > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                print(f"Reducing planes lr: {self.lr:.3e} -> "
                      f"{new_lr:.3e}")
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.bad_steps = 0
        return self.lr


class ModuleOptimizer:
    """One Adam (eps 1e-8) over a parameter pytree, with virtual batches:
    `accumulate` sums gradient trees, `step` applies the sum once and
    clears it. The pytree's tensors are updated in place.

    Under tensor parallelism `params` holds this rank's slices, and Adam
    (elementwise) steps them as the full Adam steps the whole leaves.

    `state` is the Adam state in optax.adam's layout,
    (ScaleByAdamState(count, mu, nu), EmptyState()) with mu and nu in the
    params' structure, as the JAX package's checkpoints pickle it;
    assigning one (numpy or tensor leaves, keys in any order) makes the
    next step continue from it."""

    def __init__(self, params, lr: float):
        self.params = params
        self.lr = lr
        self._leaves = _leaves(params)
        self.opt = torch.optim.Adam(self._leaves, lr=lr, eps=1e-8)
        self._accum = None

    @property
    def state(self):
        states = [self.opt.state.get(p) for p in self._leaves]
        count = int(states[0]["step"]) if states[0] else 0

        def moment(key):
            return _unflatten(self.params, [
                s[key] if s else torch.zeros_like(p)
                for p, s in zip(self._leaves, states)])

        return (ScaleByAdamState(np.asarray(count, np.int32),
                                 moment("exp_avg"), moment("exp_avg_sq")),
                EmptyState())

    @state.setter
    def state(self, value):
        adam = value[0]
        step = torch.tensor(float(np.asarray(adam.count).reshape(-1)[0]),
                            dtype=torch.float32)
        pairs = zip(self._leaves, _leaves_like(self.params, adam.mu),
                    _leaves_like(self.params, adam.nu))
        new = {}
        for p, mu, nu in pairs:
            mu, nu = (x.to(p.device, p.dtype).clone() if torch.is_tensor(x)
                      else torch.tensor(np.asarray(x), dtype=p.dtype,
                                        device=p.device)
                      for x in (mu, nu))
            if mu.shape != p.shape or nu.shape != p.shape:
                raise ValueError(f"Adam moments {tuple(mu.shape)} for a "
                                 f"parameter {tuple(p.shape)}")
            new[p] = {"step": step.clone(), "exp_avg": mu, "exp_avg_sq": nu}
        self.opt.state.clear()
        self.opt.state.update(new)

    def accumulate(self, grads):
        g = _leaves_like(self.params, grads)
        if self._accum is None:
            self._accum = [x.clone() for x in g]
        else:
            for a, x in zip(self._accum, g):
                a.add_(x)

    def zero(self):
        self._accum = None

    @torch.no_grad()
    def step(self):
        """Apply the accumulated gradients (summed, like torch's backward
        accumulation)."""
        if self._accum is None:
            return
        for p, g in zip(self._leaves, self._accum):
            p.grad = g
        self.opt.step()
        for p in self._leaves:
            p.grad = None
        self.zero()


# ---------------------------------------------------------------------------
# Training ray selection (numpy, host side)
# ---------------------------------------------------------------------------

def choose_random_pixels(rng: np.random.Generator, image, num_rays: int):
    """Random pixel pick for one training iteration: (rows [N], cols [N],
    target [N, C]); the rays come from render.build_sampled_rays."""
    h, w = image.shape[:2]
    n = min(h * w, num_rays)
    idx = rng.choice(h * w, size=n, replace=False)
    rows, cols = idx // w, idx % w
    return rows, cols, image[rows, cols]


def choose_tile_pixels(rng: np.random.Generator, image, num_rays: int,
                       tile=(8, 8)):
    """Tile-coherent pixel pick: random th x tw image tiles, tile-major
    (each th*tw consecutive rays cover one contiguous image tile, with an
    arbitrary, not grid-aligned, origin). Returns (rows [N], cols [N],
    target [N, C]) with N the largest multiple of th*tw <= min(num_rays,
    H*W)."""
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    h, w = image.shape[:2]
    n_tiles = max(1, min(num_rays, h * w) // (th * tw))
    oy = rng.integers(0, max(1, h - th + 1), size=n_tiles)
    ox = rng.integers(0, max(1, w - tw + 1), size=n_tiles)
    rows = (oy[:, None, None] + np.arange(th)[None, :, None])
    cols = (ox[:, None, None] + np.arange(tw)[None, None, :])
    rows = np.broadcast_to(rows, (n_tiles, th, tw)).reshape(-1)
    cols = np.broadcast_to(cols, (n_tiles, th, tw)).reshape(-1)
    rows = np.minimum(rows, h - 1)
    cols = np.minimum(cols, w - 1)
    return rows, cols, image[rows, cols]


def select_random_rays(rng: np.random.Generator, image, ray_origins,
                       ray_directions, num_rays: int):
    """Random ray subset from full ray maps [H, W, 3] (numpy or tensors):
    (ro [N, 3], rd [N, 3], target [N, C]). Prefer choose_random_pixels +
    render.build_sampled_rays, which never builds the full maps."""
    rows, cols, target = choose_random_pixels(rng, image, num_rays)
    return ray_origins[rows, cols], ray_directions[rows, cols], target


def choose_patch_pixels(rng: np.random.Generator, lr_image, num_rays: int,
                        ds_factor: int):
    """Patch-aligned pixel blocks for consistency iterations: draw LR
    pixels, return the HR pixel indices of their ds x ds patches
    (patch-major) -> (hr_rows [N*ds^2], hr_cols [N*ds^2], target [N, C])."""
    lh, lw = lr_image.shape[:2]
    n = min(lh * lw, num_rays // (ds_factor ** 2))
    idx = rng.choice(lh * lw, size=n, replace=False)
    rows, cols = idx // lw, idx % lw
    target = lr_image[rows, cols]
    hr_rows = (rows[:, None, None] * ds_factor
               + np.arange(ds_factor)[None, :, None])
    hr_cols = (cols[:, None, None] * ds_factor
               + np.arange(ds_factor)[None, None, :])
    hr_rows = np.broadcast_to(hr_rows, (n, ds_factor, ds_factor)).reshape(-1)
    hr_cols = np.broadcast_to(hr_cols, (n, ds_factor, ds_factor)).reshape(-1)
    return hr_rows, hr_cols, target


def select_patch_rays(rng: np.random.Generator, lr_image, ray_origins,
                      ray_directions, num_rays: int, ds_factor: int):
    """Patch-aligned ray blocks from full HR ray maps [H, W, 3] (numpy or
    tensors): (ro [N*ds^2, 3], rd [N*ds^2, 3], target [N, C]). Prefer
    choose_patch_pixels + render.build_sampled_rays."""
    hr_rows, hr_cols, target = choose_patch_pixels(rng, lr_image, num_rays,
                                                   ds_factor)
    return (ray_origins[hr_rows, hr_cols], ray_directions[hr_rows, hr_cols],
            target)
