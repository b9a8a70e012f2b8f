"""The render pipeline: rays -> coarse -> resample -> fine, for eval
frames and training batches (counterpart of nvsr_tpu/render.py).

Point functions follow the JAX protocol: point_fn(pts [R, S, 3] | None,
rays_block, z_vals) -> [R, S, 4]; a point fn with `consumes_rays` derives
its own points from (rays, z); `tile_rays` names the ray-tile size it
was built for. JAX's tiled point fns also report the share of points
their TPU kernel clamped; the port's kernels gather every tap, so its
point fns report nothing beside their output.
The JAX `lax.map` over fixed ray blocks becomes a Python loop over padded
blocks of `ray_block` rays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from nvsr_tpu_torch.models.nerf_mlp import apply_nerf_mlp
from nvsr_tpu_torch.ops import encoding as enc
from nvsr_tpu_torch.ops.geometry import get_rays_at, ndc_rays
from nvsr_tpu_torch.ops.occupancy import tighten_near_far
from nvsr_tpu_torch.ops.rendering import RenderOutputs, volume_render
from nvsr_tpu_torch.ops.sampling import (hierarchical_z_vals,
                                         stratified_z_vals)
from nvsr_tpu_torch.parallel.sharding import all_reduce_
from nvsr_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Per-mode render settings (the `nerf.validation` config section)."""
    num_coarse: int = 64
    num_fine: int = 64
    perturb: bool = True
    lindisp: bool = False
    white_background: bool = False
    radiance_field_noise_std: float = 0.0
    use_viewdirs: bool = True
    # mip-NeRF conical frustums (the baseline model's encode_position_fn
    # 'mip'): z holds interval edges and the point fns cast frustums
    mip: bool = False
    stop_coarse_grad: bool = False
    ray_block: int = 4096          # rays per render block
    # keep per-sample z in RenderOutputs.z_vals
    keep_z: bool = False

    @classmethod
    def from_cfg(cls, mode_cfg, nerf_cfg, **overrides) -> "RenderConfig":
        """From a `nerf.train` / `nerf.validation` section and the `nerf`
        section: a block holds chunksize // 16 rays (at least 1024), as
        in the JAX package."""
        kw = dict(
            num_coarse=mode_cfg.get("num_coarse", 64),
            num_fine=mode_cfg.get("num_fine", 64),
            perturb=bool(mode_cfg.get("perturb", False)),
            lindisp=mode_cfg.get("lindisp", False),
            white_background=mode_cfg.get("white_background", False),
            radiance_field_noise_std=mode_cfg.get(
                "radiance_field_noise_std", 0.0),
            use_viewdirs=nerf_cfg.get("use_viewdirs", True),
            mip=nerf_cfg.get("encode_position_fn", None) == "mip",
            ray_block=max(1024, mode_cfg.get("chunksize", 65536) // 16),
        )
        kw.update(overrides)
        return cls(**kw)


class RayBundle(NamedTuple):
    """Flat ray batch [R, ...]; near/far are [R, 1]."""
    origins: torch.Tensor
    directions: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    viewdirs: Optional[torch.Tensor] = None


class RenderResult(NamedTuple):
    coarse: RenderOutputs
    fine: Optional[RenderOutputs]


PointFn = Callable[[Optional[torch.Tensor], RayBundle, torch.Tensor],
                   torch.Tensor]


def make_ray_bundle(ray_origins, ray_directions, near: float, far: float,
                    *, use_viewdirs: bool, no_ndc: bool = True,
                    hwf=None) -> RayBundle:
    """Flat RayBundle from [..., 3] maps; viewdirs are normalized before
    the optional NDC reprojection."""
    ro = ray_origins.reshape(-1, 3)
    rd = ray_directions.reshape(-1, 3)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if not no_ndc:
        h, w, focal = hwf
        ro, rd = ndc_rays(h, w, focal, 1.0, ro, rd)
    return RayBundle(ro, rd, torch.full_like(rd[..., :1], near),
                     torch.full_like(rd[..., :1], far), viewdirs)


def build_sampled_rays(pose, rows, cols, height: int, width: int, focal,
                       downsampling_offset: float, near: float, far: float,
                       *, use_viewdirs: bool, no_ndc: bool = True
                       ) -> RayBundle:
    """RayBundle for the selected pixels (rows, cols) of one view with
    camera-to-world `pose` (a tensor on the device the rays go to): the
    training batch, without the view's full ray maps."""
    ro, rd = get_rays_at(rows, cols, height, width, focal, pose,
                         downsampling_offset)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if not no_ndc:
        ro, rd = ndc_rays(height, width, focal, 1.0, ro, rd)
    return RayBundle(ro, rd, torch.full_like(rd[..., :1], near),
                     torch.full_like(rd[..., :1], far), viewdirs)


def tighten_bundle(rays: RayBundle, aabb, tile_rays: Optional[int] = None
                   ) -> RayBundle:
    """Tighten per-ray [near, far] to the occupied AABB. With tile_rays
    (a tile-ordered bundle), every hit ray of a tile gets the UNION of the
    tile's hit intervals; tiles with no hit keep their per-ray degenerate
    intervals (exact background)."""
    aabb = torch.as_tensor(aabb, dtype=rays.origins.dtype,
                           device=rays.origins.device)
    near, far, hit = tighten_near_far(rays.origins, rays.directions,
                                      rays.near, rays.far, aabb)
    if tile_rays:
        nt = near.shape[0] // tile_rays
        hit_t = hit.reshape(nt, tile_rays)
        near_t, far_t = near.reshape(nt, tile_rays), far.reshape(nt, tile_rays)
        any_hit = torch.any(hit_t, dim=1, keepdim=True)
        big = torch.full_like(near_t, 3.4e38)
        n_t = torch.amin(torch.where(hit_t, near_t, big), dim=1, keepdim=True)
        f_t = torch.amax(torch.where(hit_t, far_t, -big), dim=1, keepdim=True)
        near = torch.where(any_hit, n_t, near_t).reshape(near.shape)
        far = torch.where(any_hit, f_t, far_t).reshape(far.shape)
    return rays._replace(near=near, far=far)


def render_rays(point_fn_coarse: PointFn, point_fn_fine: Optional[PointFn],
                rays: RayBundle, rcfg: RenderConfig,
                generator: Optional[torch.Generator] = None
                ) -> RenderResult:
    """Coarse -> hierarchical resample -> fine for one ray batch.
    `generator` draws the stratified jitter and the fine-pass uniforms
    when rcfg.perturb is set, and the density noise when
    rcfg.radiance_field_noise_std is; an eval render draws nothing. A
    shard of a batch split over ranks passes an ops.draws.RowShard: each
    draw is then the global batch's, of which the shard keeps its rows,
    so W ranks draw what one rank draws for the whole batch.
    rcfg.stop_coarse_grad detaches the coarse radiance field (and so the
    resampling weights) from the graph. With rcfg.mip, each pass samples
    one more edge than it has intervals and its point fn gets pts=None
    (it casts the frustums between the z edges itself)."""

    def run_pass(point_fn, z):
        if rcfg.mip or getattr(point_fn, "consumes_rays", False):
            return point_fn(None, rays, z)
        pts = (rays.origins[..., None, :]
               + rays.directions[..., None, :] * z[..., :, None])
        return point_fn(pts, rays, z)

    def composite(rf, z):
        return volume_render(
            rf, z, rays.directions,
            radiance_field_noise_std=rcfg.radiance_field_noise_std,
            generator=generator, white_background=rcfg.white_background,
            mip=rcfg.mip, return_z=rcfg.keep_z)

    with span("render.coarse"):
        z_vals = stratified_z_vals(rays.near, rays.far,
                                   rcfg.num_coarse + int(rcfg.mip),
                                   lindisp=rcfg.lindisp,
                                   perturb=rcfg.perturb, generator=generator)
        rf_c = run_pass(point_fn_coarse, z_vals)
        if rcfg.stop_coarse_grad:
            rf_c = rf_c.detach()
        out_c = composite(rf_c, z_vals)
    out_f = None
    if rcfg.num_fine > 0 and point_fn_fine is not None:
        with span("render.fine"):
            z_fine = hierarchical_z_vals(z_vals, out_c.weights,
                                         rcfg.num_fine + int(rcfg.mip),
                                         det=not rcfg.perturb,
                                         generator=generator, mip=rcfg.mip)
            out_f = composite(run_pass(point_fn_fine, z_fine), z_fine)
    return RenderResult(out_c, out_f)


def render_rays_chunked(point_fn_coarse, point_fn_fine, rays: RayBundle,
                        rcfg: RenderConfig,
                        generator: Optional[torch.Generator] = None,
                        mesh=None) -> RenderResult:
    """Render any number of rays in blocks of rcfg.ray_block; the last
    block is zero-padded to full size (its pad rays are cropped).

    mesh: a parallel.sharding.Mesh: each data index renders whole
    blocks, round-robin (block i on data index i % D), so every kernel
    launch keeps the full block; it writes them into zeros of the
    image's outputs, and one all_reduce(SUM) over the data group
    assembles them (exact: each entry is x + 0). The ranks of one model
    group take the same blocks in lockstep, so a tensor-parallel point
    fn's collectives meet. Only a deterministic render (no jitter, no
    density noise) may take it, as JAX's mesh-sharded eval requires."""
    n = rays.origins.shape[0]
    block = min(rcfg.ray_block, max(n, 1))
    n_blocks = -(-n // block)
    mine = list(range(n_blocks))
    todo = mine
    if mesh is not None:
        assert not rcfg.perturb and rcfg.radiance_field_noise_std == 0.0, \
            "a mesh-sharded render requires deterministic sampling"
        mine = list(range(mesh.data_index, n_blocks, mesh.data_size))
        # a rank without a block of its own renders block 0 only for the
        # outputs' shapes, so that it joins the collective
        todo = mine or [0]
    results = {}
    for i in todo:
        lo, hi = i * block, min((i + 1) * block, n)
        blk = RayBundle(*[None if f is None else f[lo:hi] for f in rays])
        if hi - lo < block:
            pad = block - (hi - lo)
            blk = RayBundle(*[None if f is None else torch.cat(
                [f, f.new_zeros((pad,) + f.shape[1:])]) for f in blk])
        results[i] = render_rays(point_fn_coarse, point_fn_fine, blk,
                                 rcfg, generator)

    if mesh is None:
        def unblock(outs):
            if outs[0] is None:
                return None
            return RenderOutputs(*[None if f[0] is None else torch.cat(f)[:n]
                                   for f in zip(*outs)])

        return RenderResult(unblock([r.coarse for r in results.values()]),
                            unblock([r.fine for r in results.values()]))
    return _assemble(results, mine, n_blocks, block, n, mesh)


def _assemble(results: dict, mine: list, n_blocks: int, block: int, n: int,
              mesh) -> RenderResult:
    """The image of a mesh-sharded render from each rank's blocks `mine`
    (rendered in `results`): each output field as zeros of the whole
    padded image with this rank's blocks written in, one all_reduce(SUM)
    over every field on the data group."""
    first = next(iter(results.values()))

    def zeros(out):
        if out is None:
            return None
        return RenderOutputs(*[None if f is None else f.new_zeros(
            (n_blocks * block,) + f.shape[1:]) for f in out])

    full = RenderResult(zeros(first.coarse), zeros(first.fine))
    for i in mine:
        res = results[i]
        for dst, src in ((full.coarse, res.coarse), (full.fine, res.fine)):
            if dst is None:
                continue
            for d, s in zip(dst, src):
                if d is not None:
                    d[i * block:(i + 1) * block] = s
    full = all_reduce_((full.coarse, full.fine), mesh=mesh, axis="data")

    def crop(out):
        return None if out is None else RenderOutputs(
            *[None if f is None else f[:n] for f in out])

    return RenderResult(crop(full[0]), crop(full[1]))


def make_triplane_point_fn(params, model_cfg, planes_pos, plane_view, box, *,
                           member: int = 0, rot_mats=None,
                           tile_rays: Optional[int] = None,
                           tile_train: bool = False,
                           noise_generator: Optional[torch.Generator] = None,
                           plane_resolution: Optional[int] = None,
                           sigma_only: bool = False, mesh=None) -> PointFn:
    """Triplane decoder point function.

    tile_rays: route the pass through a hand-written kernel (the
    counterpart of building the JAX point fn with a TileSamplerConfig of
    that tile size). For eval, on a config that fused_render.supports
    (bf16 decoder; bilinear or bicubic planes), the fused gather+decode
    kernel (ops/fused_render.py); on any other config (e.g. an f32
    decoder), the eval plane sampler's kernel (ops/plane_sample.py) with
    the decoder in plain torch, as JAX's tiled eval falls back. The plane
    table (one channel-last bf16 table serves both routes and both
    interpolations) and the packed decoder are built HERE, once per
    point fn. With tile_train, the trainable plane
    sampler (ops/plane_sample.py) with the decoder in plain torch, so
    the pass is differentiable; its table is rebuilt every call, inside
    the autograd boundary, since the planes change every step. Without
    tile_rays the pass runs the reference path (apply_triplane_rays).

    noise_generator, plane_resolution: train-time point_coords_noise
    (std = cfg.point_coords_noise * 2 / (1 + plane_resolution)), drawn
    from the generator per call; the eval fused path takes neither.

    sigma_only: CDF-only decode for an eval COARSE pass: the rgb branch
    and the view-plane sample are skipped; sigma is unchanged, so the
    fine image of a coarse+fine render is unchanged.

    mesh: a tensor-parallel mesh whose decoder slices `params` holds
    (models.triplane.decode_projections): the reference path and the
    trainable route take it; the eval kernels' routes refuse it
    (ValueError), as JAX routes such evals off its tiled path."""
    from nvsr_tpu_torch.models.triplane import (apply_triplane_rays,
                                                apply_triplane_rays_from_z,
                                                make_rot_mats, rot_mats_on)
    assert not (sigma_only and tile_train), \
        "sigma_only is an eval fast path; training needs coarse rgb"
    # the box and the plane bases on the planes' device once, not a host
    # copy (a stream wait) per call
    box_dev = torch.as_tensor(box, dtype=torch.float32,
                              device=planes_pos.device)
    rot_dev = rot_mats if rot_mats is not None else rot_mats_on(
        model_cfg.num_planes, planes_pos.device)
    if tile_rays is not None and tile_train:
        def point_fn(pts, rays, z_vals):
            return apply_triplane_rays_from_z(
                params, model_cfg, planes_pos, plane_view, box_dev,
                rays.origins, rays.directions, rays.viewdirs, z_vals,
                member=member, rot_mats=rot_dev, trainable=True,
                noise_generator=noise_generator,
                plane_resolution=plane_resolution, mesh=mesh)

        point_fn.consumes_rays = True
        point_fn.tile_rays = tile_rays
        return point_fn

    if tile_rays is not None:
        from nvsr_tpu_torch.models.triplane import refuse_split_decoder
        from nvsr_tpu_torch.ops import fused_render
        refuse_split_decoder(mesh)
        # the fused eval path cannot backprop or add coordinate noise: a
        # silently dropped noise generator would change semantics
        assert noise_generator is None and plane_resolution is None, (
            "tile_rays without tile_train is an eval-only fast path; it "
            "does not support point_coords_noise")
        table = fused_render.build_plane_table(planes_pos)
        packed = geom = None
        if fused_render.supports(model_cfg):
            packed = fused_render.pack_decoder(params, model_cfg, member)
            geom = fused_render.geometry_args(
                box, rot_mats if rot_mats is not None
                else make_rot_mats(model_cfg.num_planes))

        def point_fn(pts, rays, z_vals):
            return apply_triplane_rays_from_z(
                params, model_cfg, planes_pos, plane_view, box_dev,
                rays.origins, rays.directions, rays.viewdirs, z_vals,
                member=member, table=table, packed=packed, geom=geom,
                sigma_only=sigma_only)

        point_fn.consumes_rays = True
        point_fn.tile_rays = tile_rays
        return point_fn

    def point_fn(pts, rays, z_vals):
        return apply_triplane_rays(
            params, model_cfg, planes_pos, plane_view, box_dev, pts,
            rays.viewdirs, member=member, rot_mats=rot_dev,
            noise_generator=noise_generator,
            plane_resolution=plane_resolution, sigma_only=sigma_only,
            mesh=mesh)

    return point_fn


def _tile_hw(tile):
    return (tile, tile) if isinstance(tile, int) else tuple(tile)


def tile_ray_maps(arr, tile=8):
    """[H, W, ...] image map -> [H*W, ...] rays in tile-major order: each
    th*tw consecutive rays are one image tile."""
    th_, tw_ = _tile_hw(tile)
    h, w = arr.shape[:2]
    assert h % th_ == 0 and w % tw_ == 0, (h, w, tile)
    x = arr.reshape(h // th_, th_, w // tw_, tw_, *arr.shape[2:])
    return x.transpose(1, 2).reshape(h * w, *arr.shape[2:])


def untile_ray_maps(flat, height: int, width: int, tile=8):
    """Inverse of tile_ray_maps: [H*W, ...] tile-major -> [H, W, ...]."""
    th_, tw_ = _tile_hw(tile)
    x = flat.reshape(height // th_, width // tw_, th_, tw_, *flat.shape[1:])
    return x.transpose(1, 2).reshape(height, width, *flat.shape[1:])


def make_baseline_point_fn(params, mlp_cfg, *, num_encoding_fn_xyz=6,
                           num_encoding_fn_dir=4, include_input_xyz=True,
                           include_input_dir=True, mip=False,
                           ds_factor: int = 1,
                           ipe_multires: int = 10) -> PointFn:
    """PE / mip-IPE baseline point function (models/nerf_mlp.py).

    mip: IPE over the conical-frustum Gaussians between the z edges, with
    the reference's pixel radius ds_factor * 0.00135 * 2 / sqrt(12) (a
    Python float, so no per-call copy to the device); otherwise the sin/
    cos encoding of the points. With viewdirs, their sin/cos encoding is
    appended."""
    radii = ds_factor * 0.00135 * 2.0 / math.sqrt(12.0)

    def point_fn(pts, rays, z_vals):
        if mip:
            means, covs = enc.cast_rays(z_vals, rays.origins,
                                        rays.directions, radii)
            embedded = enc.integrated_positional_encoding(
                (means, covs), min_deg=0, max_deg=ipe_multires - 1)
            r, s = embedded.shape[:2]
            embedded = embedded.reshape(r * s, -1)
        else:
            r, s, _ = pts.shape
            embedded = enc.positional_encoding(pts.reshape(-1, 3),
                                               num_encoding_fn_xyz,
                                               include_input_xyz)
        if mlp_cfg.use_viewdirs:
            dirs = rays.viewdirs[:, None, :].expand(r, s, 3)
            emb_d = enc.positional_encoding(dirs.reshape(-1, 3),
                                            num_encoding_fn_dir,
                                            include_input_dir)
            embedded = torch.cat([embedded, emb_d], dim=-1)
        return apply_nerf_mlp(params, mlp_cfg, embedded).reshape(r, s, 4)

    return point_fn


def render_image(point_fn_coarse, point_fn_fine, ray_origins, ray_directions,
                 rcfg: RenderConfig, *, near: float, far: float,
                 no_ndc: bool = True, hwf=None, occ_aabb=None,
                 tile=None, tighten_tile_union: bool = True,
                 generator: Optional[torch.Generator] = None,
                 mesh=None) -> RenderResult:
    """Full-image render of [H, W, 3] ray maps -> maps with [H, W, ...]
    leading shape.

    occ_aabb: [2, 3] occupied box; per-ray [near, far] are tightened to
    it. tile: image-tile side (or (th, tw)): rays render in tile-major
    order (images not a tile multiple are edge-padded, then cropped) and,
    with occ_aabb and tighten_tile_union, each tile samples the union of
    its hit rays' intervals, exactly as the JAX tiled eval does. mesh:
    the ray blocks shared over its ranks (render_rays_chunked)."""
    h, w = ray_origins.shape[:2]
    hp, wp = h, w
    if tile:
        th_, tw_ = _tile_hw(tile)
        ph, pw = (-h) % th_, (-w) % tw_
        if ph or pw:
            rows = torch.clamp(torch.arange(h + ph), max=h - 1)
            cols = torch.clamp(torch.arange(w + pw), max=w - 1)
            ray_origins = ray_origins[rows][:, cols]
            ray_directions = ray_directions[rows][:, cols]
            hp, wp = h + ph, w + pw
        ray_origins = tile_ray_maps(ray_origins, tile)
        ray_directions = tile_ray_maps(ray_directions, tile)
    rays = make_ray_bundle(ray_origins, ray_directions, near, far,
                           use_viewdirs=rcfg.use_viewdirs, no_ndc=no_ndc,
                           hwf=hwf)
    if occ_aabb is not None:
        rays = tighten_bundle(rays, occ_aabb,
                              tile_rays=th_ * tw_
                              if tile and tighten_tile_union else None)
    result = render_rays_chunked(point_fn_coarse, point_fn_fine, rays, rcfg,
                                 generator, mesh=mesh)

    def reshape(out):
        if out is None:
            return None
        if tile:
            return RenderOutputs(*[
                None if a is None else untile_ray_maps(a, hp, wp, tile)[:h, :w]
                for a in out])
        return RenderOutputs(*[None if a is None else
                               a.reshape(h, w, *a.shape[1:]) for a in out])

    return RenderResult(reshape(result.coarse), reshape(result.fine))
