"""Triplane scene model (counterpart of nvsr_tpu/models/triplane.py):
parameter init, the reference (non-kernel) path, and the kernel paths
of `apply_triplane_rays_from_z` (the fused eval gather+decode; the eval
plane sampler with the plain decoder, for configs the fused kernel does
not take; and the trainable plane sampler) and of the points entry
`apply_triplane_rays(tile_cfg=...)` (the fused kernel's grids entry, or
the same eval sampler route).

Decoder parameters are the JAX pytree layout with torch tensors
(`bridge.decoder_from_jax`, `init_decoder_params`): {"members":
[{"density": [{"w", "b"}, ...], "fc_alpha", "rgb": [...], "fc_rgb"}]},
weights [in, out]. The kernel paths are held against the reference one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from nvsr_tpu_torch.ops.geometry import cart2az_el, normalize_coords
from nvsr_tpu_torch.ops.grid_sample import (dense_bilinear_sample,
                                            grid_sample_2d,
                                            multi_plane_sample)


@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    """Static model hyperparameters; mirrors the JAX TriplaneConfig
    field for field so pickled configs load into it."""
    use_viewdirs: bool = True
    dec_density_layers: int = 4
    dec_rgb_layers: int = 4
    dec_channels: int = 128
    skip_connect_every: Optional[int] = None
    num_plane_channels: int = 48
    num_viewdir_plane_channels: Optional[int] = None
    rgb_dec_input: str = "projections"          # projections|features|...
    proj_combination: str = "sum"               # sum|avg|concat
    plane_interp: str = "bilinear"              # bilinear|bicubic
    align_corners: bool = True
    viewdir_proj_combination: Optional[str] = None  # sum|avg|mult|concat|concat_pos
    num_planes: int = 3
    ensemble_size: int = 1
    point_coords_noise: float = 0.0
    # round the plane taps to this dtype ('bfloat16'); None = plane dtype
    gather_table_dtype: Optional[str] = None
    # decoder matmul operands in this dtype, f32 accumulation
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        assert self.rgb_dec_input in (
            "projections", "features", "projections_features")
        assert self.proj_combination in ("sum", "concat", "avg")
        vc = self.viewdir_proj_combination or self.proj_combination
        assert vc in ("sum", "concat", "avg", "mult", "concat_pos")
        if self.viewdir_channels != self.num_plane_channels:
            assert self.use_viewdirs is False or "concat" in vc

    @property
    def viewdir_channels(self) -> int:
        if self.num_viewdir_plane_channels is not None:
            return self.num_viewdir_plane_channels
        return self.num_plane_channels if self.use_viewdirs else 0

    @property
    def viewdir_combination(self) -> str:
        return self.viewdir_proj_combination or self.proj_combination

    @property
    def density_in_channels(self) -> int:
        mult = self.num_planes if self.proj_combination == "concat" else 1
        return self.num_plane_channels * mult

    @property
    def rgb_in_channels(self) -> int:
        src_planes = 1 if "features" in self.rgb_dec_input else self.num_planes
        pos_ch = self.num_plane_channels * (
            src_planes if self.proj_combination == "concat" else 1)
        if not self.use_viewdirs:
            return pos_ch
        comb = self.viewdir_combination
        if comb == "concat_pos":
            return self.num_plane_channels * src_planes + self.viewdir_channels
        if comb == "concat":
            return pos_ch + self.viewdir_channels
        return pos_ch

    def is_skip_layer(self, layer_num: int) -> bool:
        if self.skip_connect_every is None:
            return False
        return layer_num % self.skip_connect_every == 0 and layer_num > 0

    @classmethod
    def from_cfg(cls, model_cfg, nerf_cfg) -> "TriplaneConfig":
        """Build from the reference-style YAML sections."""
        g = model_cfg.get
        return cls(
            use_viewdirs=nerf_cfg.get("use_viewdirs", True),
            dec_density_layers=g("dec_density_layers", 4),
            dec_rgb_layers=g("dec_rgb_layers", 4),
            dec_channels=g("dec_channels", 128),
            skip_connect_every=g("skip_connect_every", None),
            num_plane_channels=g("num_plane_channels", 48),
            num_viewdir_plane_channels=g("num_viewdir_plane_channels", None),
            rgb_dec_input=g("rgb_dec_input", "projections"),
            proj_combination=g("proj_combination", "sum"),
            plane_interp=g("plane_interp", "bilinear"),
            align_corners=g("align_corners", True),
            viewdir_proj_combination=g("viewdir_proj_combination", None),
            num_planes=g("num_planes", 3),
            ensemble_size=g("ensemble_size", 1),
            point_coords_noise=nerf_cfg.get_path("train.point_coords_noise", 0)
            if hasattr(nerf_cfg, "get_path") else 0,
            gather_table_dtype=g("gather_table_dtype", None),
            compute_dtype=g("compute_dtype", None),
        )


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """'bfloat16' -> torch.bfloat16; None stays None."""
    return None if name is None else getattr(torch, name)


@functools.lru_cache(maxsize=16)
def make_rot_mats(num_planes: int, seed: int = 0) -> np.ndarray:
    """[P, 3, 3] fixed projection bases (copied from the JAX module):
    plane d projects coords onto columns 1:3 of rot_mats[d]."""
    if num_planes <= 3:
        base = np.eye(3, dtype=np.float32)
        mats = [base, base[:, [1, 0, 2]], base[:, [2, 0, 1]]]
        return np.stack(mats[:num_planes])

    n_trials = 10000
    rng = np.random.default_rng(seed)
    axes = rng.uniform(-1, 1, size=[n_trials, num_planes, 3])
    axes /= np.sqrt(np.sum(axes ** 2, 2, keepdims=True))
    axes = np.concatenate([axes, -axes], 1)
    d2 = np.sum((axes[..., None, :] - np.expand_dims(axes, 1)) ** 2, -1)
    score = np.sum(np.sort(d2, 1)[:, 1, ...], -1)
    chosen = axes[np.argmax(score)][:num_planes]
    mats = []
    for norm in chosen:
        rank = 0
        while rank != 3:
            mat = np.concatenate([norm[:, None], rng.uniform(size=[3, 2])], 1)
            rank = np.linalg.matrix_rank(mat)
        mats.append(np.linalg.qr(mat)[0])
    return np.stack(mats).astype(np.float32)


def _init_linear(generator, in_dim: int, out_dim: int, device):
    """torch.nn.Linear's init: w, b ~ U(-1/sqrt(in), 1/sqrt(in))."""
    bound = 1.0 / np.sqrt(in_dim)

    def u(shape):
        return ((torch.rand(shape, generator=generator,
                            device=generator.device) * 2 - 1) * bound
                ).to(device)

    return {"w": u((in_dim, out_dim)), "b": u((out_dim,))}


def init_decoder_params(generator: torch.Generator, cfg: TriplaneConfig,
                        device="cuda"):
    """Parameter pytree of one scene-shared decoder (`cfg.ensemble_size`
    members), drawn from `generator` with the JAX init's distributions
    (torch Linear bounds), on `device`."""
    def branch(in_ch, n):
        layers = [_init_linear(generator, in_ch, cfg.dec_channels, device)]
        for layer_num in range(n - 1):
            extra = in_ch if cfg.is_skip_layer(layer_num) else 0
            layers.append(_init_linear(generator, cfg.dec_channels + extra,
                                       cfg.dec_channels, device))
        return layers

    members = []
    for _ in range(cfg.ensemble_size):
        m = {"density": branch(cfg.density_in_channels,
                               cfg.dec_density_layers),
             "fc_alpha": _init_linear(generator, cfg.dec_channels, 1,
                                      device)}
        if "features" in cfg.rgb_dec_input:
            m["fc_feat"] = _init_linear(generator, cfg.dec_channels,
                                        cfg.num_plane_channels, device)
        m["rgb"] = branch(cfg.rgb_in_channels, cfg.dec_rgb_layers)
        m["fc_rgb"] = _init_linear(generator, cfg.dec_channels, 3, device)
        members.append(m)
    return {"members": members}


def point_coords_noise(xyz, cfg: TriplaneConfig, plane_resolution: int,
                       generator: torch.Generator):
    """Train-time noise on normalized coords [N, 3]: a standard-normal
    draw from `generator` times cfg.point_coords_noise * 2 / (1 +
    plane_resolution)."""
    assert plane_resolution is not None
    std = cfg.point_coords_noise * 2.0 / (1 + plane_resolution)
    return xyz + std * torch.randn(xyz.shape, generator=generator,
                                   dtype=xyz.dtype, device=xyz.device)


@functools.lru_cache(maxsize=16)
def rot_mats_on(num_planes: int, device: torch.device) -> torch.Tensor:
    """make_rot_mats(num_planes) as a tensor on `device`, copied there
    once: PyTorch synchronizes the stream after a copy from pageable host
    memory, so a copy per call makes the host wait for the device."""
    return torch.as_tensor(make_rot_mats(num_planes), device=device)


def project_to_planes(coords, rot_mats):
    """[N, 3] coords -> [P, N, 2] per-plane projections (columns 1:3);
    rot_mats [P, 3, 3], numpy or a tensor."""
    rot = torch.as_tensor(rot_mats if torch.is_tensor(rot_mats)
                          else np.asarray(rot_mats), dtype=coords.dtype,
                          device=coords.device)
    return torch.einsum("nc,pck->pnk", coords, rot[:, :, 1:])


def _linear(p, x, compute_dtype=None):
    """x @ w + b. With a compute dtype the operands are rounded to it and
    multiplied in f32: bf16 products are exact in f32, so this is bf16
    operands with f32 accumulation."""
    if compute_dtype is None:
        return x @ p["w"] + p["b"]
    cd = torch_dtype(compute_dtype)
    return (x.to(cd).float() @ p["w"].to(cd).float()) + p["b"]


def combine_pos_planes(projs, combination: str):
    """[P, N, C] -> combined features."""
    if combination == "sum":
        return torch.sum(projs, dim=0)
    if combination == "avg":
        return torch.mean(projs, dim=0)
    if combination == "concat":
        p, n, c = projs.shape
        return projs.permute(1, 0, 2).reshape(n, p * c)
    raise ValueError(combination)


def combine_all_planes(pos_projs, viewdir_proj, cfg: TriplaneConfig):
    """Merge positional and view-direction features."""
    comb = cfg.viewdir_combination
    if comb == "concat_pos":
        p, n, c = pos_projs.shape
        flat = pos_projs.permute(1, 0, 2).reshape(n, p * c)
        return torch.cat([flat, viewdir_proj], dim=-1)

    pos = combine_pos_planes(pos_projs, cfg.proj_combination)
    pos_shape = pos.shape
    view = viewdir_proj
    if comb != "concat" and pos.shape[1] > view.shape[1]:
        pos = pos.reshape(pos_shape[0], view.shape[1], -1)
        view = view[..., None]
    if comb == "sum":
        return (pos + view).reshape(pos_shape)
    if comb == "avg":
        return ((pos + view) / 2).reshape(pos_shape)
    if comb == "mult":
        return (pos * (1 + view)).reshape(pos_shape)
    if comb == "concat":
        return torch.cat([pos, view], dim=-1)
    raise ValueError(comb)


def _mlp_branch(layers, fc_out, x_in, cfg: TriplaneConfig):
    """relu after every hidden layer, skip-concat of the branch input
    when is_skip_layer(layer_num - 1), linear head."""
    x = x_in
    for layer_num, p in enumerate(layers):
        if cfg.is_skip_layer(layer_num - 1):
            x = torch.cat([x, x_in], dim=-1)
        x = torch.relu(_linear(p, x, cfg.compute_dtype))
    return x, _linear(fc_out, x, cfg.compute_dtype)


def sample_planes(planes_pos, grids, cfg: TriplaneConfig,
                  trainable: bool = False):
    """[P, C, H, W] planes at [P, N, 2] grids -> [P, N, C]: bilinear with
    taps rounded to cfg.gather_table_dtype, or bicubic in f32 (which
    ignores gather_table_dtype, as in JAX). trainable: through the
    trainable plane sampler's kernels instead (ops/plane_sample.py: bf16
    taps and x-weights, bf16 rows, whatever gather_table_dtype says);
    bilinear only, as the JAX trainable tiled route."""
    if cfg.plane_interp == "bicubic":
        if trainable:
            raise ValueError("the trainable plane sampler is bilinear-only")
        return multi_plane_sample(planes_pos, grids,
                                  align_corners=cfg.align_corners,
                                  mode="bicubic")
    if trainable:
        from nvsr_tpu_torch.ops.plane_sample import plane_sample
        return plane_sample(planes_pos, grids, cfg.align_corners)
    return multi_plane_sample(planes_pos, grids,
                              align_corners=cfg.align_corners,
                              tap_dtype=torch_dtype(cfg.gather_table_dtype))


def sample_viewdir_plane(plane_view, viewdirs, box, cfg: TriplaneConfig,
                         dense: bool = False):
    """Unit viewdirs [N, 3] -> view-plane features [N, Cv] (bilinear or
    bicubic, cfg.plane_interp).

    dense=True: the tiled eval path's bilinear sampler (bf16 weights and
    taps, f32 accumulation; JAX takes it for view planes up to 4096
    cells); bicubic always takes the f32 sampler."""
    azel = cart2az_el(viewdirs)
    box = torch.as_tensor(box, dtype=viewdirs.dtype, device=viewdirs.device)
    azel_n = normalize_coords(azel, box[:, 3:])
    if (dense and cfg.plane_interp == "bilinear"
            and plane_view.shape[-2] * plane_view.shape[-1] <= 4096):
        return dense_bilinear_sample(plane_view, azel_n,
                                     align_corners=cfg.align_corners)
    return grid_sample_2d(plane_view, azel_n, align_corners=cfg.align_corners,
                          mode=cfg.plane_interp)


def decode_projections(params, cfg: TriplaneConfig, pos_projs, view_proj,
                       *, member: int = 0, sigma_only: bool = False):
    """Decoder on pre-sampled plane features [P, N, C] (+ view [N, Cv])
    -> [N, 4] (rgb logits, sigma logit).

    sigma_only skips the view-conditioned rgb branch: sigma is the same,
    rgb lanes hold the fc_rgb bias."""
    m = params["members"][member]
    projected_xyz = combine_pos_planes(pos_projs, cfg.proj_combination)
    h, alpha = _mlp_branch(m["density"], m["fc_alpha"], projected_xyz, cfg)
    if sigma_only:
        rgb = m["fc_rgb"]["b"].to(alpha.dtype).expand(
            alpha.shape[:-1] + (3,))
        return torch.cat([rgb, alpha], dim=-1)
    if "features" in cfg.rgb_dec_input:
        if cfg.rgb_dec_input == "projections_features":
            raise NotImplementedError(
                "projections_features is deprecated in the reference")
        # 'features': the rgb branch reads the density features through
        # fc_feat (an f32 matmul, as in JAX), as a one-plane stack
        rgb_src = _linear(m["fc_feat"], h)[None]
    else:
        rgb_src = pos_projs
    if cfg.use_viewdirs:
        x_rgb_in = combine_all_planes(rgb_src, view_proj, cfg)
    else:
        x_rgb_in = combine_pos_planes(rgb_src, cfg.proj_combination)
    _, rgb = _mlp_branch(m["rgb"], m["fc_rgb"], x_rgb_in, cfg)
    return torch.cat([rgb, alpha], dim=-1)


def apply_triplane_points(params, cfg: TriplaneConfig, planes_pos, box,
                          xyz_raw, view_proj, *, member: int = 0,
                          noise_generator=None,
                          plane_resolution: Optional[int] = None,
                          rot_mats=None, sigma_only: bool = False,
                          trainable: bool = False):
    """Forward on raw points [N, 3] with pre-sampled view features
    [N, Cv] (or None) -> [N, 4]. With noise_generator, the normalized
    coords get cfg.point_coords_noise (train time); trainable: see
    sample_planes."""
    box = torch.as_tensor(box, dtype=xyz_raw.dtype, device=xyz_raw.device)
    xyz = normalize_coords(xyz_raw, box[:, :3])
    if noise_generator is not None and cfg.point_coords_noise:
        xyz = point_coords_noise(xyz, cfg, plane_resolution,
                                 noise_generator)
    rot = rot_mats if rot_mats is not None else make_rot_mats(cfg.num_planes)
    grids = project_to_planes(xyz, rot)
    pos_projs = sample_planes(planes_pos, grids, cfg, trainable)
    return decode_projections(params, cfg, pos_projs, view_proj,
                              member=member, sigma_only=sigma_only)


def apply_triplane(params, cfg: TriplaneConfig, planes_pos, plane_view, box,
                   x, *, member: int = 0, noise_generator=None,
                   plane_resolution: Optional[int] = None, rot_mats=None):
    """The reference-signature forward: [N, 3 (+3)] points (+ unit
    viewdirs) -> [N, 4], the view plane sampled per point."""
    view_proj = None
    if cfg.use_viewdirs:
        view_proj = sample_viewdir_plane(plane_view, x[..., 3:], box, cfg)
    return apply_triplane_points(
        params, cfg, planes_pos, box, x[..., :3], view_proj, member=member,
        noise_generator=noise_generator, plane_resolution=plane_resolution,
        rot_mats=rot_mats)


def make_density_fn(params, cfg: TriplaneConfig, planes_pos, box, *,
                    member: int = 0, rot_mats=None):
    """Density-only evaluator [N, 3] world xyz -> [N] sigma logits: the
    density branch alone (no view plane, no rgb head), through the plain
    plane gather; occupancy estimation uses it
    (ops/occupancy.estimate_occupied_box)."""
    m = params["members"][member]
    box = torch.as_tensor(box, dtype=torch.float32, device=planes_pos.device)
    rot = rot_mats if rot_mats is not None \
        else rot_mats_on(cfg.num_planes, planes_pos.device)

    def density_fn(xyz_raw):
        xyz = normalize_coords(xyz_raw, box[:, :3])
        grids = project_to_planes(xyz, rot)
        projected = combine_pos_planes(sample_planes(planes_pos, grids, cfg),
                                       cfg.proj_combination)
        _, alpha = _mlp_branch(m["density"], m["fc_alpha"], projected, cfg)
        return alpha[..., 0]

    return density_fn


# JAX's chunk cap (NVSR_CHUNK_CAP, triplane.py:590-599): the fused kernel
# takes a pass only when tile_rays * slab <= 512 after the slab is halved
# as far as 1, i.e. when tile_rays <= 512
CHUNK_CAP = 512


def apply_triplane_rays(params, cfg: TriplaneConfig, planes_pos, plane_view,
                        box, pts, viewdirs, *, member: int = 0,
                        noise_generator=None,
                        plane_resolution: Optional[int] = None,
                        rot_mats=None, sigma_only: bool = False,
                        trainable: bool = False, tile_cfg=None, table=None,
                        packed=None, form: str = "v2"):
    """Ray-structured forward: pts [R, S, 3] + per-ray viewdirs [R, 3] ->
    [R, S, 4]. The view plane is sampled once per ray and broadcast.

    tile_cfg: a TileSamplerConfig (ops/plane_sample.py): the points entry
    of the tiled eval forward (JAX triplane.py:456-498 into
    _apply_triplane_rays_tiled :553-761 with no origins). R must be a
    multiple of tile_cfg.tile_rays (ValueError, as JAX asserts). The
    route is JAX's:
      * fused: a bilinear config that fused_render.supports, 3 planes and
        tile_rays <= CHUNK_CAP: the points' plane coordinates through the
        grids entry of the gather+decode kernel
        (fused_render.tiled_render_chunked) with bf16 view rows per
        point; form "v1" takes the TPU v1 kernel's rounding (JAX:
        NVSR_MEGA_V1=1), "v2" its default;
      * any other config (bicubic, an f32 decoder, tile_rays over the
        cap): the eval plane sampler kernel (ops/plane_sample.py,
        bilinear or bicubic) and decode_projections in plain torch.
    JAX's depth slab, region dims and chunk order are the TPU kernel's
    chunking and have no counterpart: the kernels take the points in
    their own order. `table` and `packed` are the per-scene plane table
    and packed decoder (built here when not given). `rot_mats` defaults
    to the fixed bases held on the points' device (rot_mats_on); a numpy
    array is copied there on every call, which makes the host wait for
    the device. Eval only: no trainable, no noise_generator."""
    r, s, _ = pts.shape
    if tile_cfg is not None:
        if trainable:
            raise ValueError("the tiled points entry is eval-only; the "
                             "trainable route is apply_triplane_rays_from_z"
                             "(trainable=True)")
        assert noise_generator is None, \
            "point_coords_noise requires the trainable route"
        if r % tile_cfg.tile_rays:
            raise ValueError(f"{r} rays are not a multiple of tile_rays "
                             f"{tile_cfg.tile_rays}")
    vp_ray = None
    if cfg.use_viewdirs and not sigma_only:
        vp_ray = sample_viewdir_plane(plane_view, viewdirs, box, cfg)
    if tile_cfg is not None:
        return _tiled_points(params, cfg, planes_pos, box, pts, vp_ray,
                             tile_cfg, member=member, rot_mats=rot_mats,
                             table=table, packed=packed,
                             sigma_only=sigma_only, form=form)
    view_proj = None
    if vp_ray is not None:
        view_proj = vp_ray[:, None, :].expand(r, s, vp_ray.shape[-1]
                                              ).reshape(r * s, -1)
    out = apply_triplane_points(params, cfg, planes_pos, box,
                                pts.reshape(-1, 3), view_proj,
                                member=member,
                                noise_generator=noise_generator,
                                plane_resolution=plane_resolution,
                                rot_mats=rot_mats, sigma_only=sigma_only,
                                trainable=trainable)
    return out.reshape(r, s, 4)


def _plane_coords(xyz_raw, box, rot):
    """Raw points [N, 3] -> [P, N, 2] normalized plane coordinates."""
    box_t = torch.as_tensor(box, dtype=xyz_raw.dtype, device=xyz_raw.device)
    return project_to_planes(normalize_coords(xyz_raw, box_t[:, :3]),
                             rot).contiguous()


def _sampled_decode(params, cfg: TriplaneConfig, table, grids, vp_ray,
                    r: int, s: int, *, member: int, sigma_only: bool):
    """The non-fused tiled eval route (JAX triplane.py:707-760): the
    positional planes through the eval plane sampler's kernel at grids
    [P, R*S, 2], the per-ray view features vp_ray [R, Cv] (or None)
    broadcast to the points, decode_projections in plain torch at the
    config's own dtype -> [R, S, 4]."""
    from nvsr_tpu_torch.ops.plane_sample import sample_forward
    # all Cp table channels (the kernel takes multiples of 8), then the
    # config's
    pos_projs = sample_forward(table, grids, table.shape[-1],
                               cfg.align_corners,
                               cfg.plane_interp == "bicubic"
                               )[..., :cfg.num_plane_channels]
    view_proj = None
    if vp_ray is not None:
        view_proj = vp_ray[:, None, :].expand(
            r, s, vp_ray.shape[-1]).reshape(r * s, -1)
    out = decode_projections(params, cfg, pos_projs, view_proj,
                             member=member, sigma_only=sigma_only)
    return out.reshape(r, s, 4)


def _tiled_points(params, cfg: TriplaneConfig, planes_pos, box, pts, vp_ray,
                  tile_cfg, *, member: int, rot_mats, table, packed,
                  sigma_only: bool, form: str):
    """The routes of apply_triplane_rays(tile_cfg=...)."""
    from nvsr_tpu_torch.ops import fused_render
    r, s, _ = pts.shape
    rot = rot_mats if rot_mats is not None \
        else rot_mats_on(cfg.num_planes, pts.device)
    if table is None:
        table = fused_render.build_plane_table(planes_pos)
    grids = _plane_coords(pts.reshape(-1, 3), box, rot)
    fused = (cfg.plane_interp == "bilinear"
             and fused_render.supports(cfg)
             and (vp_ray is not None or sigma_only)
             and planes_pos.shape[0] == 3
             and tile_cfg.tile_rays <= CHUNK_CAP)
    if not fused:
        return _sampled_decode(params, cfg, table, grids, vp_ray, r, s,
                               member=member, sigma_only=sigma_only)
    if packed is None:
        packed = fused_render.pack_decoder(params, cfg, member)
    view = None
    if vp_ray is not None:
        view = fused_render.view_rows(vp_ray, packed.cvp)[:, None, :].expand(
            r, s, packed.cvp).reshape(r * s, packed.cvp)
    out, _ = fused_render.tiled_render_chunked(
        table, packed, grids, view, align_corners=cfg.align_corners,
        avg=cfg.proj_combination == "avg", sigma_only=sigma_only, form=form)
    return out.reshape(r, s, 4)


def apply_triplane_rays_from_z(params, cfg: TriplaneConfig, planes_pos,
                               plane_view, box, origins, directions,
                               viewdirs, z_vals, *, member: int = 0,
                               rot_mats=None, table=None, packed=None,
                               geom=None, sigma_only: bool = False,
                               trainable: bool = False,
                               noise_generator=None,
                               plane_resolution: Optional[int] = None):
    """Kernel forward straight from rays: origins/directions [R, 3],
    z_vals [R, S] -> ([R, S, 4], {"overflow_frac": 0.0}).

    Eval (default), on a config fused_render.supports: the fused
    gather+decode kernel (ops/fused_render.py), bilinear or bicubic.
    On any other config (an f32 decoder, the common case): the points
    o + d*z projected onto the planes, the positional planes through the
    eval plane sampler's kernel (ops/plane_sample.py, bilinear or
    bicubic), the view plane through the plain sampler, and
    decode_projections in plain torch at the config's own dtype (JAX
    triplane.py:707-760). `table`, `packed` and `geom` are the per-scene
    plane table (both routes), packed decoder and kernel geometry; built
    here when not given (make_triplane_point_fn builds them once per
    point fn).

    trainable: the training route, apply_triplane_rays on the points
    o + d*z with the three positional-plane gathers through the trainable
    plane sampler (ops/plane_sample.py: kernel forward and backward), the
    view plane through the reference sampler and the decoder in plain
    torch, all under autograd; noise_generator adds
    cfg.point_coords_noise to the normalized coords."""
    if trainable:
        assert not sigma_only, "training needs coarse rgb"
        pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
        return apply_triplane_rays(
            params, cfg, planes_pos, plane_view, box, pts, viewdirs,
            member=member, noise_generator=noise_generator,
            plane_resolution=plane_resolution, rot_mats=rot_mats,
            trainable=True), {"overflow_frac": 0.0}
    assert noise_generator is None, \
        "point_coords_noise requires the trainable route"
    from nvsr_tpu_torch.ops import fused_render
    cubic = cfg.plane_interp == "bicubic"
    rot = rot_mats if rot_mats is not None else make_rot_mats(cfg.num_planes)
    if table is None:
        table = fused_render.build_plane_table(planes_pos)
    vp_ray = None
    if cfg.use_viewdirs and not sigma_only:
        vp_ray = sample_viewdir_plane(plane_view, viewdirs, box, cfg,
                                      dense=True)
    if not fused_render.supports(cfg):
        r, s = z_vals.shape
        pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
        if rot_mats is None:
            rot = rot_mats_on(cfg.num_planes, pts.device)
        return _sampled_decode(
            params, cfg, table, _plane_coords(pts.reshape(-1, 3), box, rot),
            vp_ray, r, s, member=member,
            sigma_only=sigma_only), {"overflow_frac": 0.0}
    if packed is None:
        packed = fused_render.pack_decoder(params, cfg, member)
    if geom is None:
        geom = fused_render.geometry_args(box, rot)
    view = None if sigma_only else fused_render.view_rows(vp_ray,
                                                          packed.cvp)
    return fused_render.fused_render_rays(
        table, packed, origins, directions, z_vals, view, geom,
        align_corners=cfg.align_corners,
        avg=cfg.proj_combination == "avg", sigma_only=sigma_only,
        cubic=cubic)

