"""Ray and coordinate geometry (counterpart of nvsr_tpu/ops/geometry.py).

Same numerics as the JAX module: unnormalized per-pixel ray directions
with the sub-pixel downsampling offset, NDC reprojection, cartesian to
(azimuth, elevation), and per-scene box normalization.
"""

from __future__ import annotations

import torch


def _focal_x(focal):
    """The x term divides by focal[1] for a [fy-like, fx-like] pair
    (nvsr_tpu/ops/geometry.py::_focal_x)."""
    if isinstance(focal, (tuple, list)):
        return focal[1]
    return focal


def _focal_y(focal):
    if isinstance(focal, (tuple, list)):
        return focal[0]
    return focal


def get_ray_bundle(height: int, width: int, focal, c2w: torch.Tensor,
                   downsampling_offset: float = 0.0):
    """Per-pixel ray origins and directions, each [H, W, 3] (directions
    are not normalized). c2w: [4, 4] or [3, 4] camera-to-world;
    downsampling_offset: the sub-pixel offset (d-1)/(2d) of a
    d-times-downsampled image."""
    xs = torch.arange(width, dtype=c2w.dtype,
                      device=c2w.device) + downsampling_offset
    ys = torch.arange(height, dtype=c2w.dtype,
                      device=c2w.device) + downsampling_offset
    y_map, x_map = torch.meshgrid(ys, xs, indexing="ij")
    directions = torch.stack([
        (x_map - width * 0.5) / _focal_x(focal),
        -(y_map - height * 0.5) / _focal_y(focal),
        -torch.ones_like(x_map),
    ], dim=-1)
    ray_directions = torch.sum(directions[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = c2w[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def get_rays_at(rows, cols, height, width, focal, c2w: torch.Tensor,
                downsampling_offset: float = 0.0):
    """Ray origins and directions [N, 3] for the selected pixels only:
    the same rays as get_ray_bundle(...)[rows, cols] without the full
    H x W maps. rows/cols: integer index arrays or tensors [N]."""
    rows = torch.as_tensor(rows, device=c2w.device)
    cols = torch.as_tensor(cols, device=c2w.device)
    x = cols.to(c2w.dtype) + downsampling_offset
    y = rows.to(c2w.dtype) + downsampling_offset
    directions = torch.stack([
        (x - width * 0.5) / _focal_x(focal),
        -(y - height * 0.5) / _focal_y(focal),
        -torch.ones_like(x),
    ], dim=-1)
    ray_directions = torch.sum(directions[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = c2w[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def ndc_rays(height, width, focal, near, rays_o, rays_d):
    """Shift ray origins to the near plane and project to NDC space."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (width / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (height / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = (-1.0 / (width / (2.0 * focal))
          * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]))
    d1 = (-1.0 / (height / (2.0 * focal))
          * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]))
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def cart2az_el(dirs):
    """Unit direction -> [..., 2] (azimuth, elevation)."""
    el = torch.atan2(dirs[..., 2], torch.sqrt(torch.sum(dirs[..., :2] ** 2,
                                                        -1)))
    az = torch.atan2(dirs[..., 1], dirs[..., 0])
    return torch.stack([az, el], -1)


def normalize_coords(coords, box):
    """Map [..., D] coords into [-1, 1] with a [2, D] (min, max) box."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    return 2.0 * (coords - box[:1]) / (box[1:] - box[:1]) - 1.0
