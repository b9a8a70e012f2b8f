"""Ray and coordinate geometry (counterpart of nvsr_tpu/ops/geometry.py).

Same numerics as the JAX module: unnormalized per-pixel ray directions
with the sub-pixel downsampling offset, NDC reprojection, cartesian to
(azimuth, elevation), and per-scene box normalization; and the
host-side per-scene box (`calc_scene_box`, numpy, once per scene when
the dataset is built).
"""

from __future__ import annotations

import numpy as np
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


def pixel_grid(height: int, width: int, downsampling_offset: float = 0.0,
               padding_size: int = 0, dtype=torch.float32, device=None):
    """Pixel-center coordinate maps (x_map, y_map), each [H+2p, W+2p],
    x varying along the last axis."""
    xs = torch.arange(width + 2 * padding_size, dtype=dtype,
                      device=device) + downsampling_offset
    ys = torch.arange(height + 2 * padding_size, dtype=dtype,
                      device=device) + downsampling_offset
    if padding_size > 0:
        xs = xs - padding_size
        ys = ys - padding_size
    y_map, x_map = torch.meshgrid(ys, xs, indexing="ij")
    return x_map, y_map


def get_ray_bundle(height: int, width: int, focal, c2w: torch.Tensor,
                   downsampling_offset: float = 0.0):
    """Per-pixel ray origins and directions, each [H, W, 3] (directions
    are not normalized). c2w: [4, 4] or [3, 4] camera-to-world;
    downsampling_offset: the sub-pixel offset (d-1)/(2d) of a
    d-times-downsampled image."""
    x_map, y_map = pixel_grid(height, width, downsampling_offset,
                              dtype=c2w.dtype, device=c2w.device)
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


# ---------------------------------------------------------------------------
# Host-side scene-box computation (numpy; runs once per scene at build time).
# ---------------------------------------------------------------------------

def _cart2az_el_np(d):
    el = np.arctan2(d[2], np.sqrt(d[0] ** 2 + d[1] ** 2))
    az = np.arctan2(d[1], d[0])
    return np.array([az, el])


def calc_scene_box(scene_geometry: dict, including_dirs: bool, no_ndc: bool,
                   adjust_az_range=False, adjust_elevation_range=False,
                   exhaustive_check: int = 10) -> np.ndarray:
    """Axis-aligned bound of all frustum sample points at near/far.

    scene_geometry: {'camera_poses': [F,3,4] (or [F,4,4]), 'near', 'far',
    'H': [F], 'W': [F], 'f': [F] (scalar or [fx,fy] per frame)};
    including_dirs also bounds (az, el): [-pi, pi] and [-pi/2, pi/2]
    unless an adjustment is requested. Returns [2, 3(+2)] (min, max)
    rows, from 12 pixels per image edge (exhaustive_check=10), as the
    JAX function."""
    def list2pix(end_pixels):
        if exhaustive_check:
            if exhaustive_check == -1:
                return list(range(end_pixels[0], end_pixels[1]))
            return np.unique(
                np.round(np.linspace(end_pixels[0], end_pixels[1],
                                     2 + exhaustive_check)).astype(int))
        return end_pixels

    poses = np.asarray(scene_geometry["camera_poses"])
    dims = 3 + 2 * int(including_dirs)
    box = [[np.finfo(np.float64).max, np.finfo(np.float64).min]
           for _ in range(dims)]
    for f_num in range(len(poses)):
        pose = poses[f_num]
        origin_ = pose[:3, -1]
        H = scene_geometry["H"][f_num]
        W = scene_geometry["W"][f_num]
        focal = scene_geometry["f"][f_num]
        for col in list2pix([0, W - 1]):
            for row in list2pix([0, H - 1]):
                coord = np.array([
                    (col - W / 2) / _focal_x(focal),
                    -(row - H / 2) / _focal_y(focal),
                    -1.0,
                ])
                direction = np.sum(coord * pose[:3, :3], axis=-1)
                normed_dir = direction / np.linalg.norm(direction)
                if no_ndc:
                    origin = origin_.copy()
                    dir_ = direction
                else:
                    assert not isinstance(focal, (list, tuple)), \
                        "anisotropic focal not supported with NDC"
                    # f32, as the JAX function's jnp arrays
                    o, d = ndc_rays(
                        H, W, focal, 1.0,
                        torch.as_tensor(origin_, dtype=torch.float32),
                        torch.as_tensor(direction, dtype=torch.float32))
                    origin, dir_ = o.numpy(), d.numpy()
                for dist in (scene_geometry["near"], scene_geometry["far"]):
                    point = origin + dist * dir_
                    for d3 in range(3):
                        box[d3][0] = min(box[d3][0], point[d3])
                        box[d3][1] = max(box[d3][1], point[d3])
                if including_dirs and (adjust_az_range
                                       or adjust_elevation_range):
                    az_el = _cart2az_el_np(normed_dir)
                    for d2 in range(int(not adjust_az_range), 2):
                        box[3 + d2][0] = min(box[3 + d2][0], az_el[d2])
                        box[3 + d2][1] = max(box[3 + d2][1], az_el[d2])
    if including_dirs:
        if not adjust_az_range:
            box[3] = [-np.pi, np.pi]
        if not adjust_elevation_range:
            box[4] = [-np.pi / 2, np.pi / 2]
        else:
            center = np.mean(box[4])
            box[4] = list(adjust_elevation_range
                          * (np.array(box[4]) - center) + center)
    return np.array(box, dtype=np.float32).transpose(1, 0)
