"""Volume rendering (counterpart of nvsr_tpu/ops/rendering.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [R, 3]
    disp: torch.Tensor     # [R]
    acc: torch.Tensor      # [R]
    weights: torch.Tensor  # [R, S]
    depth: torch.Tensor    # [R]


def cumprod_exclusive(x):
    """Exclusive cumulative product along the last axis (leading 1)."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def volume_render(radiance_field, z_vals, ray_directions, *,
                  white_background: bool = False) -> RenderOutputs:
    """Composite [R, S, 4] (rgb logits, density logit) into per-ray maps.

    The last interval is 1e10, distances scale by |d|, weights use
    exp-transmittance with the +1e-10 floor. Rays with a zero z span
    (occupancy's miss rays) composite to exact background. (The eval
    render draws no density noise; the mip form is not ported yet.)
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(z_vals[..., :1], 1e10)],
                      dim=-1)
    dists = dists * torch.linalg.norm(ray_directions, dim=-1, keepdim=True)

    rgb = torch.sigmoid(radiance_field[..., :3])
    sigma = torch.relu(radiance_field[..., 3])

    alpha = 1.0 - torch.exp(-sigma * dists)
    span = z_vals[..., -1] - z_vals[..., 0]
    alpha = torch.where(span[..., None] > 0, alpha, torch.zeros_like(alpha))
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def img2mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse):
    """PSNR in dB; an exactly-zero mse is replaced by 1e-5."""
    mse = torch.as_tensor(mse)
    mse = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(mse)
