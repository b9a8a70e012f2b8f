"""Volume rendering and image metrics (counterpart of
nvsr_tpu/ops/rendering.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from nvsr_tpu_torch.ops import draws


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [R, 3]
    disp: torch.Tensor     # [R]
    acc: torch.Tensor      # [R]
    weights: torch.Tensor  # [R, S]
    depth: torch.Tensor    # [R]
    # per-sample depths the weights refer to (interval midpoints for
    # mip; return_z only)
    z_vals: Optional[torch.Tensor] = None  # [R, S]


def cumprod_exclusive(x):
    """Exclusive cumulative product along the last axis (leading 1)."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def volume_render(radiance_field, z_vals, ray_directions, *,
                  radiance_field_noise_std: float = 0.0,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  white_background: bool = False, mip: bool = False,
                  return_z: bool = False) -> RenderOutputs:
    """Composite [R, S, 4] (rgb logits, density logit) into per-ray maps.

    z_vals: [R, S] sample depths, or with mip [R, S+1] interval edges.
    Without mip the last interval is 1e10; with mip every interval is
    real and the depths are the interval midpoints. Distances scale by
    |d|, weights use exp-transmittance with the +1e-10 floor. Rays with
    a zero z span (occupancy's miss rays) composite to exact background.

    Train-time density noise: with radiance_field_noise_std > 0, the
    density logit gets std * noise, where `noise` [R, S] is the caller's
    standard-normal draw or is drawn from `generator`; with neither, no
    noise is added (an eval render).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if not mip:
        dists = torch.cat([dists, torch.full_like(z_vals[..., :1], 1e10)],
                          dim=-1)
    dists = dists * torch.linalg.norm(ray_directions, dim=-1, keepdim=True)

    rgb = torch.sigmoid(radiance_field[..., :3])
    sigma_logit = radiance_field[..., 3]
    if radiance_field_noise_std > 0.0 and (noise is not None
                                           or generator is not None):
        if noise is None:
            noise = draws.randn(sigma_logit.shape, generator,
                                dtype=sigma_logit.dtype,
                                device=sigma_logit.device)
        sigma_logit = sigma_logit + radiance_field_noise_std * noise
    sigma = torch.relu(sigma_logit)

    alpha = 1.0 - torch.exp(-sigma * dists)
    span = z_vals[..., -1] - z_vals[..., 0]
    alpha = torch.where(span[..., None] > 0, alpha, torch.zeros_like(alpha))
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_vals = z_vals
    if mip:
        depth_vals = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    depth_map = torch.sum(weights * depth_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map,
                         depth_vals if return_z else None)


def img2mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse):
    """PSNR in dB; an exactly-zero mse is replaced by 1e-5."""
    mse = torch.as_tensor(mse)
    mse = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(mse)


def _ssim_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def ssim(pred, target, data_range: float = 1.0, window_size: int = 11,
         sigma: float = 1.5):
    """Structural similarity of two [H, W, C] images: the single-scale
    SSIM of the JAX function (11x11 Gaussian window, sigma 1.5, K1 0.01,
    K2 0.03, 'valid' separable convolutions, mean over channels). An
    image smaller than the window has no valid output: NaN, as there."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    p = torch.as_tensor(pred, dtype=torch.float32)
    t = torch.as_tensor(target, dtype=torch.float32, device=p.device)
    if min(p.shape[0], p.shape[1]) < window_size:
        return torch.tensor(float("nan"), device=p.device)
    win = _ssim_window(window_size, sigma, p.device)

    def blur(img):
        x = img.permute(2, 0, 1)[:, None]                 # [C, 1, H, W]
        x = F.conv2d(x, win.reshape(1, 1, -1, 1))
        x = F.conv2d(x, win.reshape(1, 1, 1, -1))
        return x[:, 0]                                    # [C, H', W']

    mu_p, mu_t = blur(p), blur(t)
    var_p = blur(p * p) - mu_p * mu_p
    var_t = blur(t * t) - mu_t * mu_t
    cov = blur(p * t) - mu_p * mu_t
    num = (2.0 * mu_p * mu_t + c1) * (2.0 * cov + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)
