"""Bilinear and bicubic plane and image resizing (counterpart of
nvsr_tpu/ops/resize.py): the SR residual's upsample, and the antialiased
downsample of the image-inconsistency metric.

As in the JAX module, the resize is out = A_h @ x @ A_w^T with the
[out, in] sampling matrices built in numpy, which is torch
`interpolate(mode="bilinear" | "bicubic")` with either `align_corners`
(and `antialias`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _kernel_linear(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _kernel_cubic(x, A: float = -0.75):
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (A + 2.0) * x3 - (A + 3.0) * x2 + 1.0,
        np.where(x < 2.0, A * x3 - 5.0 * A * x2 + 8.0 * A * x - 4.0 * A, 0.0),
    )


# mode -> (kernel, support)
_KERNELS = {"bilinear": (_kernel_linear, 1.0),
            "bicubic": (_kernel_cubic, 2.0)}


@lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, mode: str,
                   align_corners: bool, antialias: bool = False
                   ) -> np.ndarray:
    """[out_size, in_size] sampling matrix. Without antialias,
    out-of-range taps clamp to the border pixel; with it (torch's AA
    resize), the kernel widens by the downscale factor, the window is cut
    to valid pixels and renormalised, and centres follow the half-pixel
    formula whatever align_corners says (it only sets the scale)."""
    kernel, support = _KERNELS[mode]
    if in_size == out_size and not antialias:
        return np.eye(in_size, dtype=np.float32)
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
        src = np.arange(out_size, dtype=np.float64) * scale
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    if antialias:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    filt_scale = max(scale, 1.0) if antialias else 1.0
    sup = support * filt_scale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        taps = np.arange(int(np.floor(src[i] - sup)) + 1,
                         int(np.floor(src[i] + sup)) + 1)
        w = kernel((taps - src[i]) / filt_scale)
        if antialias:
            valid = (taps >= 0) & (taps < in_size)
            taps, w = taps[valid], w[valid]
            if w.sum() > 0:
                w = w / w.sum()
            np.add.at(mat[i], taps, w)
        else:
            np.add.at(mat[i], np.clip(taps, 0, in_size - 1), w)
    return mat.astype(np.float32)


def resize_2d(x, out_h: int, out_w: int, mode: str = "bilinear",
              align_corners: bool = True, antialias: bool = False):
    """Resize the last two axes of x: [..., H, W] -> [..., out_h, out_w]
    with `mode` 'bilinear' or 'bicubic'."""
    if mode not in _KERNELS:
        raise ValueError(f"unknown resize mode: {mode}")
    h, w = x.shape[-2:]
    a_h = torch.as_tensor(_resize_matrix(h, out_h, mode, align_corners,
                                         antialias),
                          dtype=x.dtype, device=x.device)
    a_w = torch.as_tensor(_resize_matrix(w, out_w, mode, align_corners,
                                         antialias),
                          dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hw->...ow", a_h, x)
    return torch.einsum("pw,...ow->...op", a_w, y)


def scale_2d(x, scale_factor: float, mode: str = "bilinear",
             align_corners: bool = True, antialias: bool = False):
    """torch-interpolate-style scale_factor resize (out = floor(in * sf))."""
    h, w = x.shape[-2:]
    return resize_2d(x, int(np.floor(h * scale_factor)),
                     int(np.floor(w * scale_factor)), mode=mode,
                     align_corners=align_corners, antialias=antialias)


def upsample_plane(plane, scale_factor: int, align_corners: bool = True,
                   mode: str = "bilinear"):
    """Upsample the last two axes of `plane` by an integer factor with
    `mode` 'bilinear' or 'bicubic': [..., H, W] -> [..., sH, sW]."""
    return scale_2d(plane, float(scale_factor), mode=mode,
                    align_corners=align_corners)


def downsample_plane(plane, ds_factor: int, mode: str = "bilinear",
                     align_corners: bool = True, antialias: bool = False):
    """Downsample the last two axes by an integer factor
    (interpolate(scale_factor=1/ds))."""
    return scale_2d(plane, 1.0 / ds_factor, mode=mode,
                    align_corners=align_corners, antialias=antialias)


def avg_downsample_pixels(pixels, ds_factor: int):
    """Average ds x ds pixel patches: [N*ds*ds, 3] patch-major (as the
    patch-aligned ray selection lays them out) -> [N, 3]."""
    return torch.mean(pixels.reshape(-1, ds_factor, ds_factor, 3),
                      dim=(1, 2))


def image_inconsistency_loss(sr_image, ds_factor: int, gt_lr=None,
                             gt_hr=None, mode: str = "bilinear",
                             align_corners: bool = True):
    """L1 between the antialiased downsample of an SR render and the LR
    ground truth (given, or the antialiased downsample of gt_hr).
    Images are channel-first [..., H, W]."""
    assert (gt_lr is None) != (gt_hr is None)
    target = gt_lr if gt_hr is None else downsample_plane(
        gt_hr, ds_factor, mode=mode, align_corners=align_corners,
        antialias=True)
    pred = downsample_plane(sr_image, ds_factor, mode=mode,
                            align_corners=align_corners, antialias=True)
    return torch.mean(torch.abs(target - pred))
