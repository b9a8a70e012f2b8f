"""Bilinear and bicubic plane upsampling (counterpart of
nvsr_tpu/ops/resize.py::upsample_plane, the SR residual path).

As in the JAX module, the resize is out = A_h @ x @ A_w^T with the
[out, in] sampling matrices built in numpy (no antialias: out-of-range
taps clamp to the border pixel), which is torch
`interpolate(mode="bilinear" | "bicubic")` with either `align_corners`.
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
                   align_corners: bool) -> np.ndarray:
    """[out_size, in_size] sampling matrix."""
    kernel, support = _KERNELS[mode]
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
        src = np.arange(out_size, dtype=np.float64) * scale
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        taps = np.arange(int(np.floor(src[i] - support)) + 1,
                         int(np.floor(src[i] + support)) + 1)
        np.add.at(mat[i], np.clip(taps, 0, in_size - 1),
                  kernel(taps - src[i]))
    return mat.astype(np.float32)


def upsample_plane(plane, scale_factor: int, align_corners: bool = True,
                   mode: str = "bilinear"):
    """Upsample the last two axes of `plane` by an integer factor with
    `mode` 'bilinear' or 'bicubic': [..., H, W] -> [..., sH, sW]."""
    if mode not in _KERNELS:
        raise ValueError(f"unknown resize mode: {mode}")
    h, w = plane.shape[-2:]
    a_h = torch.as_tensor(_resize_matrix(h, h * scale_factor, mode,
                                         align_corners),
                          dtype=plane.dtype, device=plane.device)
    a_w = torch.as_tensor(_resize_matrix(w, w * scale_factor, mode,
                                         align_corners),
                          dtype=plane.dtype, device=plane.device)
    y = torch.einsum("oh,...hw->...ow", a_h, plane)
    return torch.einsum("pw,...ow->...op", a_w, y)
