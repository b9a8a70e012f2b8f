"""Bilinear plane upsampling (counterpart of
nvsr_tpu/ops/resize.py::upsample_plane, the SR residual path).

As in the JAX module, the resize is out = A_h @ x @ A_w^T with the
[out, in] sampling matrices built in numpy (border taps clamp), which is
torch `interpolate(mode="bilinear")` with either `align_corners`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int,
                     align_corners: bool) -> np.ndarray:
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
        taps = np.arange(int(np.floor(src[i] - 1.0)) + 1,
                         int(np.floor(src[i] + 1.0)) + 1)
        w = np.maximum(0.0, 1.0 - np.abs(taps - src[i]))
        np.add.at(mat[i], np.clip(taps, 0, in_size - 1), w)
    return mat.astype(np.float32)


def upsample_plane(plane, scale_factor: int, align_corners: bool = True):
    """Bilinear upsample of the last two axes of `plane` by an integer
    factor: [..., H, W] -> [..., sH, sW]."""
    h, w = plane.shape[-2:]
    a_h = torch.as_tensor(_bilinear_matrix(h, h * scale_factor,
                                           align_corners),
                          dtype=plane.dtype, device=plane.device)
    a_w = torch.as_tensor(_bilinear_matrix(w, w * scale_factor,
                                           align_corners),
                          dtype=plane.dtype, device=plane.device)
    y = torch.einsum("oh,...hw->...ow", a_h, plane)
    return torch.einsum("pw,...ow->...op", a_w, y)
