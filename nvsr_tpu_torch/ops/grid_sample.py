"""Bilinear and bicubic feature-plane sampling (counterpart of
nvsr_tpu/ops/grid_sample.py).

Planes are [C, H, W]; grid [..., 2] holds (x, y) in [-1, 1], x indexing
W. Bilinear border padding clips the source coordinate before the
weights are taken; bicubic does not clip it and clamps the 4x4 tap
indices instead (torch grid_sample semantics). Only the semantics of the
JAX packed-tap tables are ported: the packed table is a TPU gather
workaround, and its `table_dtype` becomes `tap_dtype` here (taps rounded
to that dtype, weights kept in f32; bilinear only, as in JAX).
"""

from __future__ import annotations

from typing import Optional

import torch


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _corners(grid, height: int, width: int, align_corners: bool):
    """Border-clipped source coords -> (x, y, x0, x1, y0, y1) with the
    +1 taps clamped to the edge."""
    g = grid.reshape(-1, 2)
    x = torch.clamp(_unnormalize(g[:, 0], width, align_corners),
                    0.0, width - 1.0)
    y = torch.clamp(_unnormalize(g[:, 1], height, align_corners),
                    0.0, height - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, width - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, height - 1)
    x1 = torch.clamp(x0 + 1, max=width - 1)
    y1 = torch.clamp(y0 + 1, max=height - 1)
    return x, y, x0, x1, y0, y1


def cubic_weight(d, A: float = -0.75):
    """Torch's cubic convolution kernel at signed tap distance d, in the
    Horner form of the TPU kernels (tile_sampler.py::_cubic_weight) and of
    csrc/sampling.cuh: one rounded f32 operation per step."""
    ad = torch.abs(d)
    near = ((A + 2.0) * ad - (A + 3.0)) * ad * ad + 1.0
    far = ((A * ad - 5.0 * A) * ad + 8.0 * A) * ad - 4.0 * A
    return torch.where(ad <= 1.0, near,
                       torch.where(ad < 2.0, far, torch.zeros_like(ad)))


def cubic_taps(grid, height: int, width: int, align_corners: bool):
    """The kernels' bicubic window: [..., 2] grid -> (cols [N, 4], rows
    [N, 4], tx [N, 1], ty [N, 1]). The source coordinate is clipped to
    [-1, size] (exact for torch's border: beyond it every tap clamps and
    the weights sum to 1), x0 = floor, tx = x - x0; cols x0-1 .. x0+2 and
    rows y0-1 .. y0+2 are clamped to the plane."""
    g = grid.reshape(-1, 2)
    x = torch.clamp(_unnormalize(g[:, 0], width, align_corners),
                    -1.0, float(width))
    y = torch.clamp(_unnormalize(g[:, 1], height, align_corners),
                    -1.0, float(height))
    x0, y0 = torch.floor(x), torch.floor(y)
    off = torch.arange(-1, 3, device=g.device)
    cols = torch.clamp(x0.long()[:, None] + off, 0, width - 1)
    rows = torch.clamp(y0.long()[:, None] + off, 0, height - 1)
    return cols, rows, (x - x0)[:, None], (y - y0)[:, None]


def _bicubic(plane, grid, align_corners: bool):
    """Bicubic border-padded sample -> [N, C] f32: the source coordinate
    is not clipped; the 4x4 tap indices clamp to the plane."""
    C, H, W = plane.shape
    g = grid.reshape(-1, 2)
    x = _unnormalize(g[:, 0], W, align_corners)
    y = _unnormalize(g[:, 1], H, align_corners)
    x1, y1 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x1)[:, None], (y - y1)[:, None]
    wx = [cubic_weight((i - 1) - tx) for i in range(4)]
    wy = [cubic_weight((j - 1) - ty) for j in range(4)]
    x1i, y1i = x1.long(), y1.long()
    cells = plane.permute(1, 2, 0).reshape(H * W, C).float()
    out = 0.0
    for j in range(4):
        yi = torch.clamp(y1i + (j - 1), 0, H - 1)
        row = 0.0
        for i in range(4):
            xi = torch.clamp(x1i + (i - 1), 0, W - 1)
            row = row + wx[i] * cells[yi * W + xi]
        out = out + wy[j] * row
    return out


def grid_sample_2d(plane, grid, align_corners: bool = True,
                   tap_dtype: Optional[torch.dtype] = None,
                   mode: str = "bilinear"):
    """Border-padded sample of `plane` [C, H, W] at `grid` [..., 2] ->
    [..., C] f32 (torch grid_sample semantics); mode 'bilinear' or
    'bicubic'.

    tap_dtype: round the tap values to this dtype first (the JAX
    `gather_table_dtype`; bilinear only); interpolation weights stay
    f32."""
    C, H, W = plane.shape
    lead = grid.shape[:-1]
    if mode == "bicubic":
        if tap_dtype is not None:
            raise ValueError("tap_dtype applies to bilinear sampling only")
        return _bicubic(plane, grid, align_corners).reshape(*lead, C)
    if mode != "bilinear":
        raise ValueError(f"unknown interpolation mode: {mode}")
    x, y, x0, x1, y0, y1 = _corners(grid, H, W, align_corners)
    tx = (x - torch.floor(x))[:, None]
    ty = (y - torch.floor(y))[:, None]
    cells = plane.permute(1, 2, 0).reshape(H * W, C)
    if tap_dtype is not None:
        cells = cells.to(tap_dtype)
    cells = cells.float()
    v00 = cells[y0 * W + x0]
    v01 = cells[y0 * W + x1]
    v10 = cells[y1 * W + x0]
    v11 = cells[y1 * W + x1]
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    out = top * (1.0 - ty) + bot * ty
    return out.reshape(*lead, C)


def multi_plane_sample(planes, grids, align_corners: bool = True,
                       tap_dtype: Optional[torch.dtype] = None,
                       mode: str = "bilinear"):
    """[P, C, H, W] planes at [P, N, 2] grids -> [P, N, C]."""
    return torch.stack([grid_sample_2d(p, g, align_corners, tap_dtype,
                                       mode)
                        for p, g in zip(planes, grids)])


def dense_bilinear_sample(plane, grid, align_corners: bool = True):
    """Bilinear border sample with bf16 weights and bf16 taps, f32
    accumulation -> [..., C] (semantics of the JAX
    `dense_bilinear_sample`, the view-plane sampler of the tiled eval
    path: each tap weight is the f32 product of the two hat weights
    max(0, 1 - |j - coord|), rounded to bf16)."""
    C, H, W = plane.shape
    lead = grid.shape[:-1]
    x, y, x0, x1, y0, y1 = _corners(grid, H, W, align_corners)

    def hat(j, coord):
        return torch.clamp(1.0 - torch.abs(j.to(coord.dtype) - coord),
                           min=0.0)

    # the second tap's weight uses the unclamped index: at the last
    # row/column it is 1 - |size - coord| = 0
    wx = (hat(x0, x), hat(torch.floor(x).long() + 1, x))
    wy = (hat(y0, y), hat(torch.floor(y).long() + 1, y))
    cells = plane.permute(1, 2, 0).reshape(H * W, C)
    cells = cells.to(torch.bfloat16).float()
    out = None
    for yi, wyi in ((y0, wy[0]), (y1, wy[1])):
        for xi, wxi in ((x0, wx[0]), (x1, wx[1])):
            w = (wyi * wxi).to(torch.bfloat16).float()[:, None]
            term = w * cells[yi * W + xi]
            out = term if out is None else out + term
    return out.reshape(*lead, C)
