"""Host side of the trainable plane sampler's kernels, and their plain
versions.

Counterpart of nvsr_tpu/ops/pallas/tile_sampler.py
`tiled_plane_sample_trainable` (:1775-1859), whose forward is
`tiled_plane_sample_prechunked` (:619-665) over the Pallas `_tile_gather`
kernel with the chunk descriptors of `_grid_chunk_descriptors`
(:543-574), and whose backward is the XLA scatter `_trainable_bwd`
(:1801-1856). The CUDA kernels are csrc/plane_sample.cu (built and bound
by kernels.py); `plane_sample_reference` and
`plane_sample_backward_reference` are their plain PyTorch versions with
the same rounding, used on the CPU and as the kernels' oracles.

What they compute, per plane p and point n (grids [P, N, 2] normalized
(x, y), bf16 table T = bf16(planes) channel-last [P, H, W, Cp]):
  * border-clipped source coords xp, yp, corners x0, x1 = min(x0+1,
    W-1), y0, y1; bf16 x-weights w0 = bf16(1 - tx), w1 = bf16(tx);
  * rows top = bf16(w0*T[y0,x0] + w1*T[y0,x1]), bot likewise at y1 (the
    TPU kernel's output rows are bf16);
  * out = top*(1 - ty) + bot*ty in f32 -> [P, N, C];
  * backward: dtop = bf16(dout*(1-ty)), dbot = bf16(dout*ty); the four
    products w0*dtop, w1*dtop, w0*dbot, w1*dbot are added in f32 at the
    four taps -> dplanes [P, C, H, W]. The grids get no gradient.

Against JAX: the TPU kernel takes its x-weights from the region-local
flat coordinate fidx = yl*tw + xl, whose f32 fraction loses bits, so its
bf16 weights may differ from these by one bf16 ULP now and then.

The TPU sampler needs tile-coherent rays (chunks share a DMA'd plane
region and clamp when they do not fit); here each tap is a plain load,
so the points are taken in ray-major order as they come, and
overflow_frac is always 0.0.
"""

from __future__ import annotations

import dataclasses

import torch

from nvsr_tpu_torch.ops.fused_render import build_plane_table
from nvsr_tpu_torch.ops.grid_sample import _corners


@dataclasses.dataclass(frozen=True)
class TileSamplerConfig:
    """Port-side mirror of the JAX TileSamplerConfig with only
    `tile_rays`, the rays of one image tile in a tile-major batch
    (8x8 = 64 by default, as there). Its th/tw/slab/group fields are the
    TPU kernel's region geometry and have no counterpart here."""
    tile_rays: int = 64


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _taps(grids, height: int, width: int, align_corners: bool):
    """[P, N, 2] grids -> (four [P*N] flat cell indices into the
    [P*H*W] grid, w0, w1, ty as [P*N, 1] f32)."""
    p, n, _ = grids.shape
    x, y, x0, x1, y0, y1 = _corners(grids, height, width, align_corners)
    base = torch.arange(p, device=grids.device).repeat_interleave(n) \
        * (height * width)
    tx = (x - torch.floor(x))[:, None]
    ty = (y - torch.floor(y))[:, None]
    cells = (base + y0 * width + x0, base + y0 * width + x1,
             base + y1 * width + x0, base + y1 * width + x1)
    return cells, _bf16(1.0 - tx), _bf16(tx), ty


def plane_sample_reference(table, grids, channels: int,
                           align_corners: bool) -> torch.Tensor:
    """Plain version of the forward kernel -> [P, N, channels] f32."""
    p, h, w, cp = table.shape
    n = grids.shape[1]
    (c00, c01, c10, c11), w0, w1, ty = _taps(grids, h, w, align_corners)
    t = table.reshape(p * h * w, cp)[:, :channels]
    top = _bf16(w0 * t[c00].float() + w1 * t[c01].float())
    bot = _bf16(w0 * t[c10].float() + w1 * t[c11].float())
    return (top * (1.0 - ty) + bot * ty).reshape(p, n, channels)


def plane_sample_backward_reference(dout, grids, height: int, width: int,
                                    align_corners: bool) -> torch.Tensor:
    """Plain version of the backward kernel: dout [P, N, C] f32 ->
    dplanes [P, C, H, W] f32 (index_add_ in place of the atomics)."""
    p, n, c = dout.shape
    (c00, c01, c10, c11), w0, w1, ty = _taps(grids, height, width,
                                             align_corners)
    d = dout.reshape(p * n, c).float()
    dtop = _bf16(d * (1.0 - ty))
    dbot = _bf16(d * ty)
    acc = torch.zeros((p * height * width, c), dtype=torch.float32,
                      device=dout.device)
    for cells, contrib in ((c00, w0 * dtop), (c01, w1 * dtop),
                           (c10, w0 * dbot), (c11, w1 * dbot)):
        acc.index_add_(0, cells, contrib)
    return acc.reshape(p, height, width, c).permute(0, 3, 1, 2).contiguous()


def sample_forward(table, grids, channels: int, align_corners: bool):
    """A CPU table runs the plain version; any other table goes to the
    kernel, which launches on a CUDA table and raises otherwise."""
    if table.device.type == "cpu":
        return plane_sample_reference(table, grids, channels, align_corners)
    from nvsr_tpu_torch import kernels
    return kernels.plane_sample_forward(table, grids.contiguous(), channels,
                                        align_corners=align_corners)


def sample_backward(dout, grids, height: int, width: int,
                    align_corners: bool):
    """Dispatch of the backward, as sample_forward."""
    if dout.device.type == "cpu":
        return plane_sample_backward_reference(dout, grids, height, width,
                                               align_corners)
    from nvsr_tpu_torch import kernels
    return kernels.plane_sample_backward(
        dout.contiguous(), grids.contiguous(), height, width,
        align_corners=align_corners)


class PlaneSample(torch.autograd.Function):
    """Differentiable bilinear sample of planes [P, C, H, W] at grids
    [P, N, 2] -> [P, N, C] f32, with the planes' gradient only. The bf16
    table is built inside the forward (the planes change every training
    step, so no table outlives a call)."""

    @staticmethod
    def forward(ctx, planes, grids, align_corners: bool):
        grids = grids.detach().float()
        ctx.save_for_backward(grids)
        ctx.hw = planes.shape[-2:]
        ctx.align_corners = align_corners
        return sample_forward(build_plane_table(planes.detach()), grids,
                              planes.shape[1], align_corners)

    @staticmethod
    def backward(ctx, dout):
        (grids,) = ctx.saved_tensors
        h, w = ctx.hw
        return (sample_backward(dout.float(), grids, h, w,
                                ctx.align_corners), None, None)


def plane_sample(planes, grids, align_corners: bool = True):
    """[P, C, H, W] planes at [P, N, 2] grids -> [P, N, C] f32 through
    the trainable sampler (PlaneSample)."""
    return PlaneSample.apply(planes, grids, align_corners)
