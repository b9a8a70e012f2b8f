"""Host side of the standalone decoder kernel, and its plain version.

Counterpart of nvsr_tpu/ops/pallas/fused_decoder.py::fused_decode (:231,
the TPU kernel `_kernel` :220 with `decode_body` :130). The CUDA kernel
is csrc/fused_decode.cu, which shares the decoder of
csrc/triplane_render.cu (csrc/decoder.cuh); `fused_decode_reference` is
its plain PyTorch version with the same rounding, used on the CPU and as
the kernel's oracle. The decoder is packed by
ops/fused_render.py::pack_decoder, as for the gather+decode kernel.

What both compute, per point n of N, from three bf16 vertical tap pairs
rows[p * N + n] (plane-major [3N, 128]: the top tap's channels in lanes
0:64, the bottom tap's in 64:128, as the TPU tile gather returns them):
  * f_p = top * (1 - ty) + bot * ty in f32 (lerp_pair,
    fused_decoder.py:213-217; not the gather+decode kernel's v2 lerp),
    over the first packed.cp channels: the packed weights' pad rows are
    zero, so the other lanes cannot count;
  * comb = (f0 + f1 + f2) [/ 3] in f32, then the decoder of
    fused_render.decode_reference, full decode, with the f32 view row
    [N, 64] rounded to bf16 at the first matmul as decode_body does;
  * out [N, 8] f32: rgb in lanes 0:3, sigma in lane 3, zeros in 4:8 (the
    TPU kernel's OUT_LANES block).

The TPU kernel needs N to be a multiple of its block B; this one takes
any N.
"""

from __future__ import annotations

import torch

from nvsr_tpu_torch.ops.fused_render import PackedDecoder, decode_reference

HALF = 64          # channels per tap in a row (fused_decoder.HALF)
OUT_LANES = 8      # output block: rgb 0:3, sigma 3


def lerp_pair(rows, ty, channels: int):
    """[M, 128] tap pairs, ty [M] -> [M, channels] f32 y-lerped."""
    top = rows[:, :channels].float()
    bot = rows[:, HALF:HALF + channels].float()
    t = ty[:, None]
    return top * (1.0 - t) + bot * t


def fused_decode_reference(rows, ty, view, packed: PackedDecoder, *,
                           avg: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [N, 8] f32."""
    n = rows.shape[0] // 3
    feats = lerp_pair(rows, ty.reshape(-1), packed.cp).reshape(
        3, n, packed.cp)
    out = decode_reference(packed, *feats, view[:, :packed.cvp], avg=avg,
                           sigma_only=False)
    return torch.cat([out, out.new_zeros((n, OUT_LANES - 4))], dim=-1)


def fused_decode(rows, ty, view, packed: PackedDecoder, *, avg: bool):
    """Decode tap-pair rows [3N, 128] bf16 (plane-major), ty [3N] (or
    [3N, 1]) f32 and view [N, 64] f32 -> [N, 8] f32; avg: the config's
    proj_combination is "avg" (else "sum").

    A CPU tensor runs the plain version; any other goes to the kernel
    (kernels.fused_decode_forward), which launches on a CUDA tensor and
    raises on any other device or on any failure."""
    ty = ty.reshape(-1)
    if rows.device.type == "cpu":
        return fused_decode_reference(rows, ty, view, packed, avg=avg)
    from nvsr_tpu_torch import kernels
    return kernels.fused_decode_forward(rows.contiguous(), ty.contiguous(),
                                        view.contiguous(), packed, avg=avg)
