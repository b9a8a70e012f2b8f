"""Feature-plane super-resolution, EDSR eval forward (counterpart of
nvsr_tpu/models/plane_sr.py).

Parameters keep the JAX pytree layout with OIHW conv weights
(`bridge.plane_sr_from_jax`). Convolutions are `F.conv2d` (cuDNN on the
card): the JAX package runs them in XLA, not in a hand-written kernel.
A bfloat16 compute_dtype casts operands to bf16; the conv accumulates in
f32 and rounds its output to bf16 once per layer, and the trunk then
stays bf16 (residual sums included) as in the JAX module. Whether f32
convolutions may use TF32 is the caller's `torch.backends.cudnn.allow_tf32`
(chip_smoke.py sets it to False).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nvsr_tpu_torch.ops.resize import upsample_plane

_INT32_MAX = np.iinfo(np.int32).max


def edsr_layer_plan(n_blocks: int, scale_factor: int,
                    receptive_field_bound: int = _INT32_MAX) -> dict:
    """Kernel-size schedule + fractional required padding: layers switch
    to 1x1 once the receptive field would exceed the bound; the growth per
    conv halves after each PixelShuffle."""
    assert math.log2(scale_factor) == int(math.log2(scale_factor)), \
        "only power-of-2 SR scale factors are supported"
    state = {"pad": 0.0, "rf": 1.0}
    KS = 3

    def ks(num_layers: int = 1) -> int:
        if (1 + 2 * (state["pad"] + state["rf"] * num_layers * ((KS - 1) // 2))
                ) <= receptive_field_bound:
            state["pad"] += state["rf"] * num_layers * (KS // 2)
            return KS
        return 1

    plan = {"conv_input": ks()}
    plan["blocks"] = [ks(2) for _ in range(n_blocks)]
    plan["conv_mid"] = ks()
    ups = []
    for _ in range(int(math.log2(scale_factor))):
        ups.append(ks())
        state["rf"] /= 2
    plan["upscale"] = ups
    plan["conv_output"] = ks()
    plan["required_padding_raw"] = state["pad"]
    return plan


@dataclasses.dataclass(frozen=True)
class PlaneSRConfig:
    """The fields of the JAX PlaneSRConfig that the eval forward reads
    (the training-only noise, tiling, remat and conv-lowering options are
    not ported: tiling and conv lowering do not change the result)."""
    arch: str = "EDSR"
    in_channels: int = 48
    out_channels: int = 48
    hidden_size: int = 256
    n_blocks: int = 32
    scale_factor: int = 4
    receptive_field_bound: int = _INT32_MAX
    plane_interp: str = "bilinear"       # residual-upsample mode
    align_corners: bool = True
    input_normalization: bool = False
    compute_dtype: Optional[str] = None

    def _padding_raw(self) -> float:
        if self.arch != "EDSR":
            return 0.0
        return edsr_layer_plan(self.n_blocks, self.scale_factor,
                               self.receptive_field_bound)[
                                   "required_padding_raw"]

    @property
    def required_padding(self) -> int:
        """Integer replicate-padding of the LR input."""
        return int(np.ceil(self._padding_raw()))

    @property
    def hr_overpadding(self) -> int:
        """Crop applied to the HR output."""
        raw = self._padding_raw()
        return int(np.ceil(raw)) * self.scale_factor - int(
            raw * self.scale_factor)


def _conv(p, x, compute_dtype=None):
    """VALID conv of NCHW x with OIHW p["w"] (+ p["b"])."""
    w = p["w"]
    if compute_dtype is not None:
        cd = getattr(torch, compute_dtype)
        x, w = x.to(cd), w.to(cd)
    y = F.conv2d(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    return y


def apply_edsr(params, cfg: PlaneSRConfig, x):
    """[N, C, H, W] (pre-padded) -> [N, C, H', W'] VALID-conv EDSR:
    residual blocks crop their identity path by the VALID margin and
    scale the residual by 0.1; PixelShuffle upscaling ends the trunk."""
    cd = cfg.compute_dtype
    h = _conv(params["conv_input"], x, cd)
    # 0.1 in the activation dtype (bf16(0.1) for a bf16 trunk, as JAX
    # rounds the weakly typed constant)
    scale = h.new_tensor(0.1)
    for blk in params["blocks"]:
        k_sz = blk["conv1"]["w"].shape[-1]
        m = 2 * (k_sz // 2)
        identity = h if m == 0 else h[:, :, m:-m, m:-m]
        y = _conv(blk["conv2"], torch.relu(_conv(blk["conv1"], h, cd)), cd)
        h = identity + scale * y
    h = _conv(params["conv_mid"], h, cd)
    for up in params["upscale"]:
        h = F.pixel_shuffle(_conv(up, h, cd), 2)
    return _conv(params["conv_output"], h, cd)


def apply_plane_sr(params, cfg: PlaneSRConfig, lr_planes):
    """Eval super-resolution of feature planes: [P, C, H, W] ->
    [P, C, sH, sW] = crop(EDSR(edge_pad(norm(planes)))) +
    bilinear_up(planes); all planes run as one conv batch."""
    if cfg.arch != "EDSR":
        raise NotImplementedError(f"SR arch {cfg.arch!r} is not ported yet")
    if cfg.plane_interp != "bilinear":
        raise NotImplementedError(
            f"residual upsample mode {cfg.plane_interp!r} is not ported yet")
    x = lr_planes
    if "norm" in params:
        x = (x - params["norm"]["mean"][None, :, None, None]) \
            / params["norm"]["std"][None, :, None, None]
    pad = cfg.required_padding
    if pad > 0:
        x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    diff = apply_edsr(params["inner"], cfg, x)
    over = cfg.hr_overpadding
    if over > 0:
        diff = diff[..., over:-over, over:-over]
    residual = upsample_plane(lr_planes, cfg.scale_factor,
                              align_corners=cfg.align_corners)
    return diff + residual
