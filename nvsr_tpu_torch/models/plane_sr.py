"""Feature-plane super-resolution, EDSR (counterpart of
nvsr_tpu/models/plane_sr.py): init, the forward for eval and training
(input/output noise, the per-plane training trunk, per-block
rematerialization through torch.utils.checkpoint).

Parameters keep the JAX pytree layout with OIHW conv weights
(`bridge.plane_sr_from_jax`, `init_plane_sr_params`). Convolutions are
`F.conv2d` (cuDNN on the card): the JAX package runs them in XLA, not in
a hand-written kernel.
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
from torch.utils.checkpoint import checkpoint

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
    """The fields of the JAX PlaneSRConfig that the EDSR forward reads
    (tile_size and conv_impl are not ported: neither changes the
    result; SRResNet waits)."""
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
    sr_input_noise: float = 0.0
    sr_output_noise: float = 0.0
    compute_dtype: Optional[str] = None
    # recompute each residual block (remat_every > 1: each segment of
    # that many blocks) in the backward instead of storing its
    # activations; takes effect only where gradients are recorded
    remat: bool = True
    remat_every: int = 1
    # training: all planes through the trunk as one batch, instead of
    # one plane at a time
    train_batch: bool = False

    @classmethod
    def from_cfg(cls, sr_cfg, scale_factor: int, plane_channels: int,
                 plane_interp: str, align_corners: bool) -> "PlaneSRConfig":
        """Build from a reference-style `super_resolution` YAML section,
        as the JAX from_cfg (its unported fields are not read): the
        residual mode is `plane_resize_mode`, else the triplane's
        plane_interp."""
        model = sr_cfg.get("model", {})
        return cls(
            arch=model.get("type", "EDSR"),
            in_channels=plane_channels,
            out_channels=plane_channels,
            hidden_size=model.get("hidden_size", 256),
            n_blocks=model.get("n_blocks", 32),
            scale_factor=scale_factor,
            receptive_field_bound=model.get("receptive_field_bound",
                                            _INT32_MAX),
            plane_interp=sr_cfg.get("plane_resize_mode", plane_interp),
            align_corners=align_corners,
            input_normalization=sr_cfg.get("input_normalization", False),
            sr_input_noise=sr_cfg.get("sr_input_noise", 0.0),
            sr_output_noise=sr_cfg.get("sr_output_noise", 0.0),
            compute_dtype=model.get("compute_dtype", None),
            remat=model.get("remat", True),
            remat_every=model.get("remat_every", 1),
            train_batch=model.get("train_batch", False))

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


def _init_conv(generator, in_ch: int, out_ch: int, k: int, device):
    """The reference PlanesSR conv init: N(0, sqrt(2/n)/10), n = k*k*out,
    no bias; OIHW."""
    std = math.sqrt(2.0 / (k * k * out_ch)) / 10.0
    return {"w": (torch.randn((out_ch, in_ch, k, k), generator=generator,
                              device=generator.device) * std).to(device)}


def init_edsr_params(generator: torch.Generator, cfg: PlaneSRConfig,
                     device="cuda"):
    """EDSR parameter pytree drawn from `generator`, on `device`."""
    plan = edsr_layer_plan(cfg.n_blocks, cfg.scale_factor,
                           cfg.receptive_field_bound)
    hs = cfg.hidden_size

    def conv(i, o, k):
        return _init_conv(generator, i, o, k, device)

    return {"conv_input": conv(cfg.in_channels, hs, plan["conv_input"]),
            "blocks": [{"conv1": conv(hs, hs, k), "conv2": conv(hs, hs, k)}
                       for k in plan["blocks"]],
            "conv_mid": conv(hs, hs, plan["conv_mid"]),
            "upscale": [conv(hs, 4 * hs, k) for k in plan["upscale"]],
            "conv_output": conv(hs, cfg.out_channels, plan["conv_output"])}


def init_plane_sr_params(generator: torch.Generator, cfg: PlaneSRConfig,
                         device="cuda"):
    """{"inner": EDSR params, "norm"?}: with input_normalization the
    norm entry is NaN until it is filled from the corpus statistics, as
    in the JAX module."""
    if cfg.arch != "EDSR":
        raise NotImplementedError(f"SR arch {cfg.arch!r} is not ported yet")
    params = {"inner": init_edsr_params(generator, cfg, device)}
    if cfg.input_normalization:
        nan = torch.full((cfg.in_channels,), float("nan"), device=device)
        params["norm"] = {"mean": nan, "std": nan.clone()}
    return params


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


def _edsr_blocks(blocks, h, cd):
    for blk in blocks:
        k_sz = blk["conv1"]["w"].shape[-1]
        m = 2 * (k_sz // 2)
        identity = h if m == 0 else h[:, :, m:-m, m:-m]
        y = _conv(blk["conv2"], torch.relu(_conv(blk["conv1"], h, cd)), cd)
        # 0.1 in the activation dtype (bf16(0.1) for a bf16 trunk, as
        # JAX rounds the weakly typed constant)
        h = identity + h.new_tensor(0.1) * y
    return h


def apply_edsr(params, cfg: PlaneSRConfig, x):
    """[N, C, H, W] (pre-padded) -> [N, C, H', W'] VALID-conv EDSR:
    residual blocks crop their identity path by the VALID margin and
    scale the residual by 0.1; PixelShuffle upscaling ends the trunk.
    With cfg.remat and gradients recorded, each segment of
    cfg.remat_every blocks is recomputed in the backward."""
    cd = cfg.compute_dtype
    h = _conv(params["conv_input"], x, cd)
    blocks = params["blocks"]
    if cfg.remat and torch.is_grad_enabled():
        seg = max(1, cfg.remat_every)
        for i in range(0, len(blocks), seg):
            h = checkpoint(_edsr_blocks, blocks[i:i + seg], h, cd,
                           use_reentrant=False)
    else:
        h = _edsr_blocks(blocks, h, cd)
    h = _conv(params["conv_mid"], h, cd)
    for up in params["upscale"]:
        h = F.pixel_shuffle(_conv(up, h, cd), 2)
    return _conv(params["conv_output"], h, cd)


def apply_plane_sr(params, cfg: PlaneSRConfig, lr_planes, *,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None):
    """Super-resolution of feature planes: [P, C, H, W] -> [P, C, sH, sW]
    = crop(EDSR(edge_pad(norm(planes + in_noise)))) + up(planes)
    (+ out_noise), `up` the cfg.plane_interp resize (bilinear or
    bicubic). Eval runs all planes as one conv batch; training
    (train=True) runs them one at a time unless cfg.train_batch, and
    with a generator adds sr_input_noise (std relative to the planes'
    std) and sr_output_noise (relative to the detached EDSR output's)."""
    if cfg.arch != "EDSR":
        raise NotImplementedError(f"SR arch {cfg.arch!r} is not ported yet")
    x = lr_planes
    noisy = train and generator is not None
    if noisy and cfg.sr_input_noise > 0:
        std = cfg.sr_input_noise * torch.std(x, correction=0)
        x = x + std * torch.randn(x.shape, generator=generator,
                                  dtype=x.dtype, device=x.device)
    if "norm" in params:
        x = (x - params["norm"]["mean"][None, :, None, None]) \
            / params["norm"]["std"][None, :, None, None]
    pad = cfg.required_padding
    if pad > 0:
        x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    if train and not cfg.train_batch:
        diff = torch.cat([apply_edsr(params["inner"], cfg, x[i:i + 1])
                          for i in range(x.shape[0])])
    else:
        diff = apply_edsr(params["inner"], cfg, x)
    over = cfg.hr_overpadding
    if over > 0:
        diff = diff[..., over:-over, over:-over]
    residual = upsample_plane(lr_planes, cfg.scale_factor,
                              align_corners=cfg.align_corners,
                              mode=cfg.plane_interp)
    out = diff + residual
    if noisy and cfg.sr_output_noise > 0:
        std = cfg.sr_output_noise * torch.std(diff.detach(), correction=0)
        out = out + std * torch.randn(out.shape, generator=generator,
                                      dtype=out.dtype, device=out.device)
    return out
