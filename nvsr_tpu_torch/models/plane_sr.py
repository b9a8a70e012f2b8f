"""Feature-plane super-resolution, EDSR and SRResNet (counterpart of
nvsr_tpu/models/plane_sr.py): init, the forward for eval and training
(input/output noise, the per-plane training trunk, per-block
rematerialization through torch.utils.checkpoint, EDSR in fixed-size
tiles with `tile_size`).

Parameters keep the JAX pytree layout with OIHW conv weights
(`bridge.plane_sr_from_jax`, `init_plane_sr_params`). Convolutions are
`F.conv2d` (cuDNN on the card): the JAX package runs them in XLA, not in
a hand-written kernel.
A bfloat16 compute_dtype casts operands to bf16; the conv accumulates in
f32 and rounds its output to bf16 once per layer, and the trunk then
stays bf16 (residual sums included) as in the JAX module. Whether f32
convolutions may use TF32 is the caller's `torch.backends.cudnn.allow_tf32`
(chip_smoke.py sets it to False).

The JAX config's `conv_impl` ('xla' or 'mm': lax.conv_general_dilated
or k^2 shifted matmuls) picks how XLA:TPU lowers the same convolution,
to get around its batch-1 conv lowering; it does not change the
function. On the card cuDNN picks the algorithm, so the port has no
such field.
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
    """The fields of the JAX PlaneSRConfig but conv_impl (see the module
    docstring)."""
    arch: str = "EDSR"                   # EDSR | SRResNet
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
    no_batch_norm: bool = False          # SRResNet only
    compute_dtype: Optional[str] = None
    # EDSR only: super-resolve the plane in tiles of this many LR pixels
    # (each with a required_padding halo) instead of one full-plane conv
    # stack. The VALID convolutions make each HR pixel depend on a
    # bounded LR window, so the result is the full-plane one up to
    # summation order, with activation memory O(tile^2)
    tile_size: Optional[int] = None
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
        as the JAX from_cfg (but conv_impl): the residual mode is
        `plane_resize_mode`, else the triplane's plane_interp."""
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
            no_batch_norm=model.get("no_batch_norm", False),
            compute_dtype=model.get("compute_dtype", None),
            tile_size=model.get("tile_size", None),
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


def _init_conv(generator, in_ch: int, out_ch: int, k: int, device,
               bias: bool = False):
    """The reference PlanesSR conv init: N(0, sqrt(2/n)/10), n = k*k*out,
    a zero bias if any; OIHW."""
    std = math.sqrt(2.0 / (k * k * out_ch)) / 10.0
    p = {"w": (torch.randn((out_ch, in_ch, k, k), generator=generator,
                           device=generator.device) * std).to(device)}
    if bias:
        p["b"] = torch.zeros((out_ch,), device=device)
    return p


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


def _init_bn(ch: int, device):
    return {"scale": torch.ones((ch,), device=device),
            "bias": torch.zeros((ch,), device=device),
            "mean": torch.zeros((ch,), device=device),
            "var": torch.ones((ch,), device=device)}


def _prelu_init(device):
    return torch.full((), 0.25, device=device)


def init_srresnet_params(generator: torch.Generator, cfg: PlaneSRConfig,
                         device="cuda"):
    """SRResNet parameter pytree (the JAX layout: 9x9 head and tail convs
    with biases, scalar PReLU slopes, BatchNorm unless no_batch_norm)
    drawn from `generator`, on `device`."""
    hs = cfg.hidden_size

    def conv(i, o, k, bias=False):
        return _init_conv(generator, i, o, k, device, bias)

    params = {"conv1": conv(cfg.in_channels, hs, 9, bias=True),
              "prelu1": _prelu_init(device)}
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {"conv1": conv(hs, hs, 3), "prelu": _prelu_init(device),
               "conv2": conv(hs, hs, 3)}
        if not cfg.no_batch_norm:
            blk["bn1"] = _init_bn(hs, device)
            blk["bn2"] = _init_bn(hs, device)
        blocks.append(blk)
    params["blocks"] = blocks
    params["conv2"] = conv(hs, hs, 3)
    if not cfg.no_batch_norm:
        params["bn2"] = _init_bn(hs, device)
    params["upscale"] = [{"conv": conv(hs, 4 * hs, 3, bias=True),
                          "prelu": _prelu_init(device)}
                         for _ in range(int(math.log2(cfg.scale_factor)))]
    params["conv3"] = conv(hs, cfg.out_channels, 9, bias=True)
    return params


def init_plane_sr_params(generator: torch.Generator, cfg: PlaneSRConfig,
                         device="cuda"):
    """{"inner": EDSR or SRResNet params, "norm"?}: with
    input_normalization the norm entry is NaN until it is filled from the
    corpus statistics, as in the JAX module."""
    if cfg.arch == "EDSR":
        inner = init_edsr_params(generator, cfg, device)
    elif cfg.arch == "SRResNet":
        inner = init_srresnet_params(generator, cfg, device)
    else:
        raise ValueError(f"unknown SR arch: {cfg.arch}")
    params = {"inner": inner}
    if cfg.input_normalization:
        nan = torch.full((cfg.in_channels,), float("nan"), device=device)
        params["norm"] = {"mean": nan, "std": nan.clone()}
    return params


def _conv(p, x, compute_dtype=None, padding: int = 0):
    """Conv of NCHW x with OIHW p["w"] (+ p["b"]): VALID, or zero
    `padding` on each side (SAME for an odd kernel of 2 * padding + 1)."""
    w = p["w"]
    if compute_dtype is not None:
        cd = getattr(torch, compute_dtype)
        x, w = x.to(cd), w.to(cd)
    y = F.conv2d(x, w, padding=padding)
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


def apply_edsr_tiled(params, cfg: PlaneSRConfig, x, orig_hw):
    """EDSR over a pre-padded plane batch in tiles: x [N, C, H + 2P,
    W + 2P] (P = required_padding, the full-plane path's replicate pad),
    orig_hw (H, W) -> [N, C, sH, sW], the full-plane result cropped by
    hr_overpadding, up to summation order.

    The bottom and right edges are replicate-extended so the tiles cover
    the plane (those values reach no HR pixel inside [0, sH) x [0, sW));
    each tile of T LR pixels with its P halo maps to sT + 2 *
    hr_overpadding HR pixels, cropped to its sT. One tile (of every
    plane) runs at a time, so peak memory is O(T^2)."""
    h, w = orig_hw
    pad, over, s = cfg.required_padding, cfg.hr_overpadding, cfg.scale_factor
    t = int(cfg.tile_size)
    nth, ntw = -(-h // t), -(-w // t)
    eh = nth * t + 2 * pad - x.shape[2]
    ew = ntw * t + 2 * pad - x.shape[3]
    if eh > 0 or ew > 0:
        x = F.pad(x, (0, max(ew, 0), 0, max(eh, 0)), mode="replicate")
    rows = []
    for i in range(nth):
        row = []
        for j in range(ntw):
            y = apply_edsr(params, cfg, x[:, :, i * t:i * t + t + 2 * pad,
                                          j * t:j * t + t + 2 * pad])
            if over > 0:
                y = y[..., over:-over, over:-over]
            row.append(y)
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)[..., :s * h, :s * w]


def _bn(p, x, train: bool):
    """BatchNorm of NCHW activations, eps 1e-5: in training the batch's
    statistics over N, H and W (biased variance; no running statistics
    are kept), else the stored mean and var."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), correction=0)
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + 1e-5)
    return ((x - mean[:, None, None]) * inv[:, None, None]
            * p["scale"][:, None, None] + p["bias"][:, None, None])


def _prelu(p, x):
    """PReLU with one scalar slope."""
    return torch.where(x >= 0, x, p * x)


def apply_srresnet(params, cfg: PlaneSRConfig, x, train: bool = False):
    """[N, C, H, W] -> [N, C, sH, sW]: the SRGAN generator with SAME
    padding throughout (required_padding 0), in f32. train: BatchNorm
    takes the batch's statistics."""
    h1 = _prelu(params["prelu1"], _conv(params["conv1"], x, padding=4))
    h = h1
    for blk in params["blocks"]:
        y = _conv(blk["conv1"], h, padding=1)
        if "bn1" in blk:
            y = _bn(blk["bn1"], y, train)
        y = _conv(blk["conv2"], _prelu(blk["prelu"], y), padding=1)
        if "bn2" in blk:
            y = _bn(blk["bn2"], y, train)
        h = h + y
    h2 = _conv(params["conv2"], h, padding=1)
    if "bn2" in params:
        h2 = _bn(params["bn2"], h2, train)
    h = h1 + h2
    for up in params["upscale"]:
        h = _prelu(up["prelu"],
                   F.pixel_shuffle(_conv(up["conv"], h, padding=1), 2))
    return _conv(params["conv3"], h, padding=4)


def apply_plane_sr(params, cfg: PlaneSRConfig, lr_planes, *,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None):
    """Super-resolution of feature planes: [P, C, H, W] -> [P, C, sH, sW]
    = crop(EDSR(edge_pad(norm(planes + in_noise)))) + up(planes)
    (+ out_noise), `up` the cfg.plane_interp resize (bilinear or
    bicubic); SRResNet in EDSR's place for arch "SRResNet". EDSR: with
    cfg.tile_size, in tiles (apply_edsr_tiled); else eval runs all planes
    as one conv batch and training (train=True) runs them one at a time
    unless cfg.train_batch. SRResNet runs all planes as one batch (its
    BatchNorm takes their statistics in training). With train and a
    generator, sr_input_noise (std relative to the planes' std) and
    sr_output_noise (relative to the detached net output's) are added."""
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
    if cfg.arch == "SRResNet":
        assert cfg.tile_size is None, \
            "tile_size is only supported for the EDSR (VALID-conv) arch"
        diff = apply_srresnet(params["inner"], cfg, x, train=train)
    elif cfg.tile_size is not None:
        diff = apply_edsr_tiled(params["inner"], cfg, x,
                                lr_planes.shape[-2:])
    else:
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


def sr_scale_factor(sf_config, coupler_ds_factor: int) -> int:
    """The SR scale factor from the config: 'linear' -> the LR/HR
    downsampling ratio, 'sqrt' -> its square root, else the integer
    given."""
    if sf_config == "linear":
        return int(coupler_ds_factor)
    if sf_config == "sqrt":
        return int(np.sqrt(coupler_ds_factor))
    return int(sf_config)
