"""Feature-plane super-resolution, EDSR and SRResNet (counterpart of
nvsr_tpu/models/plane_sr.py): init, the forward for eval and training
(input/output noise, the per-plane training trunk, per-block
rematerialization through torch.utils.checkpoint, EDSR in fixed-size
tiles with `tile_size`).

Parameters keep the JAX pytree layout with OIHW conv weights
(`bridge.plane_sr_from_jax`, `init_plane_sr_params`). Convolutions are
`F.conv2d` (cuDNN on the card) through `PlaneConv`, whose backward takes
an f32 data gradient as a forward convolution (see its docstring): the
JAX package runs them in XLA, not in a hand-written kernel.
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

`remat` likewise picks a schedule, not a function. JAX reads an unstated
`super_resolution.model.remat` as True, to save TPU HBM; the port reads
it as None and decides once per `apply_plane_sr` call in training, for
every plane and tile of the call (`edsr_remat`): keep the residual
blocks' activations for the backward when the ReLU maps the trunk would
keep (`edsr_kept_bytes`; the block inputs are kept either way) fit in
half of what the caching allocator can still hand out on the card
(`cuda_room`; the other half is left to the backward's own gradients and
cuDNN workspaces), else recompute each block in the backward as JAX
does. On the CPU, and under a tensor-parallel mesh, None recomputes: on
the CPU there is no allocator to ask, and under a mesh ranks that chose
differently would issue different numbers of collectives in the
backward. A stated True or False is honoured as it stands. Kept or
recomputed, the backward does the same multiply-adds on the same values.

Under a tensor-parallel mesh (`mesh=`, model_parallel > 1, the
parameters in parallel.sharding.plane_sr_tp_shardings' slices: every
conv's output channels split over the model group) each conv computes
its block of output channels from the replicated input, and the blocks
are gathered before the next conv, the residual add and the
normalizations (parallel/tensor.py). The x2 pixel shuffle maps channel
c*4 + k to channel c, so an upscale conv's block (4 * hidden / M
channels: a multiple of 4, since the input conv's hidden channels split
over M) stays contiguous through it: it is shuffled first and gathered
after.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from nvsr_tpu_torch.ops.resize import upsample_plane
from nvsr_tpu_torch.parallel.sharding import tensor_parallel

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
    """The fields of the JAX PlaneSRConfig but conv_impl; remat's
    default differs (see the module docstring)."""
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
    # activations; takes effect only where gradients are recorded. None
    # (unstated): apply_plane_sr decides in training, keeping them when
    # they fit in half the card's room (see the module docstring)
    remat: Optional[bool] = None
    remat_every: int = 1
    # training: all planes through the trunk as one batch, instead of
    # one plane at a time
    train_batch: bool = False

    @classmethod
    def from_cfg(cls, sr_cfg, scale_factor: int, plane_channels: int,
                 plane_interp: str, align_corners: bool) -> "PlaneSRConfig":
        """Build from a reference-style `super_resolution` YAML section,
        as the JAX from_cfg (but conv_impl, and an unstated remat reads
        None): the residual mode is `plane_resize_mode`, else the
        triplane's plane_interp."""
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
            remat=model.get("remat"),
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


class PlaneConv(torch.autograd.Function):
    """`F.conv2d(x, w, padding=padding)` (stride 1, dilation 1, one
    group, a square odd kernel, 0 <= padding <= k - 1) whose backward,
    for f32 (and f64) operands, takes the data gradient as a forward
    convolution: the output gradient with the weights' in and out
    channels swapped and flipped in space, at padding k - 1 - padding.
    The same multiply-adds as the convolution's own data gradient, in
    another order. At batch 1 cuDNN picks an FFT data gradient for f32,
    whose per-frequency product is a complex GEMV; its forward engines
    take the same work about 4x faster (H100, 256 -> 256 and 256 -> 1024
    channels at 330^2 and 404^2). For bf16 cuDNN's own data gradient is a
    tensor-core implicit GEMM, and the forward route made a bf16 EDSR's
    backward 15% slower on the same card, so bf16 and f16 keep it.
    The weight gradient is always the convolution's own.

    `data_grads` counts the data gradients taken as forward convolutions
    (like `kernels.launches`)."""

    data_grads = 0
    FORWARD_DGRAD_DTYPES = (torch.float32, torch.float64)

    @staticmethod
    def forward(ctx, x, w, padding: int):
        k = w.shape[-1]
        assert w.shape[-2] == k and k % 2 == 1 and 0 <= padding <= k - 1 \
            and x.shape[1] == w.shape[1], (tuple(x.shape), tuple(w.shape),
                                           padding)
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, padding=padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p = ctx.padding
        need_dx, need_dw, _ = ctx.needs_input_grad
        as_forward = need_dx and x.dtype in PlaneConv.FORWARD_DGRAD_DTYPES
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, (1, 1), (p, p), (1, 1), False, (0, 0), 1,
            (need_dx and not as_forward, need_dw, False))
        if as_forward:
            dx = F.conv2d(dy, w.transpose(0, 1).flip(-2, -1),
                          padding=w.shape[-1] - 1 - p)
            PlaneConv.data_grads += 1
        return dx, dw, None


def _conv(p, x, compute_dtype=None, padding: int = 0):
    """Conv of NCHW x with OIHW p["w"] (+ p["b"]): VALID, or zero
    `padding` on each side (SAME for an odd kernel of 2 * padding + 1)."""
    w = p["w"]
    if compute_dtype is not None:
        cd = getattr(torch, compute_dtype)
        x, w = x.to(cd), w.to(cd)
    y = PlaneConv.apply(x, w, padding)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    return y


def _split_conv(p, x, mesh, compute_dtype=None, padding: int = 0,
                gather: bool = True):
    """_conv of a replicated x; under a tensor-parallel mesh with p's
    output channels split, this rank's block of them, gathered unless
    gather=False (the block alone)."""
    if not tensor_parallel(mesh):
        return _conv(p, x, compute_dtype, padding)
    from nvsr_tpu_torch.parallel.tensor import (copy_to_model,
                                                gather_from_model)
    y = _conv(p, copy_to_model(x, mesh), compute_dtype, padding)
    return gather_from_model(y, mesh, 1) if gather else y


def _shuffle(p, h, mesh, compute_dtype=None, padding: int = 0):
    """pixel_shuffle(conv(h), 2) of an upscale conv (see the module
    docstring for the split form)."""
    if not tensor_parallel(mesh):
        return F.pixel_shuffle(_conv(p, h, compute_dtype, padding), 2)
    from nvsr_tpu_torch.parallel.tensor import gather_from_model
    y = _split_conv(p, h, mesh, compute_dtype, padding, gather=False)
    return gather_from_model(F.pixel_shuffle(y, 2), mesh, 1)


def _residual_scale(dtype) -> float:
    """0.1 rounded to the activation dtype (bf16(0.1) = 0.10009765625
    for a bf16 trunk, as JAX rounds the weakly typed constant), as a
    Python number: a tensor scalar would be copied to the device at
    every block."""
    return float(torch.tensor(0.1, dtype=dtype))


def _edsr_blocks(blocks, h, cd, mesh=None):
    for blk in blocks:
        k_sz = blk["conv1"]["w"].shape[-1]
        m = 2 * (k_sz // 2)
        identity = h if m == 0 else h[:, :, m:-m, m:-m]
        y = _split_conv(blk["conv2"], torch.relu(
            _split_conv(blk["conv1"], h, mesh, cd)), mesh, cd)
        h = identity + _residual_scale(h.dtype) * y
    return h


class BlockRecompute:
    """A segment of residual blocks under torch.utils.checkpoint: only
    its input is kept, and the backward runs the segment again for the
    activations it needs. `blocks` counts the blocks so recomputed (like
    PlaneConv.data_grads)."""

    blocks = 0

    @staticmethod
    def apply(blocks, h, cd, mesh=None):
        runs = []

        def run(h):
            if runs:
                BlockRecompute.blocks += len(blocks)
            runs.append(None)
            return _edsr_blocks(blocks, h, cd, mesh)

        return checkpoint(run, h, use_reentrant=False)


def edsr_kept_bytes(cfg: PlaneSRConfig, lr_shape, dtype=torch.float32) -> int:
    """The bytes of the ReLU maps that an EDSR trunk keeps for the
    backward when it does not recompute its blocks, for LR planes of
    `lr_shape` [P, C, H, W] in `dtype` (cfg.compute_dtype where set):
    per plane (and, with cfg.tile_size, per tile, all of which stay
    alive until the backward), each block's map of hidden_size channels
    at its first conv's output size. The block inputs are not counted:
    the recompute keeps them as well."""
    n, _, h, w = lr_shape
    pad = cfg.required_padding
    sizes = [(h + 2 * pad, w + 2 * pad)]
    if cfg.tile_size is not None:
        t = int(cfg.tile_size)
        sizes = [(t + 2 * pad, t + 2 * pad)] * (-(-h // t) * -(-w // t))
    if cfg.compute_dtype is not None:
        dtype = getattr(torch, cfg.compute_dtype)
    plan = edsr_layer_plan(cfg.n_blocks, cfg.scale_factor,
                           cfg.receptive_field_bound)
    area = 0
    for sh, sw in sizes:
        sh, sw = sh - plan["conv_input"] + 1, sw - plan["conv_input"] + 1
        for k in plan["blocks"]:
            area += (sh - k + 1) * (sw - k + 1)
            sh, sw = sh - 2 * (k - 1), sw - 2 * (k - 1)
    return n * cfg.hidden_size * area * dtype.itemsize


def cuda_room(device) -> int:
    """What the caching allocator can still hand out on a CUDA `device`:
    the driver's free memory and what the allocator holds reserved but
    unallocated."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def edsr_remat(cfg: PlaneSRConfig, kept_bytes: int, room: int, device,
               mesh=None) -> bool:
    """Whether the EDSR trunk recomputes its blocks in the backward: a
    stated cfg.remat as it stands; else (None) recompute on a device that
    is not CUDA and under a tensor-parallel mesh, and keep the
    activations when `kept_bytes` (edsr_kept_bytes) is at most half the
    `room` (cuda_room) of `device`."""
    if cfg.remat is not None:
        return cfg.remat
    if torch.device(device).type != "cuda" or tensor_parallel(mesh):
        return True
    return kept_bytes > room / 2


def apply_edsr(params, cfg: PlaneSRConfig, x, mesh=None):
    """[N, C, H, W] (pre-padded) -> [N, C, H', W'] VALID-conv EDSR:
    residual blocks crop their identity path by the VALID margin and
    scale the residual by 0.1; PixelShuffle upscaling ends the trunk.
    With gradients recorded and cfg.remat True, or None (apply_plane_sr
    decides None before it calls; a direct call recomputes), each
    segment of cfg.remat_every blocks is recomputed in the backward
    (BlockRecompute); with remat False the blocks keep their activations.
    mesh: see the module docstring."""
    cd = cfg.compute_dtype
    h = _split_conv(params["conv_input"], x, mesh, cd)
    blocks = params["blocks"]
    if cfg.remat is not False and torch.is_grad_enabled():
        seg = max(1, cfg.remat_every)
        for i in range(0, len(blocks), seg):
            h = BlockRecompute.apply(blocks[i:i + seg], h, cd, mesh)
    else:
        h = _edsr_blocks(blocks, h, cd, mesh)
    h = _split_conv(params["conv_mid"], h, mesh, cd)
    for up in params["upscale"]:
        h = _shuffle(up, h, mesh, cd)
    return _split_conv(params["conv_output"], h, mesh, cd)


def apply_edsr_tiled(params, cfg: PlaneSRConfig, x, orig_hw, mesh=None):
    """EDSR over a pre-padded plane batch in tiles: x [N, C, H + 2P,
    W + 2P] (P = required_padding, the full-plane path's replicate pad),
    orig_hw (H, W) -> [N, C, sH, sW], the full-plane result cropped by
    hr_overpadding, up to summation order.

    The bottom and right edges are replicate-extended so the tiles cover
    the plane (those values reach no HR pixel inside [0, sH) x [0, sW));
    each tile of T LR pixels with its P halo maps to sT + 2 *
    hr_overpadding HR pixels, cropped to its sT. One tile (of every
    plane) runs at a time, so peak memory is O(T^2). mesh: see the
    module docstring."""
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
                                          j * t:j * t + t + 2 * pad], mesh)
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


def apply_srresnet(params, cfg: PlaneSRConfig, x, train: bool = False,
                   mesh=None):
    """[N, C, H, W] -> [N, C, sH, sW]: the SRGAN generator with SAME
    padding throughout (required_padding 0), in f32. train: BatchNorm
    takes the batch's statistics. mesh: see the module docstring."""
    def conv(p, h, padding):
        return _split_conv(p, h, mesh, padding=padding)

    h1 = _prelu(params["prelu1"], conv(params["conv1"], x, 4))
    h = h1
    for blk in params["blocks"]:
        y = conv(blk["conv1"], h, 1)
        if "bn1" in blk:
            y = _bn(blk["bn1"], y, train)
        y = conv(blk["conv2"], _prelu(blk["prelu"], y), 1)
        if "bn2" in blk:
            y = _bn(blk["bn2"], y, train)
        h = h + y
    h2 = conv(params["conv2"], h, 1)
    if "bn2" in params:
        h2 = _bn(params["bn2"], h2, train)
    h = h1 + h2
    for up in params["upscale"]:
        h = _prelu(up["prelu"], _shuffle(up["conv"], h, mesh, padding=1))
    return conv(params["conv3"], h, 4)


def apply_plane_sr(params, cfg: PlaneSRConfig, lr_planes, *,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None, mesh=None):
    """Super-resolution of feature planes: [P, C, H, W] -> [P, C, sH, sW]
    = crop(EDSR(edge_pad(norm(planes + in_noise)))) + up(planes)
    (+ out_noise), `up` the cfg.plane_interp resize (bilinear or
    bicubic); SRResNet in EDSR's place for arch "SRResNet". EDSR: with
    cfg.tile_size, in tiles (apply_edsr_tiled); else eval runs all planes
    as one conv batch and training (train=True) runs them one at a time
    unless cfg.train_batch. SRResNet runs all planes as one batch (its
    BatchNorm takes their statistics in training). With train and a
    generator, sr_input_noise (std relative to the planes' std) and
    sr_output_noise (relative to the detached net output's) are added.
    An EDSR's unstated cfg.remat is decided here, once for all planes and
    tiles of the call (edsr_remat), in training with gradients recorded;
    otherwise it recomputes. mesh: a tensor-parallel mesh whose slices
    `params` holds (see the module docstring)."""
    if cfg.arch == "EDSR" and cfg.remat is None:
        remat = True
        if train and torch.is_grad_enabled():
            dev = lr_planes.device
            remat = edsr_remat(
                cfg, edsr_kept_bytes(cfg, lr_planes.shape, lr_planes.dtype),
                cuda_room(dev) if dev.type == "cuda" else 0, dev, mesh)
        cfg = dataclasses.replace(cfg, remat=remat)
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
        diff = apply_srresnet(params["inner"], cfg, x, train=train,
                              mesh=mesh)
    elif cfg.tile_size is not None:
        diff = apply_edsr_tiled(params["inner"], cfg, x,
                                lr_planes.shape[-2:], mesh)
    else:
        if train and not cfg.train_batch:
            diff = torch.cat([apply_edsr(params["inner"], cfg, x[i:i + 1],
                                         mesh)
                              for i in range(x.shape[0])])
        else:
            diff = apply_edsr(params["inner"], cfg, x, mesh)
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
