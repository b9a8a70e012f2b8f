"""Host side of the triplane gather+decode kernel, and its plain version.

Counterpart of nvsr_tpu/ops/pallas/tile_sampler.py::tiled_render_rays
(the entry of the TPU megakernel `_mega_kernel_v2`) and of its grids
entry `tiled_render_chunked` (:1464, `_mega_kernel_v2` or, under
NVSR_MEGA_V1=1, `_mega_kernel`), together with
nvsr_tpu/ops/pallas/fused_decoder.py::supports / pack_decoder_weights.
The CUDA kernel is csrc/triplane_render.cu (built and bound by
kernels.py); `fused_render_reference` and `tiled_render_chunked_reference`
below are its plain PyTorch versions with the same rounding, used on the
CPU and as the kernel's oracles.

What both compute, per point of rays x sorted depths (ray-major):
  * the point o + d*z, normalized by the scene box, projected onto the
    3 planes (columns 1:3 of each rotation);
  * a bilinear border-clamped sample of each plane with bf16 taps and
    bf16 x-weights bf16(1 - tx), bf16(tx); the two rows are interpolated
    in f32 and y-lerped in f32 as top + ty * (bot - top) (the shipped
    JAX kernel's single-M gather, tile_sampler.py:1115-1123);
  * cubic (plane_interp 'bicubic', the TPU kernel's interp="cubic"
    branch, tile_sampler.py:1131-1143): the 4x4 bicubic window of each
    plane (source coordinate clipped to [-1, size], taps clamped; see
    ops/grid_sample.py::cubic_taps) with bf16 weights
    bf16(cubic(i - tx) * cubic(j - ty)), f32 row sums, and the rows summed
    in f32 in the order y0, y0+1, y0-1, y0+2 (the TPU kernel's A rows,
    then its B rows);
  * comb = (f0 + f1 + f2) [/ 3] in f32; the density MLP on comb, the rgb
    MLP on [f0, f1, f2, view]; bf16 operands, f32 accumulation, f32 bias,
    relu activations kept in bf16; skip layers re-concatenate the branch
    input; heads give rgb (lanes 0:3) and sigma (lane 3);
  * sigma_only: the rgb branch is skipped, rgb lanes hold the fc_rgb
    bias, sigma is computed by the same code as in the full decode;
  * the grids entry (bilinear only) takes the points' normalized plane
    coordinates [3, N, 2] and a view row per point, and returns [N, 4]
    in the points' order. Its form "v1" is the TPU `_mega_kernel`'s
    rounding (tile_sampler.py:845-847, 869-870): the two x-interpolated
    rows rounded to bf16, the y-lerp top * (1 - ty) + bot * ty, and
    always the full decode (that kernel ignores sigma_only).

overflow_frac is always 0.0: on Hopper each point's four taps per plane
are plain loads, so no chunk footprint is ever clamped to a region.
The TPU path's region capacity, hybrid overflow repair
(triplane.py:501-550) and compact->XLA eval ladder (experiment.py
:1062-1068) exist only because its kernel clamps; they have no
counterpart here, and the aux key is kept for the point-fn protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nvsr_tpu_torch.ops.grid_sample import (_corners, cubic_taps,
                                            cubic_weight)

WIDTH = 128        # decoder width the kernel supports (dec_channels)
HEAD_COLS = 16     # head block width: rgb in cols 0:3, sigma in col 3
CH_ALIGN = 16      # feature parts are padded to a multiple of this
STEP_ROWS = 16     # K rows of one wgmma step (csrc/decoder.cuh)
SLICE_ROWS = 64    # K rows of one 16 KB slice of the kernels' weight ring


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def supports(cfg) -> bool:
    """True when the kernel computes this triplane config. compute_dtype
    must be explicitly bfloat16 (the kernel's matmuls are bf16), as in
    the JAX fused_decoder.supports; both plane_interp modes are taken."""
    return (cfg.compute_dtype == "bfloat16"
            and cfg.plane_interp in ("bilinear", "bicubic")
            and cfg.num_planes == 3
            and cfg.proj_combination in ("avg", "sum")
            and cfg.viewdir_combination == "concat_pos"
            and cfg.rgb_dec_input == "projections"
            and cfg.use_viewdirs
            and cfg.num_plane_channels <= 64
            and cfg.viewdir_channels <= 64
            and cfg.dec_channels == WIDTH)


def build_plane_table(planes_pos) -> torch.Tensor:
    """[3, C, H, W] planes -> [3, H, W, Cp] bf16 channel-last table with
    the channels zero-padded to Cp = round_up(C, 16). Built once per
    scene and point function (counterpart of build_pair_tables)."""
    p, c, h, w = planes_pos.shape
    cp = _round_up(c, CH_ALIGN)
    table = torch.zeros((p, h, w, cp), dtype=torch.bfloat16,
                        device=planes_pos.device)
    table[..., :c] = planes_pos.permute(0, 2, 3, 1).to(torch.bfloat16)
    return table


def _is_skip(skip_every: int, layer_num: int) -> bool:
    return skip_every > 0 and layer_num > 0 and layer_num % skip_every == 0


def layer_inputs(branch: str, ln: int, skip_every: int):
    """Names of the input parts of layer `ln` of a branch, in the row
    order of its packed weight block ("x" = the previous activation)."""
    first = ["comb"] if branch == "density" else ["f0", "f1", "f2", "fv"]
    if ln == 0:
        return first
    if _is_skip(skip_every, ln - 1):
        return ["x"] + first
    return ["x"]


@dataclasses.dataclass(frozen=True)
class PackedDecoder:
    """One decoder member in the kernel's layout.

    w:  [rows, 128] bf16, the layers' weight blocks stacked in order
        (density layers, then rgb layers); each block has one row group
        per input part of layer_inputs(), parts padded to cp/cvp rows.
    b:  [n_density + n_rgb, 128] f32 biases.
    wh: [2, 128, 16] bf16 heads: fc_rgb into cols 0:3, fc_alpha into
        col 3. bh: [16] f32 head bias (rgb 0:3, sigma 3).
    ws: w as the kernels stream it (pack_stream): the density blocks,
        then the rgb blocks, each branch zero-padded to SLICE_ROWS rows,
        in the wgmma B layout. whs: wh in the B layout (flat bf16).
    The plain version reads w and wh, the kernels ws and whs.
    """
    w: torch.Tensor
    b: torch.Tensor
    wh: torch.Tensor
    bh: torch.Tensor
    ws: torch.Tensor
    whs: torch.Tensor
    n_density: int
    n_rgb: int
    skip_every: int     # 0 = no skip layers
    cp: int
    cvp: int

    def part_width(self, name: str) -> int:
        return {"x": WIDTH, "fv": self.cvp}.get(name, self.cp)

    def layers(self):
        """[(branch, ln, row offset, K, part names)] in packing order."""
        out, off = [], 0
        for branch, n in (("density", self.n_density), ("rgb", self.n_rgb)):
            for ln in range(n):
                names = layer_inputs(branch, ln, self.skip_every)
                k = sum(self.part_width(nm) for nm in names)
                out.append((branch, ln, off, k, names))
                off += k
        return out


def to_b_layout(w: torch.Tensor) -> torch.Tensor:
    """[K, N] (K a multiple of 16, N of 8) -> flat, in the layout the
    wgmma B descriptor of csrc/decoder.cuh reads (no swizzle, K-major):
    per K step of 16 rows, [2 k-halves][N / 8 column groups][8 columns]
    [8 rows], i.e. 8x8 core matrices of 128 contiguous bytes."""
    k, n = w.shape
    return w.reshape(k // STEP_ROWS, 2, 8, n // 8, 8).permute(
        0, 1, 3, 4, 2).reshape(-1)


def pack_stream(w, d_rows: int) -> torch.Tensor:
    """The kernels' weight stream: w's density blocks (its first d_rows
    rows) and rgb blocks, each branch zero-padded to whole SLICE_ROWS
    slices, in the B layout."""
    parts = []
    for blk in (w[:d_rows], w[d_rows:]):
        pad = blk.new_zeros((_round_up(blk.shape[0], SLICE_ROWS)
                             - blk.shape[0], WIDTH))
        parts.append(to_b_layout(torch.cat([blk, pad])))
    return torch.cat(parts).contiguous()


def pack_decoder(params, cfg, member: int = 0) -> PackedDecoder:
    """Pack decoder `member` (JAX pytree layout, torch tensors) for the
    kernel; weights are rounded to bf16 and repacked into the kernels'
    layout once here."""
    if not supports(cfg):
        raise ValueError(f"the fused triplane kernel does not support {cfg}")
    m = params["members"][member]
    c, cv = cfg.num_plane_channels, cfg.viewdir_channels
    cp, cvp = _round_up(c, CH_ALIGN), _round_up(cv, CH_ALIGN)
    skip_every = cfg.skip_connect_every or 0
    dev = m["fc_rgb"]["w"].device
    src_rows = {"x": WIDTH, "comb": c, "f0": c, "f1": c, "f2": c, "fv": cv}
    pad_rows = {"x": WIDTH, "comb": cp, "f0": cp, "f1": cp, "f2": cp,
                "fv": cvp}

    blocks, biases = [], []
    for branch in ("density", "rgb"):
        for ln, layer in enumerate(m[branch]):
            w = layer["w"].float()
            row, parts = 0, []
            for name in layer_inputs(branch, ln, skip_every):
                n = src_rows[name]
                part = torch.zeros((pad_rows[name], WIDTH), device=dev)
                part[:n] = w[row:row + n]
                parts.append(part)
                row += n
            if row != w.shape[0] or w.shape[1] != WIDTH:
                raise ValueError(f"{branch} layer {ln}: weight shape "
                                 f"{tuple(w.shape)} does not match {cfg}")
            blocks.append(torch.cat(parts))
            biases.append(layer["b"].float())
    wh = torch.zeros((2, WIDTH, HEAD_COLS), device=dev)
    wh[0, :, :3] = m["fc_rgb"]["w"].float()
    wh[1, :, 3] = m["fc_alpha"]["w"].float()[:, 0]
    bh = torch.zeros(HEAD_COLS, device=dev)
    bh[:3] = m["fc_rgb"]["b"].float()
    bh[3] = m["fc_alpha"]["b"].float()[0]
    w = torch.cat(blocks).to(torch.bfloat16)
    wh = wh.to(torch.bfloat16)
    n_density = len(m["density"])
    d_rows = sum(blk.shape[0] for blk in blocks[:n_density])
    return PackedDecoder(
        w=w.contiguous(), b=torch.stack(biases).contiguous(),
        wh=wh.contiguous(), bh=bh.contiguous(),
        ws=pack_stream(w, d_rows),
        whs=torch.cat([to_b_layout(wh[0]), to_b_layout(wh[1])]).contiguous(),
        n_density=n_density, n_rgb=len(m["rgb"]), skip_every=skip_every,
        cp=cp, cvp=cvp)


def view_rows(vp_ray, cvp: int) -> torch.Tensor:
    """Per-ray view features [R, Cv] -> [R, cvp] bf16 kernel rows (one
    row per ray, broadcast over its samples in the kernel)."""
    r, cv = vp_ray.shape
    rows = torch.zeros((r, cvp), dtype=torch.bfloat16, device=vp_ray.device)
    rows[:, :cv] = vp_ray.to(torch.bfloat16)
    return rows


def geometry_args(box, rot) -> np.ndarray:
    """[24] f32 kernel geometry (host array, passed to the kernel by
    value): box min (3), box max (3), then rot[p, c, 1 + k] for p, c < 3
    and k < 2. `box` and `rot` may be tensors on any device."""
    box, rot = (x.detach().cpu().numpy() if torch.is_tensor(x) else x
                for x in (box, rot))
    box = np.asarray(box, dtype=np.float32)
    rot = np.asarray(rot, dtype=np.float32)
    return np.concatenate([box[0, :3], box[1, :3],
                           rot[:, :, 1:3].reshape(-1)]).astype(np.float32)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def plane_grids(origins, directions, z_vals, geom):
    """The kernel's point projection: rays x depths -> 3 x [R*S, 2] f32
    normalized plane coordinates (x, y)."""
    g = torch.as_tensor(geom, device=origins.device)
    lo, hi, rot = g[0:3], g[3:6], g[6:].reshape(3, 3, 2)
    pts = (origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
           ).reshape(-1, 3)
    n = 2.0 * (pts - lo) / (hi - lo) - 1.0
    grids = []
    for p in range(3):
        gx = n[:, 0] * rot[p, 0, 0] + n[:, 1] * rot[p, 1, 0] \
            + n[:, 2] * rot[p, 2, 0]
        gy = n[:, 0] * rot[p, 0, 1] + n[:, 1] * rot[p, 1, 1] \
            + n[:, 2] * rot[p, 2, 1]
        grids.append(torch.stack([gx, gy], dim=-1))
    return grids


# bicubic window rows (offsets from y0) in the kernel's summation order
CUBIC_ROWS = (0, 1, -1, 2)


def _bilinear_feature(cells, grid, h: int, w: int, align_corners: bool,
                      v1: bool = False):
    x, y, x0, x1, y0, y1 = _corners(grid, h, w, align_corners)
    tx = (x - torch.floor(x))[:, None]
    ty = (y - torch.floor(y))[:, None]
    w0, w1 = _bf16(1.0 - tx), _bf16(tx)
    v00, v01 = cells[y0 * w + x0].float(), cells[y0 * w + x1].float()
    v10, v11 = cells[y1 * w + x0].float(), cells[y1 * w + x1].float()
    top = w0 * v00 + w1 * v01
    bot = w0 * v10 + w1 * v11
    if v1:
        return _bf16(top) * (1.0 - ty) + _bf16(bot) * ty
    return top + ty * (bot - top)


def _cubic_feature(cells, grid, h: int, w: int, align_corners: bool):
    cols, rows, tx, ty = cubic_taps(grid, h, w, align_corners)
    wx = [cubic_weight((i - 1) - tx) for i in range(4)]
    feat = None
    for dy in CUBIC_ROWS:
        wy = cubic_weight(dy - ty)
        base = rows[:, dy + 1] * w
        row = None
        for i in range(4):
            term = _bf16(wx[i] * wy) * cells[base + cols[:, i]].float()
            row = term if row is None else row + term
        feat = row if feat is None else feat + row
    return feat


def gather_features(table, origins, directions, z_vals, geom,
                    align_corners: bool, cubic: bool = False):
    """The kernel's plane gather: -> 3 x [R*S, Cp] f32 features."""
    _, h, w, cp = table.shape
    sample = _cubic_feature if cubic else _bilinear_feature
    return [sample(table[p].reshape(h * w, cp), grid, h, w, align_corners)
            for p, grid in enumerate(plane_grids(origins, directions,
                                                 z_vals, geom))]


def decode_reference(packed: PackedDecoder, f0, f1, f2, view, *,
                     avg: bool, sigma_only: bool) -> torch.Tensor:
    """The kernels' decoder in plain PyTorch: f32 features [N, Cp] of the
    three planes and view rows [N, cvp] (any float type; None for
    sigma_only) -> [N, 4] f32 (rgb, sigma)."""
    n = f0.shape[0]
    comb = f0 + f1 + f2
    if avg:
        comb = comb / 3.0
    parts = {"comb": _bf16(comb), "f0": _bf16(f0), "f1": _bf16(f1),
             "f2": _bf16(f2)}
    if not sigma_only:
        parts["fv"] = _bf16(view.float())
    w = packed.w.float()
    acts = {}
    for li, (branch, ln, off, k, names) in enumerate(packed.layers()):
        if branch == "rgb" and sigma_only:
            break
        x = torch.cat([acts[branch] if nm == "x" else parts[nm]
                       for nm in names], dim=-1)
        y = x @ w[off:off + k] + packed.b[li]
        acts[branch] = _bf16(torch.relu(y))
    wh = packed.wh.float()
    sigma = (acts["density"] @ wh[1])[:, 3:4] + packed.bh[3]
    if sigma_only:
        rgb = packed.bh[:3].expand(n, 3)
    else:
        rgb = (acts["rgb"] @ wh[0])[:, :3] + packed.bh[:3]
    return torch.cat([rgb, sigma], dim=-1)


def fused_render_reference(table, packed: PackedDecoder, origins,
                           directions, z_vals, view, geom, *,
                           align_corners: bool, avg: bool, sigma_only: bool,
                           cubic: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [R, S, 4] f32."""
    r, s = z_vals.shape
    feats = gather_features(table, origins, directions, z_vals, geom,
                            align_corners, cubic)
    view_pts = None
    if not sigma_only:
        view_pts = view[:, None, :].expand(r, s, packed.cvp).reshape(
            r * s, packed.cvp)
    return decode_reference(packed, *feats, view_pts, avg=avg,
                            sigma_only=sigma_only).reshape(r, s, 4)


def fused_render_rays(table, packed: PackedDecoder, origins, directions,
                      z_vals, view: Optional[torch.Tensor], geom, *,
                      align_corners: bool, avg: bool, sigma_only: bool,
                      cubic: bool = False):
    """Gather + decode for rays [R, 3] x depths [R, S] ->
    ([R, S, 4] f32 ray-major, {"overflow_frac": 0.0}); geom from
    geometry_args; cubic: the bicubic gather.

    A CPU table runs the plain version; any other table goes to the
    kernel (kernels.triplane_render), which launches on a CUDA table and
    raises on any other device or on any failure."""
    kw = dict(align_corners=align_corners, avg=avg, sigma_only=sigma_only,
              cubic=cubic)
    if table.device.type == "cpu":
        out = fused_render_reference(table, packed, origins, directions,
                                     z_vals, view, geom, **kw)
    else:
        from nvsr_tpu_torch import kernels
        out = kernels.triplane_render(
            table, packed, origins.contiguous(), directions.contiguous(),
            z_vals.contiguous(), view, geom, **kw)
    return out, {"overflow_frac": 0.0}


def tiled_render_chunked_reference(table, packed: PackedDecoder, grids,
                                   view, *, align_corners: bool, avg: bool,
                                   sigma_only: bool,
                                   form: str = "v2") -> torch.Tensor:
    """Plain PyTorch version of the grids entries -> [N, 4] f32 (form and
    sigma_only as tiled_render_chunked takes them)."""
    _, h, w, cp = table.shape
    feats = [_bilinear_feature(table[p].reshape(h * w, cp), grids[p], h, w,
                               align_corners, v1=form == "v1")
             for p in range(3)]
    return decode_reference(packed, *feats, view, avg=avg,
                            sigma_only=sigma_only)


def tiled_render_chunked(table, packed: PackedDecoder, grids, view, *,
                         align_corners: bool, avg: bool, sigma_only: bool,
                         form: str = "v2"):
    """Gather + decode at given plane coordinates, bilinear: grids
    [3, N, 2] f32 normalized (x, y) of N points, view [N, cvp] bf16 rows
    (one per point; None for a v2 sigma_only call) -> ([N, 4] f32 in the
    points' order, {"overflow_frac": 0.0}).

    form: "v2" (the TPU default, `_mega_kernel_v2`) or "v1" (the TPU
    `_mega_kernel`, chosen there by NVSR_MEGA_V1=1): v1 rounds the
    x-interpolated rows to bf16 and always decodes in full, as that
    kernel ignores sigma_only; with sigma_only and no view it reads zero
    view rows, as JAX's caller passes.

    A CPU table runs the plain version; any other table goes to the
    kernel (kernels.triplane_render_grids), which launches on a CUDA
    table and raises on any other device or on any failure."""
    if form not in ("v1", "v2"):
        raise ValueError(f"form must be 'v1' or 'v2', got {form!r}")
    n = grids.shape[1]
    if form == "v1" and sigma_only:
        sigma_only = False
        if view is None:
            view = torch.zeros((n, packed.cvp), dtype=torch.bfloat16,
                               device=table.device)
    kw = dict(align_corners=align_corners, avg=avg, sigma_only=sigma_only)
    if table.device.type == "cpu":
        out = tiled_render_chunked_reference(table, packed, grids, view,
                                             form=form, **kw)
    else:
        from nvsr_tpu_torch import kernels
        out = kernels.triplane_render_grids(
            table, packed, grids.contiguous(), view, v1=form == "v1", **kw)
    return out, {"overflow_frac": 0.0}
