"""Plain PyTorch triplane NeRF training with EDSR plane super-resolution,
in f32.

The benchmark's statement of one stage-1 training iteration of Neural
Volume Super-Resolution (Bahat et al., arXiv 2212.04666) as its code
base configures it in `config/TrainModels.yml`:

* the scene box: every view's rays through 12 x 12 pixels spread over
  the image's edges, at near and at far, bound the positions; the view
  box is azimuth [-pi, pi] x elevation [-pi/2, pi/2]. An HR scene uses
  the box of its LR couple;
* rays through the drawn pixels of the view at its downsampling d
  (`render.rays_at`, offset (d - 1) / 2d), against the view's pixels
  averaged over d x d blocks;
* 64 stratified, jittered depths over [near, far]; a point's features:
  its coordinates normalised into the box and projected onto three
  planes ((y, z), (x, z), (x, y)), each sampled bilinearly with border
  clamping and aligned corners; the view plane sampled at the ray's
  (azimuth, elevation);
* the decoder: a density branch on the mean of the three features, an
  rgb branch on the three features and the view feature concatenated,
  each `layers` linear layers with relu (a skip concatenation of the
  branch input before layer l when (l - 1) > 0 and (l - 1) % every ==
  0), heads fc_alpha and fc_rgb. The coarse decoder decodes the coarse
  depths in full, composited with density noise;
* 64 fine depths from the coarse weights (sorted uniforms), merged with
  the coarse ones, decoded by the fine decoder on the fine planes: the
  scene's LR planes on an LR iteration, the plane SR of them on an HR
  iteration;
* the plane SR: SR(planes) = EDSR(replicate-pad(planes)) cropped to
  s x the plane, plus the planes upsampled s x bilinearly (aligned
  corners). EDSR runs VALID 3x3 convolutions without bias: an input
  conv, residual blocks conv-relu-conv scaled by 0.1 onto an identity
  cropped by the block's margin, a mid conv, per x2 a conv and a pixel
  shuffle, an output conv. The pad is the ceiling of the trunk's halo in
  input pixels, and the crop what the ceiling overshoots at the output;
* loss: mean squared error of coarse and of fine rgb, summed; Adam (b1
  0.9, b2 0.999, eps 1e-8) on the scene's planes (one Adam a scene) and
  on both decoders every iteration, on the EDSR on HR iterations, each
  at its configured rate.

Every matmul and convolution is f32 (the caller turns TF32 off, or on
for the control). The residual blocks are recomputed in the backward
(torch.utils.checkpoint), which changes no number. Nothing of the
measured program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference import render
from gpubench.reference.nerf import Adam, leaves

# --- the scene box ----------------------------------------------------


def scene_box(poses, height, width, focal, near, far):
    """[2, 5] (min, max) of x, y, z, azimuth, elevation over views with
    camera-to-world `poses` [F, 4, 4] (numpy), in f32."""
    def edge(n):
        return np.unique(np.round(np.linspace(0, n - 1, 12)).astype(int))

    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for pose in np.asarray(poses, np.float64):
        for col in edge(width):
            for row in edge(height):
                cam = np.array([(col - width / 2) / focal,
                                -(row - height / 2) / focal, -1.0])
                d = pose[:3, :3] @ cam
                for t in (near, far):
                    p = pose[:3, 3] + t * d
                    lo, hi = np.minimum(lo, p), np.maximum(hi, p)
    return np.array([[*lo, -np.pi, -np.pi / 2], [*hi, np.pi, np.pi / 2]],
                    np.float32)


# --- the plane SR -----------------------------------------------------

def edsr_margins(n_blocks, scale):
    """(replicate pad of the input, crop of the output): the trunk's halo
    measured in input pixels is 1 (input conv) + 2 per block + 1 (mid) +
    one output pixel's worth per x2 stage and for the output conv."""
    n_up = int(math.log2(scale))
    halo = 1 + 2 * n_blocks + 1
    step = 1.0
    for _ in range(n_up):
        halo += step
        step /= 2
    halo += step
    pad = math.ceil(halo)
    return pad, pad * scale - int(halo * scale)


def _block(blk, h):
    y = F.conv2d(torch.relu(F.conv2d(h, blk["conv1"]["w"])),
                 blk["conv2"]["w"])
    return h[:, :, 2:-2, 2:-2] + 0.1 * y


def edsr(params, x):
    """EDSR trunk of params {"conv_input", "blocks": [{"conv1", "conv2"}],
    "conv_mid", "upscale": [...], "conv_output"} (OIHW weights "w") on
    x [N, C, H, W], VALID convolutions."""
    h = F.conv2d(x, params["conv_input"]["w"])
    for blk in params["blocks"]:
        if torch.is_grad_enabled():
            h = checkpoint(_block, blk, h, use_reentrant=False)
        else:
            h = _block(blk, h)
    h = F.conv2d(h, params["conv_mid"]["w"])
    for up in params["upscale"]:
        h = F.pixel_shuffle(F.conv2d(h, up["w"]), 2)
    return F.conv2d(h, params["conv_output"]["w"])


def upsample(planes, scale):
    """[..., H, W] upsampled s x bilinearly with aligned corners, as two
    interpolation matrices (weights worked out in float64)."""
    def weights(n):
        src = torch.arange(n * scale, dtype=torch.float64) * (
            (n - 1) / (n * scale - 1))
        lo = src.floor().clamp(max=n - 2).long()
        frac = src - lo
        m = torch.zeros(n * scale, n, dtype=torch.float64)
        m[torch.arange(n * scale), lo] = 1 - frac
        m[torch.arange(n * scale), lo + 1] += frac
        return m.to(planes.device, planes.dtype)

    h, w = planes.shape[-2:]
    return torch.einsum("oh,...hw,pw->...op", weights(h), planes,
                        weights(w))


def plane_sr(params, planes, scale):
    """[P, C, H, W] -> SR planes [P, C, sH, sW]."""
    pad, crop = edsr_margins(len(params["blocks"]), scale)
    diff = edsr(params, F.pad(planes, (pad,) * 4, mode="replicate"))
    if crop:
        diff = diff[..., crop:-crop, crop:-crop]
    return diff + upsample(planes, scale)


# --- the decoder ------------------------------------------------------

PLANE_AXES = ((1, 2), (0, 2), (0, 1))


def sample_plane(plane, grid):
    """plane [C, H, W] at grid [N, 2] (x along W, y along H, in [-1, 1])
    -> [N, C], bilinear, border, aligned corners."""
    out = F.grid_sample(plane[None], grid[None, :, None, :],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[0, :, :, 0].T


def _branch(layers, head, x_in, every):
    x = x_in
    for num, p in enumerate(layers):
        if num - 1 > 0 and (num - 1) % every == 0:
            x = torch.cat([x, x_in], -1)
        x = torch.relu(x @ p["w"] + p["b"])
    return x @ head["w"] + head["b"]


def decode(member, feats, view, every):
    """[N, 4] (rgb logits, sigma logit) of features [3, N, C] and view
    features [N, Cv]."""
    alpha = _branch(member["density"], member["fc_alpha"], feats.mean(0),
                    every)
    x = torch.cat([feats[0], feats[1], feats[2], view], -1)
    return torch.cat([_branch(member["rgb"], member["fc_rgb"], x, every),
                      alpha], -1)


def point_features(planes, pts, box):
    """[3, N, C] features of world points [N, 3] in `box` [2, >= 3]."""
    xyz = 2.0 * (pts - box[0, :3]) / (box[1, :3] - box[0, :3]) - 1.0
    return torch.stack([sample_plane(p, xyz[:, list(a)])
                        for p, a in zip(planes, PLANE_AXES)])


def view_features(plane_view, dirs, box):
    """[N, Cv] view-plane features of unit directions [N, 3]."""
    el = torch.atan2(dirs[:, 2], dirs[:, :2].norm(dim=-1))
    az = torch.atan2(dirs[:, 1], dirs[:, 0])
    azel = torch.stack([az, el], -1)
    g = 2.0 * (azel - box[0, 3:5]) / (box[1, 3:5] - box[0, 3:5]) - 1.0
    return sample_plane(plane_view, g)


def _pass(member, planes, view, box, o, d, z, every):
    r, s = z.shape
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    v = view[:, None].expand(r, s, view.shape[-1]).reshape(r * s, -1)
    return decode(member, point_features(planes, pts, box), v,
                  every).reshape(r, s, 4)


# --- one iteration, and the iterations that follow --------------------

def loss(state, batch, cfg, gen):
    """The rendering loss of one iteration. state: {"dc", "df" (decoders
    {"members": [member]}), "sr" ({"inner": EDSR}), "planes" ({scene:
    {"pos", "view"}})}; batch: origins, directions [R, 3], target [R, 3],
    scene (the saved planes' key), box (tensor), sr (an HR iteration)."""
    o, d, box = batch["origins"], batch["directions"], batch["box"]
    planes = state["planes"][batch["scene"]]
    lr = planes["pos"]
    fine = plane_sr(state["sr"]["inner"], lr, cfg["scale"]) \
        if batch["sr"] else lr
    vd = d / d.norm(dim=-1, keepdim=True)
    view = view_features(planes["view"], vd, box)
    near = torch.full_like(d[:, :1], cfg["near"])
    far = torch.full_like(d[:, :1], cfg["far"])
    every = cfg["skip"]
    z = render.stratified(near, far, cfg["n_coarse"], perturb=True, gen=gen)
    raw = _pass(state["dc"]["members"][0], lr, view, box, o, d, z, every)
    rgb_c, w = render.composite(raw, z, d, cfg["noise_std"], gen)
    zf = render.fine_depths(z, w, cfg["n_fine"], det=False, gen=gen)
    raw = _pass(state["df"]["members"][0], fine, view, box, o, d, zf, every)
    rgb_f, _ = render.composite(raw, zf, d, cfg["noise_std"], gen)
    tgt = batch["target"]
    return ((rgb_c - tgt) ** 2).mean() + ((rgb_f - tgt) ** 2).mean()


def train(state, batches, cfg, gen):
    """Follow len(batches) iterations from `state` (modified in place):
    -> (losses, first gradients [(path, g)]: each group's gradient at its
    first step, state after). Paths: /dc/..., /df/..., /sr/...,
    /planes/<scene>/pos|view."""
    dec = leaves({"dc": state["dc"], "df": state["df"]})
    sr = leaves({"sr": state["sr"]})
    opt_dec = Adam([t for _, t in dec], cfg["lr"])
    opt_sr = Adam([t for _, t in sr], cfg["sr_lr"])
    opt_planes = {}
    losses, first = [], {}
    for b in batches:
        pl = leaves({"planes": {b["scene"]: state["planes"][b["scene"]]}})
        groups = [("dec", dec, opt_dec), (b["scene"], pl, None)]
        if b["sr"]:
            groups.append(("sr", sr, opt_sr))
        if b["scene"] not in opt_planes:
            opt_planes[b["scene"]] = Adam([t for _, t in pl],
                                          cfg["planes_lr"])
        named = [x for _, g, _ in groups for x in g]
        tensors = [t for _, t in named]
        for t in tensors:
            t.requires_grad_(True)
        value = loss(state, b, cfg, gen)
        grads = torch.autograd.grad(value, tensors)
        for t in tensors:
            t.requires_grad_(False)
        losses.append(float(value.detach()))
        at = 0
        for key, g, opt in groups:
            gs = grads[at:at + len(g)]
            at += len(g)
            opt = opt or opt_planes[key]
            if opt.t == 0:
                for (n, _), x in zip(g, gs):
                    first[n] = x.detach().clone()
            opt.step(gs)
    return losses, list(first.items()), state
