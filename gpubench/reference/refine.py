"""Plain PyTorch stage 3 of Neural Volume Super-Resolution, in f32.

The benchmark's statement of one iteration of `config/RefineOnTestScene.
yml` (Bahat et al., arXiv 2212.04666): the decoders and the EDSR plane
super-resolver of a stage-1 run and the LR planes of a new scene, refined
jointly on that scene. Everything of triplane.py's stage-1 iteration
holds (the scene box, the rays, the two passes, the plane SR, the
decoders, Adam), with these differences:

* the scene's LR views train its LR planes and both decoders (an "LR
  iteration", triplane.py's without the plane SR);
* a consistency iteration renders rays through whole ds x ds patches of
  the HR view (ds the ratio of the LR and HR downsamplings, 4 here),
  patch-major, decoding the fine pass on the plane SR of the LR planes;
  each patch's mean colour, coarse and fine, is held against the LR
  view's pixel, and the summed squared errors are weighted by
  im_inconsistency_loss_w for the gradient;
* the planes' and the decoders' Adams step on every iteration, the
  EDSR's (at super_resolution.lr) only on consistency iterations, the
  only ones whose loss reaches it.

The patch's rays are its pixels of the HR view (render.rays_at with
the HR view's offset (d - 1) / 2d), and its mean is unweighted, as the
code base's avg_downsampling takes it; the paper states the loss on a
downsampled render and does not say how its training samples it. No
other departure from triplane.py's statement. Nothing of the measured
program is imported.
"""

from __future__ import annotations

import torch

from gpubench.reference import render, triplane
from gpubench.reference.nerf import Adam, leaves


def loss(state, batch, cfg, gen):
    """(the rendering loss, the loss weighted for the gradient) of one
    iteration: triplane.loss's batch with `patch` (ds of a consistency
    iteration, else 0) and `weight`."""
    o, d, box = batch["origins"], batch["directions"], batch["box"]
    planes = state["planes"][batch["scene"]]
    lr = planes["pos"]
    fine = triplane.plane_sr(state["sr"]["inner"], lr, cfg["scale"]) \
        if batch["sr"] else lr
    vd = d / d.norm(dim=-1, keepdim=True)
    view = triplane.view_features(planes["view"], vd, box)
    near = torch.full_like(d[:, :1], cfg["near"])
    far = torch.full_like(d[:, :1], cfg["far"])
    every = cfg["skip"]
    z = render.stratified(near, far, cfg["n_coarse"], perturb=True, gen=gen)
    raw = triplane._pass(state["dc"]["members"][0], lr, view, box, o, d, z,
                         every)
    rgb_c, w = render.composite(raw, z, d, cfg["noise_std"], gen)
    zf = render.fine_depths(z, w, cfg["n_fine"], det=False, gen=gen)
    raw = triplane._pass(state["df"]["members"][0], fine, view, box, o, d,
                         zf, every)
    rgb_f, _ = render.composite(raw, zf, d, cfg["noise_std"], gen)
    k = batch["patch"]
    if k:
        rgb_c = rgb_c.reshape(-1, k * k, 3).mean(1)
        rgb_f = rgb_f.reshape(-1, k * k, 3).mean(1)
    tgt = batch["target"]
    total = ((rgb_c - tgt) ** 2).mean() + ((rgb_f - tgt) ** 2).mean()
    return total, batch["weight"] * total


def train(state, batches, cfg, gen):
    """Follow len(batches) iterations from `state` (modified in place), as
    triplane.train: -> (losses, first gradients [(path, g)], state
    after)."""
    dec = leaves({"dc": state["dc"], "df": state["df"]})
    sr = leaves({"sr": state["sr"]})
    opt_dec = Adam([t for _, t in dec], cfg["lr"])
    opt_sr = Adam([t for _, t in sr], cfg["sr_lr"])
    opt_planes = {}
    losses, first = [], {}
    for b in batches:
        pl = leaves({"planes": {b["scene"]: state["planes"][b["scene"]]}})
        if b["scene"] not in opt_planes:
            opt_planes[b["scene"]] = Adam([t for _, t in pl],
                                          cfg["planes_lr"])
        groups = [(dec, opt_dec), (pl, opt_planes[b["scene"]])]
        if b["sr"]:
            groups.append((sr, opt_sr))
        tensors = [t for g, _ in groups for _, t in g]
        for t in tensors:
            t.requires_grad_(True)
        value, weighted = loss(state, b, cfg, gen)
        grads = torch.autograd.grad(weighted, tensors)
        for t in tensors:
            t.requires_grad_(False)
        losses.append(float(value.detach()))
        at = 0
        for g, opt in groups:
            gs = grads[at:at + len(g)]
            at += len(g)
            if opt.t == 0:
                for (n, _), x in zip(g, gs):
                    first[n] = x.detach().clone()
            opt.step(gs)
    return losses, list(first.items()), state
