"""Plain PyTorch Mip-NeRF baseline training, in f32.

The benchmark's statement of one training iteration of the baseline in
the Neural Volume Super-Resolution code base (`config/MipNeRF_baseline.
yml`): Mip-NeRF (Barron et al., arXiv 2103.13415) with the code base's
MLP and its consistency iterations. For a batch of pixels:

* rays through the pixels (`render.rays_at`, with the sub-pixel offset
  (d - 1) / 2d of a d-times-downsampled view);
* coarse interval edges: S + 1 stratified, jittered depths; each
  interval a conical frustum of base radius d * 0.00135 * 2 / sqrt(12),
  approximated by a Gaussian (mean and diagonal covariance), encoded by
  the integrated positional encoding of degrees 0 .. L - 1 (sin half,
  then cos half as sin shifted by pi/2, degree-major);
* the MLP: layer1 (no activation), trunk layers with relu and a skip
  concatenation of the encoding before trunk layer i when i > 0 and i %
  skip == 0; sigma = fc_alpha(h); rgb = fc_rgb(relu(layers_dir([relu(
  fc_feat(h)), PE(viewdir)]))), PE with the input and 4 frequencies;
* compositing over the intervals with density noise; fine edges from
  the coarse weights over the midpoints of the midpoints (sorted
  uniforms), merged with the coarse edges; a fine MLP of its own;
* loss: mean squared error of coarse and fine rgb against the target,
  summed; on a consistency iteration the rays are ds x ds patches of an
  HR view, their rgb averaged per patch against the LR pixel, and the
  loss weighted by im_inconsistency_loss_w;
* Adam (b1 0.9, b2 0.999, eps 1e-8) on both MLPs.

Nothing of the measured program is imported.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import render


def posenc(x, n_freq, include_input=True):
    parts = [x] if include_input else []
    for i in range(n_freq):
        parts += [torch.sin((2.0 ** i) * x), torch.cos((2.0 ** i) * x)]
    return torch.cat(parts, -1)


def frustum_gaussians(t, origins, directions, radius):
    """Means and diagonal covariances [R, S, 3] of the conical frustums
    between consecutive edges t [R, S + 1]."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2.0, (t1 - t0) / 2.0
    den = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + 2.0 * mu * hw ** 2 / den
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * (
        hw ** 4 * (12.0 * mu ** 2 - hw ** 2) / den ** 2)
    r_var = radius ** 2 * (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                           - (4.0 / 15.0) * hw ** 4 / den)
    d = directions
    d2 = d ** 2
    perp = 1.0 - d2 / torch.clamp(d2.sum(-1, keepdim=True), min=1e-10)
    mean = d[:, None] * t_mean[..., None] + origins[:, None]
    cov = t_var[..., None] * d2[:, None] + r_var[..., None] * perp[:, None]
    return mean, cov


def ipe(mean, cov, n_deg):
    """Integrated positional encoding [..., 6 * n_deg]."""
    scales = 2.0 ** torch.arange(n_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (cov[..., None, :] * scales[:, None] ** 2).reshape(shape)
    y = torch.cat([y, y + 0.5 * math.pi], -1)
    return torch.exp(-0.5 * torch.cat([y_var, y_var], -1)) * torch.sin(y)


def mlp(p, enc_xyz, enc_dir, skip):
    """[N, 4] (rgb logits, sigma logit)."""
    def lin(layer, x):
        return x @ layer["w"] + layer["b"]

    h = lin(p["layer1"], enc_xyz)
    for i, layer in enumerate(p["layers_xyz"]):
        if i > 0 and i % skip == 0:
            h = torch.cat([h, enc_xyz], -1)
        h = torch.relu(lin(layer, h))
    alpha = lin(p["fc_alpha"], h)
    h = torch.cat([torch.relu(lin(p["fc_feat"], h)), enc_dir], -1)
    for layer in p["layers_dir"]:
        h = torch.relu(lin(layer, h))
    return torch.cat([lin(p["fc_rgb"], h), alpha], -1)


def render_pass(p, t, origins, directions, viewdirs, radius, cfg):
    r, s = t.shape[0], t.shape[1] - 1
    mean, cov = frustum_gaussians(t, origins, directions, radius)
    enc = ipe(mean, cov, cfg["ipe_degrees"]).reshape(r * s, -1)
    ed = posenc(viewdirs, cfg["dir_freqs"])
    ed = ed[:, None].expand(r, s, ed.shape[-1]).reshape(r * s, -1)
    return mlp(p, enc, ed, cfg["skip"]).reshape(r, s, 4)


def loss(params, batch, cfg, gen):
    """The rendering loss of one iteration. batch: origins, directions
    [R, 3], target [T, 3], radius, patch (ds of a consistency iteration,
    else 0), weight."""
    o, d = batch["origins"], batch["directions"]
    vd = d / d.norm(dim=-1, keepdim=True)
    near = torch.full_like(d[:, :1], cfg["near"])
    far = torch.full_like(d[:, :1], cfg["far"])
    t = render.stratified(near, far, cfg["n_coarse"] + 1, perturb=True,
                          gen=gen)
    raw = render_pass(params["dc"], t, o, d, vd, batch["radius"], cfg)
    rgb_c, w = render.composite(raw, t, d, cfg["noise_std"], gen, mip=True)
    tf = render.fine_depths(t, w, cfg["n_fine"] + 1, det=False, gen=gen,
                            mip=True)
    raw = render_pass(params["df"], tf, o, d, vd, batch["radius"], cfg)
    rgb_f, _ = render.composite(raw, tf, d, cfg["noise_std"], gen, mip=True)
    k = batch["patch"]
    if k:
        rgb_c = rgb_c.reshape(-1, k * k, 3).mean(1)
        rgb_f = rgb_f.reshape(-1, k * k, 3).mean(1)
    tgt = batch["target"]
    total = ((rgb_c - tgt) ** 2).mean() + ((rgb_f - tgt) ** 2).mean()
    return total, batch["weight"] * total


def leaves(tree, prefix=""):
    """[(path, tensor)] of a dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                        f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


class Adam:
    """Adam of one flat list of tensors, updated in place."""

    def __init__(self, tensors, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = tensors, lr, b1, b2, \
            eps
        self.m = [torch.zeros_like(x) for x in tensors]
        self.v = [torch.zeros_like(x) for x in tensors]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.p, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train(params, batches, cfg, gen):
    """Follow len(batches) iterations from `params` (modified in place):
    -> (losses, first gradients [(path, g)], params after)."""
    named = leaves(params)
    tensors = [t for _, t in named]
    opt = Adam(tensors, cfg["lr"])
    losses, first = [], None
    for b in batches:
        for t in tensors:
            t.requires_grad_(True)
        value, weighted = loss(params, b, cfg, gen)
        grads = torch.autograd.grad(weighted, tensors)
        for t in tensors:
            t.requires_grad_(False)
        losses.append(float(value.detach()))
        if first is None:
            first = [(n, g.detach().clone()) for (n, _), g in zip(named,
                                                                  grads)]
        opt.step(grads)
    return losses, first, params
