"""Plain PyTorch volume rendering: rays, depth sampling, compositing.

The benchmark's own statement of what a NeRF render computes, written
from the published method (Mildenhall et al. 2020, arXiv 2003.08934;
Mip-NeRF, arXiv 2103.13415) with the sampling rules of the Neural Volume
Super-Resolution code base (arXiv 2212.04666): the +1e-5 weight floor of
the inverse CDF, the right-sided bucket search, the 1e-5 denominator
floor, sorted fine samples merged with the coarse ones, 1e10 for the
last interval outside mip. It imports nothing of the measured
program.

Random draws come from a torch.Generator, in this order per pass:
uniform jitter [R, S], density noise [R, S], exponentials [R, F + 1]
for sorted fine uniforms; a generator seeded alike therefore draws the
numbers of any render that follows the same order.
"""

from __future__ import annotations

import torch


def rays_at(rows, cols, height, width, focal, c2w, offset=0.0):
    """Pinhole rays through pixels (rows, cols) of a height x width view
    with camera-to-world c2w [4, 4]: (origins [N, 3], directions [N, 3],
    not normalised); `offset` is the sub-pixel shift of a downsampled
    view."""
    x = cols.to(c2w.dtype) + offset
    y = rows.to(c2w.dtype) + offset
    d_cam = torch.stack([(x - width * 0.5) / focal,
                         -(y - height * 0.5) / focal,
                         -torch.ones_like(x)], dim=-1)
    d = d_cam @ c2w[:3, :3].T
    return c2w[:3, 3].expand(d.shape), d


def linspace01(n, like):
    """n evenly spaced values on [0, 1] as i * f32(1 / (n - 1)), the last
    exactly 1."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    step = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    return torch.where(i == n - 1, torch.ones_like(i), i * step.item())


def stratified(near, far, n, perturb, gen=None):
    """[R, n] depths from near to far ([R, 1]), jittered in their strata
    with uniforms from `gen` when perturb."""
    z = near + (far - near) * linspace01(n, near)
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        hi = torch.cat([mids, z[:, -1:]], -1)
        lo = torch.cat([z[:, :1], mids], -1)
        u = torch.rand(z.shape, generator=gen, device=z.device)
        z = lo + (hi - lo) * u
    return z


def _running_sum(x):
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[:, k] = out[:, k - 1] + x[:, k]
    return out


def inverse_cdf(bins, weights, u):
    """Samples at uniforms u [R, F] of the piecewise-constant density
    `weights` [R, B - 1] over edges `bins` [R, B]."""
    w = weights + 1e-5
    pdf = w / _running_sum(w)[:, -1:]
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), _running_sum(pdf)], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    last = bins.shape[-1] - 1
    b_lo = bins.gather(-1, torch.clamp(lo, max=last))
    b_hi = bins.gather(-1, torch.clamp(hi, max=last))
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def fine_depths(z, weights, n_fine, det, gen=None, mip=False):
    """Coarse depths z [R, S] with n_fine more drawn from the coarse
    weights (deterministic quantiles when det, else sorted uniforms from
    exponentials), merged in order. With mip z holds interval edges."""
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    if mip:
        mid = 0.5 * (mid[:, 1:] + mid[:, :-1])
    r = z.shape[0]
    if det:
        u = linspace01(n_fine, z).expand(r, n_fine)
    else:
        e = torch.empty((r, n_fine + 1), device=z.device).exponential_(
            generator=gen)
        c = torch.cumsum(e, -1)
        u = c[:, :-1] / c[:, -1:]
    s = inverse_cdf(mid, weights[:, 1:-1], u).detach()
    return torch.sort(torch.cat([z, s], -1), -1).values


def composite(raw, z, directions, noise_std=0.0, gen=None, mip=False):
    """(rgb [R, 3], weights [R, S]) of raw [R, S, 4] (rgb logits, density
    logit) at depths z ([R, S], or interval edges [R, S + 1] with mip);
    density noise drawn from `gen` when noise_std > 0."""
    dists = z[:, 1:] - z[:, :-1]
    if not mip:
        dists = torch.cat([dists, torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * directions.norm(dim=-1, keepdim=True)
    logit = raw[..., 3]
    if noise_std > 0 and gen is not None:
        logit = logit + noise_std * torch.randn(logit.shape, generator=gen,
                                                device=logit.device)
    alpha = 1.0 - torch.exp(-torch.relu(logit) * dists)
    alpha = torch.where((z[:, -1] - z[:, 0])[:, None] > 0, alpha,
                        torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    weights = alpha * trans
    rgb = (weights[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    return rgb, weights
