"""Depth sampling along rays (counterpart of nvsr_tpu/ops/sampling.py).

Randomness comes from an explicit `torch.Generator`, or the caller passes
the uniforms `u` itself (the tests feed the same numpy draws to the JAX
functions and to these). The JAX module's dense compares and one-hot
selects are TPU workarounds; here `torch.searchsorted(right=True)`,
`torch.gather` and `torch.sort` give the same values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nvsr_tpu_torch.ops import draws


def linspace01(num: int, like: torch.Tensor) -> torch.Tensor:
    """[num] evenly spaced values on [0, 1] with the reference's f32
    rounding: i * f32(1 / (num - 1)), last value exactly 1 (what
    jnp.linspace(0, 1, num) yields on the CPU; torch.linspace rounds a
    few entries differently)."""
    # made on the tensor's device without host values: a host array, or
    # a scalar stored into an element, costs a blocking copy per ray block
    i = torch.arange(num, dtype=like.dtype, device=like.device)
    if num == 1:
        return i
    return torch.where(i == num - 1, 1.0,
                       i * float(np.float32(1.0) / np.float32(num - 1)))


def stratified_z_vals(near, far, num_samples: int, *, lindisp: bool,
                      perturb: bool, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Coarse depths [R, num_samples] between near/far ([R, 1]).

    Keeps the monotone lerp near + (far - near) * t: the two-product form
    is non-monotone at the f32 ULP level when near ~= far, and the
    degenerate miss intervals of occupancy tightening (near == far) must
    give exactly constant z. perturb jitters each sample in its stratum
    with the uniforms `u` (drawn from `generator` when not given)."""
    t_vals = linspace01(num_samples, near)
    if not lindisp:
        z_vals = near + (far - near) * t_vals
    else:
        z_vals = 1.0 / (1.0 / near + (1.0 / far - 1.0 / near) * t_vals)
    z_vals = z_vals.expand(near.shape[:-1] + (num_samples,))
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if u is None:
            u = draws.rand(z_vals.shape, generator, dtype=z_vals.dtype,
                           device=z_vals.device)
        z_vals = lower + (upper - lower) * u
    return z_vals


def sample_pdf(bins, weights, num_samples: int, det: bool = False,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Inverse-transform samples [R, num_samples] from the piecewise
    constant PDF `weights` [R, B-1] over bin edges `bins` [R, B]."""
    shape = weights.shape[:-1] + (num_samples,)
    if det:
        u = linspace01(num_samples, bins).expand(shape)
    elif u is None:
        u = draws.rand(shape, generator, dtype=bins.dtype,
                       device=bins.device)
    return _invert_cdf(bins, weights, u)


def _cumsum_left(x):
    """Cumulative sum along the last axis, added strictly left to right.

    This is the order the reference's f32 sums and cumsums take on the
    CPU (torch.cumsum and torch.sum associate differently); the CDF
    inversion is discontinuous in the cdf values (bucket search, 1e-5
    denominator floor), so the same order keeps the samples equal."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


def _invert_cdf(bins, weights, u):
    """CDF inversion with the +1e-5 weight floor, the right-sided search
    and the 1e-5 denominator floor of the reference sampler."""
    weights = weights + 1e-5
    pdf = weights / _cumsum_left(weights)[..., -1:]
    cdf = _cumsum_left(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    bmax = bins.shape[-1] - 1
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=bmax))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=bmax))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sorted_uniform(shape, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device=None):
    """Sorted iid uniforms: normalized partial sums of n+1 exponentials."""
    n = shape[-1]
    e = draws.exponential(tuple(shape[:-1]) + (n + 1,), generator,
                          dtype=dtype, device=device)
    cums = torch.cumsum(e, dim=-1)
    return cums[..., :-1] / cums[..., -1:]


def merge_sorted(a, b):
    """Merge two per-row sorted arrays along the last axis."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def hierarchical_z_vals(z_vals, weights, num_fine: int, det: bool,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        mip: bool = False):
    """Fine depths: inverse-CDF resample from midpoint bins (edge weights
    dropped), merged with the coarse depths in sorted order. Without
    det, `u` must be sorted (drawn by sorted_uniform when not given).
    mip: z_vals are interval edges and weights are per interval, so the
    bins are the midpoints of the interval midpoints."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if mip:
        z_mid = 0.5 * (z_mid[..., 1:] + z_mid[..., :-1])
    if det:
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], num_fine,
                               det=True)
    else:
        if u is None:
            u = sorted_uniform(weights.shape[:-1] + (num_fine,),
                               generator=generator, dtype=z_vals.dtype,
                               device=z_vals.device)
        z_samples = _invert_cdf(z_mid, weights[..., 1:-1], u)
    return merge_sorted(z_vals, z_samples.detach())
