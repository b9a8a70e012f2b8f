"""Positional encodings (counterpart of nvsr_tpu/ops/encoding.py): the
classic sin/cos encoding and Mip-NeRF's integrated positional encoding
over conical-frustum Gaussians, with JAX's output order."""

from __future__ import annotations

import math

import torch


def positional_encoding(x, num_encoding_functions: int = 6,
                        include_input: bool = True):
    """[..., D] -> [..., D * (include + 2 * num_fn)], frequency-major: for
    each i, sin(2^i x) then cos(2^i x)."""
    encoding = [x] if include_input else []
    for i in range(num_encoding_functions):
        encoding.append(torch.sin((2.0 ** i) * x))
        encoding.append(torch.cos((2.0 ** i) * x))
    if len(encoding) == 1:
        return encoding[0]
    return torch.cat(encoding, dim=-1)


def lift_gaussian(d, t_mean, t_var, r_var):
    """A Gaussian along a ray, lifted to 3D with a diagonal covariance:
    (mean [..., S, 3], cov_diag [..., S, 3])."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(d, t0, t1, base_radius: float):
    """The Gaussian approximation of the conical frustum between t0 and
    t1 along d; base_radius is a Python float (no per-call copy)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    t_mean = mu + (2.0 * mu * hw ** 2) / (3.0 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3.0 - (4.0 / 15.0) * (
        (hw ** 4 * (12.0 * mu ** 2 - hw ** 2))
        / (3.0 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * (
        (mu ** 2) / 4.0 + (5.0 / 12.0) * hw ** 2
        - (4.0 / 15.0) * (hw ** 4) / (3.0 * mu ** 2 + hw ** 2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(t_vals, origins, directions, radii: float):
    """Conical frustums between consecutive t values: t_vals [..., S+1],
    origins/directions [..., 3] -> (means [..., S, 3], cov_diags
    [..., S, 3])."""
    means, covs = conical_frustum_to_gaussian(directions, t_vals[..., :-1],
                                              t_vals[..., 1:], radii)
    return means + origins[..., None, :], covs


def expected_sin(x, x_var):
    """E[sin(z)] for z ~ N(x, x_var)."""
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def integrated_positional_encoding(means_covs, min_deg: int = 0,
                                   max_deg: int = 16):
    """IPE of a diagonal Gaussian (x [..., 3], x_cov_diag [..., 3]) ->
    [..., 3 * 2 * (max_deg - min_deg)]: degree-major, xyz minor, the sin
    half then the cos half (sin shifted by pi/2)."""
    x, x_cov_diag = means_covs
    # powers of two made on the device: exact, and no host copy per call
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    shape = tuple(x.shape[:-1]) + (-1,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_cov_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                        torch.cat([y_var, y_var], dim=-1))


def make_ipe_encoder(multires: int = 10):
    """IPE encoder with the reference's constructor convention: degrees
    0 .. multires - 2, output dim 3 * 2 * (multires - 1) (`out_dims`)."""
    max_deg = multires - 1

    def encode(means_covs):
        return integrated_positional_encoding(means_covs, min_deg=0,
                                              max_deg=max_deg)
    encode.out_dims = 3 * 2 * max_deg
    return encode
