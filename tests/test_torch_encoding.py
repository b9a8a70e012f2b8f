"""nvsr_tpu_torch.ops.encoding against nvsr_tpu.ops.encoding on the same
numpy-seeded inputs.

Tolerances: the sin/cos encoding and the frustum Gaussians are the same
f32 formulas, atol 1e-6 / rtol 1e-6 (measured: 6e-8 and 2.5e-8 of the
largest covariance, from the order of the 3-term |d|^2 sum). The IPE is
held degree by degree at the baseline's real geometry (degrees 0..15,
num_encoding_fn_xyz 16, rays from radius 4 over t in [2, 6], the mip
pixel radius of ds 8 and ds 2): the means are scaled by up to 2^15
before sin, where two libraries' range reductions may differ, and the
variance damps a degree by exp(-var * 4^deg / 2). Measured on the CPU:
1.2e-7 at most in every degree (one f32 ulp of values near 1; sin of
arguments up to ~2e3 still agrees), and every degree from 12 (ds 8) or
14 (ds 2) on damped to exactly 0 in both. Bound: 2.5e-7 per degree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.ops import encoding as je
from nvsr_tpu_torch.ops import encoding as te

IPE_ATOL = 2.5e-7


def _rays(rng, r=128, s=64):
    """Rays from a circle of radius 4 at height 2 toward the origin, with
    jittered interval edges in [2, 6] ([r, s+1])."""
    t = np.broadcast_to(np.linspace(2, 6, s + 1, dtype=np.float32),
                        (r, s + 1)).copy()
    t[:, 1:-1] += rng.uniform(-0.02, 0.02, (r, s - 1)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, r)
    o = np.stack([4 * np.cos(ang), 4 * np.sin(ang), 2 + 0 * ang],
                 -1).astype(np.float32)
    d = (-o + 0.3 * rng.standard_normal((r, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return t, o, d


@pytest.mark.parametrize("include", [True, False])
def test_positional_encoding(rng, include):
    x = (3 * rng.standard_normal((50, 3))).astype(np.float32)
    ref = np.asarray(je.positional_encoding(jnp.asarray(x), 10, include))
    out = te.positional_encoding(torch.tensor(x), 10, include).numpy()
    assert out.shape == ref.shape == (50, 3 * (int(include) + 20))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_positional_encoding_no_functions_is_identity(rng):
    x = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        te.positional_encoding(torch.tensor(x), 0, True).numpy(), x)


def test_lift_gaussian_and_frustum(rng):
    t, o, d = _rays(rng, r=32, s=8)
    t0, t1 = t[:, :-1], t[:, 1:]
    r = 8 * 0.00135 * 2 / np.sqrt(12)
    ref = je.conical_frustum_to_gaussian(jnp.asarray(d), jnp.asarray(t0),
                                         jnp.asarray(t1), r)
    out = te.conical_frustum_to_gaussian(torch.tensor(d), torch.tensor(t0),
                                         torch.tensor(t1), r)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(a).max()))
    tm, tv, rv = (rng.random((32, 8)).astype(np.float32) for _ in range(3))
    ref = je.lift_gaussian(jnp.asarray(d), jnp.asarray(tm), jnp.asarray(tv),
                           jnp.asarray(rv))
    out = te.lift_gaussian(torch.tensor(d), torch.tensor(tm),
                           torch.tensor(tv), torch.tensor(rv))
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_cast_rays_and_expected_sin(rng):
    t, o, d = _rays(rng, r=32, s=16)
    r = 2 * 0.00135 * 2 / np.sqrt(12)
    mj, cj = je.cast_rays(jnp.asarray(t), jnp.asarray(o), jnp.asarray(d), r)
    mt, ct = te.cast_rays(torch.tensor(t), torch.tensor(o), torch.tensor(d),
                          r)
    assert tuple(mt.shape) == tuple(ct.shape) == (32, 16, 3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6 * float(np.abs(cj).max()))
    x = (5 * rng.standard_normal((64,))).astype(np.float32)
    v = rng.random((64,)).astype(np.float32)
    np.testing.assert_allclose(
        te.expected_sin(torch.tensor(x), torch.tensor(v)).numpy(),
        np.asarray(je.expected_sin(jnp.asarray(x), jnp.asarray(v))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ds", [8, 2])
def test_ipe_degree_by_degree_at_the_baseline_geometry(rng, ds):
    """IPE of degrees 0..15 (the YAML's num_encoding_fn_xyz 16), each
    package from its own cast_rays, held per degree within IPE_ATOL."""
    t, o, d = _rays(rng)
    r = ds * 0.00135 * 2 / np.sqrt(12)
    ref = np.asarray(je.integrated_positional_encoding(
        je.cast_rays(jnp.asarray(t), jnp.asarray(o), jnp.asarray(d), r),
        min_deg=0, max_deg=16))
    out = te.integrated_positional_encoding(
        te.cast_rays(torch.tensor(t), torch.tensor(o), torch.tensor(d), r),
        min_deg=0, max_deg=16).numpy()
    assert out.shape == ref.shape == (128, 64, 96)
    # [..., (sin|cos), degree, xyz]
    per_degree = np.abs(out - ref).reshape(128, 64, 2, 16, 3).max(
        axis=(0, 1, 2, 4))
    assert np.all(per_degree <= IPE_ATOL), per_degree
    # the high degrees are damped to zero in both
    top = 12 if ds == 8 else 14
    assert np.all(out.reshape(128, 64, 2, 16, 3)[:, :, :, top:] == 0)


@pytest.mark.parametrize("multires", [5, 17])
def test_make_ipe_encoder(rng, multires):
    enc_j, enc_t = je.make_ipe_encoder(multires), te.make_ipe_encoder(
        multires)
    assert enc_t.out_dims == enc_j.out_dims == 3 * 2 * (multires - 1)
    m = rng.standard_normal((6, 3)).astype(np.float32)
    c = (0.01 * rng.random((6, 3))).astype(np.float32)
    out = enc_t((torch.tensor(m), torch.tensor(c))).numpy()
    ref = np.asarray(enc_j((jnp.asarray(m), jnp.asarray(c))))
    assert out.shape == (6, enc_t.out_dims)
    np.testing.assert_allclose(out, ref, rtol=0, atol=IPE_ATOL)
