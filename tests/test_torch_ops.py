"""nvsr_tpu_torch.ops (geometry, occupancy, sampling, rendering,
grid_sample, resize) against nvsr_tpu.ops on the same numpy inputs, in
f32 on the CPU. Tolerances are atol 1e-5 (1e-4 where a division or a
transcendental amplifies one ULP), rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.ops import geometry as jg
from nvsr_tpu.ops import grid_sample as jgs
from nvsr_tpu.ops import occupancy as jo
from nvsr_tpu.ops import rendering as jr
from nvsr_tpu.ops import resize as jrs
from nvsr_tpu.ops import sampling as js
from nvsr_tpu_torch.ops import geometry as tg
from nvsr_tpu_torch.ops import grid_sample as tgs
from nvsr_tpu_torch.ops import occupancy as to
from nvsr_tpu_torch.ops import rendering as tr
from nvsr_tpu_torch.ops import resize as trs
from nvsr_tpu_torch.ops import sampling as ts
from torch_port_helpers import t


def close(a, b, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.uniform(-4, 4, 3)
    return c2w


@pytest.mark.parametrize("focal,offset", [(40.0, 0.0), ([38.0, 41.0], 0.375)])
def test_get_ray_bundle(rng, focal, offset):
    c2w = _pose(rng)
    jo_, jd = jg.get_ray_bundle(12, 10, focal, jnp.asarray(c2w),
                                downsampling_offset=offset)
    to_, td = tg.get_ray_bundle(12, 10, focal, t(c2w),
                                downsampling_offset=offset)
    close(to_, jo_)
    close(td, jd)


def test_ndc_and_az_el_and_normalize(rng):
    ro = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    ro[:, 2] -= 3.0
    rd = rng.standard_normal((64, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    for a, b in zip(jg.ndc_rays(20, 30, 25.0, 1.0, jnp.asarray(ro),
                                jnp.asarray(rd)),
                    tg.ndc_rays(20, 30, 25.0, 1.0, t(ro), t(rd))):
        close(b, a, atol=1e-4)
    dirs = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    close(tg.cart2az_el(t(dirs)), jg.cart2az_el(jnp.asarray(dirs)))
    box = np.array([[-2, -1, -3], [2, 3, 1]], np.float32)
    close(tg.normalize_coords(t(ro), box),
          jg.normalize_coords(jnp.asarray(ro), box))


def test_tighten_near_far_with_miss_rays(rng):
    R = 256
    ro = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd[:8, 1:] = 0.0                      # axis-aligned: the eps guard
    near = np.full((R, 1), 0.5, np.float32)
    far = np.full((R, 1), 7.0, np.float32)
    aabb = np.array([[-1, -1.2, -0.8], [1.1, 0.9, 1.3]], np.float32)
    jn, jf, jh = jo.tighten_near_far(jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(near), jnp.asarray(far),
                                     jnp.asarray(aabb))
    tn, tf, th = to.tighten_near_far(t(ro), t(rd), t(near), t(far), t(aabb))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 0 < th.sum() < R               # both hit and miss rays
    close(tn, jn)
    close(tf, jf)
    miss = ~th.numpy()[:, 0]
    np.testing.assert_array_equal(tn.numpy()[miss], tf.numpy()[miss])


@pytest.mark.parametrize("lindisp,perturb", [(False, False), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("n", [16, 32])
def test_stratified_z_vals(rng, lindisp, perturb, n):
    R = 40
    near = rng.uniform(1.5, 2.5, (R, 1)).astype(np.float32)
    far = near + rng.uniform(0, 4, (R, 1)).astype(np.float32)
    far[:4] = near[:4]                    # degenerate miss intervals
    u = rng.uniform(size=(R, n)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jz = js.stratified_z_vals(key, jnp.asarray(near), jnp.asarray(far), n,
                              lindisp=lindisp, perturb=perturb)
    if perturb:   # same jitter on both sides
        u = np.asarray(jax.random.uniform(key, (R, n)))
    tz = ts.stratified_z_vals(t(near), t(far), n, lindisp=lindisp,
                              perturb=perturb, u=t(u))
    if not perturb and not lindisp:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        assert np.all(np.diff(tz.numpy(), axis=-1) >= 0)
    close(tz, jz)


def _weights(rng, R, n):
    w = rng.uniform(0, 1, (R, n)).astype(np.float32) ** 4
    w[:3] = 0.0
    return w


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf(rng, det):
    R, B, n = 32, 15, 16
    bins = np.sort(rng.uniform(2, 6, (R, B)), axis=-1).astype(np.float32)
    w = _weights(rng, R, B - 1)
    u = np.sort(rng.uniform(size=(R, n)), axis=-1).astype(np.float32)
    if det:
        jout = js.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), n,
                             det=True)
        tout = ts.sample_pdf(t(bins), t(w), n, det=True)
    else:
        jout = js._invert_cdf(jnp.asarray(bins), jnp.asarray(w),
                              jnp.asarray(u))
        tout = ts.sample_pdf(t(bins), t(w), n, u=t(u))
    close(tout, jout, atol=1e-4)


@pytest.mark.parametrize("det", [True, False])
def test_hierarchical_z_vals(rng, det):
    R, S, n = 32, 16, 16
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    w = _weights(rng, R, S)
    u = np.sort(rng.uniform(size=(R, n)), axis=-1).astype(np.float32)
    if det:
        jz = js.hierarchical_z_vals(None, jnp.asarray(z), jnp.asarray(w), n,
                                    det=True)
    else:
        z_mid = 0.5 * (jnp.asarray(z)[..., 1:] + jnp.asarray(z)[..., :-1])
        jz = js.merge_sorted(jnp.asarray(z), js._invert_cdf(
            z_mid, jnp.asarray(w)[..., 1:-1], jnp.asarray(u)))
    tz = ts.hierarchical_z_vals(t(z), t(w), n, det=det, u=t(u))
    close(tz, jz, atol=1e-4)
    assert np.all(np.diff(tz.numpy(), axis=-1) >= 0)


def test_merge_sorted_with_ties(rng):
    a = np.sort(rng.integers(0, 6, (16, 9)), axis=-1).astype(np.float32)
    b = np.sort(rng.integers(0, 6, (16, 7)), axis=-1).astype(np.float32)
    np.testing.assert_array_equal(
        ts.merge_sorted(t(a), t(b)).numpy(),
        np.asarray(js.merge_sorted(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("white", [False, True])
def test_volume_render(rng, white):
    R, S = 48, 16
    rf = rng.standard_normal((R, S, 4)).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    z[:5] = 3.0                           # zero-span rays
    d = rng.standard_normal((R, 3)).astype(np.float32)
    jout = jr.volume_render(jnp.asarray(rf), jnp.asarray(z), jnp.asarray(d),
                            white_background=white)
    tout = tr.volume_render(t(rf), t(z), t(d), white_background=white)
    for name in ("rgb", "acc", "weights", "depth"):
        close(getattr(tout, name), getattr(jout, name))
    close(tout.disp[5:], jout.disp[5:], atol=1e-4, rtol=1e-4)
    bg = 1.0 if white else 0.0
    np.testing.assert_array_equal(tout.rgb[:5].numpy(), bg)
    np.testing.assert_array_equal(tout.acc[:5].numpy(), 0.0)


def test_img2mse_mse2psnr(rng):
    a = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    b = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    mse = tr.img2mse(t(a), t(b))
    close(mse, jr.img2mse(jnp.asarray(a), jnp.asarray(b)))
    close(tr.mse2psnr(mse), jr.mse2psnr(jr.img2mse(jnp.asarray(a),
                                                   jnp.asarray(b))))
    assert float(tr.mse2psnr(torch.tensor(0.0))) == 50.0


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("taps", [None, "bfloat16"])
def test_grid_sample_2d(rng, align_corners, taps):
    C, H, W = 8, 13, 17
    plane = rng.standard_normal((C, H, W)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (5, 40, 2)).astype(np.float32)
    grid[0, :4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]   # exact corners
    if taps is None:
        ref = jgs.grid_sample_2d(jnp.asarray(plane), jnp.asarray(grid),
                                 align_corners=align_corners)
    else:
        packed = jgs.pack_plane_bilinear(jnp.asarray(plane),
                                         table_dtype=jnp.bfloat16)
        ref = jgs.packed_bilinear_sample(packed, H, W, C, jnp.asarray(grid),
                                         align_corners=align_corners)
    out = tgs.grid_sample_2d(t(plane), t(grid), align_corners,
                             tap_dtype=None if taps is None
                             else torch.bfloat16)
    close(out, ref)


@pytest.mark.parametrize("align_corners", [True, False])
def test_dense_bilinear_sample(rng, align_corners):
    C, H, W = 16, 16, 16
    plane = rng.standard_normal((C, H, W)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (300, 2)).astype(np.float32)
    grid[:2] = [[1, 1], [-1, -1]]
    ref = jgs.dense_bilinear_sample(jnp.asarray(plane), jnp.asarray(grid),
                                    align_corners=align_corners)
    out = tgs.dense_bilinear_sample(t(plane), t(grid), align_corners)
    close(out, ref)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_plane(rng, align_corners, scale):
    x = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    ref = jrs.upsample_plane(jnp.asarray(x), scale,
                             align_corners=align_corners)
    close(trs.upsample_plane(t(x), scale, align_corners), ref)
    tref = torch.nn.functional.interpolate(
        t(x), scale_factor=scale, mode="bilinear",
        align_corners=align_corners)
    close(trs.upsample_plane(t(x), scale, align_corners), tref)
