"""The plain version of the triplane gather+decode kernel
(nvsr_tpu_torch/ops/fused_render.py) against the JAX reference.

* vs the JAX tiled path (apply_triplane_rays_from_z with a tile config),
  which runs the TPU megakernel _mega_kernel_v2 in Pallas interpret mode
  on the CPU: the same bf16 taps, bf16 x-weights and f32 y-lerp, so only
  the f32 arithmetic of the TPU region descriptors and the matmul
  summation order differ -> atol 1e-5 (most outputs are bit-equal).
* vs the JAX XLA path at bf16 compute (f32 tap weights there): the
  tolerance the JAX suite uses for its kernel, max 6e-2 / mean 6e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.models.triplane import (apply_triplane_rays,
                                      apply_triplane_rays_from_z)
from nvsr_tpu.ops.pallas.tile_sampler import TileSamplerConfig
from nvsr_tpu_torch.models import triplane as tt
from nvsr_tpu_torch.ops import fused_render
from torch_port_helpers import (BOX, FLAGSHIP, np_decoder, port_cfg, t,
                                to_port, tile_rays_geometry)

def _scene(rng, cfg, res=64, view_res=16):
    planes = (0.3 * rng.standard_normal(
        (3, cfg.num_plane_channels, res, res))).astype(np.float32)
    view = (0.3 * rng.standard_normal(
        (cfg.viewdir_channels, view_res, view_res))).astype(np.float32)
    return planes, view


def _port_fused(tree, cfg, planes, view, origins, dirs, viewdirs, z,
                sigma_only):
    out = tt.apply_triplane_rays_from_z(
        to_port(tree), port_cfg(cfg), t(planes), t(view), BOX, t(origins),
        t(dirs), t(viewdirs), t(z), sigma_only=sigma_only)
    return out.numpy()


@pytest.mark.parametrize("sigma_only", [False, True])
def test_plain_kernel_matches_jax_megakernel(rng, sigma_only):
    """The JAX Pallas megakernel (interpret mode) on a coherent ray tile
    that it holds without clamping (overflow_frac == 0)."""
    tree = np_decoder(rng, FLAGSHIP)
    planes, view = _scene(rng, FLAGSHIP)
    origins, d, viewdirs, z = tile_rays_geometry()
    tile_cfg = TileSamplerConfig(tile_rays=16, slab=4, th=32, tw=16,
                                 group=2, adaptive_region=False)
    ref, aux = apply_triplane_rays_from_z(
        tree, FLAGSHIP, jnp.asarray(planes), jnp.asarray(view), BOX,
        jnp.asarray(origins), jnp.asarray(d), jnp.asarray(viewdirs),
        jnp.asarray(z), tile_cfg=tile_cfg, sigma_only=sigma_only)
    assert float(aux["overflow_frac"]) == 0.0
    out = _port_fused(tree, FLAGSHIP, planes, view, origins, d, viewdirs, z,
                      sigma_only)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers,skip,comb,align,chans", [
    (4, 3, "avg", True, 48),        # TrainModels widths: no skip is hit
    (5, 3, "avg", True, 48),        # one skip layer in each branch
    (7, 3, "sum", False, 16),       # two skip layers, sum, 16 channels
    (6, 2, "avg", True, 20),        # channels padded to the kernel's 32
])
def test_plain_kernel_matches_jax_xla_bf16(rng, layers, skip, comb, align,
                                           chans):
    cfg = dataclasses.replace(
        FLAGSHIP, dec_density_layers=layers, dec_rgb_layers=layers,
        skip_connect_every=skip, proj_combination=comb,
        align_corners=align, num_plane_channels=chans)
    tree = np_decoder(rng, cfg)
    planes, view = _scene(rng, cfg)
    origins, d, viewdirs, z = tile_rays_geometry(R=16, S=12)
    pts = origins[:, None, :] + d[:, None, :] * z[..., None]
    ref = apply_triplane_rays(tree, cfg, jnp.asarray(planes),
                              jnp.asarray(view), BOX, jnp.asarray(pts),
                              jnp.asarray(viewdirs))
    out = _port_fused(tree, cfg, planes, view, origins, d, viewdirs, z,
                      False)
    err = np.abs(out - np.asarray(ref))
    assert err.max() < 6e-2 and err.mean() < 6e-3, (err.max(), err.mean())


def test_sigma_only_sigma_identical_to_full(rng):
    cfg = dataclasses.replace(FLAGSHIP, dec_density_layers=5)
    tree = np_decoder(rng, cfg)
    planes, view = _scene(rng, cfg)
    origins, d, viewdirs, z = tile_rays_geometry(R=16, S=8)
    full = _port_fused(tree, cfg, planes, view, origins, d, viewdirs, z,
                       False)
    so = _port_fused(tree, cfg, planes, view, origins, d, viewdirs, z, True)
    np.testing.assert_array_equal(so[..., 3], full[..., 3])
    np.testing.assert_array_equal(
        so[..., :3], np.broadcast_to(tree["members"][0]["fc_rgb"]["b"],
                                     so[..., :3].shape))


def test_gather_features_match_reference_sampler(rng):
    """The kernel's bilinear gather (bf16 taps, bf16 x-weights) stays
    within bf16 weight rounding of the f32-weight reference sampler."""
    cfg = FLAGSHIP
    planes, _ = _scene(rng, cfg, res=32)
    origins, d, _, z = tile_rays_geometry(R=16, S=8, z0=0.2, z1=4.0)
    table = fused_render.build_plane_table(t(planes))
    geom = fused_render.geometry_args(BOX, tt.make_rot_mats(3))
    feats = fused_render.gather_features(table, t(origins), t(d), t(z),
                                         geom, align_corners=True)
    pts = torch.as_tensor(origins[:, None] + d[:, None] * z[..., None])
    xyz = tt.normalize_coords(pts.reshape(-1, 3), t(BOX)[:, :3])
    grids = tt.project_to_planes(xyz, tt.make_rot_mats(3))
    ref = tt.multi_plane_sample(t(planes), grids, tap_dtype=torch.bfloat16)
    for p in range(3):
        err = (feats[p][:, :48] - ref[p]).abs()
        # |w - bf16(w)| <= 2^-9 per weight, taps are unit-scale
        assert err.max() < 1e-2 and err.mean() < 1e-3, (p, err.max())
    assert torch.all(feats[0][:, 48:] == 0)


def test_pack_decoder_layout(rng):
    cfg = dataclasses.replace(FLAGSHIP, dec_density_layers=5,
                              dec_rgb_layers=5, num_plane_channels=40)
    tree = np_decoder(rng, cfg)
    packed = fused_render.pack_decoder(to_port(tree), port_cfg(cfg))
    assert (packed.cp, packed.cvp, packed.skip_every) == (48, 48, 3)
    layers = packed.layers()
    ks = [k for _, _, _, k, _ in layers]
    # density: 48, 128, 128, 128, skip 128+48; rgb: 4x48, ..., skip 128+192
    assert ks == [48, 128, 128, 128, 176, 192, 128, 128, 128, 320]
    assert packed.w.shape == (sum(ks), 128)
    m = tree["members"][0]
    w = packed.w.float().numpy()
    rgb0 = layers[5][2]
    # view rows follow the three 48-row plane blocks; rows 40:48 are pad
    np.testing.assert_array_equal(
        w[rgb0 + 144:rgb0 + 184], torch.as_tensor(
            m["rgb"][0]["w"][120:160]).to(torch.bfloat16).float().numpy())
    assert not w[rgb0 + 40:rgb0 + 48].any()
    assert packed.bh[3] == float(m["fc_alpha"]["b"][0])


def _unpack_stream(packed):
    """(w, wh) rebuilt from packed.ws and packed.whs: the inverse of
    pack_stream and to_b_layout."""
    def from_b(flat, k, n):
        return flat.reshape(k // 16, 2, n // 8, 8, 8).permute(
            0, 1, 4, 2, 3).reshape(k, n)

    d = sum(k for br, _, _, k, _ in packed.layers() if br == "density")
    r = packed.w.shape[0] - d
    dp, rp = -(-d // 64) * 64, -(-r // 64) * 64
    w = torch.cat([from_b(packed.ws[:dp * 128], dp, 128)[:d],
                   from_b(packed.ws[dp * 128:], rp, 128)[:r]])
    wh = torch.stack([from_b(packed.whs[i * 2048:(i + 1) * 2048], 128, 16)
                      for i in range(2)])
    return w, wh, dp + rp


@pytest.mark.parametrize("skip,layers,rgb_layers,chans", [
    (3, 4, 4, 48), (1, 5, 3, 16), (2, 3, 6, 64), (0, 4, 4, 40)])
def test_pack_stream_is_a_permutation(rng, skip, layers, rgb_layers, chans):
    """The kernels' repack (ws: each branch padded to 64-row slices, in the
    wgmma B layout; whs: the heads) holds exactly w's and wh's bits:
    unpacking gives them back, every value of w appears in ws as often,
    and the rest of ws is the padding's zeros."""
    cfg = dataclasses.replace(
        FLAGSHIP, skip_connect_every=skip or None, dec_density_layers=layers,
        dec_rgb_layers=rgb_layers, num_plane_channels=chans)
    packed = fused_render.pack_decoder(to_port(np_decoder(rng, cfg)),
                                       port_cfg(cfg))
    w, wh, rows = _unpack_stream(packed)
    assert torch.equal(w, packed.w) and torch.equal(wh, packed.wh)
    assert packed.ws.shape == (rows * 128,)
    assert packed.whs.shape == (2 * 128 * 16,)
    ws = packed.ws.view(torch.int16).sort().values
    pad = torch.zeros(packed.ws.numel() - packed.w.numel(),
                      dtype=torch.int16)
    assert torch.equal(ws, torch.cat([packed.w.reshape(-1).view(torch.int16),
                                      pad]).sort().values)
    # one K step: element (k, n) at ((k // 8) * 16 + n // 8) * 64
    # + (n % 8) * 8 + k % 8
    k, n = 11, 37
    assert packed.ws[((k // 8) * 16 + n // 8) * 64 + (n % 8) * 8 + k % 8] \
        == packed.w[k, n]


def test_supports_gates_unported_configs():
    assert fused_render.supports(port_cfg(FLAGSHIP))
    for change in ({"compute_dtype": None}, {"dec_channels": 64},
                   {"proj_combination": "concat"}):
        assert not fused_render.supports(
            port_cfg(dataclasses.replace(FLAGSHIP, **change)))
