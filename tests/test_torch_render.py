"""The whole slice: nvsr_tpu_torch.render against nvsr_tpu.render.

On the committed trained gate scene (assets/gate_scene.pkl: 128x128,
16-channel 128^2 planes, 4+4 decoders 128 wide, 16+16 samples, occupancy
box, white background):
* XLA path: the port's reference path vs JAX render_image in f32:
  atol 1e-4 on rgb, held-out PSNR vs the stored gt within 0.05 dB.
* tiled path: the port's fused path (16x16 ray tiles, per-tile union
  bounds, bf16 compute; on the CPU the kernel's plain version) vs JAX
  render_image with the same tiles, union and bf16 compute. JAX's
  gathers there are the XLA ones with f32 weights (its own megakernel
  clamps 58% of this scene's chunks at that tile config, so it is not a
  reference here): frame PSNR between the two >= 45 dB (bench.py's gate)
  and held-out PSNR within 0.05 dB.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu import render as jrender
from nvsr_tpu.experiment import downsampling_offset
from nvsr_tpu.ops.geometry import get_ray_bundle as j_get_ray_bundle
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch import render as trender
from nvsr_tpu_torch.ops.geometry import get_ray_bundle
from nvsr_tpu_torch.ops.rendering import mse2psnr
from torch_port_helpers import (BOX, FLAGSHIP, np_decoder, port_cfg, t,
                                to_port)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "gate_scene.pkl")


@pytest.fixture(scope="module")
def gate():
    a = bridge.load_gate_asset(ASSET)
    with open(ASSET, "rb") as f:
        ja = pickle.load(f)          # JAX config, same arrays
    return a, ja


def _jax_frame(ja, tile, bf16):
    cfg = ja["model_cfg"]
    if bf16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    ro, rd = j_get_ray_bundle(
        ja["h"], ja["w"], ja["focal"], jnp.asarray(ja["pose"]),
        downsampling_offset=downsampling_offset(ja["ds_factor"]))
    rcfg = jrender.RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                                white_background=True)
    mk = lambda dec, so=False: jrender.make_triplane_point_fn(
        jax.tree.map(jnp.asarray, dec), cfg, jnp.asarray(ja["planes_pos"]),
        jnp.asarray(ja["plane_view"]), jnp.asarray(ja["box"]),
        sigma_only=so)
    out = jrender.render_image(
        mk(ja["decoder_coarse"], True), mk(ja["decoder_fine"]), ro, rd,
        jax.random.PRNGKey(0), rcfg, near=ja["near"], far=ja["far"],
        occ_aabb=jnp.asarray(ja["occ_aabb"]), tile=tile)
    return np.asarray(out.fine.rgb)


def _port_frame(a, tile, fused):
    cfg = a["model_cfg"]
    if fused:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    ro, rd = get_ray_bundle(
        a["h"], a["w"], a["focal"], t(a["pose"]),
        downsampling_offset=(a["ds_factor"] - 1) / (2 * a["ds_factor"]))
    rcfg = trender.RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                                white_background=True, ray_block=8192)
    mk = lambda dec, so=False: trender.make_triplane_point_fn(
        bridge.decoder_from_jax(dec, "cpu"), cfg, t(a["planes_pos"]),
        t(a["plane_view"]), a["box"], sigma_only=so,
        tile_rays=256 if fused else None)
    with torch.no_grad():
        out = trender.render_image(
            mk(a["decoder_coarse"], True), mk(a["decoder_fine"]), ro, rd,
            rcfg, near=a["near"], far=a["far"], occ_aabb=a["occ_aabb"],
            tile=tile)
    if fused:
        assert out.aux == {"overflow_frac": 0.0}
    return out.fine.rgb.numpy()


def _psnr(x, y):
    return float(mse2psnr(torch.as_tensor(np.mean((x - y) ** 2))))


@pytest.mark.parametrize("path", ["xla", "tiled"])
def test_gate_scene_matches_jax(gate, path):
    a, ja = gate
    tiled = path == "tiled"
    ref = _jax_frame(ja, 16 if tiled else None, bf16=tiled)
    out = _port_frame(a, 16 if tiled else None, fused=tiled)
    assert out.shape == (128, 128, 3) and np.isfinite(out).all()
    gt = a["gt"].astype(np.float32) / 255.0
    assert abs(_psnr(out, gt) - _psnr(ref, gt)) < 0.05
    if tiled:
        assert _psnr(out, ref) >= 45.0
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_render_image_tiles_union_and_padding(rng):
    """Tile order, pad+crop of a non-multiple image, per-tile union
    tightening and ray blocks on a small random field (f32 reference
    path) -> every output map within atol 1e-4 of JAX."""
    cfg = dataclasses.replace(FLAGSHIP, dec_channels=32, compute_dtype=None,
                              num_plane_channels=8)
    tree = np_decoder(rng, cfg)
    planes = (0.5 * rng.standard_normal((3, 8, 32, 32))).astype(np.float32)
    view = (0.5 * rng.standard_normal((8, 8, 8))).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, -0.1, 3.5]
    aabb = np.array([[-0.8, -0.7, -0.9], [0.9, 0.6, 0.8]], np.float32)
    H, W = 20, 14
    jrc = jrender.RenderConfig(num_coarse=8, num_fine=8, perturb=False,
                               ray_block=96)
    mkj = lambda so=False: jrender.make_triplane_point_fn(
        tree, cfg, jnp.asarray(planes), jnp.asarray(view), BOX,
        sigma_only=so)
    ro, rd = j_get_ray_bundle(H, W, 18.0, jnp.asarray(c2w))
    ref = jrender.render_image(mkj(True), mkj(), ro, rd,
                               jax.random.PRNGKey(0), jrc, near=2.0,
                               far=5.0, occ_aabb=jnp.asarray(aabb),
                               tile=(8, 4))
    trc = trender.RenderConfig(num_coarse=8, num_fine=8, perturb=False,
                               ray_block=96)
    mkt = lambda so=False: trender.make_triplane_point_fn(
        to_port(tree), port_cfg(cfg), t(planes), t(view), BOX,
        sigma_only=so)
    tro, trd = get_ray_bundle(H, W, 18.0, t(c2w))
    out = trender.render_image(mkt(True), mkt(), tro, trd, trc, near=2.0,
                               far=5.0, occ_aabb=aabb, tile=(8, 4))
    for name in ("rgb", "acc", "depth", "weights"):
        a = getattr(out.fine, name).numpy()
        assert a.shape[:2] == (H, W)
        np.testing.assert_allclose(a, np.asarray(getattr(ref.fine, name)),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.coarse.acc.numpy(),
                               np.asarray(ref.coarse.acc), atol=1e-4)


@pytest.mark.parametrize("tile_rays", [None, 4])
def test_tighten_bundle_and_tile_maps(rng, tile_rays):
    R = 32
    ro = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    near, far = np.full((R, 1), 1.0, np.float32), np.full((R, 1), 6.0,
                                                          np.float32)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    jb = jrender.tighten_bundle(jrender.RayBundle(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
        jnp.asarray(far)), jnp.asarray(aabb), tile_rays=tile_rays)
    tb = trender.tighten_bundle(trender.RayBundle(t(ro), t(rd), t(near),
                                                  t(far)), aabb,
                                tile_rays=tile_rays)
    np.testing.assert_allclose(tb.near.numpy(), np.asarray(jb.near),
                               atol=1e-5)
    np.testing.assert_allclose(tb.far.numpy(), np.asarray(jb.far),
                               atol=1e-5)
    img = rng.standard_normal((8, 12, 2)).astype(np.float32)
    tiled = trender.tile_ray_maps(t(img), (4, 6))
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jrender.tile_ray_maps(jnp.asarray(img),
                                                        (4, 6))))
    np.testing.assert_array_equal(
        trender.untile_ray_maps(tiled, 8, 12, (4, 6)).numpy(), img)
