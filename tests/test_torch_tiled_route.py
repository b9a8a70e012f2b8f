"""The tiled eval route for configs the fused kernel does not take, and
the gate scene's reference path in bicubic, against JAX.

* The non-fused route (a config the fused kernel does not take: an f32
  decoder), bilinear and bicubic: the eval plane sampler (plain version of
  plane_sample_fwd / plane_sample_cubic_fwd) and the plain f32 decoder,
  against JAX's non-fused tiled route (its `_tile_gather` in interpret
  mode and the XLA decoder). The gate scene at 16x16 tiles clamps in JAX
  (overflow_frac 0.585, ROADMAP Queue 3), and so does this fixture at
  16x16 tiles of 256 rays (0.75 bicubic, 1.0 bilinear), so the comparison
  runs on the 8x8-tile fixture, which JAX holds: atol 1e-5 (measured
  1.2e-7). On the gate scene itself, with its own f32 config and 16x16
  tiles, the port renders (it raised before) and is held against JAX's
  XLA render with the same tiles and union bounds: frame PSNR >= 45 dB
  (bf16 taps and weights against f32; measured 75.7 dB bilinear, 78.1 dB
  bicubic), held-out PSNR within 0.05 dB.
* The reference path on the gate scene in bicubic: the port's f32 path
  matches JAX's XLA path (atol 1e-4, as tests/test_torch_render.py), and
  JAX's held-out PSNR is the constant chip_smoke.py pins.
"""

import dataclasses
import importlib.util
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
from nvsr_tpu_torch.ops import fused_render
from nvsr_tpu_torch.ops import plane_sample as ps
from nvsr_tpu_torch.ops.geometry import get_ray_bundle
from nvsr_tpu_torch.ops.rendering import mse2psnr
from torch_port_helpers import (FLAGSHIP, frame_decoder, frame_scene,
                                port_cfg, t, tiled_frames)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "assets", "gate_scene.pkl")


def _psnr(x, y):
    return float(mse2psnr(torch.as_tensor(np.mean((x - y) ** 2))))


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_non_fused_tiled_route_matches_jax(rng, monkeypatch, interp):
    """The repaired route: an f32 decoder renders through the eval plane
    sampler (spied: every pass calls it, with the config's interpolation)
    and the plain decoder; JAX takes its non-fused route there too."""
    cfg = dataclasses.replace(FLAGSHIP, plane_interp=interp,
                              compute_dtype=None)
    assert not fused_render.supports(port_cfg(cfg))
    calls = []
    sample = ps.sample_forward

    def spy(*args, **kw):
        calls.append(kw["cubic"] if "cubic" in kw else args[4])
        return sample(*args, **kw)

    monkeypatch.setattr(ps, "sample_forward", spy)
    planes, view = frame_scene(rng, cfg)
    ref, out = tiled_frames(frame_decoder(rng, cfg), frame_decoder(rng, cfg),
                            cfg, planes, planes, view)
    assert calls == [interp == "bicubic"] * 2   # one ray block, two passes
    a, b = np.asarray(ref.fine.rgb), out.fine.rgb.numpy()
    assert a.mean() > 0.1
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def gate():
    a = bridge.load_gate_asset(ASSET)
    with open(ASSET, "rb") as f:
        ja = pickle.load(f)          # JAX config, same arrays
    return a, ja


def _jax_gate(ja, interp, tile):
    cfg = dataclasses.replace(ja["model_cfg"], plane_interp=interp)
    ro, rd = j_get_ray_bundle(
        ja["h"], ja["w"], ja["focal"], jnp.asarray(ja["pose"]),
        downsampling_offset=downsampling_offset(ja["ds_factor"]))
    mk = lambda dec, so=False: jrender.make_triplane_point_fn(
        jax.tree.map(jnp.asarray, dec), cfg, jnp.asarray(ja["planes_pos"]),
        jnp.asarray(ja["plane_view"]), jnp.asarray(ja["box"]),
        sigma_only=so)
    out = jrender.render_image(
        mk(ja["decoder_coarse"], True), mk(ja["decoder_fine"]), ro, rd,
        jax.random.PRNGKey(0), jrender.RenderConfig(
            num_coarse=16, num_fine=16, perturb=False,
            white_background=True),
        near=ja["near"], far=ja["far"],
        occ_aabb=jnp.asarray(ja["occ_aabb"]), tile=tile)
    return np.asarray(out.fine.rgb)


def _port_gate(a, interp, tile, tile_rays):
    cfg = dataclasses.replace(a["model_cfg"], plane_interp=interp)
    ro, rd = get_ray_bundle(
        a["h"], a["w"], a["focal"], t(a["pose"]),
        downsampling_offset=(a["ds_factor"] - 1) / (2 * a["ds_factor"]))
    mk = lambda dec, so=False: trender.make_triplane_point_fn(
        bridge.decoder_from_jax(dec, "cpu"), cfg, t(a["planes_pos"]),
        t(a["plane_view"]), a["box"], sigma_only=so, tile_rays=tile_rays)
    with torch.no_grad():
        out = trender.render_image(
            mk(a["decoder_coarse"], True), mk(a["decoder_fine"]), ro, rd,
            trender.RenderConfig(num_coarse=16, num_fine=16, perturb=False,
                                 white_background=True, ray_block=8192),
            near=a["near"], far=a["far"], occ_aabb=a["occ_aabb"], tile=tile)
    return out.fine.rgb.numpy()


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_gate_scene_f32_config_renders_tiled(gate, interp):
    a, ja = gate
    assert a["model_cfg"].compute_dtype is None
    out = _port_gate(a, interp, 16, 256)
    ref = _jax_gate(ja, interp, 16)
    gt = a["gt"].astype(np.float32) / 255.0
    assert out.shape == (128, 128, 3) and np.isfinite(out).all()
    assert _psnr(out, ref) >= 45.0
    assert abs(_psnr(out, gt) - _psnr(ref, gt)) < 0.05


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_gate_scene_bicubic_reference_path(gate):
    """JAX's XLA bicubic render of the gate scene reaches the held-out
    PSNR that chip_smoke.py pins for the port's f32 reference path on the
    card, and the port's reference path matches JAX here."""
    a, ja = gate
    ref = _jax_gate(ja, "bicubic", None)
    out = _port_gate(a, "bicubic", None, None)
    gt = a["gt"].astype(np.float32) / 255.0
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    pinned = _chip_smoke().GATE_BICUBIC_REF_PSNR_DB
    assert abs(_psnr(ref, gt) - pinned) < 5e-4
    assert abs(_psnr(out, gt) - pinned) < 0.05
