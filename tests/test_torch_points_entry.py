"""The points entry of the tiled eval forward, apply_triplane_rays(...,
tile_cfg=), against JAX's (Pallas kernels in interpret mode).

Fixture: tests/test_tile_sampler.py::test_megakernel_full_forward_matches
(bf16 4+4x128 decoder, 3x48x64^2 planes, 48x16^2 view plane, one 4x4 ray
tile, R=16, S=8; JAX's TileSamplerConfig(tile_rays=16, slab=4, th=32,
tw=16, group=2)), numpy-seeded weights handed to both. JAX does not clamp
it (overflow_frac 0.0, asserted). Tolerances, from the measured deltas:
  * the fused route, v2: atol 1e-5 (measured 1.4e-6): the features are
    JAX's up to the x-weights, which JAX takes from the region-local flat
    coordinate (a bf16 ULP now and then; none on this fixture), then the
    tensor cores' and XLA's summation orders;
  * v1 (JAX: NVSR_MEGA_V1=1): atol 5e-4 (measured 1.1e-4): its bf16 row
    rounding passes those orders on; with sigma_only JAX's v1 kernel
    decodes in full (zero view rows), and so does the port;
  * the sampler routes (an f32 decoder; bicubic grids, which the fused
    grids entry does not take): atol 1e-5 (measured 3e-8).
JAX's own test of this entry against its XLA path allows 6e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.models import triplane as jt
from nvsr_tpu.ops.pallas import tile_sampler as jts
from nvsr_tpu_torch.models import triplane as tt
from nvsr_tpu_torch.ops import fused_render
from nvsr_tpu_torch.ops import plane_sample as ps
from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
from torch_port_helpers import BOX, FLAGSHIP, np_decoder, port_cfg, t, to_port

R, S = 16, 8
JAX_TILE = jts.TileSamplerConfig(tile_rays=16, slab=4, th=32, tw=16,
                                 group=2)


def _fixture():
    rng = np.random.default_rng(0)
    tree = np_decoder(rng, FLAGSHIP)
    planes = (0.3 * rng.standard_normal((3, 48, 64, 64))).astype(np.float32)
    view = (0.3 * rng.standard_normal((48, 16, 16))).astype(np.float32)
    origin = np.array([0.0, 0.0, 1.8])
    dirs = np.stack(np.meshgrid(np.linspace(-.05, .05, 4),
                                np.linspace(-.05, .05, 4)),
                    -1).reshape(-1, 2)
    d = np.concatenate([dirs, -np.ones((R, 1))], -1).astype(np.float32)
    z = np.linspace(0.8, 3.2, S).astype(np.float32)
    pts = (origin + d[:, None, :] * z[None, :, None]).astype(np.float32)
    viewdirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                ).astype(np.float32)
    return tree, planes, view, pts, viewdirs


def _spy(monkeypatch):
    """Record the routes the port takes: the fused grids entry, and the
    eval sampler with its interpolation."""
    calls = []
    fused, sample = fused_render.tiled_render_chunked, ps.sample_forward

    def spy_fused(*a, **kw):
        calls.append(("fused", kw["form"]))
        return fused(*a, **kw)

    def spy_sample(table, grids, channels, align_corners, cubic=False):
        calls.append(("sampler", "bicubic" if cubic else "bilinear"))
        return sample(table, grids, channels, align_corners, cubic)

    monkeypatch.setattr(fused_render, "tiled_render_chunked", spy_fused)
    monkeypatch.setattr(ps, "sample_forward", spy_sample)
    return calls


# (case, plane_interp, compute_dtype, form, sigma_only, route, atol)
CASES = [
    ("v2", "bilinear", "bfloat16", "v2", False, ("fused", "v2"), 1e-5),
    ("v2-sigma", "bilinear", "bfloat16", "v2", True, ("fused", "v2"), 1e-5),
    ("v1", "bilinear", "bfloat16", "v1", False, ("fused", "v1"), 5e-4),
    ("v1-sigma", "bilinear", "bfloat16", "v1", True, ("fused", "v1"), 5e-4),
    ("f32", "bilinear", None, "v2", False, ("sampler", "bilinear"), 1e-5),
    ("f32-sigma", "bilinear", None, "v2", True, ("sampler", "bilinear"),
     1e-5),
    ("bicubic", "bicubic", "bfloat16", "v2", False, ("sampler", "bicubic"),
     1e-5),
]


@pytest.mark.parametrize("case,interp,dtype,form,sigma_only,route,atol",
                         CASES, ids=[c[0] for c in CASES])
def test_points_entry_matches_jax(monkeypatch, case, interp, dtype, form,
                                  sigma_only, route, atol):
    tree, planes, view, pts, viewdirs = _fixture()
    cfg = dataclasses.replace(FLAGSHIP, plane_interp=interp,
                              compute_dtype=dtype)
    if form == "v1":
        monkeypatch.setenv("NVSR_MEGA_V1", "1")
    else:
        monkeypatch.delenv("NVSR_MEGA_V1", raising=False)
    vp = None if sigma_only else jt.sample_viewdir_plane(
        jnp.asarray(view), jnp.asarray(viewdirs), BOX, cfg)
    ref, overflow = jt._apply_triplane_rays_tiled(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(planes), BOX,
        jnp.asarray(pts), vp, R, S, member=0, noise_key=None, rot_mats=None,
        tile_cfg=JAX_TILE, tile_tables=None, sigma_only=sigma_only)
    assert float(overflow) == 0.0
    # the public entry gives JAX's result
    np.testing.assert_array_equal(np.asarray(jt.apply_triplane_rays(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(planes),
        jnp.asarray(view), BOX, jnp.asarray(pts), jnp.asarray(viewdirs),
        tile_cfg=JAX_TILE, sigma_only=sigma_only)), np.asarray(ref))
    monkeypatch.delenv("NVSR_MEGA_V1", raising=False)

    calls = _spy(monkeypatch)
    with torch.no_grad():
        out = tt.apply_triplane_rays(
            to_port(tree), port_cfg(cfg), t(planes), t(view), BOX, t(pts),
            t(viewdirs), tile_cfg=TileSamplerConfig(tile_rays=16),
            sigma_only=sigma_only, form=form)
    assert calls == [route]
    assert out.shape == (R, S, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)
    if sigma_only and form == "v2":
        # the rgb lanes hold the fc_rgb bias, as in JAX
        np.testing.assert_allclose(
            out[..., :3].numpy(),
            np.broadcast_to(tree["members"][0]["fc_rgb"]["b"], (R, S, 3)),
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_points_entry_reuses_table_and_packed_decoder(interp):
    """table= and packed= (per-scene state, as apply_triplane_rays_from_z
    takes them) give the same result as building them per call; so do
    the rotation matrices given as a numpy array against the default, a
    tensor cached on the points' device. Both routes: fused (bilinear) and
    sampler (bicubic)."""
    tree, planes, view, pts, viewdirs = _fixture()
    cfg = port_cfg(dataclasses.replace(FLAGSHIP, plane_interp=interp))
    params = to_port(tree)
    args = (params, cfg, t(planes), t(view), BOX, t(pts), t(viewdirs))
    tile = TileSamplerConfig(tile_rays=16)
    with torch.no_grad():
        built = tt.apply_triplane_rays(*args, tile_cfg=tile)
        given = tt.apply_triplane_rays(
            *args, tile_cfg=tile,
            table=fused_render.build_plane_table(t(planes)),
            packed=fused_render.pack_decoder(params, cfg),
            rot_mats=tt.make_rot_mats(3))
    assert torch.equal(built, given)
    assert tt.rot_mats_on(3, torch.device("cpu")) is tt.rot_mats_on(
        3, torch.device("cpu"))


def test_points_entry_preconditions():
    tree, planes, view, pts, viewdirs = _fixture()
    args = (to_port(tree), port_cfg(FLAGSHIP), t(planes), t(view), BOX,
            t(pts), t(viewdirs))
    # JAX's precondition R % tile_rays == 0
    with pytest.raises(ValueError, match="tile_rays"):
        tt.apply_triplane_rays(*args, tile_cfg=TileSamplerConfig(
            tile_rays=32))
    with pytest.raises(ValueError, match="eval-only"):
        tt.apply_triplane_rays(*args, tile_cfg=TileSamplerConfig(
            tile_rays=16), trainable=True)
    with pytest.raises(ValueError, match="form"):
        tt.apply_triplane_rays(*args, tile_cfg=TileSamplerConfig(
            tile_rays=16), form="v3")


class _Routed(Exception):
    pass


@pytest.mark.parametrize("tile_rays,route", [(512, "fused"),
                                             (1024, "sampler")])
def test_chunk_cap_routing_matches_jax(monkeypatch, tile_rays, route):
    """JAX takes the fused kernel only when tile_rays * slab <= 512 after
    halving its slab as far as 1; the port's cap is tile_rays <= 512. One
    case on each side, the route read from both packages (each route
    stubbed to stop at its first kernel call)."""
    rng = np.random.default_rng(1)
    tree = np_decoder(rng, FLAGSHIP)
    planes = (0.3 * rng.standard_normal((3, 48, 64, 64))).astype(np.float32)
    view = (0.3 * rng.standard_normal((48, 16, 16))).astype(np.float32)
    r, s = 1024, 2
    pts = rng.uniform(-1.5, 1.5, (r, s, 3)).astype(np.float32)
    vd = rng.standard_normal((r, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)

    def stop(name):
        def f(*a, **kw):
            raise _Routed(name)
        return f

    monkeypatch.setattr(jts, "tiled_render_chunked", stop("fused"))
    monkeypatch.setattr(jts, "tiled_plane_sample_prechunked",
                        stop("sampler"))
    with pytest.raises(_Routed) as jax_route:
        jt.apply_triplane_rays(
            jax.tree.map(jnp.asarray, tree), FLAGSHIP, jnp.asarray(planes),
            jnp.asarray(view), BOX, jnp.asarray(pts), jnp.asarray(vd),
            tile_cfg=jts.TileSamplerConfig(tile_rays=tile_rays))
    monkeypatch.setattr(fused_render, "tiled_render_chunked", stop("fused"))
    monkeypatch.setattr(ps, "sample_forward", stop("sampler"))
    with pytest.raises(_Routed) as port_route:
        tt.apply_triplane_rays(
            to_port(tree), port_cfg(FLAGSHIP), t(planes), t(view), BOX,
            t(pts), t(vd), tile_cfg=TileSamplerConfig(tile_rays=tile_rays))
    assert str(jax_route.value) == str(port_route.value) == route
    assert (tile_rays <= tt.CHUNK_CAP) == (route == "fused")
