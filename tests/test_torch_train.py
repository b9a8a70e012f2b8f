"""The training slice: nvsr_tpu_torch.train (and the render, triplane,
plane-SR, planes_store and geometry pieces it needs) against
nvsr_tpu.train and its JAX counterparts, on numpy-seeded inputs.

Tolerances, each with its reason:
* train_step on the fixture of tests/test_tile_sampler.py::
  test_train_step_tiled_grads_match. Plain path: both sides gather f32
  taps and run f32 decoders; only summation order differs: loss rtol
  1e-5, every gradient within 2e-5 of its group's largest (measured
  5.3e-6). Trainable (tiled) path: the JAX kernel's bf16 x-weights may
  differ from the port's by one bf16 ULP (tests/test_torch_plane_sample
  .py), flipping a bf16 row here and there: loss within 1e-5, gradients
  within 5e-4 of their group's largest (measured 1.2e-4).
* HR/SR step (EDSR 2 blocks, 8 wide, x2, f32) with the noises off, on the
  trainable path: the SR net adds f32 convolutions in another order on
  top of the above: loss within 1e-5, gradients within 5e-4 of their
  group's largest (measured 1.3e-4). Remat on and off compute the same
  function with the same operations: gradients within 1e-6 of their
  largest (measured equal).
* volume_render with the JAX density-noise draw passed in: f32 order
  only, atol 1e-6. Optimizers: f32 Adam arithmetic in another order,
  atol 1e-6 after 3 steps. Pixel choosers and ray geometry: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvsr_tpu import render as jrender
from nvsr_tpu import train as jtrain
from nvsr_tpu.models import plane_sr as jsr
from nvsr_tpu.models import triplane as jtri
from nvsr_tpu.ops import rendering as jrendering
from nvsr_tpu.ops.geometry import get_rays_at as j_get_rays_at
from nvsr_tpu.ops.pallas.tile_sampler import TileSamplerConfig as JTileCfg
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch import render as trender
from nvsr_tpu_torch import train as ttrain
from nvsr_tpu_torch.models import plane_sr as tsr
from nvsr_tpu_torch.models import triplane as ttri
from nvsr_tpu_torch.ops import rendering as trendering
from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
from nvsr_tpu_torch.planes_store import PlanesOptimizer
from torch_port_helpers import port_cfg, t

CPU = "cpu"
JCFG = jtri.TriplaneConfig(dec_channels=16, num_plane_channels=8,
                           dec_density_layers=2, dec_rgb_layers=2,
                           proj_combination="avg",
                           viewdir_proj_combination="concat_pos")
JTILE = JTileCfg(tile_rays=16, slab=4, th=32, tw=16, group=2)
BOX2 = np.stack([[-2, -2, -2, -np.pi, -np.pi / 2],
                 [2, 2, 2, np.pi, np.pi / 2]]).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _decoder(seed):
    params = _np_tree(jtri.init_decoder_params(jax.random.PRNGKey(seed),
                                               JCFG))
    params["members"][0]["fc_alpha"]["b"] = (
        params["members"][0]["fc_alpha"]["b"] + 2.0)
    return params


def _fixture(rng):
    """test_train_step_tiled_grads_match's inputs: two 4x4-ray tiles
    looking down -z, planes and target from the same rng draws."""
    planes = {"pos": (0.5 * rng.standard_normal((3, 8, 64, 64))
                      ).astype(np.float32),
              "view": (0.5 * rng.standard_normal((8, 16, 16))
                       ).astype(np.float32)}
    d = []
    for cx in (-0.3, 0.25):
        dirs = np.stack(np.meshgrid(np.linspace(cx - .05, cx + .05, 4),
                                    np.linspace(-.05, .05, 4)),
                        -1).reshape(-1, 2)
        d.append(np.concatenate([dirs, -np.ones((16, 1))], -1))
    d = np.concatenate(d).astype(np.float32)
    ro = np.broadcast_to(np.array([0.0, 0.0, 1.8], np.float32), (32, 3))
    target = rng.uniform(size=(32, 3)).astype(np.float32)
    return planes, np.ascontiguousarray(ro), d, target


def _jax_step(dc, df, sr, planes, ro, d, target, sr_cfg, flags,
              cfg=JCFG):
    rays = jrender.make_ray_bundle(jnp.asarray(ro), jnp.asarray(d), 0.8,
                                   3.2, use_viewdirs=True)
    rcfg = jrender.RenderConfig(num_coarse=8, num_fine=8, perturb=False,
                                radiance_field_noise_std=0.0)
    tree = lambda x: None if x is None else jax.tree.map(jnp.asarray, x)
    m, g = jtrain.train_step(tree(dc), tree(df), tree(sr), tree(planes),
                             jnp.asarray(BOX2), rays, jnp.asarray(target),
                             jax.random.PRNGKey(5), model_cfg=cfg,
                             sr_cfg=sr_cfg, rcfg=rcfg, flags=flags)
    return {k: float(v) for k, v in m.items()}, _np_tree(g)


def _port_step(dc, df, sr, planes, ro, d, target, sr_cfg, flags,
               cfg=JCFG):
    rays = trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True)
    rcfg = trender.RenderConfig(num_coarse=8, num_fine=8, perturb=False)
    m, g = ttrain.train_step(
        bridge.decoder_from_jax(dc, CPU),
        None if df is None else bridge.decoder_from_jax(df, CPU),
        None if sr is None else bridge.plane_sr_from_jax(sr, CPU),
        bridge.planes_from_jax(planes, CPU), BOX2, rays, t(target),
        torch.Generator().manual_seed(0), model_cfg=port_cfg(cfg),
        sr_cfg=sr_cfg, rcfg=rcfg, flags=flags)
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(lambda x: x.numpy(), g))


def _assert_grads_close(gj, gt, rel):
    lj, tj = jax.tree.flatten(gj)
    lt = tj.flatten_up_to(gt)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert a.shape == b.shape and np.all(np.isfinite(b))
        scale = np.abs(a).max() + 1e-8
        assert np.abs(a - b).max() <= rel * scale, (
            np.abs(a - b).max() / scale)


@pytest.mark.parametrize("tiled", [False, True])
def test_train_step_matches_jax(rng, tiled):
    planes, ro, d, target = _fixture(rng)
    dc = _decoder(0)
    jflags = jtrain.StepFlags(share_coarse_fine=True, train_sr=False,
                              tile_cfg=JTILE if tiled else None)
    pflags = ttrain.StepFlags(share_coarse_fine=True, train_sr=False,
                              tile_cfg=TileSamplerConfig(16) if tiled
                              else None)
    mj, gj = _jax_step(dc, None, None, planes, ro, d, target, None, jflags)
    mt, gt = _port_step(dc, None, None, planes, ro, d, target, None, pflags)
    assert sorted(gt) == sorted(gj) == ["dc", "planes"]
    assert "overflow_frac" not in mt
    if tiled:
        assert mj["overflow_frac"] == 0.0
        assert abs(mt["loss"] - mj["loss"]) < 1e-5
        _assert_grads_close(gj, gt, 5e-4)
    else:
        assert abs(mt["loss"] - mj["loss"]) <= 1e-5 * mj["loss"]
        _assert_grads_close(gj, gt, 2e-5)
    for k in ("coarse_loss", "fine_loss", "psnr", "fine_psnr"):
        assert np.isclose(mt[k], mj[k], rtol=1e-3), k


def test_train_step_bf16_table_matches_jax(rng):
    """gather_table_dtype='bfloat16' (TrainModels) on the plain path.
    JAX's plain gather reads a packed bf16 table whose cotangent XLA
    accumulates in bf16 (each point's row cotangent rounded to bf16, then
    summed in bf16); the port sums the taps' cotangents in f32 and rounds
    once per cell. The planes' gradients therefore agree to bf16
    accumulation error: within 1e-2 of their largest (measured 5.5e-3);
    the decoder's and the loss as in test_train_step_matches_jax. (The
    trainable sampler ignores gather_table_dtype: its taps are bf16.)"""
    cfg = dataclasses.replace(JCFG, gather_table_dtype="bfloat16")
    planes, ro, d, target = _fixture(rng)
    dc = _decoder(0)
    jflags = jtrain.StepFlags(share_coarse_fine=True, train_sr=False)
    pflags = ttrain.StepFlags(share_coarse_fine=True, train_sr=False)
    mj, gj = _jax_step(dc, None, None, planes, ro, d, target, None, jflags,
                       cfg)
    mt, gt = _port_step(dc, None, None, planes, ro, d, target, None, pflags,
                        cfg)
    assert abs(mt["loss"] - mj["loss"]) < 1e-5
    _assert_grads_close(gj["dc"], gt["dc"], 5e-4)
    _assert_grads_close(gj["planes"], gt["planes"], 1e-2)


def test_hr_sr_step_matches_jax_and_remat(rng):
    planes, ro, d, target = _fixture(rng)
    dc, df = _decoder(0), _decoder(1)
    jsr_cfg = jsr.PlaneSRConfig(in_channels=8, out_channels=8,
                                hidden_size=8, n_blocks=2, scale_factor=2)
    sr = _np_tree(jsr.init_plane_sr_params(jax.random.PRNGKey(2), jsr_cfg))
    # larger than the reference's Kaiming/10 init, so SR moves the planes
    sr = jax.tree.map(lambda a: (a * 10).astype(np.float32), sr)
    tsr_cfg = tsr.PlaneSRConfig(in_channels=8, out_channels=8,
                                hidden_size=8, n_blocks=2, scale_factor=2)
    mj, gj = _jax_step(dc, df, sr, planes, ro, d, target, jsr_cfg,
                       jtrain.StepFlags(sr_iter=True, tile_cfg=JTILE))
    pflags = ttrain.StepFlags(sr_iter=True, tile_cfg=TileSamplerConfig(16))
    mt, gt = _port_step(dc, df, sr, planes, ro, d, target, tsr_cfg, pflags)
    assert sorted(gt) == sorted(gj) == ["dc", "df", "planes", "sr"]
    assert abs(mt["loss"] - mj["loss"]) < 1e-5
    _assert_grads_close(gj, gt, 5e-4)
    _, g_off = _port_step(dc, df, sr, planes, ro, d, target,
                          dataclasses.replace(tsr_cfg, remat=False), pflags)
    _, g_seg = _port_step(dc, df, sr, planes, ro, d, target,
                          dataclasses.replace(tsr_cfg, remat_every=2),
                          pflags)
    _assert_grads_close(g_off, gt, 1e-6)
    _assert_grads_close(g_off, g_seg, 1e-6)


def test_frozen_groups_get_no_grads_and_stay_leaves(rng):
    planes, ro, d, target = _fixture(rng)
    dc = _decoder(0)
    port_dc = bridge.decoder_from_jax(dc, CPU)
    rays = trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True)
    m, g = ttrain.train_step(
        port_dc, None, None, bridge.planes_from_jax(planes, CPU), BOX2,
        rays, t(target), torch.Generator().manual_seed(0),
        model_cfg=port_cfg(JCFG), sr_cfg=None,
        rcfg=trender.RenderConfig(num_coarse=8, num_fine=8),
        flags=ttrain.StepFlags(share_coarse_fine=True, train_decoder=False,
                               track_surface_aabb=True))
    assert sorted(g) == ["planes"] and np.isfinite(float(m["loss"]))
    assert not port_dc["members"][0]["fc_rgb"]["w"].requires_grad
    assert m["surf_w"].shape == m["surf_wx"].shape == (3,)
    assert float(m["surf_w"][0]) > 0


def test_volume_render_noise_matches_jax(rng):
    rf = rng.standard_normal((6, 5, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (6, 5)), -1).astype(np.float32)
    dirs = rng.standard_normal((6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jrendering.volume_render(jnp.asarray(rf), jnp.asarray(z),
                                   jnp.asarray(dirs), noise_key=key,
                                   radiance_field_noise_std=0.7,
                                   return_z=True)
    noise = np.asarray(jax.random.normal(key, (6, 5)))
    out = trendering.volume_render(t(rf), t(z), t(dirs),
                                   radiance_field_noise_std=0.7,
                                   noise=t(noise), return_z=True)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    quiet = trendering.volume_render(t(rf), t(z), t(dirs),
                                     radiance_field_noise_std=0.7)
    assert quiet.z_vals is None
    assert not torch.allclose(quiet.rgb, out.rgb)


def test_point_coords_noise_matches_jax(rng, monkeypatch):
    cfg = dataclasses.replace(JCFG, point_coords_noise=0.5)
    params = _decoder(0)
    planes = (0.5 * rng.standard_normal((3, 8, 16, 16))).astype(np.float32)
    xyz = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    view = rng.standard_normal((40, 8)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jtri.apply_triplane_points(
        jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(planes),
        jnp.asarray(BOX2), jnp.asarray(xyz), jnp.asarray(view),
        noise_key=key, plane_resolution=16)
    draw = t(np.asarray(jax.random.normal(key, (40, 3))))
    randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda shape, **kw:
                        draw if tuple(shape) == (40, 3) else randn(shape,
                                                                   **kw))
    out = ttri.apply_triplane_points(
        bridge.decoder_from_jax(params, CPU), port_cfg(cfg), t(planes),
        BOX2, t(xyz), t(view), noise_generator=torch.Generator(),
        plane_resolution=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_module_and_planes_optimizers_match_optax(rng):
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), params) for _ in range(4)]
    jopt = jtrain.ModuleOptimizer(jax.tree.map(jnp.asarray, params), 1e-2)
    topt = ttrain.ModuleOptimizer(jax.tree.map(t, params), 1e-2)
    # a virtual batch of two, then two single steps
    for gs in (grads[:2], grads[2:3], grads[3:]):
        for g in gs:
            jopt.accumulate(jax.tree.map(jnp.asarray, g))
            topt.accumulate(jax.tree.map(t, g))
        jopt.step()
        topt.step()
    for a, b in zip(jax.tree.leaves(jopt.params), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), topt.params))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)

    # planes: optax adam with the lr injected per step, as PlanesBuffer
    planes = {"pos": rng.standard_normal((3, 2, 4, 4)).astype(np.float32),
              "view": rng.standard_normal((2, 3, 3)).astype(np.float32)}
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2, eps=1e-8)
    jp, state = jax.tree.map(jnp.asarray, planes), None
    state = opt.init(jp)
    port = {"s": jax.tree.map(t, planes), "frozen": jax.tree.map(t, planes)}
    popt = PlanesOptimizer(port, 1e-2, frozen_scenes=["frozen"])
    for lr in (1e-2, 1e-2, 3e-3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), planes)
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        popt.set_lr(lr)
        popt.apply_grads("s", jax.tree.map(t, g))
        popt.apply_grads("frozen", jax.tree.map(t, g))
    for k in planes:
        np.testing.assert_allclose(port["s"][k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
        np.testing.assert_array_equal(port["frozen"][k].numpy(), planes[k])


def test_plateau_scheduler_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.91, 0.92, 0.93, 0.5, 0.6, 0.7, 0.8, 0.9]
    js = jtrain.PlateauScheduler(1e-3, patience=2, factor=0.5, cooldown=1)
    ts = ttrain.PlateauScheduler(1e-3, patience=2, factor=0.5, cooldown=1)
    assert [js.step(v) for v in losses] == [ts.step(v) for v in losses]
    assert ts.lr < 1e-3


@pytest.mark.parametrize("chooser", ["random", "tile"])
def test_pixel_choosers_match_jax(chooser):
    image = np.random.default_rng(1).uniform(size=(40, 37, 3))
    if chooser == "random":
        args = (image, 300)
        fj, ft = jtrain.choose_random_pixels, ttrain.choose_random_pixels
    else:
        args = (image, 300, (8, 4))
        fj, ft = jtrain.choose_tile_pixels, ttrain.choose_tile_pixels
    out_j = fj(np.random.default_rng(5), *args)
    out_t = ft(np.random.default_rng(5), *args)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a, b)
    ro = np.random.default_rng(2).standard_normal((40, 37, 3))
    rd = np.random.default_rng(3).standard_normal((40, 37, 3))
    sel_j = jtrain.select_random_rays(np.random.default_rng(6), image, ro,
                                      rd, 100)
    sel_t = ttrain.select_random_rays(np.random.default_rng(6), image, ro,
                                      rd, 100)
    for a, b in zip(sel_j, sel_t):
        np.testing.assert_array_equal(a, b)


def test_build_sampled_rays_matches_jax(rng):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    pose[:3, 3] = [0.3, -1.0, 4.0]
    rows = rng.integers(0, 30, 50)
    cols = rng.integers(0, 20, 50)
    for focal in (25.0, (25.0, 31.0)):
        ro_j, rd_j = j_get_rays_at(jnp.asarray(rows), jnp.asarray(cols), 30,
                                   20, focal, jnp.asarray(pose), 0.375)
        ref = jrender.build_sampled_rays(
            jnp.asarray(pose), jnp.asarray(rows), jnp.asarray(cols), 30, 20,
            focal, 0.375, 2.0, 6.0, use_viewdirs=True)
        out = trender.build_sampled_rays(t(pose), rows, cols, 30, 20, focal,
                                         0.375, 2.0, 6.0, use_viewdirs=True)
        np.testing.assert_allclose(out.directions.numpy(), np.asarray(rd_j),
                                   atol=1e-6)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("skip,ens,rgb_in", [(None, 1, "projections"),
                                             (3, 2, "features")])
def test_init_decoder_shapes_and_statistics(skip, ens, rgb_in):
    jcfg = jtri.TriplaneConfig(dec_channels=64, num_plane_channels=32,
                               dec_density_layers=5, dec_rgb_layers=5,
                               skip_connect_every=skip, ensemble_size=ens,
                               rgb_dec_input=rgb_in,
                               viewdir_proj_combination="concat")
    ref = _np_tree(jtri.init_decoder_params(jax.random.PRNGKey(0), jcfg))
    out = ttri.init_decoder_params(torch.Generator().manual_seed(0),
                                   port_cfg(jcfg), device=CPU)
    assert jax.tree.structure(ref) == jax.tree.structure(
        jax.tree.map(lambda x: x.numpy(), out))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), out))):
        assert a.shape == b.shape and b.dtype == np.float32
    # U(-k, k), k = 1/sqrt(fan_in): std k/sqrt(3)
    w = out["members"][0]["density"][1]["w"]
    k = 1 / np.sqrt(w.shape[0])
    assert float(w.abs().max()) <= k
    assert abs(float(w.std()) - k / np.sqrt(3)) < 0.05 * k


def test_init_plane_sr_shapes_and_statistics():
    jcfg = jsr.PlaneSRConfig(in_channels=6, out_channels=6, hidden_size=16,
                             n_blocks=2, scale_factor=4,
                             input_normalization=True)
    ref = _np_tree(jsr.init_plane_sr_params(jax.random.PRNGKey(0), jcfg))
    pcfg = tsr.PlaneSRConfig(in_channels=6, out_channels=6, hidden_size=16,
                             n_blocks=2, scale_factor=4,
                             input_normalization=True)
    out = tsr.init_plane_sr_params(torch.Generator().manual_seed(0), pcfg,
                                   device=CPU)
    outn = jax.tree.map(lambda x: x.numpy(), out)
    assert jax.tree.structure(ref) == jax.tree.structure(outn)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(outn)):
        assert a.shape == b.shape
    assert np.isnan(outn["norm"]["mean"]).all()
    w = out["inner"]["blocks"][0]["conv1"]["w"]
    std = np.sqrt(2.0 / (9 * 16)) / 10
    assert abs(float(w.std()) - std) < 0.05 * std
    assert abs(float(w.mean())) < 0.05 * std


def test_plane_sr_train_noise_matches_jax(rng, monkeypatch):
    """sr_input_noise (std relative to the planes' std, gradient through
    it) and sr_output_noise (relative to the detached EDSR output's std)
    with the JAX draws handed to the port in its draw order: f32
    convolution order only, atol 1e-5."""
    jcfg = jsr.PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                             n_blocks=2, scale_factor=2, sr_input_noise=0.3,
                             sr_output_noise=0.2)
    params = jax.tree.map(lambda a: (a * 10).astype(np.float32), _np_tree(
        jsr.init_plane_sr_params(jax.random.PRNGKey(1), jcfg)))
    lr = rng.standard_normal((3, 4, 10, 12)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jsr.apply_plane_sr(jax.tree.map(jnp.asarray, params), jcfg,
                             jnp.asarray(lr), train=True, noise_key=key)
    k_out, k_in = jax.random.split(key)
    draws = [t(np.asarray(jax.random.normal(k_in, lr.shape))),
             t(np.asarray(jax.random.normal(k_out, ref.shape)))]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: draws.pop(0))
    pcfg = tsr.PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                             n_blocks=2, scale_factor=2, sr_input_noise=0.3,
                             sr_output_noise=0.2)
    out = tsr.apply_plane_sr(bridge.plane_sr_from_jax(params, CPU), pcfg,
                             t(lr), train=True, generator=torch.Generator())
    assert draws == []
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_stop_coarse_grad_and_materialize(rng):
    """stop_coarse_grad detaches the coarse pass: with only the coarse
    loss, the planes get a zero gradient. Low-rank planes materialize as
    in JAX (f32 einsum order, atol 1e-6)."""
    from nvsr_tpu.planes_store import materialize_pos_planes as jmat
    from nvsr_tpu_torch.planes_store import materialize_pos_planes as tmat
    planes, ro, d, target = _fixture(rng)
    rays = trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True)
    _, g = ttrain.train_step(
        bridge.decoder_from_jax(_decoder(0), CPU), None, None,
        bridge.planes_from_jax(planes, CPU), BOX2, rays, t(target),
        torch.Generator().manual_seed(0), model_cfg=port_cfg(JCFG),
        sr_cfg=None,
        rcfg=trender.RenderConfig(num_coarse=8, num_fine=8,
                                  stop_coarse_grad=True),
        flags=ttrain.StepFlags(share_coarse_fine=True,
                               compute_fine_loss=False))
    assert float(g["planes"]["pos"].abs().max()) == 0.0
    f = rng.standard_normal((3, 4, 9, 6)).astype(np.float32)
    np.testing.assert_allclose(tmat(t(f), 3).numpy(),
                               np.asarray(jmat(jnp.asarray(f), 3)),
                               atol=1e-6)
    assert tmat(t(f), None).shape == f.shape


@pytest.mark.parametrize("tiled", [False, True])
def test_point_fns_hold_box_and_bases_on_device(rng, tiled):
    """make_triplane_point_fn puts the box and the plane bases on the
    planes' device once (no host copy per call): the trainable route and
    the reference point fn give the outputs and gradients of the old
    forms (a numpy box and no rot_mats handed down) bit for bit,
    coordinate noise included."""
    planes, ro, d, _ = _fixture(rng)
    cfg = dataclasses.replace(port_cfg(JCFG), point_coords_noise=0.5)
    dc = bridge.decoder_from_jax(_decoder(0), CPU)
    rays = trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True)
    z = torch.linspace(0.8, 3.2, 8).expand(32, 8).contiguous()
    pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]

    def run(new):
        pos = t(planes["pos"]).requires_grad_(True)
        view = t(planes["view"]).requires_grad_(True)
        gen = torch.Generator().manual_seed(3)
        if new:
            pf = trender.make_triplane_point_fn(
                dc, cfg, pos, view, BOX2, noise_generator=gen,
                plane_resolution=64,
                **(dict(tile_rays=16, tile_train=True) if tiled else {}))
            out = pf(pts, rays, z)
        elif tiled:
            out = ttri.apply_triplane_rays_from_z(
                dc, cfg, pos, view, BOX2, rays.origins, rays.directions,
                rays.viewdirs, z, trainable=True, noise_generator=gen,
                plane_resolution=64)
        else:
            out = ttri.apply_triplane_rays(
                dc, cfg, pos, view, BOX2, pts, rays.viewdirs,
                noise_generator=gen, plane_resolution=64)
        grads = torch.autograd.grad(out.square().sum(), (pos, view))
        return out, grads

    (o_new, g_new), (o_old, g_old) = run(True), run(False)
    assert torch.equal(o_new, o_old)
    for a, b in zip(g_new, g_old):
        assert torch.equal(a, b)
