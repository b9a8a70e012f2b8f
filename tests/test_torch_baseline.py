"""The baseline NeRF's render and training step in the port against the
JAX package: render.make_baseline_point_fn (PE and mip-IPE),
render.render_rays with RenderConfig(mip=True), and
train.train_step_baseline, on the same numpy-seeded rays and JAX-
initialized MLP weights (carried by bridge.nerf_mlp_from_jax), with the
device draws off (no jitter, no density noise).

Tolerances, each measured on the CPU:
* point fns: f32 encodings and matmuls in another order, atol 1e-5 on
  outputs of order 1 (measured 6e-8);
* mip render_rays: the fine depths come from an inverse CDF of the coarse
  weights, which amplifies the f32 differences of the coarse pass where
  the pdf is small (1.4e-4 in z on nearly opaque rays): rgb, acc and
  weights atol 1e-5, depths and z atol 1e-4 (measured 2.4e-7 / 9.5e-7);
* train_step_baseline (the PR 9 bar): loss within 1e-5 relative, every
  gradient within 2e-5 of its group's ("dc", "df") largest (measured
  loss 9e-8, gradients 3.4e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu import render as jrender
from nvsr_tpu import train as jtrain
from nvsr_tpu.models import nerf_mlp as jm
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch import render as trender
from nvsr_tpu_torch import train as ttrain
from nvsr_tpu_torch.models import nerf_mlp as tm

CPU = "cpu"
# the baseline's encodings at a narrow width: IPE degrees 0..15
# (num_encoding_fn_xyz 16, multires 17), dir PE 4 with the raw dirs
N_XYZ, N_DIR, MULTIRES = 16, 4, 17
MIP_CFG = jm.NeRFMLPConfig(num_layers=8, hidden_size=32,
                           skip_connect_every=4,
                           input_dim_xyz=3 * 2 * (MULTIRES - 1),
                           input_dim_dir=3 + 2 * 3 * N_DIR)
PE_CFG = jm.NeRFMLPConfig(num_layers=8, hidden_size=32, skip_connect_every=4,
                          num_encoding_fn_xyz=6, num_encoding_fn_dir=N_DIR)


def _mlp(cfg, seed):
    tree = jax.tree.map(np.asarray, jm.init_nerf_mlp_params(
        jax.random.PRNGKey(seed), cfg))
    # a small positive density bias: the rays composite something, and
    # are not so opaque that the density gradients vanish
    tree["fc_alpha"]["b"] = tree["fc_alpha"]["b"] + 0.2
    return tree


def _port_cfg(cfg):
    return tm.NeRFMLPConfig(**dataclasses.asdict(cfg))


def _rays(rng, n=48):
    """Rays from a circle of radius 4 at height 1 toward the origin."""
    ang = rng.uniform(0, 2 * np.pi, n)
    ro = np.stack([4 * np.cos(ang), 4 * np.sin(ang), 1 + 0 * ang],
                  -1).astype(np.float32)
    rd = (-ro + 0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    return ro, rd


def _bundles(ro, rd):
    return (jrender.make_ray_bundle(jnp.asarray(ro), jnp.asarray(rd), 2.0,
                                    6.0, use_viewdirs=True),
            trender.make_ray_bundle(torch.tensor(ro), torch.tensor(rd), 2.0,
                                    6.0, use_viewdirs=True))


def _point_fns(cfg, tree, mip, ds):
    kw = dict(num_encoding_fn_xyz=6 if not mip else N_XYZ,
              num_encoding_fn_dir=N_DIR, include_input_xyz=not mip,
              include_input_dir=True, mip=mip, ds_factor=ds,
              ipe_multires=MULTIRES)
    return (jrender.make_baseline_point_fn(jax.tree.map(jnp.asarray, tree),
                                           cfg, **kw),
            trender.make_baseline_point_fn(
                bridge.nerf_mlp_from_jax(tree, CPU), _port_cfg(cfg), **kw))


@pytest.mark.parametrize("mip,ds", [(False, 1), (True, 8), (True, 2)])
def test_baseline_point_fn(rng, mip, ds):
    cfg = MIP_CFG if mip else PE_CFG
    pf_j, pf_t = _point_fns(cfg, _mlp(cfg, 1), mip, ds)
    ro, rd = _rays(rng, 16)
    jr, tr = _bundles(ro, rd)
    z = np.sort(rng.uniform(2, 6, (16, 9)), -1).astype(np.float32)
    pts = ro[:, None] + rd[:, None] * z[..., None]
    if mip:
        ref = pf_j(None, jr, jnp.asarray(z))
        out = pf_t(None, tr, torch.tensor(z))
    else:
        ref = pf_j(jnp.asarray(pts), jr, jnp.asarray(z))
        out = pf_t(torch.tensor(pts), tr, torch.tensor(z))
    assert tuple(out.shape) == ref.shape == ((16, 8, 4) if mip
                                             else (16, 9, 4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("white", [False, True])
def test_mip_render_rays(rng, white):
    """render_rays with mip: num_coarse + 1 edges, the point fns cast the
    frustums, the fine pass resamples from the midpoints of midpoints and
    composites without the 1e10 interval, depths at interval midpoints."""
    pf_j, pf_t = _point_fns(MIP_CFG, _mlp(MIP_CFG, 2), True, 8)
    ro, rd = _rays(rng)
    jr, tr = _bundles(ro, rd)
    kw = dict(num_coarse=8, num_fine=8, perturb=False, mip=True,
              keep_z=True, white_background=white)
    ref = jrender.render_rays(pf_j, pf_j, jr, jax.random.PRNGKey(0),
                              jrender.RenderConfig(**kw))
    out = trender.render_rays(pf_t, pf_t, tr, trender.RenderConfig(**kw))
    for name in ("coarse", "fine"):
        o, r = getattr(out, name), getattr(ref, name)
        s = 8 if name == "coarse" else 17
        assert tuple(o.weights.shape) == r.weights.shape == (48, s)
        assert tuple(o.z_vals.shape) == r.z_vals.shape == (48, s)
        for f in ("rgb", "acc", "weights"):
            np.testing.assert_allclose(getattr(o, f).numpy(),
                                       np.asarray(getattr(r, f)), rtol=0,
                                       atol=1e-5, err_msg=f"{name}.{f}")
        for f in ("depth", "z_vals"):
            np.testing.assert_allclose(getattr(o, f).numpy(),
                                       np.asarray(getattr(r, f)), rtol=0,
                                       atol=1e-4, err_msg=f"{name}.{f}")
    # the composite has content
    assert float(out.fine.acc.mean()) > 0.5


def _assert_grads_close(gj, gt, rel):
    """Every gradient of a group ("dc", "df") within rel of the group's
    largest."""
    for group in gj:
        lj, tj = jax.tree.flatten(gj[group])
        lt = tj.flatten_up_to(gt[group])
        assert len(lj) == len(lt) > 0
        scale = max(np.abs(a).max() for a in lj)
        assert scale > 0, group
        for a, b in zip(lj, lt):
            assert a.shape == b.shape and np.all(np.isfinite(b))
            assert np.abs(a - b).max() <= rel * scale, (
                group, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("share,consistency,mip", [
    (False, False, True), (True, False, True), (False, True, True),
    (False, False, False)])
def test_train_step_baseline_matches_jax(rng, share, consistency, mip):
    cfg = MIP_CFG if mip else PE_CFG
    dc, df = _mlp(cfg, 3), _mlp(cfg, 4)
    ds = 2
    ro, rd = _rays(rng, 64)
    n_target = 64 // ds ** 2 if consistency else 64
    target = rng.uniform(size=(n_target, 3)).astype(np.float32)
    jr, tr = _bundles(ro, rd)
    enc = (N_XYZ if mip else 6, N_DIR, not mip, True, mip, 8, MULTIRES)
    kw = dict(num_coarse=8, num_fine=8, perturb=False, mip=mip)
    fkw = dict(consistency_iter=consistency, ds_factor=ds,
               im_inconsistency_loss_w=0.5, share_coarse_fine=share)
    mj, gj = jtrain.train_step_baseline(
        jax.tree.map(jnp.asarray, dc),
        None if share else jax.tree.map(jnp.asarray, df), jr,
        jnp.asarray(target), jax.random.PRNGKey(0), mlp_cfg=cfg,
        rcfg=jrender.RenderConfig(**kw), flags=jtrain.StepFlags(**fkw),
        enc_cfg=enc)
    mt, gt = ttrain.train_step_baseline(
        bridge.nerf_mlp_from_jax(dc, CPU),
        None if share else bridge.nerf_mlp_from_jax(df, CPU), tr,
        torch.tensor(target), torch.Generator().manual_seed(0),
        mlp_cfg=_port_cfg(cfg), rcfg=trender.RenderConfig(**kw),
        flags=ttrain.StepFlags(**fkw), enc_cfg=enc)
    assert sorted(mt) == sorted(mj)
    assert sorted(gt) == sorted(gj) == (["dc"] if share else ["dc", "df"])
    assert abs(float(mt["loss"]) - float(mj["loss"])) \
        <= 1e-5 * float(mj["loss"])
    for k in ("coarse_loss", "fine_loss", "psnr", "fine_psnr"):
        assert np.isclose(float(mt[k]), float(mj[k]), rtol=1e-5), k
    _assert_grads_close(jax.tree.map(np.asarray, gj),
                        jax.tree.map(lambda x: x.numpy(), gt), 2e-5)


@pytest.mark.parametrize("mip", [False, True])
def test_surface_moments_mip_rule(mip):
    """train._surface_moments drops the last sample (the 1e10 background
    interval) only without mip, as JAX's train_step does
    (nvsr_tpu/train.py:220-226): with mip every interval is real."""
    from nvsr_tpu_torch.ops.rendering import RenderOutputs
    w = torch.tensor([[0.2, 0.3, 0.5], [0.0, 0.1, 0.9]])
    z = torch.tensor([[1.0, 2.0, 3.0], [1.0, 2.0, 4.0]])
    rays = trender.RayBundle(torch.zeros(2, 3),
                             torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]),
                             torch.zeros(2, 1), torch.ones(2, 1))
    out = trender.RenderResult(RenderOutputs(None, None, None, w, None, z),
                               None)
    m = ttrain._surface_moments(out, rays, ttrain.StepFlags(
        surf_weight_eps=0.01), mip=mip)
    kept = w.clone()
    kept[w <= 0.01] = 0
    if not mip:
        kept[:, -1] = 0
    torch.testing.assert_close(m["surf_w"], kept.sum() * torch.ones(3))
    x = z[..., None] * rays.directions[:, None, :]
    torch.testing.assert_close(m["surf_wx"],
                               (kept[..., None] * x).sum(dim=(0, 1)))
