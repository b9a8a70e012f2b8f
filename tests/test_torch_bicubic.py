"""plane_interp 'bicubic' in the port, module by module, against the JAX
reference on numpy-seeded inputs.

* f32 plain paths (grid_sample_2d, upsample_plane, the SR residual, the
  view-plane and positional samples): atol 1e-5 (f32 summation order;
  measured at most 3.1e-6).
* cubic_weight: the port's torch form rounds once per step (as the CUDA
  kernels do); XLA evaluates the same Horner form with other roundings:
  atol 2e-6 on weights of at most 1 (measured 1.5e-6).
* the plain cubic sampler (ops/plane_sample.py, the oracle of
  plane_sample_cubic_fwd) against tiled_plane_sample_prechunked_bicubic
  (the Pallas `_tile_gather` with kernel="cubic" in interpret mode) on the
  fixture of tests/test_tile_sampler.py::test_bicubic_tiled_matches_reference,
  which JAX holds without clamping (overflow_frac == 0). JAX derives its
  bf16 x-weights from the region-local flat coordinate fidx = yl*tw + fx
  (f32), the port from tx, so a weight can differ by one bf16 ULP and a
  bf16 row can round the other way: one bf16 ULP of the row, 2^-6 =
  1.6e-2 at the fixture's |features| < 4. atol 1.6e-2, mean below 2e-5,
  more than 99% of the outputs bit-equal (measured: max 9.1e-3, mean
  8.3e-6, 99.3% equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nvsr_tpu.models import plane_sr as jp
from nvsr_tpu.models import triplane as jt
from nvsr_tpu.ops import resize as jrs
from nvsr_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from nvsr_tpu.ops.pallas.tile_sampler import (
    TileSamplerConfig, _cubic_weight, tiled_plane_sample_prechunked_bicubic,
    to_chunks)
from nvsr_tpu_torch import bridge, kernels
from nvsr_tpu_torch.models import plane_sr as tp
from nvsr_tpu_torch.models import triplane as tt
from nvsr_tpu_torch.ops import fused_render
from nvsr_tpu_torch.ops import plane_sample as ps
from nvsr_tpu_torch.ops import resize as trs
from nvsr_tpu_torch.ops.grid_sample import (cubic_weight, grid_sample_2d,
                                            multi_plane_sample)
from torch_port_helpers import BOX, FLAGSHIP, port_cfg, t

BICUBIC = dataclasses.replace(FLAGSHIP, plane_interp="bicubic",
                              compute_dtype=None, num_plane_channels=8)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_bicubic_and_its_gradient(rng, align_corners):
    """Points up to 0.4 beyond the border: the coordinate is not clipped,
    the taps clamp. The gradient (autograd through the plain gather,
    which train_step's fine pass takes on a bicubic config) matches
    JAX's VJP."""
    plane = rng.standard_normal((5, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (7, 13, 2)).astype(np.float32)
    cot = rng.standard_normal((7, 13, 5)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: j_grid_sample(
        p, jnp.asarray(grid), mode="bicubic", align_corners=align_corners),
        jnp.asarray(plane))
    pt = t(plane).requires_grad_(True)
    out = grid_sample_2d(pt, t(grid), align_corners, mode="bicubic")
    (g,) = torch.autograd.grad(out, pt, t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        grid_sample_2d(pt, t(grid), tap_dtype=torch.bfloat16, mode="bicubic")


def test_cubic_weight_matches_tpu_kernel_form():
    d = np.linspace(-2.5, 2.5, 20001).astype(np.float32)
    ref = np.asarray(jax.jit(_cubic_weight)(jnp.asarray(d)))
    np.testing.assert_allclose(cubic_weight(t(d)).numpy(), ref, atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_plane_bicubic(rng, align_corners, scale):
    x = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)
    ref = jrs.upsample_plane(jnp.asarray(x), scale, mode="bicubic",
                             align_corners=align_corners)
    out = trs.upsample_plane(t(x), scale, align_corners, mode="bicubic")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    lib = F.interpolate(t(x), scale_factor=scale, mode="bicubic",
                        align_corners=align_corners)
    np.testing.assert_allclose(out.numpy(), lib.numpy(), atol=1e-5, rtol=0)


def _np_sr_params(rng, jcfg):
    tree = jax.tree.map(np.asarray, jp.init_plane_sr_params(
        jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3
                   / np.sqrt(np.prod(a.shape[1:]))).astype(np.float32),
        tree)


def _port_sr_cfg(jcfg, sr_cfg=None):
    """The port's PlaneSRConfig with jcfg's fields. Given the YAML section
    jcfg was read from, `remat` is the value it states, or None: JAX reads
    an unstated remat as True, the port leaves it to apply_plane_sr."""
    keep = {f.name for f in dataclasses.fields(tp.PlaneSRConfig)}
    fields = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in keep}
    if sr_cfg is not None:
        fields["remat"] = sr_cfg.get("model", {}).get("remat")
    return tp.PlaneSRConfig(**fields)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_apply_plane_sr_bicubic_residual(rng, compute):
    """EDSR (hidden 16, 2 blocks, x2) with the bicubic residual. f32: atol
    1e-5; bf16 trunk: atol 2e-3, mean 1e-4 (as tests/test_torch_plane_sr.py:
    a flipped bf16 rounding propagates through the trunk)."""
    jcfg = jp.PlaneSRConfig(in_channels=6, out_channels=6, hidden_size=16,
                            n_blocks=2, scale_factor=2, compute_dtype=compute,
                            plane_interp="bicubic")
    params = _np_sr_params(rng, jcfg)
    lr = rng.standard_normal((3, 6, 12, 10)).astype(np.float32)
    ref = np.asarray(jp.apply_plane_sr(jax.tree.map(jnp.asarray, params),
                                       jcfg, jnp.asarray(lr)))
    out = tp.apply_plane_sr(bridge.plane_sr_from_jax(params, "cpu"),
                            _port_sr_cfg(jcfg), t(lr)).numpy()
    err = np.abs(out - ref)
    if compute is None:
        assert err.max() < 1e-5, err.max()
    else:
        assert err.max() < 2e-3 and err.mean() < 1e-4, err.max()
    bilinear = np.asarray(jp.apply_plane_sr(
        jax.tree.map(jnp.asarray, params),
        dataclasses.replace(jcfg, plane_interp="bilinear"), jnp.asarray(lr)))
    assert np.abs(bilinear - ref).max() > 1e-2   # the mode is honoured


@pytest.mark.parametrize("sr_cfg,interp", [
    ({"model": {"hidden_size": 64, "n_blocks": 4}}, "bicubic"),
    ({"plane_resize_mode": "bicubic", "input_normalization": True,
      "sr_input_noise": 0.1, "model": {"compute_dtype": "bfloat16",
                                       "remat_every": 2}}, "bilinear"),
    ({"plane_resize_mode": "bilinear"}, "bicubic"),
    ({"model": {"remat": True}}, "bilinear"),
    ({"model": {"remat": False, "remat_every": 3}}, "bilinear")])
def test_plane_sr_config_from_cfg(sr_cfg, interp):
    ref = jp.PlaneSRConfig.from_cfg(sr_cfg, 4, 48, interp, False)
    out = tp.PlaneSRConfig.from_cfg(sr_cfg, 4, 48, interp, False)
    assert out == _port_sr_cfg(ref, sr_cfg)
    if "remat" in sr_cfg.get("model", {}):
        assert out.remat == ref.remat == sr_cfg["model"]["remat"]


@pytest.mark.parametrize("dense", [False, True])
def test_sample_viewdir_plane_bicubic(rng, dense):
    """Bicubic always takes the f32 sampler, dense or not (JAX's dense
    view sampler is bilinear-only)."""
    plane = rng.standard_normal((8, 16, 16)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jt.sample_viewdir_plane(jnp.asarray(plane), jnp.asarray(d), BOX,
                                  BICUBIC, dense=dense)
    out = tt.sample_viewdir_plane(t(plane), t(d), BOX, port_cfg(BICUBIC),
                                  dense=dense)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_sample_planes_bicubic(rng):
    """f32 bicubic; gather_table_dtype does not apply to it (JAX
    triplane.py:337-340); the trainable route is bilinear-only."""
    cfg = dataclasses.replace(BICUBIC, gather_table_dtype="bfloat16")
    planes = rng.standard_normal((3, 8, 10, 12)).astype(np.float32)
    grids = rng.uniform(-1.2, 1.2, (3, 40, 2)).astype(np.float32)
    ref = jt.sample_planes(jnp.asarray(planes), jnp.asarray(grids), cfg)
    out = tt.sample_planes(t(planes), t(grids), port_cfg(cfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="bilinear"):
        tt.sample_planes(t(planes), t(grids), port_cfg(cfg), trainable=True)


@pytest.mark.parametrize("align_corners", [True, False])
def test_plain_cubic_sampler_matches_jax_kernel(rng, align_corners):
    P, C, H, W = 3, 8, 64, 64
    cfg = TileSamplerConfig(tile_rays=16, slab=4, th=32, tw=16, group=2)
    R, S = 32, 8
    planes = rng.standard_normal((P, C, H, W)).astype(np.float32)
    centers = rng.uniform(-1.05, 1.05, size=(P, R // 16, 1, S // 4, 1, 2))
    offs = rng.uniform(-0.02, 0.02, size=(P, R // 16, 16, S // 4, 4, 2))
    grids = np.clip(centers + offs, -1.3, 1.3).astype(np.float32).reshape(
        P, R, S, 2)
    g_c = to_chunks(jnp.asarray(grids), R // 16, 16, S // 4, 4)
    ref, ovf = tiled_plane_sample_prechunked_bicubic(
        jnp.asarray(planes), g_c, cfg, align_corners=align_corners,
        interpret=True)
    assert float(ovf) == 0.0
    table = fused_render.build_plane_table(t(planes))
    out = ps.sample_forward(table, t(np.asarray(g_c)).reshape(P, -1, 2), C,
                            align_corners, cubic=True).numpy()
    err = np.abs(out - np.asarray(ref))
    assert np.abs(out).max() < 4.0
    assert err.max() < 1.6e-2 and err.mean() < 2e-5, (err.max(), err.mean())
    assert np.mean(err == 0) > 0.99
    # and within bf16 tap/weight precision of the f32 bicubic sampler
    # (JAX's own tolerance for its kernel: max 5e-2, mean 5e-3)
    f32 = multi_plane_sample(t(planes), t(np.asarray(g_c)).reshape(P, -1, 2),
                             align_corners, mode="bicubic").numpy()
    err = np.abs(out - f32)
    assert err.max() < 5e-2 and err.mean() < 5e-3, err.max()


def test_devices_other_than_cpu_and_card_raise(monkeypatch):
    """A CPU tensor takes the plain version; a tensor on any other device
    than the card goes to the kernel wrapper, which refuses it, and a
    kernel whose library cannot be built raises and counts no launch."""
    meta = torch.zeros((3, 4, 4, 16), device="meta")
    grids = torch.zeros((3, 5, 2), device="meta")
    for cubic in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            ps.sample_forward(meta, grids, 16, True, cubic=cubic)
        with pytest.raises(ValueError, match="CUDA"):
            fused_render.fused_render_rays(
                meta, None, torch.zeros((2, 3)), torch.zeros((2, 3)),
                torch.zeros((2, 3)), None, np.zeros(24, np.float32),
                align_corners=True, avg=True, sigma_only=True, cubic=cubic)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "_libs", {})
    unbuilt = kernels.CudaKernel("plane_sample.cu", "plane_sample_cubic_fwd",
                                 [])
    with pytest.raises(RuntimeError, match="nvcc"):
        unbuilt()
    assert unbuilt.launches == 0
