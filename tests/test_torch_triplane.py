"""nvsr_tpu_torch.models.triplane (reference path) against
nvsr_tpu.models.triplane on numpy-seeded decoders and planes.

f32 compute: atol 1e-5 on unit-scale outputs (matmul summation order).
bf16 compute: both sides multiply bf16-rounded operands exactly in f32,
but a last-ULP f32 difference can flip one activation's bf16 rounding,
so atol 1e-3."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from nvsr_tpu.models import triplane as jt
from nvsr_tpu_torch.models import triplane as tt
from torch_port_helpers import BOX, np_decoder, port_cfg, t, to_port

BASE = jt.TriplaneConfig(dec_channels=32, num_plane_channels=8,
                         dec_density_layers=4, dec_rgb_layers=4,
                         skip_connect_every=3, proj_combination="avg",
                         viewdir_proj_combination="concat_pos")


def test_config_mirror_and_rot_mats():
    for nplanes in (3, 4):
        np.testing.assert_array_equal(tt.make_rot_mats(nplanes),
                                      jt.make_rot_mats(nplanes))
    pc = port_cfg(BASE)
    for prop in ("viewdir_channels", "viewdir_combination",
                 "density_in_channels", "rgb_in_channels"):
        assert getattr(pc, prop) == getattr(BASE, prop)
    assert [pc.is_skip_layer(i) for i in range(8)] == \
        [BASE.is_skip_layer(i) for i in range(8)]


@pytest.mark.parametrize("model_cfg,nerf_cfg", [
    ({}, {}),
    ({"dec_channels": 64, "skip_connect_every": 3, "num_plane_channels": 32,
      "num_viewdir_plane_channels": 16, "proj_combination": "avg",
      "viewdir_proj_combination": "concat_pos", "align_corners": False,
      "compute_dtype": "bfloat16"}, {"use_viewdirs": True}),
])
def test_config_from_cfg(model_cfg, nerf_cfg):
    assert dataclasses.asdict(tt.TriplaneConfig.from_cfg(
        model_cfg, nerf_cfg)) == dataclasses.asdict(
            jt.TriplaneConfig.from_cfg(model_cfg, nerf_cfg))


@pytest.mark.parametrize("layers,comb,vcomb,sigma_only,compute", [
    (4, "avg", "concat_pos", False, None),
    (6, "sum", "concat_pos", False, None),     # skip layers at ln 4
    (7, "avg", "concat_pos", True, None),
    (5, "concat", "concat", False, None),
    (4, "sum", "sum", False, None),
    (7, "avg", "concat_pos", False, "bfloat16"),
])
def test_decode_projections(rng, layers, comb, vcomb, sigma_only, compute):
    cfg = dataclasses.replace(BASE, dec_density_layers=layers,
                              dec_rgb_layers=layers, proj_combination=comb,
                              viewdir_proj_combination=vcomb,
                              compute_dtype=compute)
    tree = np_decoder(rng, cfg, scale=2.0)
    n = 200
    projs = rng.standard_normal((3, n, 8)).astype(np.float32)
    view = rng.standard_normal((n, 8)).astype(np.float32)
    ref = jt.decode_projections(tree, cfg, jnp.asarray(projs),
                                jnp.asarray(view), sigma_only=sigma_only)
    out = tt.decode_projections(to_port(tree), port_cfg(cfg), t(projs),
                                t(view), sigma_only=sigma_only)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-5 if compute is None else 1e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_apply_triplane_rays(rng, table_dtype, sigma_only):
    cfg = dataclasses.replace(BASE, gather_table_dtype=table_dtype,
                              align_corners=table_dtype is None)
    tree = np_decoder(rng, cfg)
    planes = rng.standard_normal((3, 8, 24, 24)).astype(np.float32)
    view = rng.standard_normal((8, 16, 16)).astype(np.float32)
    R, S = 20, 6
    pts = rng.uniform(-2.5, 2.5, (R, S, 3)).astype(np.float32)
    vd = rng.standard_normal((R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ref = jt.apply_triplane_rays(tree, cfg, jnp.asarray(planes),
                                 jnp.asarray(view), BOX, jnp.asarray(pts),
                                 jnp.asarray(vd), sigma_only=sigma_only)
    out = tt.apply_triplane_rays(to_port(tree), port_cfg(cfg), t(planes),
                                 t(view), BOX, t(pts), t(vd),
                                 sigma_only=sigma_only)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dense", [False, True])
def test_sample_viewdir_plane(rng, dense):
    view = rng.standard_normal((8, 16, 16)).astype(np.float32)
    vd = rng.standard_normal((64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ref = jt.sample_viewdir_plane(jnp.asarray(view), jnp.asarray(vd), BOX,
                                  BASE, dense=dense)
    out = tt.sample_viewdir_plane(t(view), t(vd), BOX, port_cfg(BASE),
                                  dense=dense)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
