"""Tiled eval renders with plane_interp 'bicubic' through the fused route,
against JAX.

* The fused bicubic route: render_image through the plain version of the
  cubic megakernel (ops/fused_render.py) against JAX's render_image through
  its fused bicubic megakernel (`_mega_kernel_v2`, interp="cubic", Pallas
  interpret mode) on the fixture of
  tests/test_tile_sampler.py::test_bicubic_megakernel_matches_xla (16x16
  image, 8x8 tiles of 64 rays, 8+8 samples, flagship decoder widths at
  bf16), which JAX holds without clamping (overflow_frac == 0): the same
  bf16 weights bf16(wx*wy), f32 row sums and decoder; only the f32
  arithmetic of the TPU region descriptors and the matmul summation order
  differ -> atol 2e-5 (measured 7.3e-6).
* The slice: bicubic-residual SR, then a tiled bicubic render_image (coarse
  on the LR planes, fine on the SR planes) against JAX: the SR planes agree
  to f32 summation order, and a bf16 table cell may round the other way:
  atol 1e-4 on rgb (measured 4.0e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nvsr_tpu.models import plane_sr as jp
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models import plane_sr as tp
from nvsr_tpu_torch.ops import fused_render
from torch_port_helpers import (FLAGSHIP, frame_decoder, frame_scene,
                                port_cfg, t, tiled_frames)


def test_plain_cubic_megakernel_matches_jax_megakernel(rng):
    cfg = dataclasses.replace(FLAGSHIP, plane_interp="bicubic")
    assert fused_render.supports(port_cfg(cfg))
    planes, view = frame_scene(rng, cfg)
    ref, out = tiled_frames(frame_decoder(rng, cfg), frame_decoder(rng, cfg),
                            cfg, planes, planes, view)
    a, b = np.asarray(ref.fine.rgb), out.fine.rgb.numpy()
    assert a.mean() > 0.1
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.fine.acc.numpy(), np.asarray(ref.fine.acc),
                               atol=2e-5, rtol=0)


def test_slice_sr_then_tiled_bicubic_render(rng):
    cfg = dataclasses.replace(FLAGSHIP, plane_interp="bicubic")
    jsr = jp.PlaneSRConfig(in_channels=48, out_channels=48, hidden_size=8,
                           n_blocks=1, scale_factor=2,
                           plane_interp=cfg.plane_interp)
    sr = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.3
                   / np.sqrt(np.prod(x.shape[1:]))).astype(np.float32),
        jax.tree.map(np.asarray, jp.init_plane_sr_params(
            jax.random.PRNGKey(0), jsr)))
    lr, view = frame_scene(rng, cfg, res=32)
    sr_j = np.asarray(jp.apply_plane_sr(jax.tree.map(jnp.asarray, sr), jsr,
                                        jnp.asarray(lr)))
    keep = {f.name for f in dataclasses.fields(tp.PlaneSRConfig)}
    tsr = tp.PlaneSRConfig(**{k: v for k, v in dataclasses.asdict(
        jsr).items() if k in keep})
    with torch.no_grad():
        sr_t = tp.apply_plane_sr(bridge.plane_sr_from_jax(sr, "cpu"), tsr,
                                 t(lr)).numpy()
    assert sr_t.shape == (3, 48, 64, 64)
    np.testing.assert_allclose(sr_t, sr_j, atol=1e-5, rtol=0)
    tree_c, tree_f = frame_decoder(rng, cfg), frame_decoder(rng, cfg)
    ref, out = tiled_frames(tree_c, tree_f, cfg, lr, sr_j, view, port_f=sr_t)
    a, b = np.asarray(ref.fine.rgb), out.fine.rgb.numpy()
    assert a.mean() > 0.1 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
