"""`rgb_dec_input: "features"` in the port against JAX.

The rgb branch reads the density branch's features through `fc_feat` (an
f32 matmul in both packages) instead of the plane projections. Decoder
weights come from JAX's `init_decoder_params`, bridged to the port; plane
features and view rows are numpy-seeded and handed to both.

* `decode_projections`, f32 decoder: the same f32 matmuls summed in
  another order by XLA and by torch: atol 1e-5 on outputs of unit scale.
* `decode_projections`, `compute_dtype: bfloat16`: bf16 operands and f32
  accumulation in both; a different summation order can flip a bf16
  operand of the next layer by one ULP now and then: atol 5e-4 (measured
  up to 1.4e-4 on other draws of the same shapes; the f32 case 1.9e-8).
* A 16x16 `render_image` through the tiled sampler route (the fused
  kernel does not take "features"; JAX takes its non-fused tiled route,
  Pallas in interpret mode): the bf16 decoder as above, composited:
  atol 1e-4 (measured 2.1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.models import triplane as jtri
from nvsr_tpu_torch.models import triplane as ttri
from nvsr_tpu_torch.ops import fused_render
from torch_port_helpers import (FLAGSHIP, frame_scene, port_cfg, t,
                                tiled_frames, to_port)

FEATURES = dataclasses.replace(FLAGSHIP, rgb_dec_input="features")


def _decoder(seed, cfg, density_bias=None):
    tree = jax.tree.map(np.asarray, jtri.init_decoder_params(
        jax.random.PRNGKey(seed), cfg))
    tree = jax.tree.map(np.array, tree)       # writable copies
    if density_bias is not None:
        tree["members"][0]["fc_alpha"]["b"][:] = density_bias
    return tree


def test_init_has_fc_feat_and_rgb_width():
    tree = _decoder(0, FEATURES)
    m = tree["members"][0]
    assert m["fc_feat"]["w"].shape == (128, 48)
    # [fc_feat(h), view]: one 48-channel "plane" and the view channels
    assert m["rgb"][0]["w"].shape[0] == 48 + FEATURES.viewdir_channels
    assert not fused_render.supports(port_cfg(FEATURES))


@pytest.mark.parametrize("compute_dtype,atol", [(None, 1e-5),
                                                ("bfloat16", 5e-4)])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_decode_projections_matches_jax(rng, compute_dtype, atol,
                                        sigma_only):
    cfg = dataclasses.replace(FEATURES, compute_dtype=compute_dtype)
    tree = _decoder(1, cfg)
    pos = rng.standard_normal((3, 500, 48)).astype(np.float32)
    view = rng.standard_normal((500, cfg.viewdir_channels)).astype(
        np.float32)
    ref = jtri.decode_projections(jax.tree.map(jnp.asarray, tree), cfg,
                                  jnp.asarray(pos), jnp.asarray(view),
                                  sigma_only=sigma_only)
    out = ttri.decode_projections(to_port(tree), port_cfg(cfg), t(pos),
                                  t(view), sigma_only=sigma_only)
    assert out.shape == (500, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


def test_projections_features_still_raises():
    cfg = dataclasses.replace(FEATURES,
                              rgb_dec_input="projections_features")
    tree = _decoder(2, FEATURES)
    pos = torch.zeros((3, 4, 48))
    with pytest.raises(NotImplementedError):
        ttri.decode_projections(to_port(tree), port_cfg(cfg), pos,
                                torch.zeros((4, cfg.viewdir_channels)))


def test_render_image_sampler_route_matches_jax(rng):
    planes, view = frame_scene(rng, FEATURES)
    ref, out = tiled_frames(_decoder(3, FEATURES, 0.5),
                            _decoder(4, FEATURES, 0.5), FEATURES, planes,
                            planes, view)
    a, b = np.asarray(ref.fine.rgb), out.fine.rgb.numpy()
    assert a.shape == (16, 16, 3) and a.std() > 1e-3
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
