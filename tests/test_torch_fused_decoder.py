"""The standalone decoder (ops/fused_decoder.py, the plain version of
csrc/fused_decode.cu) against JAX's fused_decoder.fused_decode (Pallas in
interpret mode) and against the port's decode_projections.

Fixture: tests/test_tile_sampler.py::test_fused_decoder_matches_decode_
projections (N=256 points, bf16 tap pairs of unit-ish scale with zero pad
lanes, ty uniform, view features), numpy-seeded decoder weights handed to
both packages. Tolerances:
  * against JAX: atol 5e-4 (measured 1.5e-8 flagship, 1.2e-6 sum without
    skips, 5.1e-5 narrow with a skip after every layer): the same y-lerp,
    comb and bf16 roundings; XLA sums the split matmuls per input part,
    which can flip a bf16 activation by one ULP;
  * against decode_projections at compute_dtype bf16 on the y-lerped
    features: atol 1e-4 (measured 7.5e-9); JAX's own test allows 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.ops.pallas import fused_decoder as jfd
from nvsr_tpu_torch.models.triplane import decode_projections
from nvsr_tpu_torch.ops import fused_decoder as tfd
from nvsr_tpu_torch.ops.fused_render import pack_decoder
from torch_port_helpers import FLAGSHIP, np_decoder, port_cfg, t, to_port

N = 256
CFGS = {
    "flagship": FLAGSHIP,
    "sum-noskip": dataclasses.replace(FLAGSHIP, proj_combination="sum",
                                      skip_connect_every=None),
    "narrow": dataclasses.replace(FLAGSHIP, num_plane_channels=16,
                                  dec_density_layers=2, dec_rgb_layers=3,
                                  skip_connect_every=1),
}


def _fixture(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tree = np_decoder(rng, cfg)
    c, h = cfg.num_plane_channels, tfd.HALF
    tops = rng.standard_normal((3, N, h)).astype(np.float32) * 0.3
    bots = rng.standard_normal((3, N, h)).astype(np.float32) * 0.3
    tops[..., c:] = 0.0
    bots[..., c:] = 0.0
    ty = rng.uniform(size=(3, N, 1)).astype(np.float32)
    view = np.zeros((N, h), np.float32)
    view[:, :cfg.viewdir_channels] = rng.standard_normal(
        (N, cfg.viewdir_channels)).astype(np.float32) * 0.3
    rows = np.asarray(jnp.concatenate(
        [jnp.asarray(tops), jnp.asarray(bots)], axis=-1
    ).reshape(3 * N, 2 * h).astype(jnp.bfloat16).astype(jnp.float32))
    return tree, rows, ty.reshape(3 * N), view


@pytest.mark.parametrize("name", list(CFGS))
def test_fused_decode_matches_jax(name):
    cfg = CFGS[name]
    assert jfd.supports(cfg)
    tree, rows, ty, view = _fixture(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    wpack, bpack, plan_info = jfd.pack_decoder_weights(params, cfg, 0)
    ref = np.asarray(jfd.fused_decode(
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(ty).reshape(-1, 1),
        jnp.asarray(view), wpack, bpack, cfg=cfg, plan_info=plan_info, B=N,
        interpret=True))
    packed = pack_decoder(to_port(tree), port_cfg(cfg))
    out = tfd.fused_decode(t(rows).to(torch.bfloat16), t(ty), t(view),
                           packed, avg=cfg.proj_combination == "avg")
    assert out.shape == (N, tfd.OUT_LANES) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=0)
    assert torch.all(out[:, 4:] == 0)


def test_fused_decode_matches_decode_projections():
    """The y-lerp of the bf16 pairs, then the port's reference decoder at
    compute_dtype bf16 (JAX's own check of fused_decode, on the port)."""
    tree, rows, ty, view = _fixture(FLAGSHIP, seed=1)
    c = FLAGSHIP.num_plane_channels
    params = to_port(tree)
    packed = pack_decoder(params, port_cfg(FLAGSHIP))
    out = tfd.fused_decode(t(rows).to(torch.bfloat16), t(ty), t(view),
                           packed, avg=True)
    r3 = rows.reshape(3, N, 2 * tfd.HALF)
    ty3 = ty.reshape(3, N, 1)
    feats = r3[..., :c] * (1 - ty3) + r3[..., tfd.HALF:tfd.HALF + c] * ty3
    ref = decode_projections(params, port_cfg(FLAGSHIP), t(feats),
                             t(view[:, :FLAGSHIP.viewdir_channels]))
    np.testing.assert_allclose(out[:, :4].numpy(), ref.numpy(), atol=1e-4,
                               rtol=0)


def test_fused_decode_takes_column_ty():
    """ty as JAX passes it, [3N, 1], gives the same result as [3N]."""
    tree, rows, ty, view = _fixture(FLAGSHIP, seed=2)
    packed = pack_decoder(to_port(tree), port_cfg(FLAGSHIP))
    args = (t(rows).to(torch.bfloat16),)
    a = tfd.fused_decode(*args, t(ty), t(view), packed, avg=True)
    b = tfd.fused_decode(*args, t(ty).reshape(-1, 1), t(view), packed,
                         avg=True)
    assert torch.equal(a, b)
