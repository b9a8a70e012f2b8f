"""The plane-SR branches the port added last, against nvsr_tpu.models.
plane_sr: SRResNet (with BatchNorm and with no_batch_norm, in eval and
train mode) and EDSR in tiles (`tile_size`), through apply_plane_sr, on
JAX-initialized weights carried by bridge.plane_sr_from_jax.

Tolerances (f32, the same functions summed in another order):
* SRResNet: atol 1e-5 on outputs of order 1 (measured 4.8e-7, eval and
  train alike);
* tiled EDSR against JAX's tiled path: atol 1e-5 (measured 3.6e-7);
* tiled EDSR against the port's own full-plane path: each HR pixel sees
  the same LR window, so at most the convolutions' summation order over
  another input extent can differ: atol 1e-6 (measured equal on the
  CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.models import plane_sr as jsr
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models import plane_sr as tsr

CPU = "cpu"


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(tsr.PlaneSRConfig)}
    return tsr.PlaneSRConfig(**{k: v for k, v in dataclasses.asdict(
        jcfg).items() if k in fields})


def _srresnet(rng, no_bn, scale):
    cfg = jsr.PlaneSRConfig(arch="SRResNet", in_channels=4, out_channels=4,
                            hidden_size=8, n_blocks=2, scale_factor=scale,
                            no_batch_norm=no_bn)
    tree = jax.tree.map(np.asarray, jsr.init_plane_sr_params(
        jax.random.PRNGKey(5), cfg))
    inner = tree["inner"]
    # random biases and BN statistics, so every parameter matters
    for p in [inner["conv1"], inner["conv3"]] + [
            u["conv"] for u in inner["upscale"]]:
        p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)
    for bn in [b[k] for b in inner["blocks"] for k in ("bn1", "bn2")
               if k in b] + ([inner["bn2"]] if "bn2" in inner else []):
        n = bn["scale"].shape
        bn["scale"] = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
        bn["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        bn["mean"] = (0.05 * rng.standard_normal(n)).astype(np.float32)
        bn["var"] = (0.5 + rng.random(n)).astype(np.float32)
    inner["prelu1"] = np.asarray(0.1, np.float32)
    return cfg, tree


@pytest.mark.parametrize("no_bn", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_srresnet_matches_jax(rng, no_bn, train):
    cfg, tree = _srresnet(rng, no_bn, scale=4)
    planes = rng.standard_normal((3, 4, 10, 10)).astype(np.float32)
    ref = np.asarray(jsr.apply_plane_sr(jax.tree.map(jnp.asarray, tree),
                                        cfg, jnp.asarray(planes),
                                        train=train))
    out = tsr.apply_plane_sr(bridge.plane_sr_from_jax(tree, CPU),
                             _port_cfg(cfg), torch.tensor(planes),
                             train=train).detach().numpy()
    assert out.shape == ref.shape == (3, 4, 40, 40)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_srresnet_init_has_the_jax_layout():
    cfg, tree = _srresnet(np.random.default_rng(0), False, scale=2)
    port = tsr.init_plane_sr_params(torch.Generator().manual_seed(0),
                                    _port_cfg(cfg), device=CPU)
    assert jax.tree.map(lambda a: np.shape(a), tree) == jax.tree.map(
        lambda a: tuple(a.shape), port, is_leaf=torch.is_tensor)
    assert float(port["inner"]["blocks"][0]["prelu"]) == 0.25
    assert "bn1" not in tsr.init_plane_sr_params(
        torch.Generator(), dataclasses.replace(_port_cfg(cfg),
                                               no_batch_norm=True),
        device=CPU)["inner"]["blocks"][0]


def test_bn_train_uses_the_biased_batch_variance(rng):
    """BatchNorm in training: statistics over N, H and W with the biased
    variance, eps 1e-5, as JAX's jnp.var."""
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    p = {k: torch.tensor(rng.random(3).astype(np.float32) + 0.5)
         for k in ("scale", "bias", "mean", "var")}
    out = tsr._bn(p, torch.tensor(x), train=True).numpy()
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    ref = np.asarray(jsr._bn(jp, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             train=True)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _edsr(tile):
    cfg = jsr.PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                            n_blocks=2, scale_factor=2, tile_size=tile)
    tree = jax.tree.map(np.asarray, jsr.init_plane_sr_params(
        jax.random.PRNGKey(6), cfg))
    # a larger init, so the trunk's output (~0.5) is not drowned by the
    # residual
    tree = jax.tree.map(lambda a: (5 * a).astype(np.float32), tree)
    return cfg, tree


@pytest.mark.parametrize("tile,hw", [(4, (10, 10)), (5, (10, 7)),
                                     (16, (12, 12))])
def test_tiled_edsr_matches_jax_and_full_plane(rng, tile, hw):
    cfg, tree = _edsr(tile)
    planes = rng.standard_normal((3, 4) + hw).astype(np.float32)
    ref = np.asarray(jsr.apply_plane_sr(jax.tree.map(jnp.asarray, tree),
                                        cfg, jnp.asarray(planes)))
    port = bridge.plane_sr_from_jax(tree, CPU)
    with torch.no_grad():
        out = tsr.apply_plane_sr(port, _port_cfg(cfg),
                                 torch.tensor(planes)).numpy()
        full = tsr.apply_plane_sr(port, _port_cfg(dataclasses.replace(
            cfg, tile_size=None)), torch.tensor(planes)).numpy()
    assert out.shape == ref.shape == full.shape == (3, 4, 2 * hw[0],
                                                    2 * hw[1])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, full, rtol=0, atol=1e-6)
    assert np.abs(out - np.asarray(jsr.upsample_plane(
        jnp.asarray(planes), 2, mode="bilinear"))).max() > 1e-2


def test_from_cfg_reads_tile_size_and_no_batch_norm():
    sr = {"model": {"type": "SRResNet", "no_batch_norm": True,
                    "hidden_size": 8, "n_blocks": 1}}
    cfg = tsr.PlaneSRConfig.from_cfg(sr, 2, 4, "bilinear", True)
    jcfg = jsr.PlaneSRConfig.from_cfg(sr, 2, 4, "bilinear", True)
    assert cfg.no_batch_norm is jcfg.no_batch_norm is True
    assert cfg.arch == "SRResNet" and cfg.required_padding == 0
    edsr = tsr.PlaneSRConfig.from_cfg({"model": {"tile_size": 64}}, 4, 48,
                                      "bilinear", True)
    assert edsr.tile_size == 64
    # tile_size is EDSR's alone, as in JAX
    with pytest.raises(AssertionError):
        tsr.apply_plane_sr(
            tsr.init_plane_sr_params(torch.Generator(), dataclasses.replace(
                cfg, tile_size=4), device=CPU),
            dataclasses.replace(cfg, tile_size=4), torch.zeros(1, 4, 6, 6))
