"""nvsr_tpu_torch.convert against nvsr_tpu.convert on the reference-layout
torch state dicts that tests/test_convert.py builds (and their ensemble,
legacy, no-viewdir, prefix-less and normalized variants): conversion is
transposes and copies, so every leaf must be bit-equal to JAX's, dtype
included. apply_triplane on the converted decoder is then held against
JAX's apply_triplane on its own conversion (f32, the same function
summed in another order: atol 1e-5 on outputs below 1, measured
4.5e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu import convert as jc
from nvsr_tpu.models.triplane import TriplaneConfig as JTriplaneConfig
from nvsr_tpu.models.triplane import apply_triplane as j_apply_triplane
from nvsr_tpu_torch import convert as tc
from nvsr_tpu_torch.models.triplane import apply_triplane
from test_convert import _build_reference_decoder_sd
from torch_port_helpers import BOX, port_cfg

CPU = "cpu"
DEC_CFG = JTriplaneConfig(dec_channels=16, num_plane_channels=4,
                          proj_combination="avg",
                          viewdir_proj_combination="concat_pos")


def _bit_equal(jtree, ttree):
    """Every leaf of the port's tree equal to JAX's, bit for bit."""
    lj, tj = jax.tree.flatten(jtree)
    lt = tj.flatten_up_to(ttree)
    assert len(lj) == len(lt) > 0
    for a, b in zip(lj, lt):
        assert torch.is_tensor(b) and b.device.type == CPU
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _two_member_sd(cfg, seed=3):
    """A 2-member ensemble decoder with fc_feat heads, in the reference's
    key layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(prefix, i, o):
        sd[prefix + ".weight"] = torch.randn(o, i, generator=g) * 0.2
        sd[prefix + ".bias"] = torch.randn(o, generator=g) * 0.1

    for m in range(2):
        lin(f"density_dec.{m}.0", cfg.density_in_channels, cfg.dec_channels)
        lin(f"density_dec.{m}.1", cfg.dec_channels, cfg.dec_channels)
        lin(f"fc_alpha.{m}", cfg.dec_channels, 1)
        lin(f"fc_feat.{m}", cfg.dec_channels, cfg.num_plane_channels)
        lin(f"rgb_dec.{m}.0", cfg.rgb_in_channels, cfg.dec_channels)
        lin(f"fc_rgb.{m}", cfg.dec_channels, 3)
    for d in range(3):
        sd[f"coord_projector.rot_mats_NON_LEARNED.{d}"] = torch.eye(3)
    # keys the conversion skips
    sd["planes_.sclego_D0"] = torch.zeros(1, 4, 8, 8)
    return sd


@pytest.mark.parametrize("layout", ["single", "ensemble", "legacy"])
def test_decoder_conversion_bit_equal(layout):
    if layout == "ensemble":
        sd = _two_member_sd(DEC_CFG)
    else:
        sd = _build_reference_decoder_sd(DEC_CFG)
    if layout == "legacy":
        sd = {k.replace(".0.", ".", 1) if "NON_LEARNED" not in k else k: v
              for k, v in sd.items()}
    jparams, jrot = jc.convert_triplane_decoder(sd)
    tparams, trot = tc.convert_triplane_decoder(sd, device=CPU)
    _bit_equal(jparams, tparams)
    _bit_equal(jrot, trot)
    assert len(tparams["members"]) == (2 if layout == "ensemble" else 1)


def test_decoder_without_rot_mats():
    sd = {k: v for k, v in _build_reference_decoder_sd(DEC_CFG).items()
          if "NON_LEARNED" not in k}
    assert jc.convert_triplane_decoder(sd)[1] is None
    assert tc.convert_triplane_decoder(sd, device=CPU)[1] is None


def test_apply_triplane_on_converted_weights(rng):
    sd = _build_reference_decoder_sd(DEC_CFG)
    jparams, jrot = jc.convert_triplane_decoder(sd)
    tparams, trot = tc.convert_triplane_decoder(sd, device=CPU)
    planes = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    pv = rng.standard_normal((4, 4, 4)).astype(np.float32)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    x = np.concatenate([pts, dirs], -1)
    ref = np.asarray(j_apply_triplane(
        jax.tree.map(jnp.asarray, jparams), DEC_CFG, jnp.asarray(planes),
        jnp.asarray(pv), BOX, jnp.asarray(x), rot_mats=np.asarray(jrot)))
    out = apply_triplane(tparams, port_cfg(DEC_CFG), torch.tensor(planes),
                         torch.tensor(pv), BOX, torch.tensor(x),
                         rot_mats=trot).numpy()
    assert out.shape == ref.shape == (64, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _nerf_sd(viewdirs, seed=1):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(prefix, i, o):
        sd[prefix + ".weight"] = torch.randn(o, i, generator=g) * 0.2
        sd[prefix + ".bias"] = torch.randn(o, generator=g) * 0.1

    lin("layer1", 15, 16)
    for i in range(3):
        lin(f"layers_xyz.{i}", 16, 16)
    if viewdirs:
        lin("layers_dir.0", 9 + 16, 8)
        lin("fc_alpha", 16, 1)
        lin("fc_rgb", 8, 3)
        lin("fc_feat", 16, 16)
    else:
        lin("fc_out", 16, 4)
    return sd


@pytest.mark.parametrize("viewdirs", [True, False])
def test_nerf_mlp_conversion_bit_equal(viewdirs):
    sd = _nerf_sd(viewdirs)
    tree = tc.convert_nerf_mlp(sd, device=CPU)
    _bit_equal(jc.convert_nerf_mlp(sd), tree)
    assert ("fc_out" in tree) != viewdirs


def _sr_sd(seed=2, norm=False):
    g = torch.Generator().manual_seed(seed)

    def conv(o, i, k):
        return torch.randn(o, i, k, k, generator=g) * 0.05

    sd = {"inner_model.conv_input.weight": conv(8, 4, 3),
          "inner_model.conv_mid.weight": conv(8, 8, 3),
          "inner_model.upscale.0.weight": conv(32, 8, 3),
          "inner_model.upscale.2.weight": conv(32, 8, 3),
          "inner_model.conv_output.weight": conv(4, 8, 3),
          "inner_model.conv_output.bias": torch.randn(4, generator=g)}
    for i in range(2):
        sd[f"inner_model.residual.{i}.conv1.weight"] = conv(8, 8, 3)
        sd[f"inner_model.residual.{i}.conv2.weight"] = conv(8, 8, 3)
    if norm:
        sd["planes_mean_NON_LEARNED"] = torch.randn(1, 4, 1, 1, generator=g)
        sd["planes_std_NON_LEARNED"] = torch.rand(1, 4, 1, 1, generator=g)
    return sd


@pytest.mark.parametrize("prefix,norm", [(True, False), (False, False),
                                         (True, True)])
def test_plane_sr_conversion_bit_equal(prefix, norm):
    sd = _sr_sd(norm=norm)
    if not prefix:
        sd = {k.replace("inner_model.", ""): v for k, v in sd.items()}
    tree = tc.convert_plane_sr(sd, device=CPU)
    _bit_equal(jc.convert_plane_sr(sd), tree)
    assert len(tree["inner"]["upscale"]) == 2
    assert ("norm" in tree) == norm


def _par(with_states):
    g = torch.Generator().manual_seed(4)
    par = {"params": {f"sclego_DS8_PlRes16_8_D{d}": torch.randn(
        1, 4, *((16, 16) if d < 3 else (8, 8)), generator=g)
        for d in (3, 0, 2, 1)},
        "coords_normalization": torch.randn(2, 5, generator=g)}
    if with_states:
        par["opt_states"] = [
            {"step": torch.tensor(5.0),
             "exp_avg": torch.randn(1, 4, n, n, generator=g),
             "exp_avg_sq": torch.rand(1, 4, n, n, generator=g)}
            for n in (16, 16, 16, 8)]
    else:
        par["opt_states"] = [None] * 4
    return par


@pytest.mark.parametrize("with_states", [True, False])
def test_par_conversion_bit_equal(with_states):
    par = _par(with_states)
    jplanes, jbox, jmom = jc.convert_par_file(par)
    tplanes, tbox, tmom = tc.convert_par_file(par, device=CPU)
    _bit_equal(jplanes, tplanes)
    _bit_equal(jbox, tbox)
    if with_states:
        assert tmom["count"] == jmom["count"] == 5
        _bit_equal({"mu": jmom["mu"], "nu": jmom["nu"]},
                   {"mu": tmom["mu"], "nu": tmom["nu"]})
    else:
        assert tmom is None and jmom is None


def test_load_torch_checkpoint_round_trip(tmp_path):
    """A checkpoint as the reference saves it (torch.save of a dict of
    state dicts) reads back through load_torch_checkpoint and converts
    to the same leaves as the dict it was made from."""
    sd = _build_reference_decoder_sd(DEC_CFG)
    path = tmp_path / "checkpoint.ckpt"
    torch.save({"model_coarse_state_dict": sd, "SR_model": _sr_sd()}, path)
    ck = tc.load_torch_checkpoint(str(path))
    _bit_equal(jc.convert_triplane_decoder(sd)[0],
               tc.convert_triplane_decoder(ck["model_coarse_state_dict"],
                                           device=CPU)[0])
    _bit_equal(jc.convert_plane_sr(_sr_sd()),
               tc.convert_plane_sr(ck["SR_model"], device=CPU))
