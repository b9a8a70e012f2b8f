"""The weight bridge and the port's import boundary."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.models import plane_sr as jp
from nvsr_tpu.models import triplane as jt
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models.triplane import TriplaneConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves_equal(jtree, ttree):
    jl, jdef = jax.tree.flatten(jtree)
    tl = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), b)


def test_decoder_round_trip():
    cfg = jt.TriplaneConfig(dec_channels=16, num_plane_channels=8,
                            dec_density_layers=5, dec_rgb_layers=5,
                            skip_connect_every=3,
                            viewdir_proj_combination="concat_pos")
    tree = jt.init_decoder_params(jax.random.PRNGKey(1), cfg)
    port = bridge.decoder_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")
    assert port["members"][0]["density"][4]["w"].shape == (16 + 8, 16)
    _leaves_equal(tree, port)


def test_plane_sr_round_trip_keeps_oihw():
    cfg = jp.PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                           n_blocks=2, scale_factor=2)
    tree = jp.init_plane_sr_params(jax.random.PRNGKey(2), cfg)
    port = bridge.plane_sr_from_jax(tree, device="cpu")
    assert port["inner"]["conv_input"]["w"].shape == (8, 4, 3, 3)
    assert port["inner"]["upscale"][0]["w"].shape == (32, 8, 3, 3)
    _leaves_equal(tree, port)


def test_load_gate_asset_maps_config():
    a = bridge.load_gate_asset(os.path.join(REPO, "assets",
                                            "gate_scene.pkl"))
    assert isinstance(a["model_cfg"], TriplaneConfig)
    assert a["model_cfg"].num_plane_channels == a["planes_pos"].shape[1]
    assert a["gt"].shape == (a["h"], a["w"], 3)


def test_load_gate_asset_refuses_jax_objects(tmp_path):
    p = tmp_path / "bad.pkl"
    p.write_bytes(pickle.dumps({"x": jnp.zeros(2)}))
    with pytest.raises(pickle.UnpicklingError):
        bridge.load_gate_asset(p)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, importlib, pkgutil, nvsr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    nvsr_tpu_torch.__path__, 'nvsr_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nvsr_tpu'))\n"
        "print(' '.join(mods), bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    *mods, bad = out.stdout.split(" ")
    assert len(mods) >= 19 and bad.strip() == "[]", out.stdout
    assert {"nvsr_tpu_torch.ops." + m for m in (
        "fused_render", "fused_decoder", "gather_dma")} <= set(mods), mods
    assert {"nvsr_tpu_torch.convert", "nvsr_tpu_torch.ops.encoding",
            "nvsr_tpu_torch.models.nerf_mlp"} <= set(mods), mods


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """fused_render_rays dispatches on the tensor's device alone: a CUDA
    table goes to the kernel wrapper (here a stub that records the call),
    never to the plain version."""
    from nvsr_tpu_torch import kernels
    from nvsr_tpu_torch.ops import fused_render

    calls = []

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def kernel(*args, **kw):
        calls.append(kw)
        return "kernel"

    def plain(*args, **kw):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(kernels, "triplane_render", kernel)
    monkeypatch.setattr(fused_render, "fused_render_reference", plain)
    table = torch.zeros((3, 4, 4, 16)).as_subclass(FakeCuda)
    z = torch.zeros((2, 3))
    out, aux = fused_render.fused_render_rays(
        table, None, torch.zeros((2, 3)), torch.zeros((2, 3)), z, None,
        np.zeros(24, np.float32), align_corners=True, avg=True,
        sigma_only=True)
    assert out == "kernel" and aux == {"overflow_frac": 0.0}
    assert calls == [{"align_corners": True, "avg": True,
                      "sigma_only": True, "cubic": False}]


def test_kernel_wrapper_refuses_cpu_tensors():
    from nvsr_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.triplane_render(torch.zeros((3, 4, 4, 16)), None, None,
                                None, torch.zeros((2, 3)), None, None,
                                align_corners=True, avg=True,
                                sigma_only=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.triplane_render_grids(torch.zeros((3, 4, 4, 16)), None,
                                      torch.zeros((3, 5, 2)), None,
                                      align_corners=True, avg=True,
                                      sigma_only=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_decode_forward(torch.zeros((3, 128)), None, None,
                                     None, avg=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gather_rows_forward(torch.zeros((4, 4)), None)


def test_new_entries_send_other_devices_to_the_kernel():
    """The points entry's grids kernel, the standalone decoder and the row
    gather dispatch on the tensor's device alone: a tensor that is not on
    the CPU (here on the meta device) goes to the kernel wrapper, which
    raises; the plain version is never taken."""
    from nvsr_tpu_torch.ops import fused_decoder, fused_render, gather_dma
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_render.tiled_render_chunked(
            torch.zeros((3, 4, 4, 16), **meta), None,
            torch.zeros((3, 5, 2), **meta), None, align_corners=True,
            avg=True, sigma_only=True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_decoder.fused_decode(torch.zeros((3, 128), **meta),
                                   torch.zeros((3,), **meta),
                                   torch.zeros((1, 64), **meta), None,
                                   avg=True)
    with pytest.raises(ValueError, match="CUDA"):
        gather_dma.gather_rows_dma(torch.zeros((4, 256), **meta),
                                   torch.zeros((1024,), dtype=torch.int32,
                                               **meta))


def test_bridge_defaults_to_the_card():
    """The port's entry points run on the card unless the caller names
    another device."""
    import inspect
    from nvsr_tpu_torch import convert
    from nvsr_tpu_torch.models import nerf_mlp, plane_sr, triplane
    for fn in (bridge.decoder_from_jax, bridge.plane_sr_from_jax,
               bridge.planes_from_jax, triplane.init_decoder_params,
               plane_sr.init_plane_sr_params, plane_sr.init_edsr_params,
               plane_sr.init_srresnet_params, bridge.nerf_mlp_from_jax,
               nerf_mlp.init_nerf_mlp_params,
               convert.convert_triplane_decoder, convert.convert_nerf_mlp,
               convert.convert_plane_sr, convert.convert_par_file):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    planes = {"pos": np.ones((3, 2, 4, 4)), "view": np.zeros((2, 3, 3))}
    out = bridge.planes_from_jax(planes, device="cpu")
    assert out["pos"].dtype == torch.float32 and out["view"].shape == (2, 3,
                                                                       3)
