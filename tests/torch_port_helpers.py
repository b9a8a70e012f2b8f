"""Shared inputs for the tests/test_torch_*.py parity suites: numpy-seeded
decoder weights and geometry handed to both the JAX reference
(nvsr_tpu) and the PyTorch port (nvsr_tpu_torch)."""

import dataclasses
import importlib
import os
import time

import numpy as np
import torch

from nvsr_tpu.models.triplane import TriplaneConfig as JaxTriplaneConfig
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models.triplane import TriplaneConfig


FLAGSHIP = JaxTriplaneConfig(dec_channels=128, num_plane_channels=48,
                             dec_density_layers=4, dec_rgb_layers=4,
                             skip_connect_every=3, proj_combination="avg",
                             viewdir_proj_combination="concat_pos",
                             compute_dtype="bfloat16")


def jax_native_ready(timeout_s=120):
    """Whether the JAX package's native store library loads, waiting up
    to timeout_s while another process may still be building it.
    nvsr_tpu's builder links into native/build/ in place, so a process
    that opens the file mid-link sees a partial library and its probe
    stays False; reloading the module (nvsr_tpu.planes_store holds the
    same module object) clears that probe, and once the file is whole
    the next probe loads it."""
    from nvsr_tpu.utils import native_store
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "native", "nvsr_native.cpp")
    deadline = time.monotonic() + timeout_s
    while not native_store.available():
        if not os.path.isfile(src) or time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        importlib.reload(native_store)
    return True


def port_cfg(jcfg) -> TriplaneConfig:
    """The port's mirror of a JAX TriplaneConfig."""
    return TriplaneConfig(**dataclasses.asdict(jcfg))


def np_decoder(rng, cfg: JaxTriplaneConfig, scale: float = 1.0):
    """Decoder pytree with numpy leaves in the JAX layout (torch Linear
    init bounds, times `scale`)."""
    def lin(i, o):
        bound = scale / np.sqrt(i)
        return {"w": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (o,)).astype(np.float32)}

    def branch(in_ch, n):
        layers = [lin(in_ch, cfg.dec_channels)]
        for ln in range(n - 1):
            extra = in_ch if cfg.is_skip_layer(ln) else 0
            layers.append(lin(cfg.dec_channels + extra, cfg.dec_channels))
        return layers

    m = {"density": branch(cfg.density_in_channels, cfg.dec_density_layers),
         "fc_alpha": lin(cfg.dec_channels, 1),
         "rgb": branch(cfg.rgb_in_channels, cfg.dec_rgb_layers),
         "fc_rgb": lin(cfg.dec_channels, 3)}
    return {"members": [m]}


def to_port(tree):
    return bridge.decoder_from_jax(tree, device="cpu")


def tile_rays_geometry(R=16, S=8, z0=0.8, z1=3.2):
    """One coherent 4x4 ray tile looking down -z (the geometry of
    tests/test_tile_sampler.py::test_ray_entry_megakernel_matches)."""
    origin = np.array([0.0, 0.0, 1.8], np.float32)
    side = int(round(np.sqrt(R)))
    dirs = np.stack(np.meshgrid(np.linspace(-.05, .05, side),
                                np.linspace(-.05, .05, side)),
                    -1).reshape(-1, 2)
    d = np.concatenate([dirs, -np.ones((R, 1))], -1).astype(np.float32)
    z = np.ascontiguousarray(np.broadcast_to(
        np.linspace(z0, z1, S, dtype=np.float32), (R, S)))
    origins = np.ascontiguousarray(np.broadcast_to(origin, (R, 3)))
    viewdirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                ).astype(np.float32)
    return origins, d, viewdirs, z


BOX = np.stack([[-2, -2, -2, -np.pi, -np.pi / 2],
                [2, 2, 2, np.pi, np.pi / 2]]).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


# -- the 16x16 tiled-render fixture of
# tests/test_tile_sampler.py::test_bicubic_megakernel_matches_xla

FRAME_BOX = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                      [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)


def frame_decoder(rng, cfg: JaxTriplaneConfig):
    """np_decoder with a positive density bias, so the frame has content
    to compare."""
    tree = np_decoder(rng, cfg)
    tree["members"][0]["fc_alpha"]["b"][:] = 0.5
    return tree


def frame_scene(rng, cfg: JaxTriplaneConfig, res: int = 64):
    """Positional planes [3, C, res, res] and a 16^2 view plane."""
    planes = (0.1 * rng.standard_normal(
        (3, cfg.num_plane_channels, res, res))).astype(np.float32)
    view = (0.1 * rng.standard_normal(
        (cfg.viewdir_channels, 16, 16))).astype(np.float32)
    return planes, view


def tiled_frames(tree_c, tree_f, cfg, planes_c, planes_f, view, port_f=None):
    """The 16x16 fixture frame through JAX's tiled eval (8x8 tiles of 64
    rays, TileSamplerConfig(tile_rays=64), Pallas interpret mode,
    sigma-only coarse) and the port's (tile_rays=64) -> (JAX result, port
    result); both hold it without clamping. port_f: the port's fine
    planes, when they differ from JAX's."""
    import jax
    import jax.numpy as jnp
    from nvsr_tpu import render as jrender
    from nvsr_tpu.ops.geometry import get_ray_bundle as j_get_ray_bundle
    from nvsr_tpu.ops.pallas.tile_sampler import TileSamplerConfig
    from nvsr_tpu_torch import render as trender
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.5
    focal = 0.5 * 16 / np.tan(0.3)
    ro, rd = j_get_ray_bundle(16, 16, focal, jnp.asarray(c2w))
    tc = TileSamplerConfig(tile_rays=64)
    mkj = lambda tree, planes, so: jrender.make_triplane_point_fn(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(planes),
        jnp.asarray(view), FRAME_BOX, tile_cfg=tc, sigma_only=so)
    ref = jrender.render_image(
        mkj(tree_c, planes_c, True), mkj(tree_f, planes_f, False), ro, rd,
        jax.random.PRNGKey(1), jrender.RenderConfig(
            num_coarse=8, num_fine=8, perturb=False, ray_block=256),
        near=2.0, far=6.0, tile=8)
    tro, trd = get_ray_bundle(16, 16, focal, t(c2w))
    mkt = lambda tree, planes, so: trender.make_triplane_point_fn(
        to_port(tree), port_cfg(cfg), t(planes), t(view), FRAME_BOX,
        tile_rays=64, sigma_only=so)
    with torch.no_grad():
        out = trender.render_image(
            mkt(tree_c, planes_c, True),
            mkt(tree_f, planes_f if port_f is None else port_f, False), tro,
            trd, trender.RenderConfig(num_coarse=8, num_fine=8,
                                      perturb=False, ray_block=256),
            near=2.0, far=6.0, tile=8)
    assert float(ref.aux["overflow_frac"]) == 0.0
    assert out.aux == {"overflow_frac": 0.0}
    return ref, out
