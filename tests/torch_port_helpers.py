"""Shared inputs for the tests/test_torch_*.py parity suites: numpy-seeded
decoder weights and geometry handed to both the JAX reference
(nvsr_tpu) and the PyTorch port (nvsr_tpu_torch)."""

import dataclasses

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
    return bridge.decoder_from_jax(tree)


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
