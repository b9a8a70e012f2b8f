"""Baseline NeRF MLP, vanilla and Mip-NeRF (counterpart of
nvsr_tpu/models/nerf_mlp.py): an xyz trunk with skip concats, a density
head, and a viewdir head for rgb. The MipNeRF_baseline.yml workflow runs
it. Parameters keep the JAX pytree layout ({"w": [in, out], "b": [out]}
per layer); the matmuls are plain torch, as they are plain XLA in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nvsr_tpu_torch.models.triplane import _init_linear


@dataclasses.dataclass(frozen=True)
class NeRFMLPConfig:
    num_layers: int = 4
    num_layers_dir: int = 1
    dirs_hidden_width_ratio: int = 2
    hidden_size: int = 128
    skip_connect_every: int = 4
    num_encoding_fn_xyz: int = 6
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    use_viewdirs: bool = True
    # explicit input dims, for the mip path, where the encoding's output
    # dim does not follow from include_input
    input_dim_xyz: Optional[int] = None
    input_dim_dir: Optional[int] = None
    xyz_input_2_dir: bool = False

    @property
    def dim_xyz(self) -> int:
        if self.input_dim_xyz is not None:
            if not self.use_viewdirs and self.input_dim_dir is not None:
                return self.input_dim_xyz + self.input_dim_dir
            return self.input_dim_xyz
        inc = 3 if self.include_input_xyz else 0
        return inc + 2 * 3 * self.num_encoding_fn_xyz

    @property
    def dim_dir(self) -> int:
        if not self.use_viewdirs:
            return 0
        if self.input_dim_xyz is not None:
            return self.input_dim_dir or 0
        inc = 3 if self.include_input_dir else 0
        return inc + 2 * 3 * self.num_encoding_fn_dir


def _linear(p, x):
    return x @ p["w"] + p["b"]


def init_nerf_mlp_params(generator: torch.Generator, cfg: NeRFMLPConfig,
                         device="cuda"):
    """Parameter pytree drawn from `generator` with the JAX init's
    distributions (torch Linear's bounds, as the triplane decoder's) and
    layer plan, on `device`."""
    def lin(i, o):
        return _init_linear(generator, i, o, device)

    params = {"layer1": lin(cfg.dim_xyz, cfg.hidden_size)}
    layers = []
    for i in range(cfg.num_layers - 1):
        skip = (i % cfg.skip_connect_every == 0 and i > 0
                and i != cfg.num_layers - 1)
        layers.append(lin(cfg.dim_xyz + cfg.hidden_size if skip
                          else cfg.hidden_size, cfg.hidden_size))
    params["layers_xyz"] = layers
    if cfg.use_viewdirs:
        dir_hidden = cfg.hidden_size // cfg.dirs_hidden_width_ratio
        in_dim = (cfg.dim_dir + cfg.hidden_size
                  + (cfg.dim_xyz if cfg.xyz_input_2_dir else 0))
        params["layers_dir"] = [lin(in_dim, dir_hidden)] + [
            lin(dir_hidden, dir_hidden)
            for _ in range(cfg.num_layers_dir - 1)]
        params["fc_alpha"] = lin(cfg.hidden_size, 1)
        params["fc_rgb"] = lin(dir_hidden, 3)
        params["fc_feat"] = lin(cfg.hidden_size, cfg.hidden_size)
    else:
        params["fc_out"] = lin(cfg.hidden_size, 4)
    return params


def apply_nerf_mlp(params, cfg: NeRFMLPConfig, x):
    """[N, dim_xyz (+ dim_dir)] encoded input -> [N, 4] (rgb, sigma).

    The trunk concatenates the xyz input before every layer i > 0 with
    i % skip_connect_every == 0 (the reference's loop tests
    `i != len(layers_xyz)`, always true, so the last trunk layer can
    take a skip too)."""
    xyz = x[..., :cfg.dim_xyz]
    h = _linear(params["layer1"], xyz)
    for i, p in enumerate(params["layers_xyz"]):
        if i % cfg.skip_connect_every == 0 and i > 0:
            h = torch.cat([h, xyz], dim=-1)
        h = torch.relu(_linear(p, h))
    if not cfg.use_viewdirs:
        return _linear(params["fc_out"], h)
    feat = torch.relu(_linear(params["fc_feat"], h))
    alpha = _linear(params["fc_alpha"], h)
    h = torch.cat([feat, x[..., cfg.dim_xyz:]], dim=-1)
    if cfg.xyz_input_2_dir:
        h = torch.cat([xyz, h], dim=-1)
    for p in params["layers_dir"]:
        h = torch.relu(_linear(p, h))
    return torch.cat([_linear(params["fc_rgb"], h), alpha], dim=-1)
