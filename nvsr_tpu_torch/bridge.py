"""Weights and scenes carried across between the JAX package and the port.

The JAX package stores parameters as pytrees with numpy leaves; the port
keeps the same nested layout with torch tensors, so nothing is reordered
(decoder weights stay [in, out], EDSR conv weights stay OIHW). The
`*_from_jax` functions read such a tree into tensors on a device; the
`*_to_jax` functions turn the port's trees back into numpy trees in the
JAX layout, as its checkpoints hold them.
"""

from __future__ import annotations

import numpy as np
import torch

from nvsr_tpu_torch.models.triplane import TriplaneConfig
from nvsr_tpu_torch.utils.io import PortUnpickler


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), dtype=torch.float32, device=device)


def decoder_from_jax(tree, device="cuda"):
    """Triplane decoder pytree {"members": [{"density": [{"w", "b"}, ...],
    "fc_alpha", "rgb": [...], "fc_rgb"}]} (numpy or jax leaves) -> the
    same structure of f32 tensors on `device` (the card unless the
    caller names another)."""
    return _to_torch(tree, device)


def plane_sr_from_jax(tree, device="cuda"):
    """Plane-SR params {"inner": {"conv_input", "blocks": [{"conv1",
    "conv2"}], "conv_mid", "upscale": [...], "conv_output"}, "norm"?} ->
    the same structure of f32 tensors (conv weights OIHW) on `device`."""
    return _to_torch(tree, device)


def nerf_mlp_from_jax(tree, device="cuda"):
    """Baseline NeRF MLP params {"layer1", "layers_xyz": [...],
    "layers_dir"?: [...], "fc_alpha"?, "fc_rgb"?, "fc_feat"?, "fc_out"?}
    (each {"w": [in, out], "b"}) -> the same structure of f32 tensors on
    `device`."""
    return _to_torch(tree, device)


def planes_from_jax(tree, device="cuda"):
    """A scene's plane dict {"pos": [P, C, H, W], "view": [Cv, Hv, Wv]?}
    -> the same dict of f32 tensors on `device`."""
    return _to_torch(tree, device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_numpy(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def decoder_to_jax(tree):
    """A decoder pytree of tensors -> the same structure of numpy arrays
    (the checkpoints' model_coarse_state_dict / model_fine_state_dict)."""
    return _to_numpy(tree)


def plane_sr_to_jax(tree):
    """Plane-SR params of tensors -> numpy (the checkpoints' SR_model)."""
    return _to_numpy(tree)


def nerf_mlp_to_jax(tree):
    """Baseline NeRF MLP params of tensors -> numpy (the baseline
    checkpoints' model_coarse_state_dict / model_fine_state_dict)."""
    return _to_numpy(tree)


def optimizer_state_to_jax(state):
    """An optimizer state in optax.adam's layout (ModuleOptimizer.state:
    the utils.io stand-ins of ScaleByAdamState and EmptyState, tensor
    moments) -> the same NamedTuples with numpy leaves; utils.io.
    save_pickle writes them under optax's names."""
    return _to_numpy(state)


class _GateUnpickler(PortUnpickler):
    """Also resolves the JAX TriplaneConfig to the port's mirror, so
    loading the asset never imports nvsr_tpu (and hence JAX)."""

    def find_class(self, module, name):
        if (module, name) == ("nvsr_tpu.models.triplane", "TriplaneConfig"):
            return TriplaneConfig
        return super().find_class(module, name)


def load_gate_asset(path):
    """Read the committed trained gate scene (assets/gate_scene.pkl,
    written by tools/make_gate_scene.py): a dict with the port's
    TriplaneConfig under "model_cfg" and numpy arrays elsewhere."""
    with open(path, "rb") as f:
        return _GateUnpickler(f).load()
