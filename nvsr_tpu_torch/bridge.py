"""Weights and scenes carried across from the JAX package.

The JAX package stores parameters as pytrees with numpy leaves; the port
keeps the same nested layout with torch tensors, so nothing is reordered
(decoder weights stay [in, out], EDSR conv weights stay OIHW).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from nvsr_tpu_torch.models.triplane import TriplaneConfig


def _to_torch(tree, device=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), dtype=torch.float32, device=device)


def decoder_from_jax(tree, device=None):
    """Triplane decoder pytree {"members": [{"density": [{"w", "b"}, ...],
    "fc_alpha", "rgb": [...], "fc_rgb"}]} (numpy or jax leaves) -> the
    same structure of f32 tensors on `device`."""
    return _to_torch(tree, device)


def plane_sr_from_jax(tree, device=None):
    """Plane-SR params {"inner": {"conv_input", "blocks": [{"conv1",
    "conv2"}], "conv_mid", "upscale": [...], "conv_output"}, "norm"?} ->
    the same structure of f32 tensors (conv weights OIHW)."""
    return _to_torch(tree, device)


class _GateUnpickler(pickle.Unpickler):
    """Resolves the JAX TriplaneConfig to the port's mirror, so loading
    the asset never imports nvsr_tpu (and hence JAX)."""

    def find_class(self, module, name):
        if (module, name) == ("nvsr_tpu.models.triplane", "TriplaneConfig"):
            return TriplaneConfig
        if module.split(".")[0] in ("nvsr_tpu", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"refusing to import {module}.{name} from the asset")
        return super().find_class(module, name)


def load_gate_asset(path):
    """Read the committed trained gate scene (assets/gate_scene.pkl,
    written by tools/make_gate_scene.py): a dict with the port's
    TriplaneConfig under "model_cfg" and numpy arrays elsewhere."""
    with open(path, "rb") as f:
        return _GateUnpickler(f).load()
