"""Reference-checkpoint conversion: the reference implementation's torch
state dicts and `.par` plane files -> the port's parameter trees
(counterpart of nvsr_tpu/convert.py, which returns the same trees with
numpy leaves).

Layouts read:
  * TwoDimPlanesModel decoders: `density_dec.{m}.{l}`, `rgb_dec...`,
    `fc_alpha.{m}`, ..., including the legacy pre-ensemble layout (the
    `.` -> `.0.` migration) and the `rot_mats_NON_LEARNED` plane bases;
  * FlexibleNeRFModel (the baseline NeRF MLP), with or without viewdirs;
  * the plane SR net (EDSR inside PlanesSR), with or without the
    `inner_model.` prefix, and its `planes_{mean,std}_NON_LEARNED`
    input normalization;
  * per-scene `.par` files ({'params', 'opt_states',
    'coords_normalization'}), with the torch Adam moments mapped onto
    the optax Adam layout.

Conversion is transposes and copies only: each leaf keeps its dtype and
its bits. The trees come back as tensors on `device`, the card unless the
caller names another. Nothing is written: a logdir is made by the
Experiment, from trees like these.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch


def _t(x, device):
    """A copy of a tensor or array on `device`, its dtype kept."""
    if torch.is_tensor(x):
        return x.detach().to(device, copy=True)
    return torch.tensor(np.asarray(x), device=device)


def _lin(sd, prefix, device):
    """torch Linear [out, in] -> {"w": [in, out], "b": [out]}."""
    return {"w": _t(sd[prefix + ".weight"], device).T.contiguous(),
            "b": _t(sd[prefix + ".bias"], device)}


def _ensure_ensemble_layout(sd):
    """The `.` -> `.0.` ensemble migration of legacy decoder checkpoints
    (every key but the NON_LEARNED buffers)."""
    needs = any("density_dec" in k
                and re.search(r"density_dec\.(\d)+\.(\d)+\.", k) is None
                for k in sd)
    if not needs:
        return sd
    return OrderedDict(
        (k if "NON_LEARNED" in k else k.replace(".", ".0.", 1), v)
        for k, v in sd.items())


def convert_triplane_decoder(state_dict, device="cuda"):
    """TwoDimPlanesModel state dict -> (decoder tree {"members": [...]},
    rot_mats [P, 3, 3] or None), tensors on `device`. Plane and SR keys
    are skipped."""
    sd = {k: v for k, v in state_dict.items()
          if "planes_." not in k and "SR_model" not in k}
    sd = _ensure_ensemble_layout(sd)

    members_idx = sorted({int(m.group(1)) for k in sd
                          for m in [re.match(r"density_dec\.(\d+)\.", k)]
                          if m})
    members = []
    for mi in members_idx:
        m = {}
        for branch, name in (("density", "density_dec"), ("rgb", "rgb_dec")):
            layers_idx = sorted({
                int(mm.group(1)) for k in sd
                for mm in [re.match(rf"{name}\.{mi}\.(\d+)\.weight", k)]
                if mm})
            m[branch] = [_lin(sd, f"{name}.{mi}.{li}", device)
                         for li in layers_idx]
        m["fc_alpha"] = _lin(sd, f"fc_alpha.{mi}", device)
        m["fc_rgb"] = _lin(sd, f"fc_rgb.{mi}", device)
        if f"fc_feat.{mi}.weight" in sd:
            m["fc_feat"] = _lin(sd, f"fc_feat.{mi}", device)
        members.append(m)

    rot_keys = sorted([k for k in state_dict if "rot_mats_NON_LEARNED" in k],
                      key=lambda k: int(k.split(".")[-1]))
    rot_mats = (torch.stack([_t(state_dict[k], device) for k in rot_keys])
                if rot_keys else None)
    return {"members": members}, rot_mats


def convert_nerf_mlp(state_dict, device="cuda"):
    """FlexibleNeRFModel state dict -> the baseline MLP's tree
    (models/nerf_mlp.py) on `device`: `fc_out` without viewdirs, else
    `layers_dir`, `fc_alpha`, `fc_rgb` and `fc_feat`."""
    sd = dict(state_dict)

    def count(prefix):
        return len({k for k in sd if k.startswith(prefix)
                    and k.endswith(".weight")})

    params = {"layer1": _lin(sd, "layer1", device),
              "layers_xyz": [_lin(sd, f"layers_xyz.{i}", device)
                             for i in range(count("layers_xyz."))]}
    if "fc_out.weight" in sd:
        params["fc_out"] = _lin(sd, "fc_out", device)
    else:
        params["layers_dir"] = [_lin(sd, f"layers_dir.{i}", device)
                                for i in range(count("layers_dir."))]
        for name in ("fc_alpha", "fc_rgb", "fc_feat"):
            params[name] = _lin(sd, name, device)
    return params


def _conv(sd, prefix, device):
    p = {"w": _t(sd[prefix + ".weight"], device)}
    if prefix + ".bias" in sd:
        p["b"] = _t(sd[prefix + ".bias"], device)
    return p


def convert_plane_sr(state_dict, device="cuda"):
    """PlanesSR (EDSR inner model) state dict -> the plane-SR tree
    {"inner": ..., "norm"?} (conv weights OIHW, as torch stores them) on
    `device`."""
    sd = dict(state_dict)
    if not any(k.startswith("inner_model.") or "NON_LEARNED" in k
               for k in sd):
        # the legacy layout, without the wrapper's prefix
        sd = {("inner_model." + k if "NON_LEARNED" not in k else k): v
              for k, v in sd.items()}
    n_blocks = len({k for k in sd
                    if re.match(r"inner_model\.residual\.(\d+)\.conv1\.", k)})
    # the upscale Sequential interleaves convs with PixelShuffles: the
    # convs are the indices that hold a weight
    up_idx = sorted({int(m.group(1)) for k in sd
                     for m in [re.match(
                         r"inner_model\.upscale\.(\d+)\.weight", k)] if m})
    inner = {
        "conv_input": _conv(sd, "inner_model.conv_input", device),
        "blocks": [
            {"conv1": _conv(sd, f"inner_model.residual.{i}.conv1", device),
             "conv2": _conv(sd, f"inner_model.residual.{i}.conv2", device)}
            for i in range(n_blocks)],
        "conv_mid": _conv(sd, "inner_model.conv_mid", device),
        "upscale": [_conv(sd, f"inner_model.upscale.{i}", device)
                    for i in up_idx],
        "conv_output": _conv(sd, "inner_model.conv_output", device)}
    params = {"inner": inner}
    if "planes_mean_NON_LEARNED" in sd:
        params["norm"] = {
            "mean": _t(sd["planes_mean_NON_LEARNED"], device).reshape(-1),
            "std": _t(sd["planes_std_NON_LEARNED"], device).reshape(-1)}
    return params


def _plane_index(name: str) -> int:
    return int(re.search(r"_D(\d+)$", name).group(1))


def convert_par_file(par_content, num_pos_planes: int = 3, device="cuda"):
    """A reference `.par` file's content -> (planes, box, moments) on
    `device`.

    par_content: {'params': {plane name: [1, C, R, R]}, 'opt_states':
    [torch Adam state per plane, or None], 'coords_normalization':
    [2, D]}. Returns ({"pos": [P, C, R, R], "view"?: [Cv, Rv, Rv]}, box
    [2, D], {"count": int, "mu": ..., "nu": ...} in the planes' layout,
    or None when a plane has no Adam state)."""
    params = par_content["params"]
    names = sorted(params.keys(), key=_plane_index)
    pos = [_t(params[n], device)[0] for n in names
           if _plane_index(n) < num_pos_planes]
    view = [_t(params[n], device)[0] for n in names
            if _plane_index(n) >= num_pos_planes]
    planes = {"pos": torch.stack(pos)}
    if view:
        planes["view"] = view[0]
    box = _t(par_content["coords_normalization"], device)

    moments = None
    opt_states = par_content.get("opt_states")
    if opt_states and all(s is not None for s in opt_states):
        def moment(field):
            vals = [_t(s[field], device)[0] for s in opt_states]
            out = {"pos": torch.stack(vals[:num_pos_planes])}
            if len(vals) > num_pos_planes:
                out["view"] = vals[num_pos_planes]
            return out
        moments = {"count": int(torch.as_tensor(opt_states[0]["step"])
                                .item()),
                   "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    return planes, box, moments


def load_torch_checkpoint(path: str):
    """Read a reference checkpoint file (a torch pickle, onto the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=False)
