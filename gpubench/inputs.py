"""Inputs made from the seed: synthetic Blender-style scenes written as
PNGs, camera poses, and model weights drawn on the device in a few large
calls. Both the program and the reference get these and nothing else."""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np


def write_png(path, rgba):
    """An 8-bit RGBA PNG of uint8 [H, W, 4] (filter 0 on every row)."""
    h, w, _ = rgba.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgba.reshape(h, w * 4)], 1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


def look_at(eye):
    """Camera-to-world [4, 4] (f32) of a camera at `eye` looking at the
    origin, z up (the Blender convention: the camera looks down -z)."""
    eye = np.asarray(eye, dtype=np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def synthetic_scene(root, name, size, counts, camera_angle_x, seed):
    """A Blender-style scene folder root/name (transforms_<split>.json,
    opaque RGBA PNGs): views on a circle of radius 4 at height 2, smooth
    gradients with seeded noise. Returns {split: [(c2w, rgb uint8
    [H, W, 3])]}."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    base = np.stack([xx, yy, 0.3 + 0.4 * xx * yy], -1)
    total = sum(counts.values())
    angles = np.linspace(0, 2 * np.pi, total, endpoint=False) \
        + rng.uniform(0, 2 * np.pi)
    out, k = {}, 0
    for split, n in counts.items():
        os.makedirs(os.path.join(root, name, split), exist_ok=True)
        frames, views = [], []
        for i in range(n):
            c2w = look_at(4.0 * np.array([np.cos(angles[k]),
                                          np.sin(angles[k]), 0.5]))
            img = np.clip(base + 0.05 * rng.standard_normal(base.shape),
                          0, 1)
            rgb = (255 * img).astype(np.uint8)
            rgba = np.concatenate([rgb, np.full_like(rgb[..., :1], 255)],
                                  -1)
            fpath = f"{split}/r_{i}"
            write_png(os.path.join(root, name, fpath + ".png"), rgba)
            frames.append({"file_path": fpath,
                           "transform_matrix": c2w.tolist()})
            views.append((c2w, rgb))
            k += 1
        with open(os.path.join(root, name, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                      f)
        out[split] = views
    return out


def _split(flat, shapes):
    out, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(flat[at:at + n].reshape(shape))
        at += n
    return out


def linear_layers(gen, dims, device):
    """[{"w": [i, o], "b": [o]}] for (i, o) in dims, torch.nn.Linear's
    U(-1/sqrt(i), 1/sqrt(i)), from one draw."""
    import torch
    shapes = [s for i, o in dims for s in ((i, o), (o,))]
    flat = torch.rand(sum(int(np.prod(s)) for s in shapes), generator=gen,
                      device=device) * 2 - 1
    parts = _split(flat, shapes)
    return [{"w": parts[2 * k] / math.sqrt(i),
             "b": parts[2 * k + 1] / math.sqrt(i)}
            for k, (i, o) in enumerate(dims)]


def triplane_decoder(gen, plane_ch, view_ch, width, layers, every,
                     density_bias, device):
    """One decoder member {"density", "fc_alpha", "rgb", "fc_rgb"} in the
    layout both sides read (concat_pos rgb input, avg density input)."""
    def branch(in_ch):
        dims = [(in_ch, width)]
        for num in range(layers - 1):
            skip = num > 0 and num % every == 0
            dims.append((width + (in_ch if skip else 0), width))
        return dims

    d_in, r_in = plane_ch, 3 * plane_ch + view_ch
    dims = branch(d_in) + [(width, 1)] + branch(r_in) + [(width, 3)]
    ls = linear_layers(gen, dims, device)
    n = layers
    member = {"density": ls[:n], "fc_alpha": ls[n], "rgb": ls[n + 1:2 * n + 1],
              "fc_rgb": ls[2 * n + 1]}
    member["fc_alpha"]["b"].fill_(density_bias)
    return member


def edsr_weights(gen, in_ch, hidden, n_blocks, scale, device):
    """EDSR conv weights (OIHW, 3x3, no bias), N(0, sqrt(2 / (9 * out)) /
    10) as the code base initialises them, from one draw."""
    import torch
    n_up = int(math.log2(scale))
    shapes = ([(hidden, in_ch, 3, 3)] + [(hidden, hidden, 3, 3)]
              * (2 * n_blocks + 1) + [(4 * hidden, hidden, 3, 3)] * n_up
              + [(in_ch, hidden, 3, 3)])
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes), generator=gen,
                       device=device)
    ws = [w * (math.sqrt(2.0 / (9 * w.shape[0])) / 10.0)
          for w in _split(flat, shapes)]
    blocks = ws[1:1 + 2 * n_blocks]
    return {"conv_input": {"w": ws[0]},
            "blocks": [{"conv1": {"w": blocks[2 * i]},
                        "conv2": {"w": blocks[2 * i + 1]}}
                       for i in range(n_blocks)],
            "conv_mid": {"w": ws[1 + 2 * n_blocks]},
            "upscale": [{"w": w} for w in ws[2 + 2 * n_blocks:-1]],
            "conv_output": {"w": ws[-1]}}


def nerf_mlp(gen, dim_xyz, dim_dir, hidden, layers, skip, device):
    """The baseline's MLP {"layer1", "layers_xyz", "fc_feat", "fc_alpha",
    "layers_dir", "fc_rgb"} (one direction layer of hidden // 2)."""
    dims = [(dim_xyz, hidden)]
    for i in range(layers - 1):
        skip_here = i > 0 and i % skip == 0
        dims.append((hidden + (dim_xyz if skip_here else 0), hidden))
    dims += [(hidden, hidden), (hidden, 1), (hidden + dim_dir, hidden // 2),
             (hidden // 2, 3)]
    ls = linear_layers(gen, dims, device)
    return {"layer1": ls[0], "layers_xyz": ls[1:layers],
            "fc_feat": ls[layers], "fc_alpha": ls[layers + 1],
            "layers_dir": [ls[layers + 2]], "fc_rgb": ls[layers + 3]}
