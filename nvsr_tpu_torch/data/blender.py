"""Blender-synthetic scene loading (host-side numpy).

Re-derivation of the reference loader (reference load_blender.py:15-39,
232-332): transforms_{split}.json parsing, per-image downsampling with
the area/degradation pipeline, focal from camera_angle_x, and the
40-pose spherical render path.

The port's copy of nvsr_tpu/data/blender.py: PNGs are read by
`utils/png.py` instead of imageio and PIL.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nvsr_tpu_torch.data.imresize import im_resize
from nvsr_tpu_torch.utils import png


def imread(path: str, with_alpha: bool = False) -> np.ndarray:
    """Read a PNG; composite RGB over the alpha validity mask
    (reference nerf_helpers.py:256-260)."""
    image = png.imread(path)
    if not with_alpha and image.ndim == 3 and image.shape[2] > 3:
        image = image[..., :3] * (image[..., 3:] > 0)
    return (image / 255.0).astype(np.float32)


def image_dims(path: str):
    """Header-only image size sniff (H, W) — replaces the reference's
    python-magic probe (load_blender.py:281) with a read of the PNG
    header."""
    return png.read_dims(path)


def translate_by_t_along_z(t):
    tform = np.eye(4, dtype=np.float32)
    tform[2][3] = t
    return tform


def rotate_by_phi_along_x(phi):
    tform = np.eye(4, dtype=np.float32)
    tform[1, 1] = tform[2, 2] = np.cos(phi)
    tform[1, 2] = -np.sin(phi)
    tform[2, 1] = -tform[1, 2]
    return tform


def rotate_by_theta_along_y(theta):
    tform = np.eye(4, dtype=np.float32)
    tform[0, 0] = tform[2, 2] = np.cos(theta)
    tform[0, 2] = -np.sin(theta)
    tform[2, 0] = -tform[0, 2]
    return tform


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Spherical orbit pose (reference load_blender.py:34-39)."""
    c2w = translate_by_t_along_z(radius)
    c2w = rotate_by_phi_along_x(phi / 180.0 * np.pi) @ c2w
    c2w = rotate_by_theta_along_y(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def spherical_render_poses(n: int = 40, phi: float = -30.0,
                           radius: float = 4.0) -> np.ndarray:
    """The reference's 40-pose orbit (load_blender.py:307-313)."""
    angles = np.linspace(-180, 180, n + 1)[:-1]
    return np.stack([pose_spherical(a, phi, radius) for a in angles])


def load_blender_data(basedir: str, *, testskip: int = 1,
                      downsampling_factor: int = 1,
                      val_downsampling_factor: int = None,
                      splits2use=("train", "val"), load_imgs: bool = True,
                      degradation: dict = None):
    """Load a Blender-synthetic scene.

    Returns (images, poses [N,4,4], render_poses [40,4,4],
    [H, W, focal, ds_factor] per-image lists, i_split) — the reference's
    contract (load_blender.py:232-332). When load_imgs=False, `images`
    holds file paths (on-the-fly mode).
    """
    if val_downsampling_factor is None:
        val_downsampling_factor = downsampling_factor
    splits = ["train", "val", "test"]
    assert all(s in splits for s in splits2use)
    metas = {}
    for s in splits2use:
        with open(os.path.join(basedir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses = [], []
    H, W, focal, ds_factor = [], [], [], []
    counts = [0]
    for s in splits:
        meta = metas.get(s, {"frames": []})
        if s in splits2use:
            camera_angle_x = float(meta["camera_angle_x"])
            focal_over_w = 0.5 / np.tan(0.5 * camera_angle_x)
        imgs, poses = [], []
        skip = testskip if s == "val" else 1
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            per_im_ds = (val_downsampling_factor if s == "val"
                         else downsampling_factor)
            if load_imgs:
                img = imread(fname)
                h, w = img.shape[:2]
                resized = im_resize(
                    img, scale_factor=per_im_ds, degradation=degradation,
                    fname="%s_%s" % (basedir.split("/")[-1],
                                     frame["file_path"].split("/")[-1]))
            else:
                h, w = image_dims(fname)
            H.append(h // per_im_ds)
            W.append(w // per_im_ds)
            focal.append(focal_over_w * W[-1])
            ds_factor.append(per_im_ds)
            imgs.append(resized if load_imgs else fname)
            poses.append(np.array(frame["transform_matrix"],
                                  dtype=np.float32))
        counts.append(counts[-1] + len(imgs))
        all_imgs.append(imgs)
        all_poses.append(np.array(poses, dtype=np.float32).reshape(-1, 4, 4))

    images = [im for split_imgs in all_imgs for im in split_imgs]
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    poses = np.concatenate(all_poses, 0)
    render_poses = spherical_render_poses()
    return images, poses, render_poses, [H, W, focal, ds_factor], i_split
