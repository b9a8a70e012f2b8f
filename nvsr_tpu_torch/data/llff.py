"""LLFF real-scene loading (host-side numpy).

Re-derivation of the reference loader (reference load_llff.py): reads
`poses_bounds.npy`, minifies images (with cv2 instead of the reference's
ImageMagick shell-out, load_llff.py:13-67), recenters poses, rescales
bounds, builds the spiral render path, and optionally interpolates poses
for smooth high-FPS video (min_eval_frames).

The port's copy of nvsr_tpu/data/llff.py: PNGs are read and written by
`utils/png.py`; other image files (LLFF's JPEGs) and the minifying
resize import imageio and cv2 where they run.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.interpolate import interp1d

from nvsr_tpu_torch.data.imresize import calc_resize_crop_margins, im_resize
from nvsr_tpu_torch.utils import png

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _image_files(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(_IMG_EXTS)]


def _imread(path):
    if path.lower().endswith(".png"):
        return png.imread(path)
    import imageio.v2 as imageio
    return imageio.imread(path)


def minify(basedir: str, factors=()):
    """Write images_{f}/ downsampled copies (cv2 INTER_AREA, replacing
    the reference's mogrify shell-out, load_llff.py:13-67)."""
    for r in factors:
        imgdir = os.path.join(basedir, f"images_{r}")
        if os.path.exists(imgdir):
            continue
        os.makedirs(imgdir)
        import cv2
        for path in _image_files(os.path.join(basedir, "images")):
            img = _imread(path)
            out = cv2.resize(img, dsize=(img.shape[1] // r, img.shape[0] // r),
                             interpolation=cv2.INTER_AREA)
            name = os.path.splitext(os.path.basename(path))[0] + ".png"
            png.imwrite(os.path.join(imgdir, name), out)


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Express all poses relative to their average (reference
    load_llff.py:189-201)."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """Spiral camera path (reference load_llff.py:173-186)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, int(N) + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def spherify_poses(poses, bds):
    """360-scene pose normalization (reference load_llff.py:204-279)."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                        [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
        @ b_i.mean(0))
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) \
        @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc
    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th),
                              radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:],
                                    new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1)
    return poses_reset, new_poses, bds


def _load_data(basedir, factor, base_factor=1, max_factor=1,
               load_imgs=True, min_eval_frames=None):
    """reference load_llff.py:70-140."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    repeat_ims = None
    if min_eval_frames is not None:
        min_eval_frames = int(np.ceil(
            min_eval_frames / (len(poses_arr) - 1)) * (len(poses_arr) - 1) + 1)
        repeat_ims = (min_eval_frames - 1) // (len(poses_arr) - 1)
        original = poses_arr.copy()
        poses_arr = interp1d(np.arange(len(poses_arr)), poses_arr, axis=0)(
            np.linspace(0, len(original) - 1, min_eval_frames))
        poses_arr[::repeat_ims, :] = original
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    while not os.path.isdir(os.path.join(
            basedir, "images" + (f"_{base_factor}" if base_factor > 1
                                 else ""))):
        assert base_factor >= 1
        base_factor //= 2
    images_subdir = "images" + (f"_{base_factor}" if base_factor > 1 else "")
    assert factor % base_factor == 0
    imgfiles = _image_files(os.path.join(basedir, images_subdir))
    if min_eval_frames is not None:
        imgfiles = [f_ for f in imgfiles
                    for f_ in ([f] + (repeat_ims - 1) * [None])]
        imgfiles = imgfiles[:-(repeat_ims - 1)] if repeat_ims > 1 else imgfiles
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses "
            f"{poses.shape[-1]}")

    sh = np.array(_imread(imgfiles[0]
                                 if imgfiles[0] else imgfiles[1]).shape)
    marg2crop = calc_resize_crop_margins(sh, max_factor // base_factor)
    if marg2crop is not None:
        sh[:2] -= 2 * marg2crop
    sh = (sh[0] // (factor // base_factor), sh[1] // (factor // base_factor),
          sh[2])
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    if load_imgs:
        imgs = []
        for f in imgfiles:
            im = _imread(f)[..., :3] / 255.0
            if marg2crop is not None:
                im = im[marg2crop[0]:-marg2crop[0] if marg2crop[0] > 0
                        else None,
                        marg2crop[1]:-marg2crop[1] if marg2crop[1] > 0
                        else None, :]
            if factor != base_factor:
                im = im_resize(im.astype(np.float32),
                               scale_factor=factor // base_factor)
            imgs.append(im.astype(np.float32))
        imgs = np.stack(imgs, -1)
    else:
        imgs = imgfiles
    return poses, bds, imgs, (base_factor, marg2crop)


def load_llff_data(basedir, factor=8, base_factor=1, max_factor=1,
                   recenter=True, bd_factor=0.75, spherify=False,
                   path_zflat=False, load_imgs=True, min_eval_frames=None):
    """reference load_llff.py:282-360. Returns
    (images, poses [N,3,5], bds, render_poses, i_test, load_params)."""
    poses, bds, imgs, load_params = _load_data(
        basedir, factor=factor, base_factor=base_factor,
        max_factor=max_factor, load_imgs=load_imgs,
        min_eval_frames=min_eval_frames)

    # rotation-column reorder + move frame axis first
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    if load_imgs:
        imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, 60
        render_poses = render_path_spiral(c2w_path, up, rads, focal,
                                          zrate=0.5, rots=n_rots, N=n_views)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return imgs, poses.astype(np.float32), bds, render_poses, i_test, \
        load_params
