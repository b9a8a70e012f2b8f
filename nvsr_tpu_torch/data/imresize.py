"""MATLAB-style antialiased cubic resize + degradation kernels (host numpy).

Behavioral re-derivation of the reference's degradation pipeline
(reference imresize.py:8-124, nerf_helpers.py:294-310): the training-time
image degradations ("##Gauss<std>" blur, "##Noise<std>" additive noise)
downsample with a cubic antialiasing kernel — optionally convolved with
a Gaussian — built from a cv2 INTER_CUBIC delta response, with the
reference's exact stride/padding conventions.

Only the integer *down*-scaling path is implemented (the only path the
data pipeline exercises; the reference's upscale/custom-kernel branches
are unused there).

The port's copy of nvsr_tpu/data/imresize.py. `im_resize`'s area
downsample by an integer factor (cv2 INTER_AREA in the JAX package) is
the block mean it computes, in numpy, so the plain data path needs no
cv2; the degradation kernels and `bicubic_interp` import cv2 where they
run.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.signal import convolve2d
from scipy.stats import norm


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    n = np.arange(size) - (size - 1) / 2
    return np.exp(-0.5 * (n / sigma) ** 2)


def gaussian_2d(sigma: float, size: int = None) -> np.ndarray:
    """Normalized 2-D Gaussian holding >=99% of 1-D energy
    (reference imresize.py:117-124)."""
    if size is None:
        size = int(1 + 2 * np.ceil(-1 * norm.ppf(0.005, scale=sigma)))
    else:
        assert size % 2 == 1, "size must be odd"
    g = _gaussian_window(size, sigma)
    k = g.reshape(1, size) * g.reshape(size, 1)
    return k / k.sum()


@lru_cache(maxsize=32)
def cubic_kernel(sf: int) -> np.ndarray:
    """The sf-x cubic interpolation kernel extracted from a delta-image
    INTER_CUBIC upsample (reference imresize.py:104-110)."""
    import cv2
    delta_size = 11
    delta = np.zeros((delta_size, delta_size))
    c = int(np.ceil(delta_size / 2)) - 1
    delta[c, c] = 1.0
    up = cv2.resize(delta, dsize=(sf * delta_size, sf * delta_size),
                    interpolation=cv2.INTER_CUBIC)
    row = up[sf * int(np.ceil(delta_size / 2)) - 1, :]
    support = np.nonzero(row)[0]
    lo, hi = support[0], support[-1]
    return up[lo:hi + 1, lo:hi + 1]


def _calc_strides(factor: int):
    """Reference imresize.py:89-102 (align_center=False convention)."""
    post = int(np.floor(factor / 2))
    pre = factor - post - 1
    return pre, post


@lru_cache(maxsize=32)
def _downscale_kernel(sf: int, blur_sigma: float = 0.0) -> np.ndarray:
    k = cubic_kernel(sf)
    if blur_sigma > 0:
        k = convolve2d(k, gaussian_2d(blur_sigma))
    pre, post = _calc_strides(sf)
    kernel_post_pad = max(0, pre - post)
    kernel_pre_pad = max(0, post - pre)
    k = np.pad(k, ((kernel_pre_pad, kernel_post_pad),
                   (kernel_pre_pad, kernel_post_pad)))
    # downscale: energy-normalize per output pixel and flip
    return np.rot90(k * (1.0 / sf) ** 2, 2)


def imresize_down(im: np.ndarray, ds_factor: int,
                  blur_sigma: float = 0.0) -> np.ndarray:
    """Antialiased cubic integer-factor downscale with edge padding.

    Matches reference imresize(im, scale_factor=1/ds, kernel=
    'blurry_cubic_<sigma>'|None) for the degradation path
    (imresize.py:45-87 downscale branch).
    """
    assert im.shape[0] % ds_factor == 0 and im.shape[1] % ds_factor == 0, \
        "image size must be divisible by the downscale factor"
    kernel = _downscale_kernel(ds_factor, blur_sigma)
    pad = (kernel.shape[0] // 2, kernel.shape[1] // 2)
    pre, _ = _calc_strides(ds_factor)
    squeeze = im.ndim < 3
    if squeeze:
        im = im[..., None]
    out = []
    for c in range(im.shape[2]):
        x = np.pad(im[:, :, c], ((pad[0], pad[0]), (pad[1], pad[1])),
                   mode="edge")
        y = convolve2d(x, kernel, mode="valid")
        out.append(y[pre::ds_factor, pre::ds_factor])
    result = np.stack(out, -1)
    return result[..., 0] if squeeze else result


def area_downsample(image: np.ndarray, factor: int) -> np.ndarray:
    """[H, W, ...] -> [H/f, W/f, ...]: the mean of each f x f block, which
    is what cv2.resize with INTER_AREA computes for an integer factor."""
    h, w = image.shape[:2]
    blocks = image.reshape(h // factor, factor, w // factor, factor,
                           *image.shape[2:])
    return blocks.mean(axis=(1, 3), dtype=np.float64).astype(image.dtype)


def im_resize(image: np.ndarray, scale_factor: int, degradation: dict = None,
              fname: str = None, rng: np.random.Generator = None
              ) -> np.ndarray:
    """Area-interp downsample with optional blur/noise degradation.

    Matches reference nerf_helpers.py:294-310:
      * plain: the area (block-mean) downsample by `scale_factor`;
      * blur: INTER_AREA by degradation['base_factor'], then
        blurry-cubic downscale by the remaining ratio;
      * noise: cubic downscale by the remaining ratio + cached additive
        Gaussian noise (one noise realization per image file).
    """
    assert all(v % scale_factor == 0 for v in image.shape[:2]), \
        "not supporting downscaling to an ambiguous size"
    cv2_factor = scale_factor if degradation is None \
        else degradation["base_factor"]
    output = area_downsample(image, cv2_factor)
    if degradation is not None and scale_factor > cv2_factor:
        assert degradation["type"] in ("blur", "noise")
        remaining = scale_factor // cv2_factor
        if degradation["type"] == "blur":
            output = np.clip(
                imresize_down(output, remaining,
                              blur_sigma=degradation["STD"]),
                0, 1).astype(output.dtype)
        else:
            output = imresize_down(output, remaining).astype(output.dtype)
            noise = _cached_noise(degradation, fname, output.shape, rng)
            output = np.clip(output + noise, 0, 1).astype(output.dtype)
    return output


def _cached_noise(degradation, fname, shape, rng):
    """Per-image cached noise file (reference nerf_helpers.py:304-309)."""
    import os
    path = degradation["path"]
    os.makedirs(path, exist_ok=True)
    noise_file = os.path.join(path, f"{fname}_{int(degradation['STD'])}.npz")
    if not os.path.exists(noise_file):
        rng = rng or np.random.default_rng()
        noise = rng.normal(scale=degradation["STD"] / 255, size=shape)
        np.savez(noise_file, noise=noise)
    return np.load(noise_file)["noise"]


def calc_resize_crop_margins(im_shape, ds_factor: int):
    """Margins to crop so the image divides evenly
    (reference nerf_helpers.py:312-321)."""
    if not any(v % ds_factor for v in im_shape[:2]):
        return None
    marg = np.zeros(2, dtype=np.int32)
    for dim in (0, 1):
        while (im_shape[dim] - 2 * marg[dim]) % ds_factor:
            marg[dim] += 1
            assert marg[dim] < ds_factor, "cannot find a suitable crop"
    return marg


def bicubic_interp(im: np.ndarray, sf: int) -> np.ndarray:
    """cv2 bicubic upsample (eval-time reference visualization,
    nerf_helpers.py:92-93)."""
    import cv2
    return cv2.resize(im, dsize=(im.shape[1] * sf, im.shape[0] * sf),
                      interpolation=cv2.INTER_CUBIC)
