"""The port's copies of the data helpers held against nvsr_tpu.data on the
same inputs (ROADMAP Queue 3 #2; JAX's own tests of them are
tests/test_data.py:35-62, :91, :113, :123):

* im_resize with the ##GaussN (blur) and ##NoiseN (noise) degradations:
  the same code but for the first area downsample, a block mean in the
  port where JAX calls cv2 INTER_AREA; held at 1e-6 (the area resize's
  measured delta is 6.0e-8). The noise realization is cached
  per image file: the same seed draws the same noise, and a file JAX
  cached reads back the same in the port;
* minify of a JPEG LLFF scene: both read through PIL and resize with
  cv2, the port writes its PNGs with utils/png.py: bit-equal;
* load_llff_data with min_eval_frames (the interpolated video path) and
  the spherical render poses: bit-equal.
"""

import os

import numpy as np
import pytest
from PIL import Image

from helpers_synth import write_llff_scene
from nvsr_tpu.data.blender import spherical_render_poses as j_poses
from nvsr_tpu.data.imresize import im_resize as j_im_resize
from nvsr_tpu.data.llff import load_llff_data as j_load_llff
from nvsr_tpu.data.llff import minify as j_minify
from nvsr_tpu_torch.data.blender import read_image
from nvsr_tpu_torch.data.blender import spherical_render_poses as t_poses
from nvsr_tpu_torch.data.imresize import im_resize as t_im_resize
from nvsr_tpu_torch.data.llff import load_llff_data as t_load_llff
from nvsr_tpu_torch.data.llff import minify as t_minify

AREA_TOL = 1e-6


@pytest.mark.parametrize("kind,std", [("blur", 1.0), ("blur", 2.5),
                                      ("noise", 10.0)])
def test_im_resize_degradations_match_jax(rng, tmp_path, kind, std):
    im = rng.random((32, 32, 3)).astype(np.float32)
    deg = {"type": kind, "base_factor": 2, "STD": std}
    if kind == "noise":
        deg["path"] = str(tmp_path / "deg")
    mine = t_im_resize(im, 4, degradation=deg, fname="img0",
                       rng=np.random.default_rng(5))
    ref = j_im_resize(im, 4, degradation=dict(
        deg, path=str(tmp_path / "deg_jax")) if kind == "noise" else deg,
        fname="img0", rng=np.random.default_rng(5))
    assert mine.shape == ref.shape == (8, 8, 3)
    assert mine.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(mine, ref, rtol=0, atol=AREA_TOL)
    if kind == "noise":
        # the cached realization: JAX's file read back by the port, and
        # the port's own again
        again = t_im_resize(im, 4, degradation=dict(
            deg, path=str(tmp_path / "deg_jax")), fname="img0")
        np.testing.assert_allclose(again, ref, rtol=0, atol=AREA_TOL)
        np.testing.assert_array_equal(
            t_im_resize(im, 4, degradation=deg, fname="img0"), mine)


def test_im_resize_plain_matches_jax(rng):
    im = rng.random((24, 40, 3)).astype(np.float32)
    for factor in (1, 2, 4, 8):
        np.testing.assert_allclose(t_im_resize(im, factor),
                                   j_im_resize(im, factor), rtol=0,
                                   atol=AREA_TOL)


def test_minify_jpeg_scene_matches_jax(tmp_path):
    """images/ as JPEGs; each package minifies its own copy by 2 and 4:
    the same files, the same pixels."""
    trees = {}
    for name in ("jax", "port"):
        scene = write_llff_scene(str(tmp_path / name), "fern", n_images=3,
                                 size=40)
        d = os.path.join(scene, "images")
        for f in sorted(os.listdir(d)):
            with Image.open(os.path.join(d, f)) as im:
                im.convert("RGB").save(os.path.join(d, f[:-4] + ".jpg"),
                                       format="JPEG", quality=90)
            os.remove(os.path.join(d, f))
        (j_minify if name == "jax" else t_minify)(scene, factors=[2, 4])
        trees[name] = {
            (r, f): read_image(os.path.join(scene, f"images_{r}", f))
            for r in (2, 4)
            for f in sorted(os.listdir(os.path.join(scene, f"images_{r}")))}
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert len(trees["jax"]) == 6
    for k, ref in trees["jax"].items():
        assert ref.shape[:2] == (40 // k[0], 40 // k[0])
        np.testing.assert_array_equal(trees["port"][k], ref)


def test_llff_min_eval_frames_matches_jax(tmp_path):
    scene = write_llff_scene(str(tmp_path), "fern", n_images=5, size=40)
    mine = t_load_llff(scene, factor=2, load_imgs=False, min_eval_frames=12)
    ref = j_load_llff(scene, factor=2, load_imgs=False, min_eval_frames=12)
    assert ref[1].shape[0] >= 12
    assert [x is None for x in mine[0]] == [x is None for x in ref[0]]
    assert None in ref[0]
    assert [x for x in mine[0] if x is not None] == \
        [x for x in ref[0] if x is not None]
    for a, b in zip(mine[1:4], ref[1:4]):
        np.testing.assert_array_equal(a, b)
    assert mine[4] == ref[4]


def test_spherical_render_poses_match_jax():
    for n, radius in ((8, 4.0), (40, 4.0), (12, 2.5)):
        np.testing.assert_array_equal(t_poses(n, radius=radius),
                                      j_poses(n, radius=radius))
