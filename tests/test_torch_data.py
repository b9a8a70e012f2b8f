"""The port's data path against the JAX package's: the PNG codec
(nvsr_tpu_torch/utils/png.py) against imageio, the block-mean area resize
against JAX's cv2 INTER_AREA, and MultiSceneDataset against JAX's on the
synthetic corpus of tests/helpers_synth.py.

Tolerances: PNG pixels bit-equal; the resize within 1e-6 (cv2 sums a
block in another order; measured 6.0e-8); dataset poses and metadata
equal, images within 1e-6 (the resize).
"""

import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from helpers_synth import write_blender_scene
from nvsr_tpu.data.dataset import MultiSceneDataset as JDataset
from nvsr_tpu.data.imresize import im_resize as j_im_resize
from nvsr_tpu.utils.config import CfgNode
from nvsr_tpu_torch.data.dataset import MultiSceneDataset as TDataset
from nvsr_tpu_torch.data.imresize import im_resize as t_im_resize
from nvsr_tpu_torch.utils import png


def _filtered_png(img, ftype):
    """PNG bytes of a uint8 [H, W, C] image with every row under PNG
    filter `ftype` (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    prior = np.zeros_like(raw)
    prior[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, c:] = raw[:, :-c]
    upleft = np.zeros_like(raw)
    upleft[:, c:] = prior[:, :-c]
    if ftype == 4:
        p = left + prior - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                      np.abs(p - upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    else:
        pred = [0 * raw, left, prior, (left + prior) // 2][ftype]
    rows = np.concatenate([np.full((h, 1), ftype),
                           (raw - pred) & 0xFF], 1).astype(np.uint8)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reads_every_filter_like_imageio(tmp_path, rng, ftype,
                                             channels):
    img = rng.integers(0, 256, (13, 11, channels), dtype=np.uint8)
    img[:6] = np.linspace(0, 255, 11 * channels).reshape(11, channels
                                                         ).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, ftype))
    mine, ref = png.imread(path), imageio.imread(path)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(ref, want)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)
    assert png.read_dims(path) == (13, 11)


@pytest.mark.parametrize("shape", [(20, 21), (17, 9, 3), (32, 32, 4)])
def test_png_round_trips_with_imageio(tmp_path, rng, shape):
    """The port's files read bit-equal in imageio, and imageio's (its own
    filter choice per row) bit-equal in the port."""
    img = np.clip(np.linspace(0, 255, np.prod(shape)).reshape(shape)
                  + rng.integers(-20, 20, shape), 0, 255).astype(np.uint8)
    mine, theirs = str(tmp_path / "m.png"), str(tmp_path / "t.png")
    png.imwrite(mine, img)
    imageio.imwrite(theirs, img)
    np.testing.assert_array_equal(imageio.imread(mine), img)
    np.testing.assert_array_equal(png.imread(theirs), img)


def test_png_reads_the_synthetic_corpus_like_imageio(tmp_path):
    scene = write_blender_scene(str(tmp_path), "lego", size=32)
    paths = [os.path.join(d, f) for d, _, fs in os.walk(scene) for f in fs
             if f.endswith(".png")]
    assert len(paths) == 7
    for p in paths:
        ref = imageio.imread(p)
        assert ref.shape == (32, 32, 4)
        np.testing.assert_array_equal(png.imread(p), ref)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_area_resize_matches_cv2(rng, factor):
    img = rng.random((64, 48, 3), dtype=np.float32)
    mine = t_im_resize(img, scale_factor=factor)
    ref = j_im_resize(img, scale_factor=factor)
    assert mine.dtype == ref.dtype == np.float32
    assert mine.shape == ref.shape == (64 // factor, 48 // factor, 3)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)


def _dataset_cfg(root):
    return CfgNode({
        "synt": {"root": "synt", "near": 2, "far": 6, "no_ndc": True},
        "llff": {"root": "llff", "near": 0, "far": 1, "no_ndc": False},
        "testskip": 1, "llffhold": 2, "root_path": str(root),
        "dir": {"train": {"4,8,8": ["lego", "ship"], "2,16,8": ["lego"]},
                "val": {"2,16,8": ["ship"]}}})


@pytest.mark.parametrize("eval_mode", [False, True])
def test_dataset_items_match_jax(tmp_path, eval_mode):
    """Images, poses and per-image metadata of every item, and the index
    bookkeeping, as JAX's; eval mode loads on the fly (three scene
    groups), reading sizes from the PNG headers."""
    for name in ("lego", "ship"):
        write_blender_scene(str(tmp_path / "synt"), name, size=32)
    nerf = CfgNode({"use_viewdirs": True})
    j = JDataset(_dataset_cfg(tmp_path), eval_mode=eval_mode,
                 scene_norm_coords=nerf)
    t = TDataset(_dataset_cfg(tmp_path), eval_mode=eval_mode,
                 scene_norm_coords=nerf)
    assert t.on_the_fly_load == j.on_the_fly_load == eval_mode
    assert t.i_train == j.i_train and t.i_val == j.i_val
    assert t.per_im_scene_id == j.per_im_scene_id and len(t) == len(j) > 0
    assert t.hwfDs == j.hwfDs
    for k, box in j.coords_normalization.items():
        np.testing.assert_array_equal(t.coords_normalization[k], box)
    for i in range(len(j)):
        ti, ji = t.item(i), j.item(i)
        assert ti[0].dtype == ji[0].dtype == np.float32
        np.testing.assert_allclose(ti[0], ji[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ti[1], ji[1])
        assert ti[2:] == ji[2:]
