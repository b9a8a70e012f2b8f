"""The port reads JPEG images as the JAX package does (the repair of
ROADMAP Queue 3 #1): `data.blender.imread`, `image_dims` and the LLFF
loader decode any file that is not a PNG through PIL, and JAX's reads it
through imageio, which decodes JPEGs through PIL too. Tolerance: bit for
bit (the same decoder on the same bytes).

The scenes are written here with PIL: an LLFF scene whose images/ are
JPEGs, and a Blender scene whose frames hold JPEG bytes (a Blender
frame's path always ends in .png; imageio and PIL read what the bytes
hold, and so does the port). The datasets use a downsampling factor of 1,
so no resize stands between the decoders and the items. The port's side
also runs in a process that refuses to import imageio."""

import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from helpers_synth import write_blender_scene, write_llff_scene
from nvsr_tpu.data import blender as jblender
from nvsr_tpu.data.dataset import MultiSceneDataset as JDataset
from nvsr_tpu.utils.config import CfgNode as JCfgNode
from nvsr_tpu_torch.data import blender as tblender
from nvsr_tpu_torch.data import llff as tllff
from nvsr_tpu_torch.data.dataset import MultiSceneDataset as TDataset
from nvsr_tpu_torch.utils import png
from nvsr_tpu_torch.utils.config import CfgNode as TCfgNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_jpeg(path, dst=None):
    """Re-encode an image file as a JPEG (quality 90) at `dst` (default:
    in place, keeping its name)."""
    with Image.open(path) as im:
        rgb = im.convert("RGB")
    rgb.save(dst or path, format="JPEG", quality=90)
    if dst and dst != path:
        os.remove(path)


def _corpus(root):
    """lego and ship (Blender, every frame JPEG bytes) and fern (LLFF,
    images/*.jpg)."""
    for name in ("lego", "ship"):
        scene = write_blender_scene(str(root / "synt"), name, size=24)
        for split in ("train", "val", "test"):
            d = os.path.join(scene, split)
            for f in os.listdir(d):
                _to_jpeg(os.path.join(d, f))
    fern = write_llff_scene(str(root / "llff"), "fern", n_images=6, size=24)
    d = os.path.join(fern, "images")
    for f in sorted(os.listdir(d)):
        _to_jpeg(os.path.join(d, f), os.path.join(d, f[:-4] + ".jpg"))


def _dataset_cfg(root, eval_mode):
    """lego and fern train, ship validates; an eval (which loads its val
    scenes only) validates fern too."""
    val = {"1,16,8": ["ship"]}
    if eval_mode:
        val["1,8,8,'llff'"] = ["fern"]
    return {"synt": {"root": "synt", "near": 2, "far": 6, "no_ndc": True},
            "llff": {"root": "llff", "near": 0, "far": 1, "no_ndc": False},
            "testskip": 1, "llffhold": 2, "root_path": str(root),
            "dir": {"train": {"1,8,8": ["lego"], "1,8,8,'llff'": ["fern"]},
                    "val": val}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg")
    _corpus(root)
    return root


def test_imread_and_image_dims_read_jpeg_like_jax(tmp_path, rng):
    """An 8x10 RGB JPEG and a grayscale one (a real .jpg name), and the
    same bytes under a .png name: the port's imread, image_dims and LLFF
    read equal JAX's bit for bit; a PNG still goes through utils/png.py."""
    rgb = (255 * rng.random((8, 10, 3))).astype(np.uint8)
    paths = {"rgb.jpg": Image.fromarray(rgb),
             "gray.jpg": Image.fromarray(rgb[..., 0]),
             "named.png": Image.fromarray(rgb)}
    for name, im in paths.items():
        im.save(tmp_path / name, format="JPEG", quality=90)
    Image.fromarray(rgb).save(tmp_path / "real.png", format="PNG")
    for name in list(paths) + ["real.png"]:
        p = str(tmp_path / name)
        mine, ref = tblender.imread(p), jblender.imread(p)
        assert mine.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)
        assert tblender.image_dims(p) == jblender.image_dims(p) == (8, 10)
        np.testing.assert_array_equal(tblender.read_image(p),
                                      imageio.imread(p))
    with pytest.raises(ValueError):
        png.imread(str(tmp_path / "named.png"))


@pytest.mark.parametrize("eval_mode", [False, True])
def test_dataset_items_match_jax_on_jpeg(corpus, eval_mode):
    """MultiSceneDataset over the JPEG corpus, preloading (training) and
    on the fly (eval: three scene groups): every item's image, pose and
    metadata, and the index bookkeeping, equal JAX's bit for bit."""
    nerf = {"use_viewdirs": True}
    j = JDataset(JCfgNode(_dataset_cfg(corpus, eval_mode)),
                 eval_mode=eval_mode, scene_norm_coords=JCfgNode(nerf))
    t = TDataset(TCfgNode(_dataset_cfg(corpus, eval_mode)),
                 eval_mode=eval_mode, scene_norm_coords=TCfgNode(nerf))
    assert t.on_the_fly_load == j.on_the_fly_load == eval_mode
    assert t.i_train == j.i_train and t.i_val == j.i_val
    assert t.per_im_scene_id == j.per_im_scene_id and len(t) == len(j) > 0
    assert t.hwfDs == j.hwfDs
    assert {t.scene_types[s] for s in t.per_im_scene_id} == {"synt", "llff"}
    for i in range(len(j)):
        ti, ji = t.item(i), j.item(i)
        assert ti[0].dtype == ji[0].dtype == np.float32
        np.testing.assert_array_equal(ti[0], ji[0])
        np.testing.assert_array_equal(ti[1], ji[1])
        assert ti[2:] == ji[2:]


def test_llff_loader_reads_jpeg_like_jax(corpus):
    """load_llff_data on the JPEG images/ directory: the images equal
    JAX's bit for bit."""
    from nvsr_tpu.data.llff import load_llff_data as jload
    scene = str(corpus / "llff" / "fern")
    mine = tllff.load_llff_data(scene, factor=1)
    ref = jload(scene, factor=1)
    assert np.asarray(mine[0]).shape == np.asarray(ref[0]).shape == \
        (6, 24, 24, 3)
    np.testing.assert_array_equal(np.asarray(mine[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(mine[1], ref[1])


_NO_IMAGEIO = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("imageio", "jax", "nvsr_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
import numpy as np
from nvsr_tpu_torch.data.dataset import MultiSceneDataset
from nvsr_tpu_torch.utils.config import CfgNode
cfgs = eval(sys.argv[1])
for eval_mode in (False, True):
    ds = MultiSceneDataset(CfgNode(cfgs[eval_mode]), eval_mode=eval_mode,
                           scene_norm_coords=CfgNode({"use_viewdirs": True}))
    items = [ds.item(i)[0] for i in range(len(ds))]
    np.save(sys.argv[2] + "_%d.npy" % eval_mode, np.stack(items))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("imageio", "jax", "nvsr_tpu")))
"""


def test_dataset_reads_jpeg_without_imageio(corpus, tmp_path):
    """The port's dataset over the JPEG corpus in a process that refuses
    imageio (and JAX): the same items as in this process, and no module of
    the refused packages loaded. No module of the port imports imageio."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_IMAGEIO,
         repr([_dataset_cfg(corpus, m) for m in (False, True)]),
         str(tmp_path / "items")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    for eval_mode in (False, True):
        t = TDataset(TCfgNode(_dataset_cfg(corpus, eval_mode)),
                     eval_mode=eval_mode,
                     scene_norm_coords=TCfgNode({"use_viewdirs": True}))
        np.testing.assert_array_equal(
            np.load(tmp_path / f"items_{int(eval_mode)}.npy"),
            np.stack([t.item(i)[0] for i in range(len(t))]))
    port = os.path.join(REPO, "nvsr_tpu_torch")
    importers = [os.path.relpath(os.path.join(d, f), REPO)
                 for d, _, fs in os.walk(port) for f in fs
                 if f.endswith(".py") and "import imageio" in open(
                     os.path.join(d, f)).read()]
    assert importers == []
