"""Multi-scene dataset assembly (the reference's `BlenderDataset`).

Re-derivation of reference load_blender.py:42-230: parses scene-group
configs for both Blender-synthetic and LLFF-real scenes, builds
per-scene train/val image indices keyed by scene_id, computes per-scene
coordinate-normalization boxes, tracks degradations
(`##Gauss`/`##Noise` suffixes), per-scene sampling probabilities and
module confinements, and loads images lazily ("on the fly") beyond a
scene-count threshold.

The port's copy of nvsr_tpu/data/dataset.py (numpy only).
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np

from nvsr_tpu_torch.data import llff as llff_mod
from nvsr_tpu_torch.data.blender import imread, load_blender_data
from nvsr_tpu_torch.data.imresize import im_resize
from nvsr_tpu_torch.ops.geometry import calc_scene_box
from nvsr_tpu_torch.scenes import get_scene_configs


def parse_scene_suffix(basedir: str, base_ds_factor: int,
                       planes_logdir: str):
    """Strip ##-suffixes and derive the degradation spec
    (reference load_blender.py:92-102).

    Returns (clean_path_suffixless_basedir, degradation|None).
    """
    degradation = None
    clean = basedir
    if re.search("##", basedir) is not None:
        m_num = re.search(r"##(\d)+$", basedir)
        m_gauss = re.search(r"##Gauss(\d)+(\.)?(\d)*", basedir)
        m_noise = re.search(r"##Noise(\d)+(\.)?(\d)*", basedir)
        if m_num is not None:
            clean = basedir.replace(m_num.group(0), "")
        elif m_gauss is not None:
            clean = basedir.replace(m_gauss.group(0), "")
            degradation = {
                "type": "blur", "base_factor": base_ds_factor,
                "STD": float(re.search(r"(?<=##Gauss)(\d)+(\.)?(\d)*$",
                                       basedir).group(0))}
        elif m_noise is not None:
            clean = basedir.replace(m_noise.group(0), "")
            degradation = {
                "type": "noise", "base_factor": base_ds_factor,
                "STD": float(re.search(r"(?<=##Noise)(\d)+(\.)?(\d)*$",
                                       basedir).group(0)),
                "path": os.path.join(planes_logdir, "degradations")}
    return clean, degradation


class MultiSceneDataset:
    """All scenes of one experiment, with per-scene index bookkeeping."""

    ON_THE_FLY_THRESHOLD_TRAIN = 20
    ON_THE_FLY_THRESHOLD_EVAL = 2

    def __init__(self, config, eval_mode: bool = False,
                 scene_norm_coords=None, planes_logdir: str = None):
        """Args mirror reference BlenderDataset.__init__
        (load_blender.py:43): `config` is the `dataset` config section;
        `scene_norm_coords` is the `nerf` section when new coord boxes
        must be computed (else None)."""
        threshold = (self.ON_THE_FLY_THRESHOLD_EVAL if eval_mode
                     else self.ON_THE_FLY_THRESHOLD_TRAIN)
        prob_groups = config.get("prob_assigned2scene_groups", True)
        train_specs = get_scene_configs(
            config.get("dir", {}).get("train", {}),
            prob_assigned2scene_groups=prob_groups)
        val_specs = get_scene_configs(config.get("dir", {}).get("val", {}))
        assert all(len(s.module_confinements) == 0 for s in val_specs), \
            "no sense confining training of validation scenes"
        train_ids = [s.scene_id for s in train_specs]
        val_ids = [s.scene_id for s in val_specs]
        if (len(set(train_ids + val_ids)) != len(train_ids + val_ids)
                and not eval_mode):
            overlap = [s for s in val_ids if s in train_ids]
            raise ValueError(
                f"overlap between training and validation scenes: {overlap}")
        specs = val_specs + train_specs

        self.eval_mode = eval_mode
        self.on_the_fly_load = len(specs) > threshold
        if eval_mode and config.get("llff", {}).get("min_eval_frames"):
            # interpolated video poses interleave None image slots
            # (reference load_llff.py:104-105); only the on-the-fly item
            # path handles them (load_blender.py:171-177)
            self.on_the_fly_load = True
        self.images: list = []
        self.poses = np.zeros((0, 4, 4), dtype=np.float32)
        self.hwfDs: list = []
        self.per_im_scene_id: list = []
        self.i_train: "OrderedDict[str, list]" = OrderedDict()
        self.i_val: "OrderedDict[str, list]" = OrderedDict()
        self.scene_probs: "OrderedDict[str, float]" = OrderedDict()
        self.val_only_scene_ids: list = []
        self.coords_normalization: dict = {}
        self.scene_id_plane_resolution: dict = {}
        self.module_confinements: dict = {}
        self.degradations: dict = {}
        self.scene_types: dict = {}
        self.scenes_set: set = set()
        self.marg2crop: dict = {}
        self.base_factors: dict = {}

        all_ds = [s.ds_factor for s in specs]
        for spec in specs:
            scene_id = spec.scene_id
            if scene_id in self.i_train:
                raise ValueError(f"scene {scene_id} already in the set")
            self.scenes_set.add(scene_id)
            self.module_confinements[scene_id] = spec.module_confinements
            val_only = ((scene_id in val_ids or len(val_ids) == 0)
                        if eval_mode else scene_id not in train_ids)
            if val_only:
                self.val_only_scene_ids.append(scene_id)
            self.scene_id_plane_resolution[scene_id] = spec.plane_res
            if eval_mode and not val_only:
                continue
            splits2use = (["test"] if eval_mode
                          else (["val"] if val_only else ["train", "val"]))

            clean_base, degradation = parse_scene_suffix(
                spec.basedir, min(all_ds), planes_logdir or "")
            if degradation is not None:
                self.degradations[scene_id] = degradation
            scene_path = os.path.join(
                config.get("root_path", ""),
                config[spec.scene_type]["root"], clean_base)
            self.scene_types[scene_id] = spec.scene_type

            if spec.scene_type == "synt":
                images, poses, _, hwfd, i_split = load_blender_data(
                    scene_path, testskip=config.get("testskip", 1),
                    downsampling_factor=spec.ds_factor,
                    splits2use=splits2use,
                    load_imgs=not self.on_the_fly_load,
                    degradation=degradation)
                per_im = [(hwfd[0][i], hwfd[1][i], hwfd[2][i], hwfd[3][i])
                          for i in range(len(hwfd[0]))]
                poses4 = poses
            elif spec.scene_type == "llff":
                assert scene_id not in self.degradations, "unsupported"
                images, poses, _, _, i_test, load_params = \
                    llff_mod.load_llff_data(
                        scene_path, factor=spec.ds_factor,
                        base_factor=min(all_ds), max_factor=max(all_ds),
                        load_imgs=not self.on_the_fly_load,
                        min_eval_frames=config.get("llff", {}).get(
                            "min_eval_frames", None) if eval_mode else None)
                self.base_factors[scene_id] = load_params[0]
                if load_params[1] is not None:
                    self.marg2crop[scene_id] = load_params[1]
                images = [im for im in images]
                hwf = poses[0, :3, -1]
                per_im = [(int(hwf[0]), int(hwf[1]), float(hwf[2]),
                           spec.ds_factor)] * len(images)
                bottom = np.tile(np.array([0, 0, 0, 1], np.float32)
                                 .reshape(1, 1, 4), (poses.shape[0], 1, 1))
                poses4 = np.concatenate([poses[:, :3, :4], bottom], 1)
                if eval_mode:
                    i_split = [[], [], list(range(len(images)))]
                else:
                    llffhold = config.get("llffhold", 0)
                    if llffhold > 0:
                        hold = [(i + len(images) // (2 * llffhold))
                                % len(images)
                                for i in np.unique(np.round(np.linspace(
                                    0, len(images) - 1, llffhold + 1))
                                    .astype(int))][:llffhold]
                    else:
                        hold = [i_test]
                    i_split = [np.arange(len(images)), hold, hold]
            else:
                raise ValueError(
                    f"scene type {spec.scene_type} not supported")

            if scene_norm_coords is not None:
                self.coords_normalization[scene_id] = calc_scene_box(
                    {"camera_poses": poses4[:, :3, :4],
                     "near": config[spec.scene_type]["near"],
                     "far": config[spec.scene_type]["far"],
                     "H": [p[0] for p in per_im],
                     "W": [p[1] for p in per_im],
                     "f": [p[2] for p in per_im]},
                    including_dirs=scene_norm_coords.get("use_viewdirs",
                                                         True),
                    no_ndc=config[spec.scene_type]["no_ndc"],
                    adjust_az_range=scene_norm_coords.get(
                        "adjust_azimuth_range", False),
                    adjust_elevation_range=scene_norm_coords.get(
                        "adjust_elevation_range", False))

            offset = len(self.images)
            if eval_mode:
                self.i_val[scene_id] = [v + offset for v in i_split[2]]
            else:
                self.i_val[scene_id] = [v + offset for v in i_split[1]]
            if not val_only:
                self.i_train[scene_id] = [v + offset for v in i_split[0]]
                self.scene_probs[scene_id] = spec.prob
            self.images += list(images)
            self.poses = np.concatenate([self.poses, poses4], 0)
            self.hwfDs += per_im
            self.per_im_scene_id += [scene_id] * len(images)

    def __len__(self):
        return len(self.images)

    def item(self, index: int):
        """Fetch (image [H,W,C] float32, pose [4,4], H, W, focal, ds).

        Mirrors reference BlenderDataset.item (load_blender.py:168-198)
        including on-the-fly load + crop + degradation resize.
        """
        h, w, focal, ds_factor = self.hwfDs[index]
        if self.on_the_fly_load:
            im_path = self.images[index]
            if im_path is None:  # interpolated video pose without an image
                go_back = 1
                while im_path is None:
                    im_path = self.images[index - go_back]
                    go_back += 1
                img = np.float32(np.nan) * imread(im_path)
            else:
                img = imread(im_path)
            scene_id = self.per_im_scene_id[index]
            if scene_id in self.marg2crop:
                m = self.marg2crop[scene_id]
                img = img[m[0]:-m[0] if m[0] > 0 else None,
                          m[1]:-m[1] if m[1] > 0 else None, :]
            resizing_factor = ds_factor
            if scene_id in self.base_factors:  # LLFF
                resizing_factor //= self.base_factors[scene_id]
            if resizing_factor > 1:
                basedir = re.sub(r"_DS(\d).*", "", scene_id)
                basedir = re.sub(r"##.*", "", basedir)
                img = im_resize(
                    img, scale_factor=resizing_factor,
                    degradation=self.degradations.get(scene_id),
                    fname="%s_%s" % (basedir, os.path.basename(im_path)
                                     .replace(".png", "")))
        else:
            img = self.images[index]
        return img, self.poses[index], h, w, focal, ds_factor
