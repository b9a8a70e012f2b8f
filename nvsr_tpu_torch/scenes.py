"""Scene identity, LR/HR coupling, and sampling (host-side orchestration).

Re-implements the reference's multi-scene bookkeeping with the same
observable behavior:
  * scene-id DSL `{name}_DS{d}[_PlRes{p}_{v}]`
    (reference models.py:928-934) and plane naming `sc{id}_D{dim}`
    (models.py:110-116);
  * the scene-group config-key convention
    `"ds,pos_res,view_res[,type[,prob[,confinements]]]": [scenes]`
    (reference load_blender.py:203-230) — parsed with ast.literal_eval
    instead of eval();
  * SceneCoupler: pairs LR/HR variants of a scene, derives the global
    ds factor, and maps every scene to the scene whose planes are stored
    (reference models.py:936-1019);
  * SceneSampler / ImageSampler / cycle Counter
    (reference models.py:441-469, nerf_helpers.py:94-156).

The port's copy of nvsr_tpu/scenes.py (numpy only), unchanged.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Scene-id DSL
# ---------------------------------------------------------------------------

def get_scene_id(basedir: str, ds_factor: int, plane_res) -> str:
    """Reference models.py:928-929."""
    if plane_res is None or plane_res[0] is None:
        return "%s_DS%d" % (basedir, ds_factor)
    return "%s_DS%d_PlRes%d_%d" % (basedir, ds_factor, plane_res[0],
                                   plane_res[1])


def extract_ds_and_res(scene_id: str):
    """Reference models.py:931-934."""
    ds = int(re.search(r"(?<=_DS)(\d)+", scene_id).group(0))
    res = (int(re.search(r"(?<=_PlRes)(\d)+(?=_)", scene_id).group(0))
           if "_PlRes" in scene_id else None)
    return ds, res


def get_plane_name(scene_id: Optional[str], dimension: int) -> str:
    """Reference models.py:110-113."""
    if scene_id is None:
        return "_D%d" % dimension
    return "sc%s_D%d" % (scene_id, dimension)


def plane_name2scene(plane_name: str) -> str:
    """Reference models.py:115-116."""
    return re.search("(?<=sc).*(?=_D)", plane_name).group(0)


def scene_basedir(scene_id: str) -> str:
    """Strip the _DS.../##... suffixes back to the dataset folder name."""
    base = re.sub(r"_DS(\d).*", "", scene_id)
    return re.sub(r"##.*", "", base)


def interpret_scene_list(values) -> list[str]:
    """Range expansion: [a, b] -> "a".."b-1" (reference
    nerf_helpers.py:165-173)."""
    scenes = []
    for sc in values:
        if isinstance(sc, list):
            assert len(sc) == 2
            scenes.extend(str(i) for i in range(sc[0], sc[1]))
        else:
            scenes.append(sc)
    return scenes


@dataclass
class SceneSpec:
    scene_id: str
    basedir: str
    ds_factor: int
    plane_res: tuple            # (pos_res, viewdir_res); (None, None) = NeRF
    scene_type: str             # 'synt' | 'llff'
    prob: float
    module_confinements: list


def parse_scene_group_key(key: str):
    """Parse a scene-group config key into its up-to-6 fields.

    Reference load_blender.py:209-216 uses eval(); we literal-eval a
    tuple. Fields: (ds, pos_res, view_res, type, prob, confinements).
    """
    conf = list(ast.literal_eval(f"({str(key).rstrip(',')},)"))
    if len(conf) < 2:
        conf.append(None)
    if len(conf) < 3:
        conf.append(conf[1])
    if len(conf) < 4:
        conf.append("synt")
    if len(conf) < 5:
        conf.append(1)
    elif conf[4] is None:
        conf[4] = 1
    if len(conf) < 6:
        conf.append([])
    return tuple(conf)


def get_scene_configs(config_dict, excluded_scene_ids=(),
                      prob_assigned2scene_groups: bool = True
                      ) -> list[SceneSpec]:
    """Expand a {group_key: [scenes]} dict into per-scene specs.

    Matches reference BlenderDataset.get_scene_configs
    (load_blender.py:203-230) including probability spreading.
    """
    specs: list[SceneSpec] = []
    for key, scenes in dict(config_dict).items():
        if not isinstance(scenes, list):
            scenes = [scenes]
        assert len(scenes) > 0, f"empty scene list for group {key!r}"
        ds, pos_res, view_res, s_type, prob, confinements = \
            parse_scene_group_key(key)
        scenes = interpret_scene_list(scenes)
        group_prob = prob if prob_assigned2scene_groups else prob * len(scenes)
        for s in scenes:
            sid = get_scene_id(s, ds, (pos_res, view_res))
            if sid in excluded_scene_ids:
                continue
            specs.append(SceneSpec(
                scene_id=sid, basedir=s, ds_factor=ds,
                plane_res=(pos_res, view_res), scene_type=s_type,
                prob=group_prob / len(scenes),
                module_confinements=list(confinements)))
    return specs


# ---------------------------------------------------------------------------
# LR/HR scene coupling
# ---------------------------------------------------------------------------

class SceneCoupler:
    """Pairs LR/HR variants of each scene and derives the SR factor.

    Same observable behavior as reference models.py:936-1019 for the
    supported (`planes_res in {'LR',''}`) paths; the deprecated
    HR-planes mode raises.
    """

    def __init__(self, scenes_list, planes_res: str, num_pos_planes: int,
                 training_scenes, multi_im_res: bool = True):
        assert planes_res in ("HR", "LR", "LRHR", "HRLR", "")
        if "HR" in planes_res:
            raise NotImplementedError(
                "HR-planes mode is deprecated in the reference "
                "(models.py:981-985)")
        planes_model = num_pos_planes > 0
        self.num_pos_planes = num_pos_planes
        scenes_list = list(set(list(scenes_list) + list(training_scenes)))
        self.upsample_couples: dict[str, str] = {}
        self.downsample_couples: dict[str, str] = {}
        ds_ratios, res_ratios, res_vals, ds_vals = [], [], [], []

        def name_pattern(name: str) -> str:
            if planes_model:
                return ("^" + re.escape(name.split("_DS")[0]) + "_DS"
                        + r"(\d)+_PlRes(\d)+_" + name.split("_")[-1])
            return "^" + re.escape(name.split("_DS")[0]) + "_DS"

        if multi_im_res:
            for i, sc in enumerate(scenes_list):
                matches = [s for j, s in enumerate(scenes_list)
                           if j != i and re.search(name_pattern(sc), s)]
                if not matches:
                    continue
                org = extract_ds_and_res(sc)
                for match in matches:
                    found = extract_ds_and_res(match)
                    res_vals.extend([found[1], org[1]])
                    res_ratio = (found[1] / org[1]) if planes_model else None
                    if res_ratio == 1:
                        continue
                    res_ratios.append(res_ratio)
                    ds_ratios.append(found[0] / org[0])
                    ds_vals.extend([found[0], org[0]])
                    determining = res_ratios[-1] if planes_model \
                        else 1 / ds_ratios[-1]
                    if determining < 1:
                        if sc in training_scenes:
                            self.upsample_couples[match] = sc
                        self.downsample_couples[sc] = match
                    elif determining > 1:
                        self.downsample_couples[match] = sc
                        if match in training_scenes:
                            self.upsample_couples[sc] = match

        if len(self.downsample_couples) == 0:
            self.ds_factor = 1
        else:
            self.plane_res_vals = set(res_vals)
            self.ds_vals = set(ds_vals)
            assert len(self.plane_res_vals) <= 2, \
                "more than two plane resolutions in the couple graph"
            if planes_model:
                self.ds_factor = int(max(1 / res_ratios[0], res_ratios[0]))
            else:
                self.ds_factor = int(max(1 / ds_ratios[0], ds_ratios[0]))
        if planes_model:
            for k in range(len(ds_ratios)):
                if res_ratios[k] != 1 / ds_ratios[k]:
                    assert ds_ratios[k] == 1, (
                        "downsampling factor should match the plane "
                        "resolution ratio")
                assert res_ratios[k] in (self.ds_factor, 1 / self.ds_factor), \
                    "inconsistent plane resolution ratios"

        self.scene2saved = {
            sc: self.downsample_couples.get(sc, sc) for sc in scenes_list}

    # -- queries (reference models.py:989-1019) -----------------------------
    def plane2saved(self, plane_name: str) -> str:
        scene = plane_name2scene(plane_name)
        return plane_name.replace(scene, self.scene2saved[scene])

    def coupled_scene(self, scene: str) -> list[str]:
        couples = []
        if scene in self.downsample_couples:
            couples.append(self.downsample_couples[scene])
        if scene in self.upsample_couples:
            couples.append(self.upsample_couples[scene])
        assert len(couples) <= 1, "expected at most one couple per scene"
        return couples

    def scene_with_saved_plane(self, scene: str,
                               plane_not_scene: bool = False) -> str:
        if plane_not_scene:
            return self.plane2saved(scene)
        return self.scene2saved[scene]

    def should_SR(self, scene: str, plane_not_scene: bool = False) -> bool:
        if plane_not_scene:
            return plane_name2scene(scene) in self.downsample_couples
        return scene in self.downsample_couples


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

class SceneSampler:
    """Permutation-without-replacement scene sampler with a reshuffle
    callback and frozen-scene handling (reference models.py:441-469)."""

    def __init__(self, scenes: list, do_when_reshuffling: Callable = None,
                 frozen_scenes: list = (), rng: np.random.Generator = None):
        self.scenes = list(scenes)
        self.frozen_scenes = list(frozen_scenes)
        self.rng = rng or np.random.default_rng()
        self.do_when_reshuffling = lambda: None
        self.shuffle()
        self.do_when_reshuffling = do_when_reshuffling or (lambda: None)

    def shuffle(self, inhibit_func: bool = False):
        perm = self.rng.permutation(len(self.scenes))
        self.sample_from = [self.scenes[i] for i in perm]
        if not inhibit_func:
            self.do_when_reshuffling()

    def sample(self, n: int, just_shuffle: bool = False) -> list:
        assert n <= len(self.scenes)
        sampled: list = []
        cursor = 0
        if just_shuffle:  # buffer covers all scenes
            self.shuffle(inhibit_func=True)
            while self.sample_from:
                sampled.append(self.sample_from.pop())
            return sampled
        while len(sampled) < n:
            if cursor >= len(self.sample_from):
                self.shuffle()
                cursor = 0
            cand = self.sample_from[cursor]
            all_frozen = all(sc in self.frozen_scenes for sc in sampled)
            if cand in sampled or (len(sampled) == n - 1
                                   and cand in self.frozen_scenes
                                   and all_frozen):
                cursor += 1
            else:
                sampled.append(self.sample_from.pop(cursor))
        return sampled


class ImageSampler:
    """Samples a (scene, image) pair weighted by per-scene probability
    over the active (buffered) scenes (reference nerf_helpers.py:135-156)."""

    def __init__(self, scenes_dict: dict, scene_probs: dict = None,
                 rng: np.random.Generator = None):
        self.scenes_dict = scenes_dict
        self.scene_probs = scene_probs or {}
        self.rng = rng or np.random.default_rng()
        self.active_scenes: list = []
        self.im_inds: list = []
        self.im_probs = np.zeros(0)

    def update_active(self, active_scenes: list):
        self.active_scenes = list(active_scenes)
        self.im_inds, probs = [], []
        for sc_num, sc in enumerate(self.active_scenes):
            imgs = self.scenes_dict[sc]
            self.im_inds.extend((sc_num, ind) for ind in imgs)
            p = self.scene_probs.get(sc, 1.0)
            probs.extend([p / len(imgs)] * len(imgs))
        self.im_probs = np.asarray(probs, dtype=np.float64)
        self.im_probs /= self.im_probs.sum()

    def sample(self):
        chosen = self.rng.choice(len(self.im_inds), p=self.im_probs)
        sc_num, img_idx = self.im_inds[chosen]
        return self.active_scenes[sc_num], img_idx


class Counter:
    """Counts full scene-cycles; triggers save-on-cycle
    (reference nerf_helpers.py:94-112)."""

    def __init__(self):
        self.counter = 0
        self.flag = False

    def count(self) -> int:
        return self.counter

    def step(self, print_str: str = None):
        self.counter += 1
        self.flag = True
        if print_str is not None:
            print(print_str + str(self.count()))

    def check_and_reset(self) -> bool:
        if self.flag:
            self.flag = False
            return True
        return False


def subsample_eval_scenes(max_scenes: int, scene_types: list,
                          pick_first: bool = False) -> list[int]:
    """Keep at most max_scenes per eval tag group
    (reference nerf_helpers.py:204-210)."""
    keep: list[int] = []
    for scene_type in set(scene_types):
        nums = [i for i, t in enumerate(scene_types) if t == scene_type]
        if pick_first:
            idx = range(min(len(nums), max_scenes))
        else:
            idx = np.unique(np.round(
                np.linspace(0, len(nums) - 1, max_scenes)).astype(int))
        keep.extend(nums[i] for i in idx)
    return keep
