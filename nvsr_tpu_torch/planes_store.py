"""Per-scene feature planes: init, the on-disk store, the resident buffer
and the planes' Adam (counterpart of nvsr_tpu/planes_store.py).

  * `ScenePlanes` -- one scene's state (positional plane stack, view-
    direction plane, coordinate box, occupied box);
  * `PlaneStore` -- the files `{model}_{scene_id}.planes[_best]` of the
    JAX package, read and written here unchanged: NVPS bundles from
    `native/` or npz (a load sniffs which), with the atomic-write/backup
    semantics and the search-path hierarchy, and the planes' Adam state
    as keys `opt_{i}` in the order JAX flattens its optax state
    (`PlanesAdamState`);
  * `PlanesBuffer` -- its eval half: the scene draw, the per-scene load
    that puts a scene's planes on the port's device once, and the
    occupied-box update. Buffer redraws while training, the planes' Adam
    steps through the buffer, saving and corpus statistics belong to the
    training half (ROADMAP Queue 1 #3); `PlanesOptimizer` below is the
    per-scene Adam that the training step uses today.

optax.adam(lr, eps=1e-8) and torch.optim.Adam(lr, eps=1e-8) take the
same step.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from nvsr_tpu_torch.scenes import SceneSampler
from nvsr_tpu_torch.utils import native_store
from nvsr_tpu_torch.utils.io import safe_load, safe_save, save_npz

SUFFIX = "planes"


@dataclass
class ScenePlanes:
    """Per-scene learnable state.

    planes_pos: [P, C, R, R] full planes, or [P, C, R, 2k] low-rank
    factors when rank is set (plane = A @ B^T, A = [..., :k],
    B = [..., k:]); plane_view: [Cv, Rv, Rv] or None; box: [2, 3+2]
    numpy; occ_aabb: the occupied world box [2, 3] (numpy) once
    estimated."""
    planes_pos: torch.Tensor
    plane_view: Optional[torch.Tensor]
    box: np.ndarray
    rank: Optional[int] = None
    occ_aabb: Optional[np.ndarray] = None

    def params(self) -> dict:
        p = {"pos": self.planes_pos}
        if self.plane_view is not None:
            p["view"] = self.plane_view
        return p

    def with_params(self, p: dict) -> "ScenePlanes":
        return replace(self, planes_pos=p["pos"],
                       plane_view=p.get("view", self.plane_view))


def materialize_pos_planes(planes_pos, rank: Optional[int]):
    """Expand low-rank factors [P, C, R, 2k] to full planes [P, C, R, R];
    identity when rank is None."""
    if rank is None:
        return planes_pos
    a = planes_pos[..., :rank]
    b = planes_pos[..., rank:]
    return torch.einsum("pcrk,pcsk->pcrs", a, b)


def create_scene_planes(generator: torch.Generator, *, num_planes: int,
                        num_channels: int, resolution,
                        viewdir_resolution=None, viewdir_channels: int = 0,
                        init_std: float, box,
                        rank_ratio: Optional[float] = None,
                        device="cuda") -> ScenePlanes:
    """Random-normal planes with the decoder-tied std, drawn from
    `generator`, on `device`. With rank_ratio, the positional planes are
    low-rank factors [P, C, R, 2*ceil(rank_ratio*R)] of std
    sqrt(init_std), so their product has ~init_std scale."""
    if not isinstance(resolution, (tuple, list)):
        resolution = (resolution, resolution)

    def normal(shape, std):
        return (std * torch.randn(shape, generator=generator,
                                  device=generator.device)).to(device)

    rank = None
    if rank_ratio is not None:
        rank = int(np.ceil(rank_ratio * resolution[0]))
        planes_pos = normal((num_planes, num_channels, resolution[0],
                             2 * rank), np.sqrt(init_std))
    else:
        planes_pos = normal((num_planes, num_channels, resolution[0],
                             resolution[1]), init_std)
    plane_view = None
    if viewdir_channels:
        if not isinstance(viewdir_resolution, (tuple, list)):
            viewdir_resolution = (viewdir_resolution, viewdir_resolution)
        plane_view = normal((viewdir_channels, viewdir_resolution[0],
                             viewdir_resolution[1]), init_std)
    return ScenePlanes(planes_pos, plane_view, np.asarray(box), rank=rank)


def decoder_tied_init_std(decoder_params, std_factor: float = 0.1,
                          member: int = 0) -> float:
    """std_factor x the population std of the decoder's fc_alpha
    weight."""
    w = decoder_params["members"][member]["fc_alpha"]["w"]
    return float(std_factor * torch.std(w, correction=0))


class PlanesAdamState(NamedTuple):
    """A scene's planes Adam state as the JAX package stores it: the
    leaves of optax.inject_hyperparams(optax.adam)'s state, in
    jax.tree.flatten order -- the wrapper's step count, its
    hyperparameters by sorted name (b1, b2, eps, eps_root,
    learning_rate), Adam's step count, then the first and the second
    moments, each a dict of numpy arrays by sorted plane key ("pos",
    "view")."""
    inject_count: np.ndarray
    hyperparams: dict
    count: np.ndarray
    mu: dict
    nu: dict

    def leaves(self) -> list:
        return ([self.inject_count]
                + [self.hyperparams[k] for k in sorted(self.hyperparams)]
                + [self.count]
                + [self.mu[k] for k in sorted(self.mu)]
                + [self.nu[k] for k in sorted(self.nu)])

    @classmethod
    def from_leaves(cls, leaves, plane_keys) -> "PlanesAdamState":
        keys = sorted(plane_keys)
        names = ("b1", "b2", "eps", "eps_root", "learning_rate")
        n = len(keys)
        assert len(leaves) == 2 + len(names) + 2 * n, len(leaves)
        return cls(leaves[0], dict(zip(names, leaves[1:6])), leaves[6],
                   dict(zip(keys, leaves[7:7 + n])),
                   dict(zip(keys, leaves[7 + n:7 + 2 * n])))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _read_any(path: str) -> dict:
    if native_store.is_nvps_file(path):
        return native_store.load_arrays(path)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class PlaneStore:
    """Disk store with the search-path hierarchy [logdir/planes,
    models.planes_path/planes, pretrained/planes]."""

    def __init__(self, save_locations, run_time_signature: float = 0,
                 backend: str = "auto"):
        """backend: 'native' (the C codec of native/), 'npz', or 'auto'
        (native when the library builds, else npz, as the JAX package
        does). Loads sniff the file magic, so both formats load."""
        if isinstance(save_locations, str):
            save_locations = [save_locations]
        self.save_locations = list(save_locations)
        self.run_time_signature = run_time_signature
        if backend == "auto":
            backend = "native" if native_store.available() else "npz"
        assert backend in ("native", "npz")
        self.backend = backend

    def path(self, scene: str, model_name: str = "coarse",
             must_exist: bool = False, prefer_best: bool = False,
             locations=None) -> str:
        fname = f"{model_name}_{scene}.{SUFFIX}"
        for loc in (locations or self.save_locations):
            p = os.path.join(loc, fname)
            if must_exist:
                check = p.replace(f".{SUFFIX}", f".{SUFFIX}_best") \
                    if prefer_best else p
                if os.path.isfile(check):
                    return p
            elif os.path.isdir(loc):
                return p
        return ""

    def exists(self, scene: str, prefer_best: bool = False) -> bool:
        return bool(self.path(scene, must_exist=True,
                              prefer_best=prefer_best))

    def save(self, scene: str, planes: ScenePlanes,
             opt_state: Optional[PlanesAdamState] = None,
             as_best: bool = False, model_name: str = "coarse") -> str:
        arrays = {"planes_pos": _numpy(planes.planes_pos),
                  "box": np.asarray(planes.box)}
        if planes.rank is not None:
            arrays["rank"] = np.asarray(planes.rank)
        if planes.plane_view is not None:
            arrays["plane_view"] = _numpy(planes.plane_view)
        if planes.occ_aabb is not None:
            arrays["occ_aabb"] = np.asarray(planes.occ_aabb)
        if opt_state is not None:
            for i, leaf in enumerate(opt_state.leaves()):
                arrays[f"opt_{i}"] = _numpy(leaf)
        path = self.path(scene, model_name=model_name)
        assert path, f"no writable store location for scene {scene}"
        run_folder = os.path.dirname(path)
        run_folder = run_folder[:-len("/planes")] \
            if run_folder.endswith("/planes") else run_folder
        if self.backend == "native":
            return safe_save(path, lambda tmp: native_store.save_arrays(
                tmp, arrays), SUFFIX, best=as_best,
                run_time_signature=self.run_time_signature,
                run_folder=run_folder)
        return save_npz(path, arrays, suffix=SUFFIX, best=as_best,
                        run_time_signature=self.run_time_signature,
                        run_folder=run_folder)

    def load(self, scene: str, prefer_best: bool = False,
             model_name: str = "coarse", with_opt_state: bool = False,
             locations=None):
        """-> (ScenePlanes with CPU tensors, PlanesAdamState | None); the
        Adam state only when asked for and stored."""
        path = self.path(scene, model_name=model_name, must_exist=True,
                         prefer_best=prefer_best, locations=locations)
        assert path, (
            f"Could not find the required feature planes file for scene "
            f"{scene} in {locations or self.save_locations}")
        arrays = safe_load(path, _read_any, SUFFIX, best=prefer_best)
        planes = ScenePlanes(
            torch.from_numpy(arrays["planes_pos"]),
            torch.from_numpy(arrays["plane_view"])
            if "plane_view" in arrays else None,
            arrays["box"],
            rank=int(np.asarray(arrays["rank"]).reshape(()))
            if "rank" in arrays else None,
            occ_aabb=arrays.get("occ_aabb"))
        opt_state = None
        n_opt = sum(k.startswith("opt_") for k in arrays)
        if with_opt_state and n_opt:
            opt_state = PlanesAdamState.from_leaves(
                [arrays[f"opt_{i}"] for i in range(n_opt)],
                planes.params().keys())
        return planes, opt_state


class PlanesBuffer:
    """The resident scene working set, eval half: draw the scenes, load
    one scene on demand, record its occupied box. Each scene's planes
    are put on `device` once, when they are loaded. With optimize, the
    scenes load from their rolling files rather than their best ones;
    stepping them belongs to the training half."""

    def __init__(self, store: PlaneStore, training_scenes, *, lr: float,
                 buffer_size: Optional[int] = None,
                 steps_per_buffer: int = -1, optimize: bool = False,
                 frozen_scenes=(), scene2saved: Optional[dict] = None,
                 do_when_reshuffling: Callable = None,
                 rng: np.random.Generator = None, device="cuda"):
        self.store = store
        self.device = torch.device(device)
        self.training_scenes = list(training_scenes)
        self.scene2saved = scene2saved or {s: s for s in self.training_scenes}
        self.frozen_scenes = set(frozen_scenes)
        self.optimize = optimize
        self.lr = lr
        self.buffer_size = buffer_size or len(self.training_scenes)
        self.steps_per_buffer = steps_per_buffer
        if self.buffer_size >= len(self.training_scenes):
            self.buffer_size = len(self.training_scenes)
            self.steps_per_buffer = -1
        assert (self.steps_per_buffer == -1
                or self.steps_per_buffer >= self.buffer_size), (
            "steps_per_buffer < buffer_size would load scenes in vain")
        self.sampler = SceneSampler(
            self.training_scenes,
            do_when_reshuffling=do_when_reshuffling,
            frozen_scenes=list(self.frozen_scenes), rng=rng)
        self.resident: dict[str, ScenePlanes] = {}
        self.dirty: set[str] = set()
        self.steps_since_drawing = 0
        self.cur_scenes: list[str] = []

    def _flush(self):
        for scene in sorted(self.dirty):
            self.store.save(scene, self.resident[scene])
        self.dirty.clear()

    def _load(self, saved: str, prefer_best: bool):
        planes, _ = self.store.load(saved, prefer_best=prefer_best)
        self.resident[saved] = replace(
            planes, planes_pos=planes.planes_pos.to(self.device),
            plane_view=None if planes.plane_view is None
            else planes.plane_view.to(self.device))

    def draw_scenes(self):
        """Flush the changed scenes and load a fresh buffer."""
        self._flush()
        self.steps_since_drawing = 0
        self.cur_scenes = self.sampler.sample(
            self.buffer_size, just_shuffle=self.steps_per_buffer == -1)
        keep = {self.scene2saved[s] for s in self.cur_scenes}
        for scene in list(self.resident):
            if scene not in keep:
                del self.resident[scene]
        for scene in self.cur_scenes:
            saved = self.scene2saved[scene]
            if saved not in self.resident:
                self._load(saved, prefer_best=scene in self.frozen_scenes
                           or not self.optimize)
        return self.cur_scenes

    def get(self, scene: str) -> ScenePlanes:
        return self.resident[self.scene2saved[scene]]

    def load_scene(self, scene: str, load_best: bool = False) -> ScenePlanes:
        """One scene's planes for evaluation, loaded on first use."""
        self._flush()
        saved = self.scene2saved[scene]
        if saved not in self.resident:
            self._load(saved, prefer_best=load_best)
        return self.resident[saved]

    def set_occ_aabb(self, scene: str, aabb):
        """Record a scene's occupied box; it is saved with the planes and
        tightens the sampling bounds."""
        saved = self.scene2saved[scene]
        self.resident[saved] = replace(self.resident[saved],
                                       occ_aabb=np.asarray(aabb))
        self.dirty.add(saved)


class PlanesOptimizer:
    """One Adam per trained scene over its plane dict {"pos", "view"?}.

    `planes` maps scene -> plane dict of leaf tensors, which are updated
    in place; frozen scenes (or optimize=False) never step."""

    def __init__(self, planes: dict, lr: float, *, optimize: bool = True,
                 frozen_scenes=()):
        self.planes = planes
        self.lr = float(lr)
        self.optimize = optimize
        self.frozen_scenes = set(frozen_scenes)
        self.opts: dict = {}

    def _opt(self, scene: str) -> torch.optim.Adam:
        if scene not in self.opts:
            self.opts[scene] = torch.optim.Adam(
                list(self.planes[scene].values()), lr=self.lr, eps=1e-8)
        return self.opts[scene]

    @torch.no_grad()
    def apply_grads(self, scene: str, grads: dict):
        """One Adam step on this scene's planes with `grads` (the same
        keys as its plane dict); a no-op for a frozen scene."""
        if not self.optimize or scene in self.frozen_scenes:
            return
        opt = self._opt(scene)
        for g in opt.param_groups:
            g["lr"] = self.lr
        for k, p in self.planes[scene].items():
            p.grad = grads[k]
        opt.step()
        for p in self.planes[scene].values():
            p.grad = None

    def set_lr(self, lr: float):
        """Adjust the planes learning rate (plateau scheduler hook); it
        takes effect at the next step."""
        self.lr = float(lr)
