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
  * `PlanesBuffer` -- the resident working set: draws `buffer_size`
    scenes every `steps_per_buffer` steps, puts each drawn scene's planes
    and its Adam state on the port's device once, steps them
    (`apply_grads`), and writes changed scenes back, Adam state included,
    on a redraw, a save or an eval load; across ranks
    (`host_partition=`), each scene is read and written by its owner
    rank only, which broadcasts what it read;
  * `PlanesOptimizer` -- one Adam per trained scene, the step inside the
    buffer.

optax.adam(lr, eps=1e-8) and torch.optim.Adam(lr, eps=1e-8) take the
same step (in another order of f32 operations).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from nvsr_tpu_torch.parallel.sharding import broadcast_object
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
        # the plane files this store has read, and their bytes
        self.files_read = self.bytes_read = 0
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

    def _read(self, path: str) -> dict:
        arrays = _read_any(path)
        self.files_read += 1
        self.bytes_read += os.path.getsize(path)
        return arrays

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
        arrays = safe_load(path, self._read, SUFFIX, best=prefer_best)
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
    """The resident scene working set and the per-scene Adam of the
    planes.

    buffer_size scenes are resident; every steps_per_buffer steps the
    buffer is flushed and redrawn (steps_per_buffer == -1: the buffer
    holds every scene and is only reshuffled); the sampler's reshuffle
    callback marks scene cycles; frozen scenes never step or save;
    `save_params(as_best=True)` snapshots every training scene. Each
    resident scene's planes, and with optimize its Adam moments, live on
    `device`; they are loaded once per draw and updated in place.

    host_partition: a parallel.host_pool.HostPartition over the saved
    scene ids, with `mesh` the ranks that share this store (one process
    each, the same draws on every rank): only a scene's owner reads its
    file and writes it back, and what the owner reads reaches every rank
    through HostPartition.broadcast. Every rank then steps the same
    planes with the same averaged gradients, so the skipped writes lose
    nothing. Without one (or with one rank) every scene is this
    process's.

    device_pool (JAX's store_planes.device_pool; with a host_partition
    whose owners are the pool's homes): a scene's planes and Adam
    moments are resident on its home rank alone, which reads and writes
    its file; every other rank keeps only its small fields (box, rank,
    occupied box) and the planes' shapes. `lend` (a step's or an eval's
    planes; collective) broadcasts the home's planes, not its moments, into
    transient tensors on every rank; `apply_grads` (the gradients are
    averaged on every rank) steps Adam on the home alone and frees the
    other ranks' copies."""

    def __init__(self, store: PlaneStore, training_scenes, *, lr: float,
                 buffer_size: Optional[int] = None,
                 steps_per_buffer: int = -1, optimize: bool = True,
                 frozen_scenes=(), scene2saved: Optional[dict] = None,
                 do_when_reshuffling: Callable = None,
                 rng: np.random.Generator = None, device="cuda",
                 host_partition=None, mesh=None, device_pool: bool = False):
        self.store = store
        self.host_partition = host_partition
        self.mesh = mesh
        self.device_pool = bool(device_pool and host_partition is not None
                                and host_partition.process_count > 1
                                and mesh is not None)
        # the device pool's one lent scene: (saved id, plane dict)
        self._lent = None
        self.device = torch.device(device)
        self.training_scenes = list(training_scenes)
        self.scene2saved = scene2saved or {s: s for s in self.training_scenes}
        self.frozen_scenes = set(frozen_scenes)
        self.optimize = optimize
        # the step's lr is the buffer's, read at each step (set_lr)
        self.opt = PlanesOptimizer({}, lr)
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
        self._prefetch = None

    @property
    def lr(self) -> float:
        return self.opt.lr

    # -- buffer management --------------------------------------------------
    def _owns(self, saved: str) -> bool:
        return self.host_partition is None or self.host_partition.owns(saved)

    def _keeps(self, saved: str) -> bool:
        """Whether this rank keeps the scene's planes and Adam state
        between steps: every rank, but under the device pool its home
        alone."""
        return not self.device_pool or self._owns(saved)

    def _flush(self):
        for scene in sorted(self.dirty):
            if self._owns(scene):
                self.store.save(scene, self.resident[scene],
                                self.opt.state(scene))
        self.dirty.clear()

    def _fetch(self, saved: str, prefer_best, with_opt_state: bool):
        """A stored scene as (ScenePlanes on the device, PlanesAdamState |
        None); prefer_best None: the best file if there is one. Shared
        over ranks, only the owner reads the file: the small fields reach
        the others as one object, the planes and Adam moments in one
        broadcast into zeros of their shapes. Under the device pool
        nothing else is sent: the other ranks get the ScenePlanes with
        each tensor's (shape, dtype) in its place, and no Adam state."""
        part = self.host_partition
        shared = (part is not None and part.process_count > 1
                  and self.mesh is not None)
        planes = opt_state = None
        if not shared or part.owns(saved):
            if prefer_best is None:
                prefer_best = self.store.exists(saved, prefer_best=True)
            planes, opt_state = self.store.load(
                saved, prefer_best=prefer_best, with_opt_state=with_opt_state)
            planes = replace(
                planes, planes_pos=planes.planes_pos.to(self.device),
                plane_view=None if planes.plane_view is None
                else planes.plane_view.to(self.device))
            if shared and opt_state is not None:
                opt_state = opt_state._replace(**{
                    m: {k: torch.tensor(np.asarray(v), device=self.device)
                        for k, v in getattr(opt_state, m).items()}
                    for m in ("mu", "nu")})
        if shared:
            spec = broadcast_object(
                None if planes is None else _spec(planes, opt_state),
                part.owner(saved), mesh=self.mesh)
            if self.device_pool:
                return (planes, opt_state) if planes is not None \
                    else (spec[0], None)
            if planes is None:
                planes, opt_state = _zeros_of(spec, self.device)
            part.broadcast([planes.params(), None if opt_state is None
                            else [opt_state.mu, opt_state.nu]],
                           saved, self.mesh)
        return planes, opt_state

    def _load(self, saved: str, prefer_best: bool, trained: bool):
        """Put a stored scene on the device; with `trained`, its Adam
        state too (the stored one, else a fresh one)."""
        planes, opt_state = self._fetch(saved, prefer_best, trained)
        self.resident[saved] = planes
        if trained and self._keeps(saved):
            self.opt.add_scene(saved, planes.params(), opt_state)

    def draw_scenes(self):
        """Flush the changed scenes and load a fresh buffer."""
        self._flush()
        if self._prefetch is not None:
            self._prefetch.join()
            self._prefetch = None
        self.steps_since_drawing = 0
        self.cur_scenes = self.sampler.sample(
            self.buffer_size, just_shuffle=self.steps_per_buffer == -1)
        keep = {self.scene2saved[s] for s in self.cur_scenes}
        self._lent = None
        for scene in list(self.resident):
            if scene not in keep:
                del self.resident[scene]
                self.opt.drop_scene(scene)
        for scene in self.cur_scenes:
            saved = self.scene2saved[scene]
            if saved not in self.resident:
                frozen = scene in self.frozen_scenes
                self._load(saved, prefer_best=frozen or not self.optimize,
                           trained=self.optimize and not frozen)
        self._start_prefetch()
        return self.cur_scenes

    def _start_prefetch(self):
        """Warm the page cache for the next buffer's plane files on the
        native store's background threads while training runs (only
        where the buffer is redrawn, and the native store is built)."""
        if self.steps_per_buffer == -1 or not native_store.available():
            return
        saved = [self.scene2saved.get(sc, sc)
                 for sc in self.sampler.sample_from[:self.buffer_size]]
        paths = [self.store.path(s, must_exist=True) for s in saved
                 if self._owns(s)]
        paths = [p for p in paths if p]
        if paths:
            self._prefetch = native_store.Prefetcher(paths, n_threads=2)

    def get(self, scene: str) -> ScenePlanes:
        """A resident scene's planes as this rank holds them: under the
        device pool a rank that is not the scene's home holds its small
        fields (box, rank, occupied box) and no tensors (`lend` gives
        them)."""
        return self.resident[self.scene2saved[scene]]

    def lend(self, scene: str) -> ScenePlanes:
        """A resident scene's planes with their tensors, for a step, an
        occupancy update or an eval. Under the device pool this is
        collective (every rank calls it, in the same order): the home
        broadcasts the planes into transient tensors on the other ranks,
        once until the next apply_grads or the next scene (one scene is
        lent at a time). Otherwise it is `get`."""
        saved = self.scene2saved[scene]
        planes = self.resident[saved]
        if not self.device_pool:
            return planes
        if self._lent is None or self._lent[0] != saved:
            self._lent = None
            params = planes.params() if self._owns(saved) \
                else _zeros_of((planes, None), self.device)[0].params()
            self.host_partition.broadcast([params], saved, self.mesh)
            self._lent = (saved, params)
        return planes.with_params(self._lent[1])

    def resident_bytes(self) -> int:
        """The bytes of plane and Adam-moment tensors this rank keeps
        between steps (a lent scene's transient copy is not counted)."""
        total = 0
        for planes in self.resident.values():
            for t in planes.params().values():
                if torch.is_tensor(t):
                    total += t.numel() * t.element_size()
        for scene in self.opt.planes:
            st = self.opt.state(scene)
            for t in list(st.mu.values()) + list(st.nu.values()):
                total += t.numel() * t.element_size()
        return total

    def load_scene(self, scene: str, load_best: bool = False) -> ScenePlanes:
        """One scene's planes for evaluation, loaded on first use."""
        self._flush()
        saved = self.scene2saved[scene]
        if saved not in self.resident:
            self._load(saved, prefer_best=load_best,
                       trained=self.optimize
                       and scene not in self.frozen_scenes)
        return self.lend(scene)

    # -- optimization -------------------------------------------------------
    def apply_grads(self, scene: str, grads: dict):
        """One Adam step on this scene's planes (a no-op for a frozen
        scene or without optimize)."""
        if not self.optimize or scene in self.frozen_scenes:
            return
        saved = self.scene2saved[scene]
        self._lent = None
        if self._keeps(saved):
            self.opt.apply_grads(saved, grads)
        self.dirty.add(saved)

    def set_occ_aabb(self, scene: str, aabb):
        """Record a scene's occupied box; it is saved with the planes and
        tightens the sampling bounds."""
        saved = self.scene2saved[scene]
        self.resident[saved] = replace(self.resident[saved],
                                       occ_aabb=np.asarray(aabb))
        self.dirty.add(saved)

    def set_lr(self, lr: float):
        """Adjust the planes learning rate (plateau scheduler hook)."""
        self.opt.set_lr(lr)

    def step_cadence(self):
        """Advance the buffer clock; redraw when due. Returns the new
        scene list, or None."""
        self.steps_since_drawing += 1
        if self.steps_since_drawing == self.steps_per_buffer:
            return self.draw_scenes()
        return None

    def jump_start(self, config=None, on: bool = True):
        """Curriculum warm-up: on=True pins training to the first
        `config[0]` scenes (a fraction or a count) with the redraw
        suspended until the caller's criterion is met; on=False restores
        the redraw cadence and redraws. Returns the number of scenes (on)
        or the new scene list (off)."""
        if on:
            num_scenes = config[0]
            if isinstance(num_scenes, float):
                num_scenes = int(np.ceil(num_scenes
                                         * len(self.sampler.scenes)))
            self._jump_start_memory = {
                "steps_per_buffer": self.steps_per_buffer}
            self.sampler.sample_from = []
            self.steps_per_buffer = -1
            return num_scenes
        self.steps_per_buffer = \
            self._jump_start_memory["steps_per_buffer"]
        self.sampler.sample_from = []
        self.draw_scenes()
        return self.cur_scenes

    def save_params(self, as_best: bool = False):
        """Write the planes (and their Adam state) back to disk; as_best
        snapshots every training scene."""
        scenes = self.training_scenes if as_best else self.cur_scenes
        saved_set = []
        for sc in scenes:
            if sc in self.frozen_scenes:
                continue
            saved = self.scene2saved[sc]
            if saved in saved_set:
                continue
            saved_set.append(saved)
            if not self._owns(saved):
                continue
            if saved in self.resident:
                self.store.save(saved, self.resident[saved],
                                self.opt.state(saved), as_best=as_best)
            elif as_best and self.store.exists(saved):
                planes, opt_state = self.store.load(
                    saved, with_opt_state=self.optimize)
                self.store.save(saved, planes, opt_state, as_best=True)
        if not as_best:
            self.dirty.clear()

    # -- statistics ---------------------------------------------------------
    def get_plane_stats(self, viewdir: bool = False) -> dict:
        """Per-channel mean and std over the corpus planes (numpy, in
        the JAX package's order of reductions), for SR input
        normalization."""
        means, stds = [], []
        for sc in self.training_scenes:
            saved = self.scene2saved[sc]
            if saved in self.resident:
                planes = self.lend(sc)
            elif self.device_pool:
                # lent for the statistics, then dropped again
                self._load(saved, None, False)
                planes = self.lend(sc)
                del self.resident[saved]
                self._lent = None
            else:
                planes, _ = self._fetch(saved, None, False)
            pos = _numpy(planes.planes_pos)
            means.extend(pos.mean(axis=(2, 3)))
            stds.extend(pos.reshape(*pos.shape[:2], -1).std(axis=2))
            if viewdir and planes.plane_view is not None:
                pv = _numpy(planes.plane_view)
                means.append(pv.mean(axis=(1, 2)))
                stds.append(pv.reshape(pv.shape[0], -1).std(axis=1))
        return {"mean": np.stack(means).mean(0),
                "std": np.stack(stds).mean(0)}


def _spec(planes: ScenePlanes, opt_state):
    """(planes, opt_state) with each tensor as its (shape, dtype): what
    a rank that does not read the file needs to receive it."""
    def desc(t):
        return None if t is None else (tuple(t.shape), t.dtype)

    spec_planes = replace(planes, planes_pos=desc(planes.planes_pos),
                          plane_view=desc(planes.plane_view))
    if opt_state is not None:
        opt_state = opt_state._replace(
            mu={k: desc(v) for k, v in opt_state.mu.items()},
            nu={k: desc(v) for k, v in opt_state.nu.items()})
    return spec_planes, opt_state


def _zeros_of(spec, device):
    """Zeros on `device` in the place of every (shape, dtype) of a
    _spec."""
    def zeros(d):
        return None if d is None else torch.zeros(d[0], dtype=d[1],
                                                  device=device)

    planes, opt_state = spec
    planes = replace(planes, planes_pos=zeros(planes.planes_pos),
                     plane_view=zeros(planes.plane_view))
    if opt_state is not None:
        opt_state = opt_state._replace(
            mu={k: zeros(v) for k, v in opt_state.mu.items()},
            nu={k: zeros(v) for k, v in opt_state.nu.items()})
    return planes, opt_state


_ADAM_HYPERPARAMS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


class PlanesOptimizer:
    """One Adam per trained scene over its plane dict {"pos", "view"?}.

    `planes` maps scene -> plane dict of leaf tensors, which are updated
    in place; frozen scenes (or optimize=False) never step. Each scene's
    state converts to and from the JAX package's stored form
    (`PlanesAdamState`): the Adam moments stay on the planes' device, the
    step count on the host, and the optax wrapper's step count and
    hyperparameters are carried beside them (the learning rate being the
    one of the scene's last step, as optax.inject_hyperparams keeps it)."""

    def __init__(self, planes: dict, lr: float, *, optimize: bool = True,
                 frozen_scenes=()):
        self.planes = planes
        self.lr = float(lr)
        self.init_lr = float(lr)
        self.optimize = optimize
        self.frozen_scenes = set(frozen_scenes)
        self.opts: dict = {}
        self._wrapper: dict = {}

    def _opt(self, scene: str) -> torch.optim.Adam:
        if scene not in self.opts:
            self.opts[scene] = torch.optim.Adam(
                list(self.planes[scene].values()), lr=self.lr, eps=1e-8)
        return self.opts[scene]

    def _wrap(self, scene: str) -> dict:
        if scene not in self._wrapper:
            hyper = dict(_ADAM_HYPERPARAMS, learning_rate=self.init_lr)
            self._wrapper[scene] = {
                "inject_count": np.asarray(0, np.int32),
                "count_shape": (),
                "hyperparams": {k: np.asarray(v, np.float32)
                                for k, v in hyper.items()}}
        return self._wrapper[scene]

    def add_scene(self, scene: str, planes: dict,
                  state: Optional[PlanesAdamState] = None):
        """Track `scene`'s plane tensors, with its stored Adam state (the
        moments copied to the planes' device) or a fresh one."""
        self.drop_scene(scene)
        self.planes[scene] = planes
        if state is None:
            return
        opt = self._opt(scene)
        step = torch.tensor(float(np.asarray(state.count).reshape(-1)[0]),
                            dtype=torch.float32)

        def moment(x, p):
            if torch.is_tensor(x):
                return x.to(p.device)
            return torch.tensor(np.asarray(x), device=p.device)

        for k, p in planes.items():
            opt.state[p] = {"step": step.clone(),
                            "exp_avg": moment(state.mu[k], p),
                            "exp_avg_sq": moment(state.nu[k], p)}
        # the scalars as stored (the native store keeps a 0-d array as
        # shape (1,)), so a state saved again without a step is the same
        self._wrapper[scene] = {
            "inject_count": np.asarray(state.inject_count),
            "count_shape": np.shape(state.count),
            "hyperparams": dict(state.hyperparams)}

    def drop_scene(self, scene: str):
        for d in (self.planes, self.opts, self._wrapper):
            d.pop(scene, None)

    def state(self, scene: str) -> Optional[PlanesAdamState]:
        """The scene's Adam state in the stored form (moments as tensors
        on the device), or None for a scene this optimizer does not
        train."""
        if scene not in self.planes:
            return None
        params = self.planes[scene]
        opt_state = self.opts[scene].state if scene in self.opts else {}
        st = {k: opt_state.get(p) for k, p in params.items()}
        first = next(iter(st.values()))
        count = int(first["step"]) if first else 0
        wrap = self._wrap(scene)
        return PlanesAdamState(
            wrap["inject_count"], dict(wrap["hyperparams"]),
            np.full(wrap["count_shape"], count, np.int32),
            {k: v["exp_avg"] if v else torch.zeros_like(params[k])
             for k, v in st.items()},
            {k: v["exp_avg_sq"] if v else torch.zeros_like(params[k])
             for k, v in st.items()})

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
        wrap = self._wrap(scene)
        wrap["inject_count"] = wrap["inject_count"] + 1
        wrap["hyperparams"]["learning_rate"] = np.asarray(self.lr,
                                                          np.float32)

    def set_lr(self, lr: float):
        """Adjust the planes learning rate (plateau scheduler hook); it
        takes effect at the next step."""
        self.lr = float(lr)
