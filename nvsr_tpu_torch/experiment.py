"""The experiment runner (counterpart of nvsr_tpu/experiment.py).

`Experiment(cfg)` builds what the JAX Experiment builds for one config --
dataset, scene coupler, eval tags, best-loss groups, decoders, plane SR,
optimizers, planes store and buffer -- and `run()` trains it as JAX's
does: per iteration one view's pixels (random, tile-major with
`nerf.train.tiled_gather`, or LR-patch-aligned on consistency
iterations), one `train.train_step`, the gated optimizer steps with
virtual batches, the planes' Adam through the buffer, occupancy updates;
around them the validation cadence, buffer redraws, the plateau
scheduler, rolling and best checkpoints, preemption (`time_sig.txt`),
resume and early stop. With `eval_mode="images"` it evaluates a trained
logdir instead, writing `metrics.txt` and PNGs per eval sequence as JAX's
`evaluate` does.

The logdir is the bridge both ways: pickled numpy pytrees
(`checkpoint*.ckpt[_best]`, `SR_checkpoint*.ckpt[_best]`, with the
optimizers' state in optax's layout, and `exp_info.pkl`) and plane files
(`planes/coarse_<scene>.planes[_best]`, with each scene's Adam state);
parameters go to the port through `bridge.*_from_jax` and back through
`bridge.*_to_jax`. A logdir that either package wrote is resumed by the
other.

On a CUDA device the eval renders take the tiled route by default, as
the JAX package does on a TPU: the fused gather+decode kernel
(csrc/triplane_render.cu) for configs `fused_render.supports` after the
bf16 substitution, else the eval plane sampler kernel with the plain
decoder. `nerf.validation.tiled_gather` overrides the default either
way. On the CPU the same routes run the kernels' plain versions.

Training draws its random numbers as JAX's does where they are host
draws (one numpy Generator, in the same order: the scene and image
samplers, the pixel chooser, the ensemble member); the device draws
(jitter, density, SR and point noise) come from a torch.Generator on the
device in the JAX key's place. Metrics stay on the device until
`flush_train_metrics` fetches a print window's in one copy; a view's
pose, pixel indices and target go to the card through pinned memory,
without a host wait.

The baseline NeRF (a config whose `models.coarse.type` is not
TwoDimPlanesModel, as configs/MipNeRF_baseline.yml) has no planes, SR net
or kernel: its two MLPs train through `train.train_step_baseline`, which
differs from `train.train_step` only in its point fns, in the same
training iteration; its eval renders take the plain path, with the same
checkpoint layout as JAX's baseline.

Data parallel (`experiment.data_parallel: true | N`) runs one process
per rank under torch.distributed (`cli.py` under torchrun), with JAX's
contract: every rank draws the global batch from the shared host seed,
renders and differentiates its contiguous rows of it (its device draws
those of the global batch: ops.draws.RowShard), and one all_reduce
averages the gradients and the loss terms (train.reduce_step), so every
rank takes the same optimizer steps on the same replicated parameters.
Eval renders share their ray blocks (render.render_rays_chunked). Each
scene's plane file is read and written by its owner rank only
(parallel.host_pool), rank 0 alone writes checkpoints, logs, images and
experiment_info, and the host's decisions (evaluate, save, stop,
preemption) are rank 0's, broadcast.

With `experiment.model_parallel: M` the world is JAX's ('data',
'model') mesh of W // M x M ranks: each rank keeps its model index's
slices of the decoders, the SR net and their Adam moments
(parallel.sharding's layouts; JAX `_place_params_on_mesh`), the ranks of
one model group hold the same rows of the batch and run the model
group's collectives inside the forward and backward
(parallel/tensor.py), and the gradients are averaged over the data
group. Checkpoints are written in the full layout (gathered over the
model group), so a logdir moves between model_parallel 1, M and the JAX
package; a full one is read and sliced. With
`nerf.train.store_planes.device_pool` each scene's planes and Adam
moments live on one home rank (JAX's round-robin over the sorted saved
ids), which reads and writes its file and broadcasts the planes for each
step and eval (planes_store.PlanesBuffer.lend). Evals under either
keep the eval kernels (JAX sends them to its reference path): a
tensor-parallel rank gathers the decoders once an evaluate pass, a
pooled one renders the lent planes; training keeps the trainable
route. A world of 1 ignores both keys, as JAX's one device
does.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from collections import OrderedDict, defaultdict
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.data.dataset import MultiSceneDataset
from nvsr_tpu_torch.models.nerf_mlp import (NeRFMLPConfig,
                                            init_nerf_mlp_params)
from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig, apply_plane_sr,
                                            init_plane_sr_params,
                                            sr_scale_factor)
from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                            init_decoder_params,
                                            make_density_fn, make_rot_mats,
                                            project_to_planes)
from nvsr_tpu_torch.ops.fused_decoder import HALF
from nvsr_tpu_torch.ops.draws import RowShard
from nvsr_tpu_torch.ops.geometry import get_ray_bundle, normalize_coords
from nvsr_tpu_torch.ops.occupancy import estimate_occupied_box
from nvsr_tpu_torch.ops.plane_sample import TileSamplerConfig
from nvsr_tpu_torch.ops.rendering import img2mse, mse2psnr, ssim
from nvsr_tpu_torch.ops.resize import image_inconsistency_loss
from nvsr_tpu_torch.parallel.host_pool import HostPartition, pool_homes
from nvsr_tpu_torch.parallel.sharding import (COLLECTIVES, agree,
                                              broadcast_object,
                                              data_sharding,
                                              decoder_tp_shardings,
                                              gather_tree, make_mesh,
                                              plane_sr_tp_shardings,
                                              replicate, shard_rays,
                                              shard_tree, tensor_parallel)
from nvsr_tpu_torch.planes_store import (PlaneStore, PlanesBuffer,
                                         create_scene_planes,
                                         decoder_tied_init_std,
                                         materialize_pos_planes)
from nvsr_tpu_torch.render import (RayBundle, RenderConfig,
                                   build_sampled_rays,
                                   make_triplane_point_fn, render_image,
                                   tighten_bundle)
from nvsr_tpu_torch.scenes import (Counter, ImageSampler, SceneCoupler,
                                   extract_ds_and_res, get_plane_name,
                                   get_scene_configs, subsample_eval_scenes)
from nvsr_tpu_torch.train import (ModuleOptimizer, PlateauScheduler,
                                  StepFlags, baseline_point_fn,
                                  choose_patch_pixels, choose_random_pixels,
                                  choose_tile_pixels, reduce_step,
                                  train_step, train_step_baseline)
from nvsr_tpu_torch.utils.config import (CfgNode,
                                         assert_compatible_model_config,
                                         get_config)
from nvsr_tpu_torch.utils.coverage import PlaneCoverage
from nvsr_tpu_torch.utils.io import (PreemptedError, check_run_signature,
                                     load_pickle, save_pickle)
from nvsr_tpu_torch.utils.logging import ExperimentLogger, RunningScores
from nvsr_tpu_torch.utils.tracing import span

RUNNING_MEAN_LOGS = ["psnr", "SR_psnr_gain", "planes_SR", "fine_loss",
                     "rays_per_sec", "fine_psnr", "loss", "coarse_loss",
                     "inconsistency", "loss_sr", "loss_lr",
                     "im_inconsistency", "ssim"]


def downsampling_offset(ds_factor) -> float:
    """Sub-pixel ray offset matching image downsampling."""
    return (ds_factor - 1) / (2 * ds_factor)


def _files_read(paths) -> dict:
    """A load_pretrained span's args: how many files were read and their
    bytes."""
    return {"files": len(paths),
            "bytes": sum(os.path.getsize(p) for p in paths)}


def find_latest_checkpoint(ckpt_path: str, sr: bool,
                           find_best: bool = False):
    """The newest rolling checkpoint in `ckpt_path` (or its best one)."""
    if ckpt_path is None or not os.path.isdir(ckpt_path):
        return None
    prefix = "SR_checkpoint" if sr else "checkpoint"
    if find_best:
        pattern = "^" + prefix + r"(\d)*\.ckpt_best"
        cands = [f for f in os.listdir(ckpt_path) if re.search(pattern, f)]
        if not cands:
            return None
        return os.path.join(ckpt_path, cands[0])
    pattern = "(?<=^" + prefix + r")(\d)+(?=\.ckpt$)"
    cands = [f for f in os.listdir(ckpt_path) if re.search(pattern, f)]
    if not cands:
        return None
    latest = sorted(cands, key=lambda x: int(re.search(pattern, x).group(0)))
    return os.path.join(ckpt_path, latest[-1])


class _Batch(NamedTuple):
    """One training iteration's draw (Experiment._draw_batch): the whole
    batch on the device, untightened and unsharded."""
    scene_id: str
    sr_iter: bool
    consistency_iter: bool
    rays: RayBundle
    target: torch.Tensor
    rcfg: RenderConfig
    tile_cfg: Optional[TileSamplerConfig]
    member: int


class Experiment:
    """Builds the system for one config and trains it, or evaluates a
    trained logdir. `device` is where the models, planes, optimizer
    states and renders live: the card unless the caller names another
    (the tests pass "cpu"); under a process group with
    `experiment.data_parallel`, this rank's device."""

    def __init__(self, cfg: CfgNode, *, load_checkpoint: str = "",
                 eval_mode: str = None, results_path: str = None,
                 root_path: str = "", device="cuda"):
        self.cfg = cfg
        self.eval_mode = eval_mode
        self.root_path = root_path
        self.device = torch.device(device)
        self.mesh = self._build_mesh()
        # the tensor-parallel mesh the models' functions take, and the
        # layouts of their slices (set by _place_params_on_mesh)
        self._tp = None
        self._layouts = {}
        # rank 0 alone writes the logdir's files, logs and images
        self.is_main = self.mesh is None or self.mesh.rank == 0
        experiment_id = cfg.experiment.get(
            "id", cfg.experiment["logdir"].split("/")[-1])
        self.experiment_id = experiment_id
        cfg.dataset["root_path"] = root_path

        self.planes_model = ("coarse" not in cfg.get("models", {})
                             or cfg.models.coarse.get("type")
                             == "TwoDimPlanesModel")
        self.what2train = list(cfg.get_path("nerf.train.what", []))
        assert all(m in ("LR_planes", "decoder", "SR")
                   for m in self.what2train)
        self.decoder_training = "decoder" in self.what2train
        self.im_inconsistency_loss_w = cfg.get_path(
            "nerf.train.im_inconsistency_loss_w", None)

        # --- logdir / resume policy -------------------------------------
        self.logdir = os.path.join(root_path, cfg.experiment["logdir"],
                                   cfg.experiment.get("id", ""))
        self.results_dir = None
        if eval_mode:
            self.results_dir = os.path.join(root_path, results_path or ".",
                                            experiment_id)
            if self.is_main:
                os.makedirs(self.results_dir, exist_ok=True)
        if load_checkpoint == "resume":
            load_checkpoint = self.logdir
        elif load_checkpoint == "" and eval_mode:
            # evaluation of a trained experiment: its models live in its
            # logdir
            load_checkpoint = self.logdir
        elif load_checkpoint == "":
            if os.path.exists(self.logdir) and not eval_mode:
                assert not [f for f in os.listdir(self.logdir)
                            if ".ckpt" in f], (
                    f"Folder {self.logdir} already contains saved models.")
            os.makedirs(self.logdir, exist_ok=True)
        if self.is_main and (not eval_mode or load_checkpoint == ""):
            with open(os.path.join(
                    self.logdir,
                    "config%s.yml" % ("_Eval" if eval_mode else "")),
                    "w") as f:
                f.write(cfg.dump())
        self.resume_experiment = (load_checkpoint != ""
                                  and os.path.exists(load_checkpoint))
        if load_checkpoint != "":
            assert self.resume_experiment, (
                f"Experiment to resume not found in {load_checkpoint}")
        self.load_checkpoint = load_checkpoint

        # --- pretrained model inheritance -------------------------------
        self.pretrained_model_folder = cfg.get_path("models.path", None)
        if self.pretrained_model_folder is not None:
            self.pretrained_model_folder = os.path.join(
                root_path, self.pretrained_model_folder)
        pretrained_cfg = None
        if self.planes_model and (not self.decoder_training
                                  or self.pretrained_model_folder):
            if self.pretrained_model_folder and os.path.isfile(
                    self.pretrained_model_folder):
                self.pretrained_model_folder = os.path.dirname(
                    self.pretrained_model_folder)
            if self.pretrained_model_folder:
                pretrained_cfg = get_config(os.path.join(
                    self.pretrained_model_folder, "config.yml"))
                cfg.models.set_defaults_from(pretrained_cfg.models)
        self.pretrained_cfg = pretrained_cfg

        load_saved_models = (self.pretrained_model_folder is not None
                             or self.resume_experiment)
        only_planes_update = self.what2train == ["LR_planes"]
        self.init_new_scenes = (not self.resume_experiment
                                and not eval_mode
                                and "LR_planes" in self.what2train
                                and (self.pretrained_model_folder is None
                                     or only_planes_update))
        self.sr_experiment = ("super_resolution" in cfg
                              or (only_planes_update and pretrained_cfg
                                  and "super_resolution" in pretrained_cfg))

        # --- dataset ----------------------------------------------------
        self.dataset = MultiSceneDataset(
            cfg.dataset, eval_mode=bool(eval_mode),
            scene_norm_coords=cfg.nerf if self.init_new_scenes else None,
            planes_logdir=cfg.get_path("models.planes_path", self.logdir))
        ds = self.dataset
        self.i_train = ds.i_train
        self.i_val = ds.i_val
        coords_normalization = dict(ds.coords_normalization)
        scene_id_plane_resolution = dict(ds.scene_id_plane_resolution)
        available_scenes = list(ds.scenes_set)
        self.planes_updating = "LR_planes" in self.what2train

        # --- scene coupler ----------------------------------------------
        if self.planes_model and (not self.planes_updating
                                  or self.pretrained_model_folder) \
                and pretrained_cfg is not None:
            for spec in get_scene_configs(
                    {k: v for p in pretrained_cfg.dataset["dir"].values()
                     for k, v in dict(p).items()}):
                available_scenes.append(spec.scene_id)
            available_scenes = list(set(available_scenes))
        self.scene_coupler = SceneCoupler(
            list(set(available_scenes + ds.val_only_scene_ids)),
            planes_res="".join(m[:2] for m in self.what2train
                               if "_planes" in m),
            num_pos_planes=(cfg.get_path("models.coarse.num_planes", 3)
                            if self.planes_model else 0),
            training_scenes=list(self.i_train.keys()))

        # --- eval tagging -----------------------------------------------
        only_lr_eval = (len(self.scene_coupler.downsample_couples) == 0
                        and self.sr_experiment)
        self.only_lr_eval = only_lr_eval

        def tags_for(scene_id):
            bare = scene_id.replace("_train", "")
            tags = []
            if scene_id in ds.val_only_scene_ids:
                tags.append("blind_validation")
            elif "_train" in scene_id:
                tags.append("train_imgs")
            else:
                tags.append("validation")
            if "##Gauss" in bare:
                tags.append("Gauss")
            if (bare in self.scene_coupler.downsample_couples.values()
                    or only_lr_eval):
                tags.append("LR")
            if len(ds.module_confinements.get(bare, [])) > 0:
                tags.append("Fixed_" + "_".join(
                    ds.module_confinements[bare]))
            if ds.scene_types.get(bare) == "llff":
                tags.append("real")
            return "_".join(tags)

        val_strings = [tags_for(sid) for sid in self.i_val]
        if "max_scenes_eval" in cfg.dataset and not eval_mode:
            keep = subsample_eval_scenes(cfg.dataset["max_scenes_eval"],
                                         val_strings, pick_first=True)
            self.i_val = OrderedDict(
                [it for i, it in enumerate(self.i_val.items()) if i in keep])

        self.val_ims_per_scene = None
        if not eval_mode:
            counts = [len(v) for v in self.i_val.values()]
            assert all(max(counts) % c == 0 for c in counts), (
                "eval sets must repeat to a common length")
            self.val_ims_per_scene = max(counts)
            self.i_val = OrderedDict(
                [(k, (self.val_ims_per_scene // len(v)) * list(v))
                 for k, v in self.i_val.items()])

        if (cfg.get_path("nerf.validation.eval_train_scenes", False)
                and not eval_mode):
            for sid in list(self.i_val.keys()):
                if sid not in self.i_train:
                    continue
                n = self.val_ims_per_scene
                tr = self.i_train[sid]
                picks = sorted((i + (len(tr) // n) // 2) % len(tr)
                               for i in np.unique(np.round(
                                   np.linspace(0, len(tr) - 1, n))
                                   .astype(int)))
                self.i_val[sid + "_train"] = [tr[i] for i in picks]

        # consistency-loss scenes join training
        if not eval_mode and self.im_inconsistency_loss_w:
            for sid in ds.val_only_scene_ids:
                lr = self.scene_coupler.downsample_couples[sid]
                self.i_train[sid] = self.i_train[lr]
                freq = cfg.get_path("nerf.train.im_consistency_iters_freq",
                                    0.1)
                ds.scene_probs[sid] = freq / (
                    len(ds.val_only_scene_ids)
                    if cfg.dataset.get("prob_assigned2scene_groups", True)
                    else 1)
                self.scene_coupler.upsample_couples[lr] = sid
        self.training_scenes = list(self.i_train.keys())

        # unify coord normalization across couples
        if self.sr_experiment:
            for sc in list(ds.scenes_set):
                if sc not in self.scene_coupler.downsample_couples:
                    continue
                lr_sc = self.scene_coupler.downsample_couples[sc]
                if (self.init_new_scenes and sc in coords_normalization
                        and lr_sc in coords_normalization):
                    if ds.scene_types.get(sc) == "llff":
                        both = np.stack([coords_normalization[sc],
                                         coords_normalization[lr_sc]], -1)
                        merged = np.stack([both[0].min(-1), both[1].max(-1)],
                                          0)
                        coords_normalization[sc] = merged
                        coords_normalization[lr_sc] = merged.copy()
                    else:
                        coords_normalization[sc] = \
                            coords_normalization[lr_sc].copy()
                if sc in scene_id_plane_resolution:
                    hr_res = scene_id_plane_resolution.pop(sc)
                    if self.pretrained_model_folder is not None:
                        scene_id_plane_resolution[lr_sc] = (
                            hr_res[0] // self.scene_coupler.ds_factor,
                            hr_res[1])
        self.coords_normalization = coords_normalization
        self.scene_id_plane_resolution = scene_id_plane_resolution

        self.evaluation_sequences = list(self.i_val.keys())
        self.val_strings = [tags_for(s) for s in self.evaluation_sequences]

        # best-model policy
        self.loss4best = ("im_inconsistency" if self.im_inconsistency_loss_w
                          else "fine_loss"
                          if all(v not in self.what2train
                                 for v in ("decoder", "SR")) else "loss")

        def tag_filter(tags, include=(), exclude=()):
            return list({t for t in tags
                         if all(p in t for p in include)
                         and all(p not in t for p in exclude)})

        if self.im_inconsistency_loss_w:
            self.loss_groups4_best = tag_filter(
                self.val_strings, ["blind", "validation"], ["_LR"])
        else:
            self.loss_groups4_best = tag_filter(
                self.val_strings, ["validation"], ["blind", "_LR"])
            if not self.loss_groups4_best:
                self.loss_groups4_best = tag_filter(
                    self.val_strings, ["validation"], ["blind"])

        # --- RNG: numpy for the host samplers; torch generators in place
        # of JAX keys, one on the host for parameter init and one on the
        # device for the training steps' and renders' draws
        seed = cfg.experiment.get("randomseed", 0)
        self.host_rng = np.random.default_rng(seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.render_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.run_time_signature = time.time()
        if self.mesh is not None:
            # one run, one signature: rank 0's
            self.run_time_signature = broadcast_object(
                self.run_time_signature, 0, mesh=self.mesh)

        # --- models -----------------------------------------------------
        self._build_models()
        self._build_sr()
        self._build_optimizers()
        if load_saved_models:
            with span("load_pretrained") as sp:
                sp.set(**_files_read(self._load_checkpoints()))
        self._build_planes()

        # SR input normalization from the corpus planes' statistics,
        # written into the SR net's norm tensors in place (the SR
        # optimizer holds them)
        if (self.sr_experiment and self.sr_params is not None
                and cfg.get_path("super_resolution.input_normalization",
                                 False)
                and not self.resume_experiment and "norm" in self.sr_params):
            stats = self.planes_buffer.get_plane_stats(
                viewdir=cfg.get_path("super_resolution.SR_viewdir", False))
            with torch.no_grad():
                for k in ("mean", "std"):
                    self.sr_params["norm"][k].copy_(torch.as_tensor(
                        stats[k], dtype=torch.float32))
        self._place_params_on_mesh()

        # --- samplers / logging / experiment info ------------------------
        self.image_sampler = ImageSampler(self.i_train, ds.scene_probs,
                                          rng=self.host_rng)
        self.scenes_cycle_counter = Counter()
        groups = list(set(self.val_strings)) + ["train"]
        maxlens = {g: (len(self.training_scenes) if g == "train"
                       else (self.val_ims_per_scene or 1)) for g in groups}
        self.running = RunningScores(RUNNING_MEAN_LOGS, groups, maxlens)
        self.logger = ExperimentLogger(
            logdir=self.logdir, results_dir=self.results_dir,
            eval_mode=eval_mode, running=self.running,
            skip_metrics=bool(cfg.get_path("dataset.llff.min_eval_frames")),
            writes=self.is_main)
        self.logger.set_eval_sequences(self.evaluation_sequences)
        self.experiment_info = {
            "start_i": 0, "eval_counter": 0,
            "best_loss": (0, float(np.finfo(np.float32).max)),
            "last_saved": {m: [] for m in self._models_to_save()}}
        self.experiment_info_file = os.path.join(self.logdir, "exp_info.pkl")
        if self.resume_experiment and not eval_mode and os.path.exists(
                self.experiment_info_file):
            saved = load_pickle(self.experiment_info_file)
            running_state = saved.pop("running_scores", None)
            self.experiment_info.update(saved)
            if running_state:
                self.running.load_state_dict(running_state)
        self.saved_target_ims = {v: set() for v in set(self.val_strings)}
        self._dev_cache = {}
        self._pending_metrics = []
        self._occ_last_update = {}
        self._occ_window = {}
        self._plane_coverage = None
        self.virtual_batch_size = cfg.get_path(
            "nerf.train.virtual_batch_size", 1)

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _models_to_save(self):
        if not self.planes_model:
            return ["decoder"]
        out = []
        if "decoder" in self.what2train:
            out.append("decoder")
        if (self.sr_experiment and "SR" in self.what2train
                and getattr(self, "sr_params", None) is not None):
            out.append("SR")
        return out

    def _build_mesh(self):
        """The ('data', 'model') mesh (JAX `_build_mesh`): with
        `experiment.data_parallel` (true: the whole world; N: must be the
        world size) under an initialized process group, a mesh over it
        with `experiment.model_parallel` (default 1; it must divide the
        world) -- even a world of 1, whose collectives then run on one
        rank, and which ignores model_parallel and
        store_planes.device_pool as JAX's one device does; else None (as
        JAX without more than one device). A world of more than one rank
        needs data_parallel: each rank would otherwise train the same
        logdir on its own."""
        cfg = self.cfg
        dp = cfg.experiment.get("data_parallel", False)
        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        if not dp:
            if world > 1:
                raise ValueError(f"a world of {world} ranks needs "
                                 f"experiment.data_parallel")
            return None
        n = world if dp is True else int(dp)
        if n > world:
            raise ValueError(f"experiment.data_parallel={n} exceeds the "
                             f"{world} ranks of the process group")
        if n != world:
            raise ValueError(f"experiment.data_parallel={n} in a world of "
                             f"{world} ranks: a mesh spans the world")
        if not live:
            return None
        mp = int(cfg.experiment.get("model_parallel", 1)) if n > 1 else 1
        return make_mesh(n, model_parallel=mp, device=self.device)

    def _device_pool(self) -> bool:
        """store_planes.device_pool on a mesh of more than one rank."""
        return bool(self.mesh is not None and self.mesh.world > 1
                    and self.cfg.get_path(
                        "nerf.train.store_planes.device_pool", False))

    def _place_params_on_mesh(self):
        """Rank 0's module parameters and optimizer moments on every rank
        (JAX `_place_params_on_mesh`): broadcast in place, so the ranks
        start from the same state whatever each one loaded or drew; under
        model_parallel > 1 each rank then keeps its slices of the
        decoders and the SR net (decoder_tp_shardings,
        plane_sr_tp_shardings), and its optimizers are rebuilt over them
        with the Adam moments in the parameters' layout (JAX's
        place_state). The baseline's MLPs stay replicated, as in JAX."""
        if self.mesh is None:
            return
        tree = [self.decoder_coarse, self.decoder_fine, self.sr_params]
        for opt in (self.decoder_opt, self.sr_opt):
            if opt is not None:
                tree.append([[st["exp_avg"], st["exp_avg_sq"]]
                             for st in opt.opt.state.values()])
        replicate(self.mesh, tree)
        if not (tensor_parallel(self.mesh) and self.planes_model):
            return
        mesh = self._tp = self.mesh
        lay = self._layouts["decoder"] = decoder_tp_shardings(
            self.decoder_coarse, mesh)
        self.decoder_coarse = shard_tree(self.decoder_coarse, lay, mesh)
        if self.decoder_fine is not None:
            self.decoder_fine = shard_tree(self.decoder_fine, lay, mesh)
        if self.sr_params is not None:
            self._layouts["SR"] = plane_sr_tp_shardings(self.sr_params,
                                                        mesh)
            self.sr_params = shard_tree(self.sr_params, self._layouts["SR"],
                                        mesh)
        if self.decoder_opt is not None:
            self.decoder_opt = self._sharded_opt(
                self.decoder_opt, self._decoder_opt_params())
        if self.sr_opt is not None:
            self.sr_opt = self._sharded_opt(self.sr_opt, self.sr_params)

    def _decoder_opt_params(self) -> dict:
        params = {"dc": self.decoder_coarse}
        if not self.share_coarse_fine and self.decoder_fine is not None:
            params["df"] = self.decoder_fine
        return params

    def _opt_layout(self, opt):
        """The layout of an optimizer's parameter tree."""
        if opt is self.sr_opt:
            return self._layouts["SR"]
        return {k: self._layouts["decoder"] for k in opt.params}

    def _sharded_opt(self, opt, params):
        """A ModuleOptimizer over the sharded `params`, with `opt`'s Adam
        state (when it has one) sliced to their layout."""
        new = ModuleOptimizer(params, lr=opt.lr)
        if opt.opt.state:
            adam, empty = opt.state
            lay = self._opt_layout(opt)
            new.state = (adam._replace(mu=shard_tree(adam.mu, lay, self.mesh),
                                       nu=shard_tree(adam.nu, lay,
                                                     self.mesh)), empty)
        return new

    def _full(self, kind: str, tree):
        """A module's parameter tree in the full layout: gathered over the
        model group under tensor parallelism (collective), else as it
        is."""
        if self._tp is None or tree is None:
            return tree
        return gather_tree(tree, self._layouts[kind], self.mesh)

    def _full_opt_state(self, opt):
        """An optimizer's state in optax's layout with full moments."""
        adam, empty = opt.state
        if self._tp is None:
            return adam, empty
        lay = self._opt_layout(opt)
        return (adam._replace(mu=gather_tree(adam.mu, lay, self.mesh),
                              nu=gather_tree(adam.nu, lay, self.mesh)),
                empty)

    def _build_models(self):
        cfg = self.cfg
        fine_cfg = cfg.models.get("fine", CfgNode())
        self.share_coarse_fine = fine_cfg.get("type") == "use_same"
        self.mlp_cfg = self.enc_cfg = None
        if not self.planes_model:
            self._build_baseline_models()
            return
        self.model_cfg = TriplaneConfig.from_cfg(cfg.models.coarse, cfg.nerf)
        self.rot_mats = make_rot_mats(self.model_cfg.num_planes)
        self.decoder_coarse = init_decoder_params(
            self.generator, self.model_cfg, self.device)
        self.decoder_fine = None if self.share_coarse_fine else \
            init_decoder_params(self.generator, self.model_cfg, self.device)

    def _build_baseline_models(self):
        """The baseline's coarse and fine NeRF MLPs. With mip, the xyz
        encoding is IPE of degrees 0 .. num_encoding_fn_xyz - 1 with no raw
        xyz; enc_cfg is train_step_baseline's, its ds_factor filled per
        scene from the scene id."""
        cfg = self.cfg
        mc = cfg.models.coarse
        mip = cfg.nerf.get("encode_position_fn") == "mip"
        include_xyz = mc.get("include_input_xyz", True) and not mip
        multires = mc.get("num_encoding_fn_xyz", 6) + 1
        common = dict(num_layers=mc.get("num_layers", 4),
                      hidden_size=mc.get("hidden_size", 128),
                      skip_connect_every=mc.get("skip_connect_every", 4),
                      use_viewdirs=cfg.nerf.get("use_viewdirs", True))
        if mip:
            self.mlp_cfg = NeRFMLPConfig(
                input_dim_xyz=3 * 2 * (multires - 1),
                input_dim_dir=((3 if mc.get("include_input_dir", True)
                                else 0)
                               + 2 * 3 * mc.get("num_encoding_fn_dir", 4)),
                **common)
        else:
            self.mlp_cfg = NeRFMLPConfig(
                num_encoding_fn_xyz=mc.get("num_encoding_fn_xyz", 6),
                num_encoding_fn_dir=mc.get("num_encoding_fn_dir", 4),
                include_input_xyz=include_xyz,
                include_input_dir=mc.get("include_input_dir", True),
                **common)
        self.enc_cfg = (mc.get("num_encoding_fn_xyz", 6),
                        mc.get("num_encoding_fn_dir", 4), include_xyz,
                        mc.get("include_input_dir", True), mip, 1, multires)
        self.decoder_coarse = init_nerf_mlp_params(
            self.generator, self.mlp_cfg, self.device)
        self.decoder_fine = None if self.share_coarse_fine else \
            init_nerf_mlp_params(self.generator, self.mlp_cfg, self.device)
        self.model_cfg = None
        self.rot_mats = None

    def _enc_for(self, scene_id: str) -> tuple:
        """The baseline's enc_cfg with the scene's downsampling factor
        (its id's _DS<n>), which sets the mip pixel radius."""
        enc = list(self.enc_cfg)
        enc[5] = int(re.search(r"(?<=_DS)(\d)+", scene_id).group(0))
        return tuple(enc)

    def _build_sr(self):
        cfg = self.cfg
        self.sr_params = None
        self.sr_cfg = None
        self.sr_checkpoint_source = None
        self.rendering_loss_w = 1.0
        self.apply_sr_to_coarse = False
        if not self.sr_experiment or not self.planes_model:
            return
        sr_section = cfg.get("super_resolution", CfgNode())
        if "SR" not in self.what2train and self.pretrained_model_folder \
                and self.pretrained_cfg is not None \
                and "super_resolution" in self.pretrained_cfg:
            sr_section = sr_section.clone() if sr_section else CfgNode()
            sr_section.set_defaults_from(
                self.pretrained_cfg["super_resolution"])
            cfg["super_resolution"] = sr_section
        if sr_section.get_path("model.type", "EDSR") == "None":
            return
        factor = sr_scale_factor(
            sr_section.get_path("model.scale_factor", "linear"),
            self.scene_coupler.ds_factor)
        self.sr_cfg = PlaneSRConfig.from_cfg(
            sr_section, factor, self.model_cfg.num_plane_channels,
            self.model_cfg.plane_interp, self.model_cfg.align_corners)
        self.sr_params = init_plane_sr_params(self.generator, self.sr_cfg,
                                              self.device)
        self.rendering_loss_w = sr_section.get("rendering_loss", 1)
        self.apply_sr_to_coarse = sr_section.get("apply_2_coarse", False)
        if not self.apply_sr_to_coarse:
            assert sr_section.get_path("training.loss", "fine") == "fine", (
                "coarse decoder output cannot train the SR model unless "
                "SR applies to coarse planes")

    def _build_optimizers(self):
        cfg = self.cfg
        self.decoder_opt = None
        self.sr_opt = None
        if self.eval_mode:
            return
        if self.decoder_training or not self.planes_model:
            params = {"dc": self.decoder_coarse}
            if not self.share_coarse_fine and self.decoder_fine is not None:
                params["df"] = self.decoder_fine
            self.decoder_opt = ModuleOptimizer(
                params, lr=cfg.get_path("optimizer.lr", 5e-4))
        if self.sr_params is not None and "SR" in self.what2train:
            self.sr_opt = ModuleOptimizer(
                self.sr_params,
                lr=cfg.get_path("super_resolution.lr",
                                cfg.get_path("optimizer.lr", 5e-4)))

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _decoder_state(self):
        to_jax = bridge.decoder_to_jax if self.planes_model \
            else bridge.nerf_mlp_to_jax
        state = {"model_coarse_state_dict": to_jax(
            self._full("decoder", self.decoder_coarse))}
        if self.decoder_fine is not None:
            state["model_fine_state_dict"] = to_jax(
                self._full("decoder", self.decoder_fine))
        if self.planes_model:
            state["rot_mats"] = np.asarray(self.rot_mats)
            state["models_config"] = self.cfg.get("models",
                                                  CfgNode()).to_dict()
        if self.decoder_opt is not None:
            state["optimizer"] = bridge.optimizer_state_to_jax(
                self._full_opt_state(self.decoder_opt))
        return state

    def _sr_state(self):
        state = {"SR_model": bridge.plane_sr_to_jax(
            self._full("SR", self.sr_params))}
        if self.sr_opt is not None:
            state["SR_optimizer"] = bridge.optimizer_state_to_jax(
                self._full_opt_state(self.sr_opt))
        return state

    def _load_checkpoints(self):
        """Load the SR net and the decoders (with their optimizers' state)
        from the pretrained or resumed logdir -> the files read."""
        load_best = self.eval_mode or not self.resume_experiment
        cfg = self.cfg
        read = []
        if self.sr_experiment and self.sr_params is not None:
            if ("SR" not in self.what2train or self.resume_experiment
                    or cfg.get_path("super_resolution.model.path")):
                if self.resume_experiment and "SR" in self.what2train:
                    src = self.load_checkpoint
                elif cfg.get_path("super_resolution.model.path") is not None:
                    src = os.path.join(self.root_path,
                                       cfg.super_resolution.model["path"])
                else:
                    src = self.pretrained_model_folder
                path = find_latest_checkpoint(
                    src, sr=True,
                    find_best=load_best or "SR" not in self.what2train)
                assert path is not None, "Could not find an SR model to load"
                ckpt = load_pickle(path, suffix="ckpt_best"
                                   if path.endswith("_best") else "ckpt")
                self.sr_params = bridge.plane_sr_from_jax(ckpt["SR_model"],
                                                          self.device)
                if self.sr_opt is not None:
                    self.sr_opt = ModuleOptimizer(self.sr_params,
                                                  lr=self.sr_opt.lr)
                    if "SR_optimizer" in ckpt:
                        self.sr_opt.state = ckpt["SR_optimizer"]
                self.sr_checkpoint_source = path
                read.append(path)

        frozen_decoder = (self.planes_model
                          and "decoder" not in self.what2train)
        if self.load_checkpoint == "" or frozen_decoder:
            src = self.pretrained_model_folder
            find_best = load_best or "decoder" not in self.what2train
        else:
            src = self.load_checkpoint
            find_best = load_best or frozen_decoder
        path = find_latest_checkpoint(src, sr=False, find_best=find_best)
        if path is None:
            return read
        ckpt = load_pickle(path, suffix="ckpt_best"
                           if path.endswith("_best") else "ckpt")
        read.append(path)
        if self.planes_model and "models_config" in ckpt:
            assert_compatible_model_config(
                ckpt["models_config"], self.cfg.get("models",
                                                    CfgNode()).to_dict())
        from_jax = bridge.decoder_from_jax if self.planes_model \
            else bridge.nerf_mlp_from_jax
        self.decoder_coarse = from_jax(ckpt["model_coarse_state_dict"],
                                       self.device)
        if "model_fine_state_dict" in ckpt and not self.share_coarse_fine:
            self.decoder_fine = from_jax(ckpt["model_fine_state_dict"],
                                         self.device)
        if "rot_mats" in ckpt:
            self.rot_mats = np.asarray(ckpt["rot_mats"])
            # the point fns take the fixed bases (models.triplane
            # make_rot_mats), which every JAX checkpoint stores
            if not np.array_equal(self.rot_mats,
                                  make_rot_mats(self.model_cfg.num_planes)):
                raise ValueError(f"{path}: its plane bases are not "
                                 f"make_rot_mats({self.model_cfg.num_planes})")
        if self.decoder_opt is not None:
            self.decoder_opt = ModuleOptimizer(self._decoder_opt_params(),
                                               lr=self.decoder_opt.lr)
            if "optimizer" in ckpt:
                # a state of another structure (e.g. a checkpoint without
                # the fine decoder's) is not restored, as in JAX
                try:
                    self.decoder_opt.state = ckpt["optimizer"]
                except (KeyError, IndexError, ValueError):
                    pass
        return read

    def save_checkpoints(self, iteration: int, as_best: bool = False):
        """Rolling checkpoints (the last one of each model kept), the best
        ones with as_best, and exp_info.pkl; the run's signature is
        checked first, so a newer run on the same logdir stops this one
        here. Under a mesh only rank 0 writes them, in the full layout:
        under tensor parallelism every rank first joins the gathers of
        the slices."""
        states = {}
        if self.is_main or self._tp is not None:
            states = {m: self._sr_state() if m == "SR"
                      else self._decoder_state()
                      for m in self._models_to_save()}
        if not self.is_main:
            return
        check_run_signature(self.logdir, self.run_time_signature)
        self.experiment_info["running_scores"] = self.running.state_dict()
        for model in self._models_to_save():
            prefix = "SR_checkpoint" if model == "SR" else "checkpoint"
            state = states[model]
            name = os.path.join(self.logdir,
                                f"{prefix}{iteration:05d}.ckpt")
            save_pickle(name, state, suffix="ckpt")
            hist = self.experiment_info["last_saved"].setdefault(model, [])
            if hist:
                old = hist.pop(0)
                if os.path.exists(old):
                    os.remove(old)
            hist.append(name)
            if as_best:
                save_pickle(os.path.join(self.logdir, f"{prefix}.ckpt"),
                            state, suffix="ckpt", best=True)
        save_pickle(self.experiment_info_file, self.experiment_info,
                    suffix="pkl")

    # ------------------------------------------------------------------
    # planes
    # ------------------------------------------------------------------
    def _build_planes(self):
        self.planes_lr_scheduler = None
        if not self.planes_model:
            self.planes_buffer = None
            return
        cfg = self.cfg
        folders = []
        if self.planes_updating:
            folders.append(self.logdir)
        if cfg.get_path("models.planes_path") is not None:
            folders.append(os.path.join(self.root_path,
                                        cfg.models["planes_path"]))
        if self.pretrained_model_folder is not None:
            folders.append(self.pretrained_model_folder)
        folders = [os.path.join(f, "planes") for f in folders]
        if self.eval_mode:
            assert os.path.isdir(folders[0]), \
                f"missing planes folder {folders[0]}"
        os.makedirs(folders[0], exist_ok=True)
        # time_sig.txt is rank 0's to claim and check
        self.store = PlaneStore(
            folders, run_time_signature=(self.run_time_signature
                                         if self.is_main else 0))
        # scene ownership over the ranks: only a scene's owner reads and
        # writes its plane file (JAX's Experiment never needs one: its
        # single controller writes each scene once); under the device
        # pool the owner is the scene's home, JAX's round-robin placement
        # over the sorted saved ids (then those of every other scene)
        self.host_partition = None
        if self.mesh is not None and self.mesh.world > 1:
            def saved_of(scenes):
                return sorted({self.scene_coupler.scene2saved.get(s, s)
                               for s in scenes})

            saved_ids = saved_of(self.training_scenes or list(self.i_val))
            owners = None
            if self._device_pool():
                owners = pool_homes(saved_ids, self.mesh.world, extra=saved_of(
                    [*self.i_val, *self.scene_id_plane_resolution]))
            self.host_partition = HostPartition(saved_ids, owners=owners)
        optimize_planes = (any("planes" in m for m in self.what2train)
                           and not self.eval_mode)

        frozen = set()
        if cfg.get_path("models.use_existing_planes", False):
            frozen_store_dir = os.path.join(self.pretrained_model_folder,
                                            "planes")
            for sc in self.training_scenes:
                lr_sc = self.scene_coupler.scene2saved.get(sc, sc)
                if PlaneStore([frozen_store_dir]).exists(lr_sc,
                                                         prefer_best=True):
                    frozen.add(sc)
                    frozen.add(lr_sc)

        if self.init_new_scenes and not self.eval_mode:
            init_std = decoder_tied_init_std(
                self.decoder_coarse,
                std_factor=cfg.get_path("nerf.train.STD_factor", 0.1))
            new = [(scene, res)
                   for scene, res in self.scene_id_plane_resolution.items()
                   if scene not in frozen and not self.store.exists(scene)
                   and scene in self.coords_normalization]
            if self.mesh is not None:
                # rank 0's list, taken before any rank writes one: every
                # rank draws the same planes from its generator
                new = broadcast_object(new, 0, mesh=self.mesh)
            for scene, res in new:
                planes = create_scene_planes(
                    self.generator, num_planes=self.model_cfg.num_planes,
                    num_channels=self.model_cfg.num_plane_channels,
                    resolution=res[0], viewdir_resolution=res[1],
                    viewdir_channels=(self.model_cfg.viewdir_channels
                                      if self.model_cfg.use_viewdirs else 0),
                    init_std=init_std,
                    rank_ratio=cfg.get_path(
                        "models.coarse.planes_rank_ratio", None),
                    box=self.coords_normalization[scene], device="cpu")
                if (self.host_partition is None
                        or self.host_partition.owns(scene)):
                    self.store.save(scene, planes)

        # the planes' plateau lr scheduler, stepped at print cadence
        sched = cfg.get_path("optimizer.lr_scheduler", None)
        if sched is not None and not self.eval_mode:
            patience = int(np.ceil(sched["patience"]
                                   / cfg.experiment.get("print_every", 100)))
            self.planes_lr_scheduler = PlateauScheduler(
                lr=cfg.get_path("optimizer.planes_lr",
                                cfg.get_path("optimizer.lr", 1e-3)),
                patience=patience, factor=sched["factor"])
        store_opts = cfg.get_path("nerf.train.store_planes", CfgNode())
        self.planes_buffer = PlanesBuffer(
            self.store, self.training_scenes or list(self.i_val.keys()),
            lr=cfg.get_path("optimizer.planes_lr",
                            cfg.get_path("optimizer.lr", 1e-3)),
            buffer_size=store_opts.get("buffer_size", None),
            steps_per_buffer=store_opts.get("steps_per_buffer", -1),
            optimize=optimize_planes,
            frozen_scenes=frozen,
            scene2saved=self.scene_coupler.scene2saved,
            do_when_reshuffling=lambda: self.scenes_cycle_counter.step(
                print_str="Number of scene cycles performed: "),
            rng=self.host_rng, device=self.device,
            host_partition=self.host_partition, mesh=self.mesh,
            device_pool=self._device_pool())

    # ------------------------------------------------------------------
    # rendering helpers
    # ------------------------------------------------------------------
    def _mode_render_cfg(self, mode: str, scene_id: str) -> RenderConfig:
        cfg = self.cfg
        stop_coarse = (self.planes_model and self.sr_params is not None
                       and not self.decoder_training
                       and not self.apply_sr_to_coarse)
        return RenderConfig.from_cfg(
            cfg.nerf[mode], cfg.nerf,
            stop_coarse_grad=stop_coarse and mode == "train")

    def _point_fns_for_eval(self, scene_id, planes, skip_sr=False,
                            tiled=True):
        """(coarse, fine) point fns for a scene at eval time, cached per
        (scene_id, skip_sr, tiled) within one evaluate() pass, so the
        plane SR runs once per scene, not once per view."""
        cache = getattr(self, "_eval_pf_cache", None)
        if cache is not None and (scene_id, skip_sr, tiled) in cache:
            return cache[(scene_id, skip_sr, tiled)]
        result = self._point_fns_for_eval_uncached(scene_id, planes,
                                                   skip_sr, tiled)
        if cache is not None:
            cache[(scene_id, skip_sr, tiled)] = result
        return result

    def _point_fns_for_eval_uncached(self, scene_id, planes,
                                     skip_sr=False, tiled=True):
        if not self.planes_model:
            enc = self._enc_for(scene_id)
            dc = self.decoder_coarse
            df = dc if self.share_coarse_fine else self.decoder_fine
            return (baseline_point_fn(dc, self.mlp_cfg, enc),
                    baseline_point_fn(df, self.mlp_cfg, enc))
        sr_scene = (self.sr_params is not None
                    and self.scene_coupler.should_SR(scene_id)
                    and not skip_sr)
        pos = materialize_pos_planes(planes.planes_pos, planes.rank)
        fine_planes = coarse_planes = pos
        if sr_scene:
            hr = apply_plane_sr(self.sr_params, self.sr_cfg, pos,
                                mesh=self._tp)
            fine_planes = hr
            if self.apply_sr_to_coarse:
                coarse_planes = hr
        tile_cfg = self.eval_tile_cfg(scene_id) if tiled else None
        dc, df, mesh = self._eval_decoders(kernels=tile_cfg is not None)
        model_cfg = self.model_cfg
        if tile_cfg is not None and model_cfg.compute_dtype is None:
            # the documented bf16 substitution of the JAX package: the
            # tiled eval samples planes from a bf16 tap table and the
            # fused decoder runs bf16 matmuls (f32 accumulation);
            # fused_render.supports requires compute_dtype bf16 so that
            # the substitution is explicit
            model_cfg = dataclasses.replace(model_cfg,
                                            compute_dtype="bfloat16")
        tile_rays = None if tile_cfg is None else tile_cfg.tile_rays
        pf_c = make_triplane_point_fn(dc, model_cfg, coarse_planes,
                                      planes.plane_view, planes.box,
                                      tile_rays=tile_rays, mesh=mesh)
        pf_f = make_triplane_point_fn(df, model_cfg, fine_planes,
                                      planes.plane_view, planes.box,
                                      tile_rays=tile_rays, mesh=mesh)
        return pf_c, pf_f

    def _eval_decoders(self, kernels: bool):
        """(coarse, fine, mesh) of an eval's point fns. The reference path
        computes on this rank's decoder slices with the model group's
        collectives (mesh: the tensor-parallel mesh, or None). The
        kernels take whole decoders: under tensor parallelism they are
        gathered over the model group (collective; every rank builds the
        same point fns in one order) once per evaluate pass, and the
        point fns then run no collective."""
        dc = self.decoder_coarse
        df = dc if self.share_coarse_fine else self.decoder_fine
        if self._tp is None or not kernels:
            return dc, df, self._tp
        cache = getattr(self, "_eval_pf_cache", None)
        if cache is not None and "decoders" in cache:
            return cache["decoders"]
        full = self._full("decoder", dc)
        result = (full, full if self.share_coarse_fine
                  else self._full("decoder", df), None)
        if cache is not None:
            cache["decoders"] = result
        return result

    def eval_tile_shape(self):
        """(th, tw) image-tile shape of tiled eval renders
        (nerf.validation.tile_shape, e.g. '16x16' / '8' / '8x16')."""
        return self._parse_tile_shape("nerf.validation.tile_shape", "16x16")

    def _parse_tile_shape(self, cfg_key: str, default: str):
        spec = str(self.cfg.get_path(cfg_key, default))
        th, _, tw = spec.partition("x")
        return int(th), int(tw or th)

    def train_tile_shape(self):
        """(th, tw) image-tile shape of tile-coherent training batches
        (nerf.train.tile_shape)."""
        return self._parse_tile_shape("nerf.train.tile_shape", "8x8")

    def train_tile_cfg(self, scene_id: str, num_rays: int):
        """TileSamplerConfig of the trainable route when it is asked for
        (nerf.train.tiled_gather: true; off by default, as in JAX, since
        it changes which pixels a batch holds) and the geometry qualifies
        (bilinear planes, <= 64 channels, a batch of whole tiles), else
        None. The coarse pass's plane gathers then run the trainable
        plane sampler's kernels in both directions. Under a mesh each
        data index's rows must be whole tiles. (JAX refuses any mesh
        here: GSPMD cannot partition its Pallas kernel. Each rank of the
        port runs the kernels on its own rows, on planes replicated over
        the model axis, so only the split must keep tiles whole, as JAX's
        eval gate asks of a ray block.)"""
        if (not self.planes_model
                or not self.cfg.get_path("nerf.train.tiled_gather", False)):
            return None
        if (self.model_cfg.plane_interp != "bilinear"
                or self.model_cfg.num_plane_channels > HALF):
            return None
        th, tw = self.train_tile_shape()
        ranks = 1 if self.mesh is None else self.mesh.data_size
        if num_rays % (ranks * th * tw):
            return None
        return TileSamplerConfig(tile_rays=th * tw)

    def eval_tile_cfg(self, scene_id: str):
        """TileSamplerConfig of the tiled eval route when the geometry
        qualifies (bilinear or bicubic planes, <= 64 plane channels, a
        ray block of whole tiles), else None. On by default where the
        kernels run (a CUDA device); nerf.validation.tiled_gather
        overrides that either way. Under a mesh, JAX's gate without its
        refusal of the model axis and the device pool: deterministic
        sampling, and a ray block of whole tiles for every data index.
        (JAX sends tensor-parallel and pooled evals to the reference path
        because its mesh-sharded tiled render needs replicated parameters
        and planes; a port rank holds a pooled scene's planes whole once
        they are lent, and its kernels take the decoders gathered once a
        pass: _eval_decoders.)"""
        enabled = self.cfg.get_path("nerf.validation.tiled_gather", None)
        if enabled is None:
            enabled = self.device.type == "cuda"
        if not enabled or not self.planes_model:
            return None
        if (self.model_cfg.plane_interp not in ("bilinear", "bicubic")
                or self.model_cfg.num_plane_channels > HALF):
            return None
        th, tw = self.eval_tile_shape()
        tc = TileSamplerConfig(tile_rays=th * tw)
        rcfg = self._mode_render_cfg("validation", scene_id)
        if rcfg.ray_block % tc.tile_rays:
            return None
        if self.mesh is not None and (
                rcfg.perturb or rcfg.radiance_field_noise_std != 0.0
                or rcfg.ray_block % (self.mesh.data_size * tc.tile_rays)):
            return None
        return tc

    def _view_rays(self, img_idx: int):
        """One eval view's target image and ray maps; its pose goes to
        the device once per view (both renders of an SR view share it)."""
        cached = getattr(self, "_last_view", None)
        if cached is not None and cached[0] == img_idx:
            return cached[1]
        img, pose, h, w, focal, ds_f = self.dataset.item(img_idx)
        ro, rd = get_ray_bundle(
            h, w, focal, torch.as_tensor(pose, device=self.device),
            downsampling_offset=downsampling_offset(ds_f))
        view = (img, ro, rd, (h, w, focal))
        self._last_view = (img_idx, view)
        return view

    def _on_device(self, kind: str, scene_id: str, array):
        """A scene's host array (its box, its occupied box) on the device.
        The copy is kept per scene with the array it was made from, and
        made again once the scene holds another array
        (PlanesBuffer.set_occ_aabb stores a new occupied box), so an
        update reaches the next step and render, and an unchanged array
        costs no copy: a copy from pageable memory makes the host wait
        for the stream."""
        key = (kind, self.scene_coupler.scene2saved.get(scene_id, scene_id))
        cached = self._dev_cache.get(key)
        if cached is None or cached[0] is not array:
            cached = (array, torch.as_tensor(np.asarray(array),
                                             dtype=torch.float32,
                                             device=self.device))
            self._dev_cache[key] = cached
        return cached[1]

    def _occ_aabb_for(self, scene_id, planes):
        """The scene's occupied box on the device, or None without
        occupancy bounds (or planes: the baseline)."""
        if (self.occupancy_cfg is None or planes is None
                or planes.occ_aabb is None):
            return None
        return self._on_device("occ_aabb", scene_id, planes.occ_aabb)

    @torch.no_grad()
    def render_eval_image(self, scene_id: str, img_idx: int,
                          skip_sr: bool = False):
        """Render one full eval view -> (RenderResult, target image)."""
        img, ro, rd, hwf = self._view_rays(img_idx)
        planes = None
        if self.planes_model:
            planes = self.planes_buffer.load_scene(
                scene_id, load_best=not self.planes_buffer.optimize)
        tiled = self.eval_tile_cfg(scene_id) is not None
        scene_type = self.dataset.scene_types.get(
            scene_id.replace("_train", ""), "synt")
        sc_cfg = self.cfg.dataset[scene_type]
        rcfg = self._mode_render_cfg("validation", scene_id)
        if self.is_main and self.planes_model and self.cfg.get_path(
                "models.coarse.plane_stats", False):
            self._update_plane_coverage(scene_id, planes, ro, rd, sc_cfg,
                                        rcfg)
        # "kernel or reference", no ladder: the JAX package escalates an
        # overflowing view from its tiled kernel to compact tiles and then
        # to its XLA path, with a time probe between them, because its TPU
        # kernel clamps a chunk's gather region; the port's kernels gather
        # every tap exactly, so a tiled render never overflows and there
        # is nothing to escalate or to report
        pf_c, pf_f = self._point_fns_for_eval(scene_id, planes,
                                              skip_sr=skip_sr, tiled=tiled)
        # under a mesh, a deterministic render shares its ray blocks over
        # the ranks; one that draws (jitter, density noise) is rendered
        # whole by every rank from the shared generator
        deterministic = (not rcfg.perturb
                         and rcfg.radiance_field_noise_std == 0.0)
        out = render_image(pf_c, pf_f, ro, rd, rcfg, near=sc_cfg["near"],
                           far=sc_cfg["far"], no_ndc=sc_cfg["no_ndc"],
                           hwf=hwf,
                           occ_aabb=self._occ_aabb_for(scene_id, planes),
                           tile=self.eval_tile_shape() if tiled else None,
                           generator=self.render_generator,
                           mesh=self.mesh if deterministic else None)
        return out, img

    # ------------------------------------------------------------------
    # occupancy-guided sampling bounds
    # ------------------------------------------------------------------
    @property
    def occupancy_cfg(self):
        """nerf.train.occupancy {enabled, mode, grid, threshold,
        alpha_eps, weight_eps, margin, margin_steps, sigma_k,
        warmup_iters, update_every} with JAX's defaults, or None when
        occupancy bounds are off. Each trained scene's occupied box is
        estimated while training (mode "surface": from the rendering
        weights' moments; "density": by thresholding the density field on
        a grid) and tightens every ray's [near, far] in training and
        eval."""
        if not hasattr(self, "_occ_cfg"):
            occ = self.cfg.get_path("nerf.train.occupancy", None)
            if not occ or not occ.get("enabled", True):
                self._occ_cfg = None
            else:
                self._occ_cfg = {
                    "mode": occ.get("mode", "surface"),
                    "grid": occ.get("grid", 64),
                    "threshold": occ.get("threshold", "auto"),
                    "alpha_eps": occ.get("alpha_eps", 0.01),
                    "weight_eps": occ.get("weight_eps", 0.01),
                    "margin": occ.get("margin", 1.0),
                    "margin_steps": occ.get("margin_steps", 3.0),
                    "sigma_k": occ.get("sigma_k", 4.0),
                    "warmup_iters": occ.get("warmup_iters", 300),
                    "update_every": occ.get("update_every", 200),
                }
        return self._occ_cfg

    def _sample_step(self, scene_id: str) -> float:
        """(far - near) / samples per ray of the scene's training
        renders: one sampling step."""
        scene_type = self.dataset.scene_types.get(
            scene_id.replace("_train", ""), "synt")
        sc_cfg = self.cfg.dataset[scene_type]
        rcfg = self._mode_render_cfg("train", scene_id)
        return (float(sc_cfg["far"]) - float(sc_cfg["near"])) / max(
            rcfg.num_coarse + rcfg.num_fine, 1)

    def _maybe_update_occupancy(self, scene_id: str, iteration: int):
        occ = self.occupancy_cfg
        if occ is None or not self.planes_model \
                or not self.planes_buffer.optimize:
            return
        if iteration < occ["warmup_iters"]:
            return
        last = self._occ_last_update.get(scene_id)
        if last is not None and iteration - last < occ["update_every"]:
            return
        self._occ_last_update[scene_id] = iteration
        if occ["mode"] == "surface":
            self._commit_surface_aabb(scene_id, occ)
            return
        planes = self.planes_buffer.lend(scene_id)
        pos = materialize_pos_planes(planes.planes_pos, planes.rank)
        box = self._on_device("box", scene_id, planes.box)
        density = make_density_fn(self.decoder_coarse, self.model_cfg, pos,
                                  box, mesh=self._tp)
        thr = occ["threshold"]
        if thr in (None, "auto"):
            # alpha = 1 - exp(-sigma*dt) > alpha_eps  =>  sigma > eps/dt
            # (to first order): the contribution floor of one sample
            thr = float(occ["alpha_eps"]) / max(self._sample_step(scene_id),
                                                1e-6)
        with torch.no_grad():
            aabb = estimate_occupied_box(density, box, grid=occ["grid"],
                                         threshold=thr, margin=occ["margin"])
        self.planes_buffer.set_occ_aabb(scene_id, aabb.cpu().numpy())

    def _commit_surface_aabb(self, scene_id: str, occ: dict):
        """Surface-mode occupancy update from the window's rendering-mass
        moments (surf_w, surf_wx, surf_wx2 of each train_step with
        flags.track_surface_aabb, kept on the device and fetched here in
        one copy): per axis, mean +- sigma_k * std, plus margin_steps
        sampling steps, clipped to the scene box."""
        window = self._occ_window.get(scene_id)
        if not window:
            return
        stats = torch.stack([torch.stack(w) for w in window]).cpu().numpy()
        self._occ_window[scene_id] = []
        sw = stats[:, 0].sum(axis=0)
        swx = stats[:, 1].sum(axis=0)
        swx2 = stats[:, 2].sum(axis=0)
        if not np.all(sw > 1e-3):    # no rendering mass observed yet
            return
        mean = swx / sw
        var = np.maximum(swx2 / sw - mean * mean, 0.0)
        k = float(occ.get("sigma_k", 4.0))
        lo = mean - k * np.sqrt(var)
        hi = mean + k * np.sqrt(var)
        box = np.asarray(self.planes_buffer.get(scene_id).box)
        m = float(occ["margin_steps"]) * self._sample_step(scene_id)
        lo = np.maximum(lo - m, box[0, :3])
        hi = np.minimum(hi + m, box[1, :3])
        self.planes_buffer.set_occ_aabb(
            scene_id, np.stack([lo, hi]).astype(np.float32))

    def _scene_plane_res(self, scene_id: str):
        """The scene's plane resolution, for point_coords_noise (parsed
        from the scene id, else the configured one); None when the noise
        is off."""
        if not self.cfg.get_path("nerf.train.point_coords_noise", 0):
            return None
        res = extract_ds_and_res(scene_id)[1]
        if res is None:
            res = self.scene_id_plane_resolution.get(scene_id, (None,))[0]
        return res

    # ------------------------------------------------------------------
    # training iteration
    # ------------------------------------------------------------------
    def _to_device(self, array):
        """A host array on the Experiment's device. On a card the copy is
        staged in pinned memory and does not block: a copy from pageable
        memory makes the host wait for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def train_iteration(self, iteration: int):
        """One training iteration: draw a view and its pixels, one step
        (train_step, or train_step_baseline for the baseline), the
        planes' Adam step, the gated decoder and SR steps at the end of a
        virtual batch. The metrics are queued on the device. Returns the
        buffer's new scenes when it was redrawn, else None.

        Under a profiler the iteration is a `train_iteration` span (args:
        the iteration and its kind, "lr", "sr" or "consistency") whose
        children follow one another: `input` (the draw, the rays and the
        target to the device; for a planes model a second one after
        `occupancy`: the planes lent, the rays tightened to the occupied
        box; the last one builds the flags and takes this rank's share),
        `occupancy`, the step's `forward` and `backward`,
        `reduce` (under a mesh; arg `bytes`, what its all_reduce moved)
        and `optimizer`."""
        with span("train_iteration", iteration=iteration) as root:
            return self._train_iteration(iteration, root)

    def _train_iteration(self, iteration: int, root):
        vb = self.virtual_batch_size
        if iteration % vb == 0:
            # before the forward: a virtual batch's unstepped sums are freed
            if self.decoder_opt is not None:
                self.decoder_opt.zero()
            if self.sr_opt is not None:
                self.sr_opt.zero()
        with span("input"):
            batch = self._draw_batch(root)
            if not self.planes_model:
                step_in = self._step_inputs(batch)
        if self.planes_model:
            with span("occupancy"):
                self._maybe_update_occupancy(batch.scene_id, iteration)
            # the planes are lent after the occupancy update has read them
            with span("input"):
                step_in = self._step_inputs(batch)
        planes, flags, rays, target, generator = step_in
        if planes is None:
            metrics, grads = train_step_baseline(
                self.decoder_coarse, self.decoder_fine, rays, target,
                generator, mlp_cfg=self.mlp_cfg, rcfg=batch.rcfg,
                flags=flags, enc_cfg=self._enc_for(batch.scene_id))
        else:
            metrics, grads = train_step(
                self.decoder_coarse, self.decoder_fine, self.sr_params,
                planes.params(),
                self._on_device("box", batch.scene_id, planes.box), rays,
                target, generator, model_cfg=self.model_cfg,
                sr_cfg=self.sr_cfg, rcfg=batch.rcfg, flags=flags,
                mesh=self._tp)
        if self.mesh is not None:
            with span("reduce") as sp:
                before = COLLECTIVES["data:all_reduce_bytes"]
                metrics, grads = reduce_step(self.mesh, metrics, grads)
                sp.set(bytes=COLLECTIVES["data:all_reduce_bytes"] - before)
        if flags.track_surface_aabb:
            # device tensors, fetched in one copy at the commit
            self._occ_window.setdefault(batch.scene_id, []).append(
                (metrics.pop("surf_w"), metrics.pop("surf_wx"),
                 metrics.pop("surf_wx2")))
        with span("optimizer"):
            new_drawn = self._optimizer_steps(batch, grads,
                                              iteration % vb == vb - 1)
        self._pending_metrics.append(
            (iteration, batch.consistency_iter, batch.sr_iter,
             torch.stack([metrics[k] for k in self._METRIC_STACK])))
        return new_drawn

    def _draw_batch(self, root) -> _Batch:
        """The iteration's view and pixels, drawn from the image sampler
        and the host generator (pixels, then a planes model's ensemble
        member), with their rays and target on the device; sets the
        root span's `kind`."""
        cfg = self.cfg
        scene_id, img_idx = self.image_sampler.sample()
        sr_iter = scene_id in self.scene_coupler.downsample_couples
        img, pose, h, w, focal, ds_f = self.dataset.item(img_idx)
        consistency_iter = bool(self.im_inconsistency_loss_w) and \
            scene_id in self.dataset.val_only_scene_ids
        root.set(kind="consistency" if consistency_iter
                 else "sr" if sr_iter else "lr")
        coupler_ds = self.scene_coupler.ds_factor
        if consistency_iter:
            # the HR scene's rays, averaged over ds x ds patches, against
            # its LR couple's pixels
            h, w, focal = h * coupler_ds, w * coupler_ds, focal * coupler_ds
            ds_f = ds_f // coupler_ds
        num_rays = cfg.get_path("nerf.train.num_random_rays", 4096)
        tile_cfg = None if consistency_iter \
            else self.train_tile_cfg(scene_id, num_rays)
        if consistency_iter:
            rows, cols, target = choose_patch_pixels(
                self.host_rng, img, num_rays, coupler_ds)
        elif tile_cfg is not None:
            rows, cols, target = choose_tile_pixels(
                self.host_rng, img, num_rays, tile=self.train_tile_shape())
        else:
            rows, cols, target = choose_random_pixels(
                self.host_rng, img, num_rays)
        sc_cfg = cfg.dataset[self.dataset.scene_types.get(scene_id, "synt")]
        focal_arg = (tuple(float(f) for f in focal)
                     if isinstance(focal, (tuple, list, np.ndarray))
                     else float(focal))
        rays = build_sampled_rays(
            self._to_device(np.asarray(pose, dtype=np.float32)),
            self._to_device(rows), self._to_device(cols), float(h),
            float(w), focal_arg, downsampling_offset(ds_f),
            float(sc_cfg["near"]), float(sc_cfg["far"]),
            use_viewdirs=cfg.nerf.get("use_viewdirs", True),
            no_ndc=bool(sc_cfg["no_ndc"]))
        member = int(self.host_rng.integers(self.model_cfg.ensemble_size)) \
            if self.planes_model else 0
        return _Batch(
            scene_id, sr_iter, consistency_iter, rays,
            self._to_device(np.asarray(target, dtype=np.float32)),
            self._mode_render_cfg("train", scene_id), tile_cfg, member)

    def _step_inputs(self, batch: _Batch):
        """(lent planes or None, flags, this rank's rays, target and
        generator); a planes model's rays tightened to its occupied box."""
        rays, planes = batch.rays, None
        if self.planes_model:
            planes = self.planes_buffer.lend(batch.scene_id)
            occ_aabb = self._occ_aabb_for(batch.scene_id, planes)
            if occ_aabb is not None:
                rays = tighten_bundle(
                    rays, occ_aabb, tile_rays=None if batch.tile_cfg is None
                    else batch.tile_cfg.tile_rays)
        flags = self._step_flags(batch, planes)
        rays, target, generator = self._shard_batch(rays, batch.target,
                                                    self.render_generator)
        return planes, flags, rays, target, generator

    def _step_flags(self, batch: _Batch, planes) -> StepFlags:
        """The step's switches: a consistency iteration's loss weight and
        patch size and share_coarse_fine for either kind; for a planes
        model (`planes` lent) also the SR, loss, trained-group and
        occupancy switches."""
        kw = {}
        if planes is not None:
            cfg = self.cfg
            sr_loss = cfg.get_path("super_resolution.training.loss", "fine") \
                if self.sr_experiment else "both"
            trains_lr = any(m in self.what2train
                            for m in ("decoder", "LR_planes"))
            occ = self.occupancy_cfg
            kw = dict(
                sr_iter=batch.sr_iter and self.sr_params is not None,
                detach_lr_planes=cfg.get_path("nerf.train.detach_LR_planes",
                                              False),
                apply_sr_to_coarse=self.apply_sr_to_coarse,
                compute_coarse_loss=trains_lr or sr_loss != "fine",
                compute_fine_loss=trains_lr or sr_loss != "coarse",
                rendering_loss_w=self.rendering_loss_w,
                member=batch.member,
                plane_rank=planes.rank,
                plane_resolution=self._scene_plane_res(batch.scene_id),
                train_planes=self.planes_buffer.optimize,
                train_decoder=self.decoder_opt is not None,
                train_sr=self.sr_opt is not None,
                track_surface_aabb=(occ is not None
                                    and occ["mode"] == "surface"
                                    and self.planes_buffer.optimize),
                surf_weight_eps=float((occ or {}).get("weight_eps", 0.01)),
                tile_cfg=batch.tile_cfg)
        return StepFlags(
            consistency_iter=batch.consistency_iter,
            im_inconsistency_loss_w=self.im_inconsistency_loss_w or 0.0,
            ds_factor=self.scene_coupler.ds_factor,
            share_coarse_fine=self.share_coarse_fine,
            **kw)

    def _optimizer_steps(self, batch: _Batch, grads: dict,
                         last_vb: bool):
        """The planes' Adam step, the decoder and SR gradients into their
        virtual batches, and at a virtual batch's end the gated decoder
        and SR steps. Returns the buffer's new scenes when it was
        redrawn, else None."""
        if "planes" in grads:
            self.planes_buffer.apply_grads(batch.scene_id, grads["planes"])
        confinements = self.dataset.module_confinements.get(batch.scene_id,
                                                            [])
        if self.decoder_opt is not None:
            self.decoder_opt.accumulate(
                {k: grads[k] for k in ("dc", "df")
                 if k in grads and k in self.decoder_opt.params})
        if self.sr_opt is not None and "sr" in grads:
            self.sr_opt.accumulate(grads["sr"])
        new_drawn = self.planes_buffer.step_cadence() \
            if self.planes_model else None
        if last_vb:
            if self.decoder_opt is not None:
                decoder_step = "decoder" not in confinements
                if "SR" in self.what2train and self.cfg.get_path(
                        "nerf.train.separate_decoder_sr", False):
                    decoder_step &= not batch.sr_iter
                if decoder_step and (self.decoder_training
                                     or not self.planes_model):
                    self.decoder_opt.step()
                else:
                    self.decoder_opt.zero()
            if (self.sr_opt is not None and batch.sr_iter
                    and "SR" not in confinements):
                self.sr_opt.step()
        return new_drawn

    def _shard_batch(self, rays, target, generator):
        """This rank's rows of the global batch (JAX's sharded batch; the
        rows of its data index):
        the rays and the target split contiguously, and a generator that
        draws the global batch's numbers and keeps the rank's rows. On a
        consistency iteration each target pixel owns its ds^2
        consecutive rays, so whole patches go to a rank. As given without
        a mesh."""
        if self.mesh is None:
            return rays, target, generator
        lo, hi = data_sharding(self.mesh, target.shape[0])
        n = rays.origins.shape[0]
        per = n // target.shape[0]
        assert n == per * target.shape[0], (n, target.shape)
        return (shard_rays(self.mesh, rays), target[lo:hi],
                RowShard(generator, lo * per, hi * per, n))

    _METRIC_STACK = ("loss", "coarse_loss", "fine_loss", "psnr",
                     "fine_psnr")

    def flush_train_metrics(self):
        """Fetch the queued training metrics in one device-to-host copy
        and write them to the logger; returns (losses, psnrs) of the
        flushed iterations that were not consistency iterations."""
        if not self._pending_metrics:
            return [], []
        with span("flush_metrics"):
            vals = torch.stack([m for (_, _, _, m) in self._pending_metrics]
                               ).cpu().numpy()
        losses, psnrs = [], []
        for (it, cons, sr_iter, _), row in zip(self._pending_metrics, vals):
            loss_val = float(row[0])
            if cons:
                self.logger.write_scalar("train/im_inconsistency", loss_val,
                                         it)
                continue
            self.logger.write_scalar("train/loss", loss_val, it)
            self.logger.write_scalar(
                "train/loss_%s" % ("sr" if sr_iter else "lr"), loss_val, it)
            self.logger.write_scalar("train/psnr", float(row[3]), it)
            self.logger.write_scalar("train/coarse_loss", float(row[1]), it)
            self.logger.write_scalar("train/fine_loss", float(row[2]), it)
            self.logger.write_scalar("train/fine_psnr", float(row[4]), it)
            losses.append(loss_val)
            psnrs.append(float(row[3]))
        self._pending_metrics = []
        return losses, psnrs

    def _update_plane_coverage(self, scene_id, planes, ro, rd, sc_cfg,
                               rcfg):
        """models.coarse.plane_stats: accumulate which plane texels an
        eval view's coarse samples (every 64th ray) touch, and write the
        histograms as PNGs under <logdir>/coverage."""
        if self._plane_coverage is None:
            names = [get_plane_name(s, d)
                     for s in self.scene_coupler.scene2saved.values()
                     for d in range(self.model_cfg.num_planes)]
            self._plane_coverage = PlaneCoverage(sorted(set(names)))
        ro = ro.reshape(-1, 3)[::64].cpu().numpy()
        rd = rd.reshape(-1, 3)[::64].cpu().numpy()
        z = np.linspace(sc_cfg["near"], sc_cfg["far"], rcfg.num_coarse)
        pts = ro[:, None, :] + rd[:, None, :] * z[None, :, None]
        xyz = normalize_coords(
            torch.as_tensor(pts.reshape(-1, 3), dtype=torch.float32),
            torch.as_tensor(np.asarray(planes.box)[:, :3]))
        grids = project_to_planes(xyz, self.rot_mats).numpy()
        saved = self.scene_coupler.scene2saved.get(scene_id, scene_id)
        for d in range(grids.shape[0]):
            self._plane_coverage.update(get_plane_name(saved, d), grids[d])
        self._plane_coverage.save(os.path.join(self.logdir, "coverage"))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, iteration: int = 0):
        """Render every eval view (eval mode) or one view per sequence
        and write the metrics and images; returns {group: losses}.
        Metrics are computed on the host from the renders' rgb, one
        device-to-host copy per render."""
        self._eval_pf_cache = {}
        eval_mode = self.eval_mode
        if eval_mode:
            img_groups = [list(v) for v in self.i_val.values()]
        else:
            vi = self.experiment_info["eval_counter"] \
                % self.val_ims_per_scene
            img_groups = [[v[vi] for v in self.i_val.values()]]

        def host(out):
            fine = out.fine if out.fine is not None else out.coarse
            return fine.rgb.cpu().numpy(), out.coarse.rgb.cpu().numpy()

        def mse(a, b):
            return float(img2mse(torch.from_numpy(a), torch.from_numpy(b)))

        def psnr(loss):
            return float(mse2psnr(torch.tensor(loss, dtype=torch.float32)))

        all_losses = {}
        for cycle, img_indices in enumerate(img_groups):
            per = defaultdict(lambda: defaultdict(list))
            for eval_num, img_idx in enumerate(img_indices):
                scene_num = cycle if eval_mode else eval_num
                scene_id = self.dataset.per_im_scene_id[img_idx]
                group = self.val_strings[scene_num]
                sr_scene = bool((not self.planes_model
                                 or self.sr_experiment) and scene_id
                                in self.scene_coupler.downsample_couples)
                out, img_target = self.render_eval_image(scene_id, img_idx)
                rgb_fine, rgb_coarse = host(out)
                target = np.asarray(img_target, np.float32)[..., :3]
                loss = mse(rgb_fine, target)
                per[group]["loss"].append(loss)
                per[group]["psnr"].append(psnr(loss))
                per[group]["ssim"].append(float(ssim(
                    torch.from_numpy(rgb_fine), torch.from_numpy(target))))
                per[group]["target"].append(target)
                per[group]["sr_scene"].append(sr_scene)
                if sr_scene:
                    if self.im_inconsistency_loss_w is not None:
                        inc = float(image_inconsistency_loss(
                            torch.from_numpy(rgb_fine.transpose(2, 0, 1)
                                             [None].copy()),
                            self.scene_coupler.ds_factor,
                            gt_hr=torch.from_numpy(
                                target.transpose(2, 0, 1)[None].copy())))
                        per[group]["im_inconsistency"].append(inc)
                    per[group]["rgb_SR"].append(rgb_fine)
                    if self.planes_model and self.sr_params is not None:
                        # the render without SR, for the SR-gain metric
                        out_ref, _ = self.render_eval_image(
                            scene_id, img_idx, skip_sr=True)
                        rgb_fine, rgb_coarse = host(out_ref)
                    per[group]["fine_loss"].append(mse(rgb_fine, target))
                else:
                    per[group]["rgb_SR"].append(None)
                    per[group]["coarse_loss"].append(mse(rgb_coarse, target))
                    per[group]["fine_loss"].append(loss)
                per[group]["rgb_fine"].append(rgb_fine)
                per[group]["rgb_coarse"].append(rgb_coarse)

            groups = [self.val_strings[cycle]] if eval_mode \
                else set(self.val_strings)
            for group in groups:
                g = per[group]
                if not g["loss"]:
                    continue
                write_index = cycle if eval_mode else iteration
                if sum(g["sr_scene"]) > 0 and any(
                        v is not None for v in g["rgb_SR"]):
                    gains = [g["psnr"][i] - psnr(l)
                             for i, l in enumerate(g["fine_loss"])
                             if g["sr_scene"][i]]
                    self.logger.write_scalar(
                        f"{group}/SR_psnr_gain",
                        gains if eval_mode else float(np.nanmean(gains)),
                        write_index)
                    self.logger.write_images(
                        f"{group}/rgb_SR",
                        [im for im in g["rgb_SR"] if im is not None],
                        str(write_index), write_index,
                        psnrs=(gains if eval_mode else g["psnr"]))
                if g.get("im_inconsistency"):
                    self.logger.write_scalar(
                        f"{group}/im_inconsistency",
                        float(np.nanmean(g["im_inconsistency"])),
                        write_index)
                self.logger.write_scalar(
                    f"{group}/fine_psnr",
                    float(np.nanmean([psnr(l) for l in g["fine_loss"]])),
                    write_index)
                self.logger.write_scalar(f"{group}/loss",
                                         float(np.nanmean(g["loss"])),
                                         write_index)
                self.logger.write_scalar(f"{group}/psnr",
                                         float(np.nanmean(g["psnr"])),
                                         write_index)
                if g.get("ssim"):
                    self.logger.write_scalar(f"{group}/ssim",
                                             float(np.nanmean(g["ssim"])),
                                             write_index)
                if g.get("coarse_loss"):
                    self.logger.write_scalar(
                        f"{group}/coarse_loss",
                        float(np.nanmean(g["coarse_loss"])), write_index)
                self.logger.write_scalar(f"{group}/fine_loss",
                                         float(np.nanmean(g["fine_loss"])),
                                         write_index)
                if (eval_mode and self.evaluation_sequences[cycle]
                        in self.scene_coupler.downsample_couples.values()):
                    from nvsr_tpu_torch.data.imresize import bicubic_interp
                    sf = self.scene_coupler.ds_factor
                    self.logger.write_images(
                        f"{group}/rgb_bicubic",
                        [bicubic_interp(im, sf) for im in g["rgb_fine"]],
                        str(write_index), write_index)
                    self.logger.write_images(
                        f"{group}/rgb_LR",
                        [np.repeat(np.repeat(im, sf, 0), sf, 1)
                         for im in g["rgb_fine"]],
                        str(write_index), write_index)
                self.logger.write_images(
                    f"{group}/rgb_fine", g["rgb_fine"], str(write_index),
                    write_index,
                    psnrs=[psnr(l) for l in g["fine_loss"]],
                    white_bg=self.cfg.get_path(
                        "nerf.validation.white_background", False))
                if not eval_mode and iteration not in \
                        self.saved_target_ims[group]:
                    self.logger.write_images(f"{group}/img_target",
                                             g["target"], str(write_index),
                                             write_index)
                    self.saved_target_ims[group].add(iteration)
                all_losses[group] = g["loss"]
        # the pass's point fns (and under the device pool the planes they
        # hold) go with it
        self._eval_pf_cache = None
        return all_losses

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def _update_active_scenes(self):
        """The image sampler draws from the buffer's resident scenes, or
        from every training scene for the baseline (no planes)."""
        self.image_sampler.update_active(
            self.planes_buffer.cur_scenes if self.planes_model
            else self.training_scenes)

    def run(self, max_iters: int = None):
        """Eval mode: draw the scenes and evaluate every view. Otherwise
        train from experiment_info["start_i"] to max_iters (default
        experiment.train_iters), as the JAX package's loop does. Under a
        mesh, when to evaluate, save and stop, and a preemption, are
        rank 0's decisions (the time-based cadences differ by rank),
        broadcast with the iteration's save decision, so no rank leaves
        a collective that another waits in."""
        cfg = self.cfg
        if self.planes_model:
            # set-up's planes load (a pretrained run's from planes_path)
            with span("load_pretrained") as sp:
                store = self.store
                files, nbytes = store.files_read, store.bytes_read
                self.planes_buffer.draw_scenes()
                sp.set(files=store.files_read - files,
                       bytes=store.bytes_read - nbytes)
        if self.eval_mode:
            with span("evaluate"):
                self.evaluate()
            return
        self._update_active_scenes()

        train_iters = max_iters if max_iters is not None \
            else cfg.experiment["train_iters"]
        validate_every = cfg.experiment.get("validate_every", [0.1, 5000])
        save_every = cfg.experiment.get("save_every", 10.0)
        print_every = cfg.experiment.get("print_every", 100)
        no_improvement_iters = cfg.experiment.get("no_improvement_iters",
                                                  None)

        training_time, evaluation_time = 0.0, 0.0
        last_evaluated = self.experiment_info["start_i"]
        recently_saved = time.time()
        print_loss, print_psnr = [], []
        # the device runs behind the host: time is accounted per flush
        # window, which flush_train_metrics ends with its one copy
        window_t0 = time.time()
        window_iters = 0

        def flush_window():
            nonlocal window_t0, window_iters, training_time
            fl, fp = self.flush_train_metrics()
            print_loss.extend(fl)
            print_psnr.extend(fp)
            elapsed = time.time() - window_t0
            training_time += elapsed
            if window_iters:
                rays = cfg.get_path("nerf.train.num_random_rays", 4096)
                self.logger.write_scalar(
                    "train/rays_per_sec",
                    rays * window_iters / max(elapsed, 1e-9), iteration)
            window_t0 = time.time()
            window_iters = 0

        def evaluate_at(iteration):
            if isinstance(validate_every, list):
                now = (evaluation_time <= training_time * validate_every[0]
                       or iteration - last_evaluated >= validate_every[1])
            else:
                now = iteration % validate_every == 0
            return now or iteration == train_iters - 1

        start = self.experiment_info["start_i"]
        evaluate_now, = agree(self.mesh, evaluate_at(start))
        for iteration in range(start, train_iters):
            if evaluate_now:
                flush_window()
                last_evaluated = iteration
                t0 = time.time()
                with span("evaluate", iteration=iteration):
                    self.evaluate(iteration)
                evaluation_time = time.time() - t0
                if self.planes_model:
                    self.planes_buffer.draw_scenes()
                self._update_active_scenes()
                training_time = 0.0
                self.experiment_info["eval_counter"] += 1
                window_t0 = time.time()

            new_drawn = self.train_iteration(iteration)
            window_iters += 1
            if new_drawn is not None:
                self.image_sampler.update_active(new_drawn)

            if iteration % print_every == 0 or iteration == train_iters - 1:
                flush_window()
                if self.is_main:
                    print("[TRAIN] Iter: %d Loss: %s PSNR: %s"
                          % (iteration,
                             np.mean(print_loss) if print_loss else "n/a",
                             np.mean(print_psnr) if print_psnr else "n/a"))
                if (self.planes_lr_scheduler is not None and print_loss
                        and self.planes_model):
                    self.planes_buffer.set_lr(
                        self.planes_lr_scheduler.step(
                            float(np.mean(print_loss))))
                print_loss, print_psnr = [], []

            save_now = (self.scenes_cycle_counter.check_and_reset()
                        if (self.planes_model and self.decoder_training)
                        else False)
            if isinstance(save_every, int):
                save_now |= iteration % save_every == 0
            else:
                save_now |= (time.time() - recently_saved) / 60 > save_every
            save_now |= iteration == train_iters - 1
            # the next iteration's evaluate reads nothing the save changes
            save_now, evaluate_now = agree(self.mesh, save_now,
                                           evaluate_at(iteration + 1))

            if save_now:
                save_as_best, quit_training = False, False
                grp0 = self.loss_groups4_best[0] \
                    if self.loss_groups4_best else None
                if grp0 and self.running.full(self.loss4best, grp0):
                    recent = float(np.mean(
                        [v for g in self.loss_groups4_best
                         for v in self.running.scores[self.loss4best][g]]))
                    if recent < self.experiment_info["best_loss"][1]:
                        self.experiment_info["best_loss"] = (iteration,
                                                             recent)
                        save_as_best = True
                    elif no_improvement_iters is not None:
                        if (iteration - self.experiment_info["best_loss"][0]
                                >= len(self.training_scenes)
                                * no_improvement_iters):
                            quit_training = True
                preempted = False
                if self.mesh is not None:
                    if self.is_main:
                        try:
                            check_run_signature(self.logdir,
                                                self.run_time_signature)
                        except PreemptedError:
                            preempted = True
                    save_as_best, quit_training, preempted = agree(
                        self.mesh, save_as_best, quit_training, preempted)
                    if preempted:
                        raise PreemptedError(
                            "Exiting run %f since a newer run has started."
                            % self.run_time_signature)
                recently_saved = time.time()
                with span("save", iteration=iteration):
                    if self.planes_model and self.planes_buffer.optimize:
                        self.planes_buffer.save_params()
                        if save_as_best:
                            self.planes_buffer.save_params(as_best=True)
                    self.experiment_info["start_i"] = iteration + 1
                    self.save_checkpoints(iteration, as_best=save_as_best)
                if quit_training:
                    print("Done training: no improvement for %d iters"
                          % (iteration
                             - self.experiment_info["best_loss"][0]))
                    break
        self.flush_train_metrics()
        print("Done!")
