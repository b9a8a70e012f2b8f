"""The Experiment's eval half: nvsr_tpu_torch.experiment (with its store,
CLI and the small functions it needs) against nvsr_tpu.experiment, on a
logdir that the JAX package trains.

The fixture writes the synthetic corpus of tests/helpers_synth.py at
size 32 and trains a mini stage 1 (tests/test_experiment.py's _mini_cfg,
4 iterations) with JAX's Experiment; both packages then evaluate that
logdir in eval mode. Tolerances, each with its reason:
* the untiled eval (f32 reference paths on both sides, on the CPU): the
  same function, summed in another order: every view's fine rgb within
  1e-4 (measured 1.8e-7), PSNR, fine PSNR and SR gain within 0.01 dB
  (measured 1e-6, the 6 decimals metrics.txt prints), SSIM within 1e-4
  (measured 1e-5), the losses within 1e-6 (measured equal as printed);
* the port's tiled route (bf16 taps and bf16 decoder, the kernels' plain
  versions on the CPU) against JAX's f32 eval: every view's PSNR within
  0.05 dB (PERF.md section 2's quality limit; measured 9.5e-5 dB);
* the small counterparts: f32 order only, atol 1e-6 (measured <= 6.6e-7,
  SSIM), and equal where no arithmetic is involved;
* the plane store: bit-equal both ways, planes and Adam state.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers_synth import make_camera, write_blender_scene
from nvsr_tpu import planes_store as jps
from nvsr_tpu import render as jrender
from nvsr_tpu.experiment import Experiment as JExperiment
from nvsr_tpu.models import plane_sr as jsr
from nvsr_tpu.ops import geometry as jgeo
from nvsr_tpu.ops import rendering as jrendering
from nvsr_tpu.ops import resize as jresize
from nvsr_tpu.utils import native_store as jnative
from nvsr_tpu.utils.config import get_config as jget_config
from nvsr_tpu_torch import planes_store as tps
from nvsr_tpu_torch import render as trender
from nvsr_tpu_torch.experiment import Experiment as TExperiment
from nvsr_tpu_torch.models import plane_sr as tsr
from nvsr_tpu_torch.ops import geometry as tgeo
from nvsr_tpu_torch.ops import rendering as trendering
from nvsr_tpu_torch.ops import resize as tresize
from nvsr_tpu_torch.utils import io as tio
from nvsr_tpu_torch.utils.config import get_config as tget_config
from test_experiment import _mini_cfg
from torch_port_helpers import jax_native_ready

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = {"4,8,8": ["lego"], "2,16,8": ["lego"]}
# the HR scene (an SR scene: two renders a view) and its LR couple
VAL = {"2,16,8": ["lego"], "4,8,8": ["lego"]}


def _eval_cfg(root, tiled=None):
    cfg = _mini_cfg(root, logdir="logs/stage1", train_groups=TRAIN,
                    val_groups=VAL, iters=4)
    # as configs/TrainModels.yml: 0 turns the consistency iterations off,
    # and eval still reports the metric for SR views
    cfg.nerf.train["im_inconsistency_loss_w"] = 0
    if tiled is not None:
        cfg.nerf.validation["tiled_gather"] = tiled
    return cfg


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_experiment")
    write_blender_scene(str(root / "synt"), "lego", size=32)
    JExperiment(_mini_cfg(root, logdir="logs/stage1", train_groups=TRAIN,
                          iters=4), root_path=str(root)).run()
    return root


@pytest.fixture(scope="module")
def evals(logdir):
    """JAX's and the port's eval-mode Experiments on the logdir, run."""
    je = JExperiment(_eval_cfg(logdir), eval_mode="images",
                     results_path="res_jax", root_path=str(logdir))
    je.run()
    te = TExperiment(_eval_cfg(logdir), eval_mode="images",
                     results_path="res_port", root_path=str(logdir),
                     device="cpu")
    te.run()
    return je, te


def _metrics(path):
    out = {}
    with open(path) as f:
        for line in f:
            name, value = line.rsplit(":", 1)
            out[name] = float(value)
    return out


def _views(exp):
    """(sequence, image index, skip_sr) of every render an eval makes:
    two per view of an SR scene, one otherwise."""
    return [(seq, i, skip) for seq, idx in exp.i_val.items() for i in idx
            for skip in ((False, True)
                         if seq in exp.scene_coupler.downsample_couples
                         else (False,))]


@pytest.fixture(scope="module")
def jax_renders(evals):
    """JAX's fine rgb and target of every render of the eval."""
    je, _ = evals
    out = {}
    for seq, i, skip in _views(je):
        res, tgt = je.render_eval_image(seq, i, skip_sr=skip)
        out[seq, i, skip] = (np.asarray(res.fine.rgb),
                             np.asarray(tgt)[..., :3])
    return out


def test_eval_bookkeeping_matches_jax(evals):
    je, te = evals
    assert te.evaluation_sequences == je.evaluation_sequences
    assert te.val_strings == je.val_strings
    assert {k: list(v) for k, v in te.i_val.items()} == \
        {k: list(v) for k, v in je.i_val.items()}
    assert te.scene_coupler.scene2saved == je.scene_coupler.scene2saved
    assert te.sr_checkpoint_source.endswith("SR_checkpoint.ckpt_best")


def test_eval_metrics_match_jax(evals, logdir):
    """metrics.txt: the same keys (those JAX writes for an SR group and
    for its LR couple), PSNRs within 0.01 dB, SSIM within 1e-4."""
    je, _ = evals
    for seq in je.evaluation_sequences:
        mj = _metrics(logdir / "res_jax" / "stage1" / seq / "metrics.txt")
        mt = _metrics(logdir / "res_port" / "stage1" / seq / "metrics.txt")
        assert list(mt) == list(mj), seq
        for name, vj in mj.items():
            kind = name.split("/")[1]
            tol = {"psnr": 0.01, "fine_psnr": 0.01, "SR_psnr_gain": 0.01,
                   "ssim": 1e-4}.get(kind, 1e-6)
            if np.isnan(vj):
                assert np.isnan(mt[name]), name
            else:
                assert abs(mt[name] - vj) <= tol, (name, mt[name], vj)
    sr_keys = {n.split("/")[1] for n in _metrics(
        logdir / "res_port" / "stage1" / je.evaluation_sequences[0]
        / "metrics.txt")}
    assert sr_keys == {"SR_psnr_gain", "im_inconsistency", "fine_psnr",
                       "loss", "psnr", "ssim", "fine_loss"}
    pngs = [f for _, _, fs in os.walk(logdir / "res_port") for f in fs
            if f.endswith(".png")]
    assert len(pngs) == len([f for _, _, fs in os.walk(logdir / "res_jax")
                             for f in fs if f.endswith(".png")]) > 0


def test_eval_views_match_jax(evals, jax_renders):
    """Every render's fine rgb (an SR view with and without the plane
    SR) within 1e-4 of JAX's (both f32 reference paths)."""
    _, te = evals
    for (seq, i, skip), (a, _) in jax_renders.items():
        ot, _ = te.render_eval_image(seq, i, skip_sr=skip)
        assert a.std() > 1e-3      # the scene is not empty
        np.testing.assert_allclose(ot.fine.rgb.numpy(), a, rtol=0,
                                   atol=1e-4)


def test_tiled_route_within_quality_limit(logdir, jax_renders):
    """The port's tiled eval (nerf.validation.tiled_gather: true, the
    kernels' plain versions on the CPU) within 0.05 dB of JAX's f32 eval
    PSNR on every view."""
    tt = TExperiment(_eval_cfg(logdir, tiled=True), eval_mode="images",
                     results_path="res_tiled", root_path=str(logdir),
                     device="cpu")
    tt.planes_buffer.draw_scenes()
    for (seq, i, skip), (a, tgt) in jax_renders.items():
        if skip:
            continue
        assert tt.eval_tile_cfg(seq) is not None
        pf_c, _ = tt._point_fns_for_eval(seq, tt.planes_buffer.get(seq))
        assert pf_c.tile_rays == 256
        ot, _ = tt.render_eval_image(seq, i)
        p_j = float(jrendering.mse2psnr(jnp.mean((a - tgt) ** 2)))
        p_t = float(trendering.mse2psnr(torch.mean(
            (ot.fine.rgb - torch.from_numpy(tgt)) ** 2)))
        assert abs(p_t - p_j) <= 0.05, (seq, i, p_t, p_j)


def test_plane_sr_runs_once_per_scene(logdir, monkeypatch):
    """evaluate(): both renders of every view of an SR scene reuse one
    plane SR."""
    from nvsr_tpu_torch import experiment as texp
    calls = []
    real = texp.apply_plane_sr
    monkeypatch.setattr(texp, "apply_plane_sr",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    te = TExperiment(_eval_cfg(logdir), eval_mode="images",
                     results_path="res_once", root_path=str(logdir),
                     device="cpu")
    te.run()
    sr_scenes = [s for s in te.evaluation_sequences
                 if s in te.scene_coupler.downsample_couples]
    assert len(sr_scenes) == 1 and len(te.i_val[sr_scenes[0]]) == 2
    assert len(calls) == 1


_NO_JAX = """
import importlib.abc, runpy, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "nvsr_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["nvsr_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("nvsr_tpu_torch.cli", run_name="__main__")
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "nvsr_tpu")))
"""


def test_cli_evaluates_a_jax_logdir_without_jax(logdir):
    """python -m nvsr_tpu_torch.cli --eval images --device cpu on the
    JAX-trained logdir, in a process that refuses to import jax, jaxlib,
    optax and nvsr_tpu: the checkpoints (which pickle optax states) and
    planes load, and metrics.txt is written."""
    cfg = _eval_cfg(logdir)
    cfg_path = logdir / "eval_cli.yml"
    cfg_path.write_text(cfg.dump())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "--config", str(cfg_path),
         "--eval", "images", "--device", "cpu", "--results_path", "res_cli"],
        cwd=str(logdir), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    for seq in ("lego_DS2_PlRes16_8", "lego_DS4_PlRes8_8"):
        assert os.path.isfile(logdir / "res_cli" / "stage1" / seq
                              / "metrics.txt")


def test_load_pickle_maps_optax_and_refuses_jax(tmp_path):
    """A checkpoint's pickled optax.adam state loads into stand-ins with
    the same fields and leaves; any other global of the JAX stack is
    refused."""
    import io
    import pickle
    adam = jax.tree.map(np.asarray, optax.adam(1e-3).init(
        {"w": jnp.ones(2), "b": jnp.zeros(3)}))
    p = str(tmp_path / "a.ckpt")
    with open(p, "wb") as f:
        pickle.dump({"optimizer": adam}, f)
    got = tio.load_pickle(p, suffix="ckpt")["optimizer"]
    assert [type(x).__name__ for x in got] == ["ScaleByAdamState",
                                               "EmptyState"]
    assert got[0]._fields == adam[0]._fields
    for a, b in zip(jax.tree.leaves(adam), jax.tree.leaves(
            jax.tree.map(np.asarray, tuple(got)))):
        np.testing.assert_array_equal(a, b)
    planes_state = optax.inject_hyperparams(optax.adam)(
        learning_rate=1e-3).init({"w": jnp.ones(3)})
    for bad in (jnp.zeros(2), jax.tree.map(np.asarray, planes_state)):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            tio.PortUnpickler(io.BytesIO(pickle.dumps({"x": bad}))).load()


# --- the small counterparts ------------------------------------------------

def _case_ssim(rng):
    a = rng.random((24, 20, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1
                ).astype(np.float32)
    return (float(trendering.ssim(torch.from_numpy(a), torch.from_numpy(b))),
            float(jrendering.ssim(jnp.asarray(a), jnp.asarray(b))))


def _case_calc_scene_box(rng):
    poses = np.stack([make_camera(4.0 * np.array([np.cos(t), np.sin(t),
                                                  0.5]))[:3, :4]
                      for t in rng.uniform(0, 2 * np.pi, 4)])
    outs = []
    for kw in (dict(including_dirs=True, no_ndc=True),
               dict(including_dirs=False, no_ndc=False),
               dict(including_dirs=True, no_ndc=True, adjust_az_range=True,
                    adjust_elevation_range=1.2)):
        geom = {"camera_poses": poses, "near": 2.0, "far": 6.0,
                "H": [20] * 4, "W": [24] * 4, "f": [30.0] * 4}
        outs.append((tgeo.calc_scene_box(geom, **kw),
                     jgeo.calc_scene_box(geom, **kw)))
    return [o[0] for o in outs], [o[1] for o in outs]


def _case_downsample_plane(rng):
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    got, ref = [], []
    for ds, mode, aa, ac in ((2, "bilinear", True, True),
                             (4, "bicubic", True, False),
                             (2, "bicubic", False, True)):
        got.append(tresize.downsample_plane(torch.from_numpy(x), ds,
                                            mode=mode, align_corners=ac,
                                            antialias=aa).numpy())
        ref.append(np.asarray(jresize.downsample_plane(
            jnp.asarray(x), ds, mode=mode, align_corners=ac, antialias=aa)))
    return got, ref


def _case_image_inconsistency_loss(rng):
    sr = rng.random((1, 3, 16, 16), dtype=np.float32)
    hr = rng.random((1, 3, 16, 16), dtype=np.float32)
    lr = rng.random((1, 3, 4, 4), dtype=np.float32)
    t = torch.from_numpy
    return ([float(tresize.image_inconsistency_loss(t(sr), 2, gt_hr=t(hr))),
             float(tresize.image_inconsistency_loss(t(sr), 4, gt_lr=t(lr)))],
            [float(jresize.image_inconsistency_loss(jnp.asarray(sr), 2,
                                                    gt_hr=jnp.asarray(hr))),
             float(jresize.image_inconsistency_loss(jnp.asarray(sr), 4,
                                                    gt_lr=jnp.asarray(lr)))])


def _case_render_config_from_cfg(rng):
    path = os.path.join(REPO, "configs", "TrainModels.yml")
    tc, jc = tget_config(path), jget_config(path)
    got = [dataclasses.asdict(trender.RenderConfig.from_cfg(
        tc.nerf[m], tc.nerf, stop_coarse_grad=m == "train"))
        for m in ("train", "validation")]
    ref = [dataclasses.asdict(jrender.RenderConfig.from_cfg(
        jc.nerf[m], jc.nerf, stop_coarse_grad=m == "train"))
        for m in ("train", "validation")]
    assert got[1]["ray_block"] == 8192
    # the baseline's mip form (configs/MipNeRF_baseline.yml)
    mip = {"encode_position_fn": "mip"}
    got.append(dataclasses.asdict(trender.RenderConfig.from_cfg(
        tc.nerf["validation"], mip)))
    ref.append(dataclasses.asdict(jrender.RenderConfig.from_cfg(
        jc.nerf["validation"], mip)))
    assert got[2]["mip"] is True
    return got, ref


def _case_pixel_grid(rng):
    got = [t.numpy() for t in tgeo.pixel_grid(5, 7, 0.25, padding_size=2)]
    ref = [np.asarray(a) for a in jgeo.pixel_grid(5, 7, 0.25,
                                                  padding_size=2)]
    return got, ref


def _case_sr_scale_factor(rng):
    cases = (("linear", 4), ("sqrt", 4), (2, 8), ("linear", 2))
    return ([tsr.sr_scale_factor(*c) for c in cases],
            [jsr.sr_scale_factor(*c) for c in cases])


@pytest.mark.parametrize("case", [
    "ssim", "calc_scene_box", "downsample_plane", "image_inconsistency_loss",
    "render_config_from_cfg", "sr_scale_factor", "pixel_grid"])
def test_small_counterparts_match_jax(rng, case):
    got, ref = globals()["_case_" + case](rng)

    def close(g, r):
        if isinstance(r, (list, tuple)):
            assert len(g) == len(r)
            for a, b in zip(g, r):
                close(a, b)
        elif isinstance(r, dict):
            assert g == r
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(r, np.float64),
                                       rtol=0, atol=1e-6)

    close(got, ref)


# --- the plane store ---------------------------------------------------------

def _jax_scene(rng):
    pos = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    view = rng.standard_normal((4, 5, 5)).astype(np.float32)
    box = rng.standard_normal((2, 5)).astype(np.float32)
    occ = rng.standard_normal((2, 3)).astype(np.float32)
    planes = jps.ScenePlanes(jnp.asarray(pos), jnp.asarray(view), box,
                             occ_aabb=occ)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2, eps=1e-8)
    state = opt.init(planes.params())
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), planes.params())
    _, state = opt.update(grads, state, planes.params())
    return planes, state


@pytest.mark.parametrize("backend", ["native", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plane_store_bit_equal_both_ways(tmp_path, rng, backend, writer):
    """Planes, box, occupied box and the planes' Adam state (keys opt_i in
    JAX's flatten order) written by one package load bit-equal in the
    other, through either backend."""
    if backend == "native" and not jax_native_ready():
        pytest.fail("the native store library did not build")
    planes, state = _jax_scene(rng)
    leaves = [np.asarray(x) for x in jax.tree.leaves(state)]
    loc = str(tmp_path / "planes")
    os.makedirs(loc)
    if writer == "jax":
        jps.PlaneStore([loc], backend=backend).save("sc", planes, state,
                                                    as_best=True)
        got, got_state = tps.PlaneStore([loc]).load(
            "sc", prefer_best=True, with_opt_state=True)
        got_leaves = got_state.leaves()
        got_pos, got_view = got.planes_pos.numpy(), got.plane_view.numpy()
    else:
        tplanes = tps.ScenePlanes(torch.from_numpy(np.array(
            planes.planes_pos)), torch.from_numpy(np.array(
                planes.plane_view)), planes.box, occ_aabb=planes.occ_aabb)
        tps.PlaneStore([loc], backend=backend).save(
            "sc", tplanes, tps.PlanesAdamState.from_leaves(
                leaves, ["pos", "view"]), as_best=True)
        got, got_state = jps.PlaneStore([loc]).load(
            "sc", prefer_best=True, opt_state_template=state)
        got_leaves = [np.asarray(x) for x in jax.tree.leaves(got_state)]
        got_pos, got_view = (np.asarray(got.planes_pos),
                             np.asarray(got.plane_view))
    assert native_magic(loc) == (backend == "native")
    np.testing.assert_array_equal(got_pos, np.asarray(planes.planes_pos))
    np.testing.assert_array_equal(got_view, np.asarray(planes.plane_view))
    np.testing.assert_array_equal(got.box, planes.box)
    np.testing.assert_array_equal(got.occ_aabb, planes.occ_aabb)
    assert len(got_leaves) == len(leaves) == 11
    for a, b in zip(got_leaves, leaves):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def native_magic(loc):
    path = os.path.join(loc, "coarse_sc.planes_best")
    return jnative.is_nvps_file(path)
