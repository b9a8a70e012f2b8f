"""The Experiment's training half against the JAX package's: the same
iterations from one JAX-trained logdir, and logdirs written by one
package resumed by the other.

A fixture trains a JAX mini stage 1 (tests/test_experiment.py's
_mini_cfg, 4 iterations, saved as JAX's run() saves them) on the
synthetic corpus of tests/helpers_synth.py. Then:
* loss parity: from that logdir (pretrained decoders and SR net, its
  planes with their Adam state), both packages run 8 iterations of a
  deterministic refine config (no jitter, no noise; consistency
  iterations on; surface occupancy committing boxes from iteration 2).
  The host draws (scenes, images, pixels, members) are the same numbers
  in the same order. Every flushed per-iteration loss and PSNR within
  relative 1e-5 (measured 5.7e-7: f32 summation order, amplified by
  Adam's near-sign first steps); the committed occupied box within 1e-5
  (measured equal); the metric names, the logdir's files and the
  checkpoints' and plane files' keys equal;
* the port resumes the JAX-written logdir: start_i, the decoders, the SR
  net, the planes and every Adam leaf bit-equal to the files, then it
  trains on.
The other direction, JAX resuming a logdir that the port's CLI wrote, is
tests/test_torch_experiment_cli.py.
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from helpers_synth import write_blender_scene
from nvsr_tpu.experiment import Experiment as JExperiment
from nvsr_tpu.experiment import find_latest_checkpoint
from nvsr_tpu.planes_store import PlaneStore as JPlaneStore
from nvsr_tpu_torch.experiment import Experiment as TExperiment
from test_experiment import _mini_cfg
from torch_port_helpers import jax_native_ready

TRAIN = {"4,8,8": ["lego"], "2,16,8": ["lego"]}
LR_SCENE = "lego_DS4_PlRes8_8"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The corpus and a JAX-written stage-1 logdir: JAX's run() without
    its evaluations (whose compiles would double the fixture's time):
    4 iterations, then the planes, rolling and best, and the
    checkpoints, rolling and best, as its save at the last iteration
    writes them."""
    root = tmp_path_factory.mktemp("interop")
    write_blender_scene(str(root / "synt"), "lego", size=32)
    je = JExperiment(_mini_cfg(root, logdir="logs/stage1",
                               train_groups=TRAIN, iters=4),
                     root_path=str(root))
    je.planes_buffer.draw_scenes()
    je.image_sampler.update_active(je.planes_buffer.cur_scenes)
    for i in range(4):
        je.train_iteration(i)
    assert np.all(np.isfinite(je.flush_train_metrics()[0]))
    je.planes_buffer.save_params()
    je.planes_buffer.save_params(as_best=True)
    je.experiment_info["start_i"] = 4
    je.save_checkpoints(3, as_best=True)
    return root


def _refine_cfg(root, logdir):
    cfg = _mini_cfg(root, logdir=logdir, train_groups={"4,8,8": ["lego"]},
                    val_groups={"2,16,8": ["lego"]},
                    pretrained="logs/stage1", planes_path="logs/stage1",
                    im_inconsistency=1.0, iters=8)
    # evaluations at fixed iterations (a time-based cadence would move
    # the buffer's reshuffles, and with them the host draws)
    cfg.experiment.update(validate_every=1000, print_every=1, save_every=3)
    cfg.nerf.train["perturb"] = False
    cfg.nerf.train["occupancy"] = {"enabled": True, "warmup_iters": 2,
                                   "update_every": 2}
    return cfg


def _logged(exp):
    log = []
    real = exp.logger.write_scalar

    def write_scalar(name, value, index):
        log.append((name, index, value))
        return real(name, value, index)

    exp.logger.write_scalar = write_scalar
    return log


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_refine_losses_match_jax(root):
    runs = {}
    for name, make in (
            ("jax", lambda c: JExperiment(c, root_path=str(root))),
            ("port", lambda c: TExperiment(c, root_path=str(root),
                                           device="cpu"))):
        exp = make(_refine_cfg(root, f"logs/refine_{name}"))
        log = _logged(exp)
        exp.run()
        runs[name] = (exp, log)
    (je, jl), (te, tl) = runs["jax"], runs["port"]

    def train(log):
        return {(n, i): v for n, i, v in log
                if n.startswith("train/") and n != "train/rays_per_sec"}

    jt, tt = train(jl), train(tl)
    assert sorted(jt) == sorted(tt)
    assert {n for n, _ in jt} >= {"train/loss", "train/psnr",
                                  "train/fine_psnr", "train/loss_lr",
                                  "train/im_inconsistency"}
    assert len({i for _, i in jt}) == 8
    for k, v in jt.items():
        assert abs(tt[k] - v) <= 1e-5 * abs(v), (k, tt[k], v)
    assert sorted({n for n, _, _ in jl}) == sorted({n for n, _, _ in tl})

    # the committed occupied box
    jb = je.planes_buffer.get(LR_SCENE).occ_aabb
    tb = te.planes_buffer.get(LR_SCENE).occ_aabb
    assert jb is not None and tb is not None
    assert JPlaneStore([os.path.join(str(root), "logs/stage1/planes")]
                       ).load(LR_SCENE)[0].occ_aabb is None
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-5)

    # the logdirs: the same files, checkpoints of the same structure
    # (optax's classes included: pickle.load reads the port's as JAX's)
    jdir, tdir = je.logdir, te.logdir
    files = sorted(f for f in os.listdir(jdir) if not f.startswith("events"))
    assert files == sorted(f for f in os.listdir(tdir)
                           if not f.startswith("events"))
    for f in files:
        if ".ckpt" in f:
            cj, ct = _load(os.path.join(jdir, f)), _load(os.path.join(tdir,
                                                                      f))
            assert sorted(cj) == sorted(ct), f
            assert jax.tree.structure(cj) == jax.tree.structure(ct), f
    ij = _load(os.path.join(jdir, "exp_info.pkl"))
    it = _load(os.path.join(tdir, "exp_info.pkl"))
    assert sorted(ij) == sorted(it) and ij["start_i"] == it["start_i"] == 8
    assert sorted(os.listdir(os.path.join(jdir, "planes"))) == sorted(
        os.listdir(os.path.join(tdir, "planes")))


def _saved(logdir):
    """What a logdir holds: the newest rolling checkpoints, exp_info and
    the LR scene's rolling plane file with its Adam leaves (numpy)."""
    # the plane file may be native: let JAX's library finish building
    jax_native_ready()
    ck = _load(find_latest_checkpoint(logdir, sr=False))
    sr = _load(find_latest_checkpoint(logdir, sr=True))
    info = _load(os.path.join(logdir, "exp_info.pkl"))
    store = JPlaneStore([os.path.join(logdir, "planes")])
    planes, _ = store.load(LR_SCENE)
    template = optax.inject_hyperparams(optax.adam)(
        learning_rate=1e-2, eps=1e-8).init(planes.params())
    planes, adam = store.load(LR_SCENE, opt_state_template=template)
    return ck, sr, info, planes, adam


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_bit_equal(a, b):
    la = [_np(x) for x in jax.tree.leaves(a, is_leaf=torch.is_tensor)]
    lb = [_np(x) for x in jax.tree.leaves(b, is_leaf=torch.is_tensor)]
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.reshape(-1), y.reshape(-1))


def test_port_resumes_a_jax_logdir(root):
    """Last in this file: it trains on in the fixture's JAX logdir."""
    logdir = os.path.join(str(root), "logs/stage1")
    ck, sr, info, planes, adam = _saved(logdir)
    te = TExperiment(_mini_cfg(root, logdir="logs/stage1",
                               train_groups=TRAIN, iters=6),
                     load_checkpoint="resume", root_path=str(root),
                     device="cpu")
    te.planes_buffer.draw_scenes()
    assert te.experiment_info["start_i"] == info["start_i"] == 4
    _assert_bit_equal(te.decoder_opt.params, {
        "dc": ck["model_coarse_state_dict"],
        "df": ck["model_fine_state_dict"]})
    _assert_bit_equal(tuple(te.decoder_opt.state), ck["optimizer"])
    _assert_bit_equal(te.sr_opt.params, sr["SR_model"])
    _assert_bit_equal(tuple(te.sr_opt.state), sr["SR_optimizer"])
    _assert_bit_equal(te.planes_buffer.get(LR_SCENE).params(),
                      planes.params())
    _assert_bit_equal(te.planes_buffer.opt.state(LR_SCENE).leaves(),
                      jax.tree.leaves(adam))
    te.run()
    assert te.experiment_info["start_i"] == 6
