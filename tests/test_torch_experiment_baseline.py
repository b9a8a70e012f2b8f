"""The baseline NeRF workflow (configs/MipNeRF_baseline.yml in miniature)
in the port's Experiment against the JAX package's.

A fixture trains a JAX mini mip baseline (the model of tests/
test_experiment.py::test_mip_baseline_smoke: 2 layers, 16 wide, IPE of
degrees 0..3, dir PE 2; LR group `4,`, val group `2,`) on the synthetic
corpus of tests/helpers_synth.py for 4 iterations and saves it as JAX's
run() saves at its last iteration. Then:
* the port runs the scenario of test_mip_baseline_smoke and writes a
  checkpoint of JAX's structure;
* both packages evaluate the JAX logdir in eval mode: the same
  metrics.txt keys, PSNRs within 0.01 dB (measured 1e-6, the decimals
  metrics.txt prints), SSIM within 1e-4, the losses within 1e-6;
* both refine from it for 8 iterations with the device draws off (no
  jitter, no density noise) and consistency iterations on; the host
  draws (scenes, images, pixels) are the same numbers in the same order:
  every flushed loss within 1e-5 relative (measured 5.7e-7);
* the port resumes the JAX logdir and JAX the port's: start_i, both MLPs
  and every Adam leaf bit-equal to the files, and each trains on;
* the port's CLI trains, resumes and evaluates a baseline config in a
  process that refuses the JAX stack's imports.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from helpers_synth import write_blender_scene
from nvsr_tpu.experiment import Experiment as JExperiment
from nvsr_tpu.experiment import find_latest_checkpoint
from nvsr_tpu.utils.config import CfgNode
from nvsr_tpu_torch.experiment import Experiment as TExperiment
from test_experiment import _mini_cfg
from test_torch_experiment import _metrics
from test_torch_experiment_interop import _assert_bit_equal, _logged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = {"4,": ["lego"]}
VAL = {"2,": ["lego"]}


def _baseline_cfg(root, logdir, iters=4, im_inconsistency=None,
                  pretrained=None):
    cfg = _mini_cfg(root, logdir=logdir, iters=iters, train_groups=TRAIN,
                    val_groups=VAL, sr=False, what=(),
                    im_inconsistency=im_inconsistency, pretrained=pretrained)
    models = {"coarse": {"type": "FlexibleNeRFModel", "num_layers": 2,
                         "hidden_size": 16, "skip_connect_every": 4,
                         "num_encoding_fn_xyz": 4, "num_encoding_fn_dir": 2,
                         "include_input_xyz": True,
                         "include_input_dir": True},
              "fine": {"type": "FlexibleNeRFModel"}}
    if pretrained:
        models["path"] = pretrained
    cfg.models = CfgNode(models)
    cfg.nerf["encode_position_fn"] = "mip"
    return cfg


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The corpus and a JAX-written mini baseline logdir (logs/base): 4
    iterations, then the rolling and best checkpoints and exp_info, as
    JAX's run() saves at its last iteration (without its evaluations,
    whose compiles would double the fixture's time)."""
    root = tmp_path_factory.mktemp("baseline")
    write_blender_scene(str(root / "synt"), "lego", size=32)
    je = JExperiment(_baseline_cfg(root, "logs/base"), root_path=str(root))
    assert not je.planes_model
    je.image_sampler.update_active(je.training_scenes)
    for i in range(4):
        je.train_iteration(i)
    assert np.all(np.isfinite(je.flush_train_metrics()[0]))
    je.experiment_info["start_i"] = 4
    je.save_checkpoints(3, as_best=True)
    return root


@pytest.fixture(scope="module")
def port_logdir(root):
    """tests/test_experiment.py::test_mip_baseline_smoke in the port."""
    exp = TExperiment(_baseline_cfg(root, "logs/mip"), root_path=str(root),
                      device="cpu")
    assert not exp.planes_model and exp.planes_buffer is None
    exp.run()
    return exp


def test_mip_baseline_smoke(root, port_logdir):
    logdir = os.path.join(str(root), "logs/mip")
    path = find_latest_checkpoint(logdir, sr=False)
    assert path is not None and path.endswith("checkpoint00003.ckpt")
    assert port_logdir.experiment_info["start_i"] == 4
    assert port_logdir._models_to_save() == ["decoder"]
    # the JAX baseline's checkpoint structure: both MLPs and the Adam
    # state, no plane bases or models config
    ours = _load(path)
    jax_ckpt = _load(os.path.join(str(root), "logs/base",
                                  "checkpoint00003.ckpt"))
    assert sorted(ours) == sorted(jax_ckpt) == [
        "model_coarse_state_dict", "model_fine_state_dict", "optimizer"]
    assert jax.tree.structure(ours) == jax.tree.structure(jax_ckpt)
    losses = list(port_logdir.running.scores["loss"]["train"])
    assert losses and np.all(np.isfinite(losses))


def test_eval_of_a_jax_logdir_matches_jax(root):
    for name, make in (
            ("jax", lambda c: JExperiment(c, eval_mode="images",
                                          results_path="res_jax",
                                          root_path=str(root))),
            ("port", lambda c: TExperiment(c, eval_mode="images",
                                           results_path="res_port",
                                           root_path=str(root),
                                           device="cpu"))):
        exp = make(_baseline_cfg(root, "logs/base"))
        exp.run()
    seqs = exp.evaluation_sequences
    assert seqs
    for seq in seqs:
        mj = _metrics(root / "res_jax" / "base" / seq / "metrics.txt")
        mt = _metrics(root / "res_port" / "base" / seq / "metrics.txt")
        assert list(mt) == list(mj), seq
        for key, vj in mj.items():
            kind = key.split("/")[1]
            tol = {"psnr": 0.01, "fine_psnr": 0.01, "SR_psnr_gain": 0.01,
                   "ssim": 1e-4}.get(kind, 1e-6)
            if np.isnan(vj):
                assert np.isnan(mt[key]), key
            else:
                assert abs(mt[key] - vj) <= tol, (key, mt[key], vj)
    pngs = {name: sorted(f for _, _, fs in os.walk(root / name) for f in fs
                         if f.endswith(".png"))
            for name in ("res_jax", "res_port")}
    assert pngs["res_port"] == pngs["res_jax"] and pngs["res_jax"]


def test_refine_losses_match_jax(root):
    runs = {}
    for name, make in (
            ("jax", lambda c: JExperiment(c, root_path=str(root))),
            ("port", lambda c: TExperiment(c, root_path=str(root),
                                           device="cpu"))):
        cfg = _baseline_cfg(root, f"logs/refine_{name}", iters=8,
                            im_inconsistency=1.0, pretrained="logs/base")
        cfg.experiment.update(validate_every=1000, print_every=1,
                              save_every=3)
        cfg.nerf.train["perturb"] = False
        exp = make(cfg)
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
                                  "train/loss_lr", "train/im_inconsistency"}
    assert len({i for _, i in jt}) == 8
    for k, v in jt.items():
        assert abs(tt[k] - v) <= 1e-5 * abs(v), (k, tt[k], v)
    assert sorted({n for n, _, _ in jl}) == sorted({n for n, _, _ in tl})
    files = sorted(f for f in os.listdir(je.logdir)
                   if not f.startswith("events"))
    assert files == sorted(f for f in os.listdir(te.logdir)
                           if not f.startswith("events"))


def test_jax_resumes_a_port_logdir(root, port_logdir):
    logdir = os.path.join(str(root), "logs/mip")
    ck = _load(find_latest_checkpoint(logdir, sr=False))
    je = JExperiment(_baseline_cfg(root, "logs/mip", iters=6),
                     load_checkpoint="resume", root_path=str(root))
    assert je.experiment_info["start_i"] == 4
    _assert_bit_equal(je.decoder_opt.params, {
        "dc": ck["model_coarse_state_dict"],
        "df": ck["model_fine_state_dict"]})
    _assert_bit_equal(je.decoder_opt.state, ck["optimizer"])
    je.image_sampler.update_active(je.training_scenes)
    for i in (4, 5):
        je.train_iteration(i)
    losses, _ = je.flush_train_metrics()
    assert len(losses) == 2 and np.all(np.isfinite(losses))


_CLI_NO_JAX = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "nvsr_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from nvsr_tpu_torch import cli
cfg = sys.argv[1]
cli.main(["--config", cfg, "--device", "cpu", "--max-iters", "2"])
cli.main(["--config", cfg, "--device", "cpu", "--load-checkpoint",
          "resume", "--max-iters", "3"])
cli.main(["--config", cfg, "--device", "cpu", "--eval", "images",
          "--results_path", "res_cli"])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "nvsr_tpu")))
"""


def test_cli_trains_resumes_and_evaluates_the_baseline(root):
    """python -m nvsr_tpu_torch.cli's three modes on a baseline config,
    in a process that refuses the JAX stack: train 2 iterations, resume
    to 3, then --eval images (metrics.txt and PNGs)."""
    cfg = _baseline_cfg(root, "logs/cli", iters=100)
    cfg.experiment.update(validate_every=1000, save_every=1)
    path = root / "baseline_cli.yml"
    path.write_text(cfg.dump())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CLI_NO_JAX, str(path)],
                         cwd=str(root), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    logdir = os.path.join(str(root), "logs/cli")
    assert _load(os.path.join(logdir, "exp_info.pkl"))["start_i"] == 3
    assert find_latest_checkpoint(logdir, sr=False).endswith(
        "checkpoint00002.ckpt")
    results = root / "res_cli" / "cli"
    seqs = sorted(os.listdir(results))
    assert seqs and all((results / seq / "metrics.txt").is_file()
                        for seq in seqs)
    assert any(f.endswith(".png") for _, _, fs in os.walk(results)
               for f in fs)


def test_port_resumes_a_jax_logdir(root):
    """Last in this file: it trains on in the fixture's JAX logdir."""
    logdir = os.path.join(str(root), "logs/base")
    ck = _load(find_latest_checkpoint(logdir, sr=False))
    te = TExperiment(_baseline_cfg(root, "logs/base", iters=6),
                     load_checkpoint="resume", root_path=str(root),
                     device="cpu")
    assert te.experiment_info["start_i"] == 4
    _assert_bit_equal(te.decoder_opt.params, {
        "dc": ck["model_coarse_state_dict"],
        "df": ck["model_fine_state_dict"]})
    _assert_bit_equal(tuple(te.decoder_opt.state), ck["optimizer"])
    te.run()
    assert te.experiment_info["start_i"] == 6
    assert find_latest_checkpoint(logdir, sr=False).endswith(
        "checkpoint00005.ckpt")
