"""The port's CLI trains a corpus and writes a logdir that the JAX package
resumes.

`python -m nvsr_tpu_torch.cli --config <yml> --device cpu --max-iters 4`
runs a mini stage 1 (tests/test_experiment.py's _mini_cfg) on the
synthetic corpus of tests/helpers_synth.py in a process that refuses the
jax, jaxlib, optax and nvsr_tpu imports, so the checkpoints' optax states
are written without optax. JAX's Experiment then resumes that logdir:
start_i, the decoders, the SR net, the planes and every Adam leaf are
bit-equal to the files (a plain pickle.load reads the port's optimizer
states as optax's classes), and it trains on from them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from helpers_synth import write_blender_scene
from nvsr_tpu.experiment import Experiment as JExperiment
from test_experiment import _mini_cfg
from test_torch_experiment_interop import (LR_SCENE, TRAIN,
                                           _assert_bit_equal, _saved)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    write_blender_scene(str(root / "synt"), "lego", size=32)
    return root


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


@pytest.fixture(scope="module")
def cli_logdir(root):
    """python -m nvsr_tpu_torch.cli --config <yml> --device cpu
    --max-iters 4 in a process that refuses the JAX stack's imports."""
    cfg = _mini_cfg(root, logdir="logs/cli", train_groups=TRAIN, iters=100)
    cfg_path = root / "train_cli.yml"
    cfg_path.write_text(cfg.dump())
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "--config", str(cfg_path),
         "--device", "cpu", "--max-iters", "4"],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert "Running experiment cli on cpu" in out.stdout
    return os.path.join(str(root), "logs/cli")


def test_cli_trains_and_jax_resumes_it(root, cli_logdir):
    ck, sr, info, planes, adam = _saved(cli_logdir)
    assert info["start_i"] == 4
    assert sorted(ck) == ["model_coarse_state_dict", "model_fine_state_dict",
                          "models_config", "optimizer", "rot_mats"]
    je = JExperiment(_mini_cfg(root, logdir="logs/cli", train_groups=TRAIN,
                               iters=6),
                     load_checkpoint="resume", root_path=str(root))
    je.planes_buffer.draw_scenes()
    assert je.experiment_info["start_i"] == 4
    _assert_bit_equal(je.decoder_opt.params, {
        "dc": ck["model_coarse_state_dict"],
        "df": ck["model_fine_state_dict"]})
    _assert_bit_equal(je.decoder_opt.state, ck["optimizer"])
    _assert_bit_equal(je.sr_opt.params, sr["SR_model"])
    _assert_bit_equal(je.sr_opt.state, sr["SR_optimizer"])
    _assert_bit_equal(je.planes_buffer.get(LR_SCENE).params(),
                      planes.params())
    _assert_bit_equal(je.planes_buffer.opt_states[LR_SCENE], adam)
    # two more iterations (without run()'s evaluation, whose compiles
    # would double the test's time)
    je.image_sampler.update_active(je.planes_buffer.cur_scenes)
    for i in (4, 5):
        je.train_iteration(i)
    losses, _ = je.flush_train_metrics()
    assert len(losses) == 2 and np.all(np.isfinite(losses))
