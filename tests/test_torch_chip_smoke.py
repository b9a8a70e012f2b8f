"""chip_smoke.py must fail, and print no result, where it cannot do its
job: on a machine without a CUDA device, and as a lone script without
the package beside it."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(tmp_path, where):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_train_phase_rehearses_on_the_cpu():
    """chip_smoke.py's training phase at a tiny size on the CPU, where
    every step runs the plain versions: the path, its optimizers and its
    checks (finite losses, every trained group moves, kernel and plain
    sampler steps agree) work end to end."""
    cs = _chip_smoke()
    small = dict(rays=64, samples=4, channels=8, res=12, view_res=4,
                 sr_hidden=4, sr_blocks=1, sr_scale=2, image=16)
    assert cs.train_phase("cpu", cs.camera([3.8, 0.5, 0.7]), w=small,
                          on_card=False) == {}


def test_bicubic_phase_rehearses_on_the_cpu():
    """chip_smoke.py's bicubic phase on the CPU, through the plain
    versions: SR with the bicubic residual and the bf16 and f32 frames at
    a tiny size, then the gate scene's checks at its own size (kernel vs
    plain, the f32 non-fused tiled route vs the reference path in bicubic
    and bilinear, the reference path's PSNR against JAX's)."""
    cs = _chip_smoke()
    small = dict(image=16, channels=8, res=12, view_res=4, sr_hidden=4,
                 sr_blocks=1, sr_scale=2, reps=1)
    assert cs.bicubic_phase("cpu", cs.camera([3.8, 0.5, 0.7]), w=small,
                            on_card=False) == {}


def test_points_phase_rehearses_on_the_cpu():
    """chip_smoke.py's points-entry phase on the CPU, through the plain
    versions at a tiny size: SR, the frame through the public points entry
    (v2 and v1) against the from-rays frame (>= 45 dB), and the standalone
    decoder and the row gather on the fine pass's data."""
    cs = _chip_smoke()
    small = dict(image=16, channels=8, res=12, view_res=4, sr_hidden=4,
                 sr_blocks=1, sr_scale=2, reps=1)
    assert cs.points_phase("cpu", cs.camera([3.8, 0.5, 0.7]), w=small,
                           on_card=False) == {}


def test_experiment_phase_rehearses_on_the_cpu():
    """chip_smoke.py's Experiment phase on the CPU at a tiny size: the
    synthetic scene and the JAX-layout logdir written by the port, the
    eval-mode Experiment on them through the tiled route's plain versions
    (metrics.txt keys and PNGs, the plane SR once, the first view against
    the reference path >= 45 dB)."""
    cs = _chip_smoke()
    small = dict(image=32, channels=8, res=6, view_res=4, sr_hidden=4,
                 sr_blocks=1, sr_scale=2, reps=1)
    assert cs.experiment_phase("cpu", w=small, on_card=False) is None


def test_experiment_train_phase_rehearses_on_the_cpu():
    """chip_smoke.py's Experiment training phase on the CPU at a tiny
    size, every step and render through the plain versions: the training
    run and its logdir (rolling and best checkpoints, SR checkpoints,
    exp_info, plane files with their Adam leaves), finite losses, a
    committed occupied box inside the scene box, an eval view against the
    reference path (>= 45 dB), and the resume, which starts at the saved
    start_i with every parameter and Adam state bit-equal and trains
    on."""
    cs = _chip_smoke()
    small = dict(rays=64, samples=4, channels=8, res=12, view_res=4,
                 sr_hidden=4, sr_blocks=1, sr_scale=2, image=32)
    assert cs.experiment_train_phase("cpu", w=small, on_card=False) is None


def test_baseline_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 10 (a) on the CPU at a tiny size: the
    MipNeRF_baseline config as a dict through the Experiment (training
    with consistency iterations, saves, the bit-equal resume), a crop of
    the val view against the CPU render, and `--eval images` of the
    logdir (metrics.txt and PNGs from the best checkpoint)."""
    cs = _chip_smoke()
    small = dict(image=32, layers=2, hidden=16, rays=64, samples=4, crop=8)
    assert cs.baseline_phase("cpu", w=small, on_card=False) is None


def test_convert_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 10 (b) on the CPU at a tiny size: reference
    checkpoints saved with torch.save, read and converted, then SR and the
    frame on the converted weights through the fused route's plain
    version against the plain point fns (>= 45 dB)."""
    cs = _chip_smoke()
    small = dict(image=16, channels=8, res=12, view_res=4, sr_hidden=4,
                 sr_blocks=1, sr_scale=2)
    assert cs.convert_phase("cpu", w=small, on_card=False) is None


def test_sr_gaps_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 10 (c) on the CPU at a tiny size: SRResNet
    with and without BatchNorm in eval and train mode, and tiled EDSR
    against the full plane in f32 (within the bound) and bf16."""
    cs = _chip_smoke()
    small = dict(channels=4, res=12, sr_hidden=8, sr_blocks=2, sr_scale=2,
                 srresnet_hidden=8, srresnet_blocks=2, tile=5, reps=1)
    assert cs.sr_gaps_phase("cpu", w=small, on_card=False) is None
