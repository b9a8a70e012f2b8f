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
