"""A run with its timed path broken underneath comes out not correct,
once for each fault that its cell can have, and each cell's control (the
reference in the precision below the configuration's, in the program's
place) fails its limits. CPU at tiny sizes; the TF32 control needs the
card. Run: python -m pytest gpubench/tests."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_gpubench_harness import TINY, tiny_run  # noqa: E402

from gpubench import faults  # noqa: E402

CASES = [("mipnerf_baseline.train", "unchanged"),
         ("mipnerf_baseline.train", "half_batch"),
         ("trainmodels.train_stage1", "unchanged"),
         ("trainmodels.train_stage1", "half_batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    _, sound = tiny_run(cell, seed=424242)
    assert sound["correct"], sound["checks"]
    with faults.FAULTS[fault]():
        _, out = tiny_run(cell, seed=424242)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mipnerf_baseline.train",
                                  "trainmodels.train_stage1"])
def test_the_tf32_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card: the control of an f32 "
                    "cell runs there (gpubench/readings.py --control)")
    from gpubench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # at the cell's own size
    ctx = harness.Context(cell, 31, 0.3, 0, torch.device("cuda", 0),
                          overrides={"control": True})
    harness.load_driver("train").run(ctx)
    assert not harness.correct_of(ctx.checks), ctx.checks
