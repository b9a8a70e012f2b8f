"""Tiny CPU sizes of the cells added after test_gpubench_harness.py's
TINY, registered in it before the tests are collected, so that its
tiny rehearsal of every cell of BENCHMARK.json covers them too."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_gpubench_harness  # noqa: E402

TINY = test_gpubench_harness.TINY
# four gloo CPU ranks of 8 rays each
TINY["trainmodels.train_stage1_dp4"] = dict(TINY["trainmodels.train_stage1"])
# stage 3 on a 32x32 view: the LR group at ds 8 (4x4 views, 8^2 planes),
# consistency iterations on its ds 2 couple (2 LR pixels x 4x4 patches);
# the stage-1 logdir's models at the stage-1 cell's tiny widths
TINY["refineontestscene.train_refine"] = {
    "image": 32, "views": {"train": 3, "val": 2, "test": 1},
    "trace_skip": 5, "trace_iters": 5,
    "config": {"dataset.dir.train": {"8,8,4": ["lego##1"]},
               "dataset.dir.val": {"2,32,4": ["lego##1"]},
               "super_resolution.model.hidden_size": 8,
               "super_resolution.model.n_blocks": 1,
               "nerf.train.num_random_rays": 32,
               "nerf.train.num_coarse": 8, "nerf.train.num_fine": 8},
    "pretrained_config": {"models.coarse.dec_channels": 16,
                          "super_resolution.model.hidden_size": 8,
                          "super_resolution.model.n_blocks": 1}}
