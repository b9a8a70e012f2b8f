"""mfu.stage1: mfu.train (metrics/mfu.train.py) in the stage-1 training cell, where it
moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("mfu.train").read
